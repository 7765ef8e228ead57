"""Streaming enhancement (counterpart of
``speech_enhancement_by_s3prl_tpu/ops/streaming.py``).

- ``enhance_streaming``: chunked enhancement for audio longer than the
  largest duration bucket (numpy only). Fixed windows with overlapped cosine
  crossfades: it works with any model, bidirectional ones included,
  recomputes the overlap, and its crossfaded seams differ from a
  full-utterance pass.
- ``StatefulStreamer``: constant-latency streaming for one-direction heads,
  sample-exact against the offline path. The host keeps the stream, the
  feature FIFOs, the delta strip and the overlap-add in numpy; the device
  runs the analysis (framing and a product with the DFT matrix, then the
  mel bank) and the model step (deltas, the head continuing from the
  carried per-layer (h, c), the carrier rescaled to the masked magnitude, a
  product with the inverse DFT matrix, the window). On a CUDA model the
  recurrence is kernel B1 with its state in and out (a bf16 head: B1's
  bf16-h form, the JAX scan cell in bf16); the (h, c) stay on the
  device between chunks. The fused STFT (B4) and decode (B5) kernels do not
  fit here: B4 reflect-pads each call's edges itself, and the streamer
  overlap-adds on the host across chunks, where B5 overlap-adds on the
  device within one call.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def enhance_streaming(
    enhance_fn: Callable[[np.ndarray], np.ndarray],
    wav: np.ndarray,
    sample_rate: int = 16000,
    window_sec: float = 10.0,
    overlap_sec: float = 1.0,
) -> np.ndarray:
    """Apply a fixed-window enhancer to a long 1-D signal.

    enhance_fn: maps a window (exactly window samples, zero-padded at the
    tail) to its enhanced version of the same length.
    """
    window = int(window_sec * sample_rate)
    overlap = int(overlap_sec * sample_rate)
    if not 0 <= overlap < window:
        raise ValueError(f"the overlap ({overlap} samples) must be shorter than the "
                         f"window ({window} samples)")
    hop = window - overlap
    n = len(wav)
    if n <= window:
        padded = np.zeros(window, np.float32)
        padded[:n] = wav
        return np.asarray(enhance_fn(padded))[:n]

    fade_in = 0.5 - 0.5 * np.cos(np.pi * np.arange(overlap) / overlap)
    out = np.zeros(n, np.float32)
    norm = np.zeros(n, np.float32)

    start = 0
    while start < n:
        chunk = np.zeros(window, np.float32)
        valid = min(window, n - start)
        chunk[:valid] = wav[start : start + valid]
        enhanced = np.asarray(enhance_fn(chunk))[:valid]

        weight = np.ones(valid, np.float32)
        if start > 0:
            m = min(overlap, valid)
            weight[:m] = fade_in[:m]
        if start + valid < n:
            m = min(overlap, valid)
            weight[valid - m :] = fade_in[::-1][:m][-m:]
        out[start : start + valid] += enhanced * weight
        norm[start : start + valid] += weight
        if start + window >= n:
            break
        start += hop

    return out / np.maximum(norm, 1e-8)


class StatefulStreamer:
    """Constant-latency streaming enhancement for one-direction heads.

    Reproduces the offline pipeline sample-exactly, chunk by chunk:

    - the host keeps the reflect-padded sample stream (the ``center=True``
      STFT convention) and frames it without any per-chunk edge padding;
    - an ANALYSIS step on the device turns each F-frame chunk into the
      feature rows (log-)mel, the power spectrum and the packed [re | im]
      carrier;
    - the host keeps a rolling feature strip with ``2 * delta`` rows of left
      context (replicating row 0 at the very start and the last row at
      flush, the replicate padding of the offline ``compute_deltas``);
    - a MODEL step on the device computes the delta stack on the strip, runs
      the head from the carried per-layer (h, c) (``lstm_state``), rescales
      the carrier to the masked magnitude and returns windowed time-domain
      synthesis frames; only the frames of the chunk come to the host;
    - the host overlap-adds the frames and the window-square envelope and
      emits samples once no later frame can touch them.

    Latency is fixed at ``(2 * delta) frames + one chunk``; memory is
    constant. The offline path's per-utterance dB renorm needs the whole
    utterance, so the stream is not renormalized (renorm the concatenation
    to compare with the offline contract).

    Needs a one-direction ``LSTM`` / ``Residual`` head (f32, or bf16: the
    bf16-h form of B1 from the carried state), mel downstream
    features (``feat_cfg``, by default the preprocessor's slot 1) with
    ``cmvn`` False (CMVN is a whole-utterance statistic), and the model's
    weights on the device the steps run on.
    """

    def __init__(self, model, preprocessor, feat_cfg: Optional[dict] = None,
                 frames_per_chunk: int = 48, linear_power: float = 2.0):
        from ..models.lstm import LSTMStack
        from .mel import mel_filterbank
        from .stft import _dft_tensors

        stack = getattr(model, "lstm", None)
        if not isinstance(stack, LSTMStack) or stack.bidirectional:
            raise ValueError(
                "stateful streaming needs a unidirectional LSTM / Residual head (the "
                "backward direction would need future audio); use enhance_streaming's "
                "crossfade windows for bidirectional models")
        cfg = preprocessor.config
        st = cfg.stft
        self.n_fft, self.hop, self.n_freq = st.n_fft, st.hop_length, st.n_freq
        self.F = int(frames_per_chunk)
        if feat_cfg is None:
            # the downstream feature slot of the six-feature bundle
            feat_cfg = preprocessor.feat_list[1]
        if feat_cfg["feat_type"] != "mel":
            raise ValueError(f"stateful streaming needs mel features, got {feat_cfg}")
        if feat_cfg.get("cmvn", False):
            raise ValueError("CMVN is a whole-utterance statistic: streaming needs "
                             "cmvn=False downstream features")
        self.delta = int(feat_cfg.get("delta", 0))
        self.log = bool(feat_cfg.get("log", False))
        self.ctx = 2 * self.delta  # exact-delta context rows per side
        self.device = next(model.parameters()).device
        self.model = model
        fwd, inv, window = _dft_tensors(self.n_fft, st.win_length, self.device)
        self._w2 = (window.cpu().numpy().astype(np.float64) ** 2).astype(np.float32)
        self.seg_len = (self.F - 1) * self.hop + self.n_fft
        n_mels, eps = cfg.n_mels, cfg.eps
        # the mel bank of ops/mel.power_to_mel, on the device once
        mel_fb = torch.from_numpy(mel_filterbank(self.n_freq, n_mels, cfg.sample_rate)).to(
            self.device)
        F, n_fft, hop, n_freq, delta = self.F, self.n_fft, self.hop, self.n_freq, self.delta

        def analysis(seg):
            frames = seg.unfold(0, n_fft, hop)    # (F, n_fft), a view
            packed = torch.matmul(frames, fwd)    # (F, 2 * n_freq)
            re, im = packed[:, :n_freq], packed[:, n_freq:]
            power = re * re + im * im
            mel = torch.matmul(power, mel_fb)
            feat = torch.log(mel + eps) if self.log else mel
            # one copy to the host: [feat | power | packed]
            return torch.cat([feat, power, packed], dim=-1).cpu().numpy()

        def model_step(strip, power, packed, state, n_frames):
            from .features import compute_deltas

            parts = [strip]
            for _ in range(delta):
                parts.append(compute_deltas(parts[-1]))
            feats = torch.cat(parts, dim=-1)[2 * delta:2 * delta + F][None]  # (1, F, D)
            predicted, aux = model(feats, power[None], lstm_state=state)
            predicted = predicted[0]
            mag = predicted ** (1.0 / linear_power) if linear_power != 1.0 else predicted
            zre, zim = packed[:, :n_freq], packed[:, n_freq:]
            zmag = torch.sqrt(zre * zre + zim * zim)
            nz = zmag > 0.0
            invz = 1.0 / torch.where(nz, zmag, torch.ones_like(zmag))
            sre = mag * torch.where(nz, zre * invz, torch.ones_like(zre))
            sim = mag * torch.where(nz, zim * invz, torch.zeros_like(zim))
            synth = torch.matmul(torch.cat([sre, sim], dim=-1), inv) * window  # (F, n_fft)
            # only the frames of the chunk come to the host
            return synth[:n_frames].cpu().numpy(), aux["lstm_state"]

        self._analysis = analysis
        self._model_step = model_step
        H = stack.hidden_size
        self._zero_state = tuple(
            (torch.zeros((1, H), device=self.device), torch.zeros((1, H), device=self.device))
            for _ in range(stack.num_layers))
        self._n_mels = n_mels
        self.reset()

    def reset(self) -> None:
        """Rewind to the start-of-stream state (LSTM zeros, empty FIFOs)."""
        self._state = self._zero_state
        self._pending = np.zeros(0, np.float32)  # raw samples, pre-padding
        self._padded: Optional[np.ndarray] = None  # reflect-prefixed stream
        self._pad_consumed = 0   # padded samples dropped from _padded[0]
        self._n_raw = 0          # total raw samples pushed
        self._analyzed = 0       # frames analyzed so far
        self._consumed = 0       # frames consumed by the model so far
        self._feat_fifo = np.zeros((0, self._n_mels), np.float32)
        self._pw_fifo = np.zeros((0, self.n_freq), np.float32)
        self._pk_fifo = np.zeros((0, 2 * self.n_freq), np.float32)
        self._left_ctx: Optional[np.ndarray] = None  # ctx consumed rows
        # overlap-add accumulators aligned at padded coordinate _ola_base
        self._ola = np.zeros(0, np.float32)
        self._env = np.zeros(0, np.float32)
        self._ola_base = 0
        self._emitted = 0        # padded samples emitted so far

    def clone(self) -> "StatefulStreamer":
        """A fresh stream sharing this instance's model and steps: what a
        server makes per connection."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.reset()
        return new

    # -- internals -------------------------------------------------------

    def _ensure_padded(self) -> bool:
        half = self.n_fft // 2
        if self._padded is None:
            if len(self._pending) <= half:
                return False
            prefix = self._pending[1 : half + 1][::-1]
            self._padded = np.concatenate([prefix, self._pending])
            self._pending = np.zeros(0, np.float32)
        return True

    def _analyze(self, n_frames: int):
        """Analysis of frames [_analyzed, _analyzed + n_frames): feature rows,
        power and packed carrier appended to the FIFOs."""
        hop, n_fft = self.hop, self.n_fft
        start = self._analyzed * hop - self._pad_consumed
        need = (n_frames - 1) * hop + n_fft
        seg = np.asarray(self._padded[start : start + need], np.float32)
        if len(seg) < self.seg_len:
            seg = np.pad(seg, (0, self.seg_len - len(seg)))
        with torch.inference_mode():
            out = self._analysis(torch.from_numpy(seg).to(self.device))[:n_frames]
        m, f = self._n_mels, self.n_freq
        self._feat_fifo = np.concatenate([self._feat_fifo, out[:, :m]])
        self._pw_fifo = np.concatenate([self._pw_fifo, out[:, m : m + f]])
        self._pk_fifo = np.concatenate([self._pk_fifo, out[:, m + f :]])
        self._analyzed += n_frames
        # drop padded samples no later frame needs
        keep_from = self._analyzed * hop - self._pad_consumed
        if keep_from > 0:
            self._padded = self._padded[keep_from:]
            self._pad_consumed += keep_from

    def _consume(self, n_frames: int, at_end: bool):
        """Model step over the oldest n_frames FIFO rows (exact deltas: ctx
        left rows kept from consumed history, ctx right rows present in the
        FIFO unless the stream has ended, when the true last row replicates,
        the offline end-padding convention)."""
        F, ctx, hop, n_fft = self.F, self.ctx, self.hop, self.n_fft
        if self._left_ctx is None:
            # offline compute_deltas replicate-pads the utterance start
            self._left_ctx = np.repeat(self._feat_fifo[:1], ctx, axis=0)
        strip = np.concatenate([self._left_ctx, self._feat_fifo[: n_frames + ctx]], axis=0)
        want = ctx + n_frames + ctx
        if strip.shape[0] < want:
            if not at_end:
                raise RuntimeError("right context missing before the end of the stream")
            strip = np.concatenate(
                [strip, np.repeat(strip[-1:], want - strip.shape[0], axis=0)])
        if strip.shape[0] < F + 2 * ctx:  # final partial chunk
            strip = np.concatenate(
                [strip, np.repeat(strip[-1:], F + 2 * ctx - strip.shape[0], axis=0)])
        pw = self._pw_fifo[:n_frames]
        pk = self._pk_fifo[:n_frames]
        if n_frames < F:
            pw = np.pad(pw, ((0, F - n_frames), (0, 0)))
            pk = np.pad(pk, ((0, F - n_frames), (0, 0)))
        # one copy to the device: [power | packed] rows, then the strip's rows
        rows = np.concatenate([np.concatenate([pw, pk], axis=1).reshape(-1),
                               strip.reshape(-1)])
        with torch.inference_mode():
            dev = torch.from_numpy(rows).to(self.device)
            f = self.n_freq
            chunk = dev[: F * 3 * f].view(F, 3 * f)
            synth, self._state = self._model_step(
                dev[F * 3 * f :].view(strip.shape), chunk[:, :f], chunk[:, f:],
                self._state, n_frames)  # the state is junk past the end only at flush

        s = self._consumed
        first = s * hop
        last_end = (s + n_frames - 1) * hop + n_fft
        if len(self._ola) == 0:
            self._ola_base = first
        need_len = last_end - self._ola_base
        if need_len > len(self._ola):
            grow = need_len - len(self._ola)
            self._ola = np.concatenate([self._ola, np.zeros(grow, np.float32)])
            self._env = np.concatenate([self._env, np.zeros(grow, np.float32)])
        for j in range(n_frames):
            o = (s + j) * hop - self._ola_base
            self._ola[o : o + n_fft] += synth[j]
            self._env[o : o + n_fft] += self._w2
        self._consumed += n_frames
        keep = self._feat_fifo[n_frames:]
        if ctx:
            self._left_ctx = np.concatenate(
                [self._left_ctx, self._feat_fifo[:n_frames]])[-ctx:]
        else:
            self._left_ctx = self._left_ctx[:0]
        self._feat_fifo = keep
        self._pw_fifo = self._pw_fifo[n_frames:]
        self._pk_fifo = self._pk_fifo[n_frames:]

    def _emit(self, upto_padded: int) -> np.ndarray:
        half = self.n_fft // 2
        lo = max(self._emitted, half)
        hi = upto_padded
        if hi <= lo:
            return np.zeros(0, np.float32)
        a = lo - self._ola_base
        b = hi - self._ola_base
        env = self._env[a:b]
        out = self._ola[a:b] / np.where(env > 1e-11, env, 1.0)
        self._emitted = hi
        self._ola = self._ola[b:]
        self._env = self._env[b:]
        self._ola_base = hi
        return out.astype(np.float32)

    def _frames_framable(self) -> int:
        avail = self._pad_consumed + len(self._padded)
        return max(0, (avail - self.n_fft) // self.hop + 1 - self._analyzed)

    # -- public API ------------------------------------------------------

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed samples; returns whatever enhanced audio became final."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._n_raw += len(samples)
        if self._padded is None:
            self._pending = np.concatenate([self._pending, samples])
            if not self._ensure_padded():
                return np.zeros(0, np.float32)
        else:
            self._padded = np.concatenate([self._padded, samples])
        out = []
        while self._frames_framable() >= self.F:
            self._analyze(self.F)
        while len(self._feat_fifo) >= self.F + self.ctx:
            self._consume(self.F, at_end=False)
            out.append(self._emit(self._consumed * self.hop))
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def flush(self) -> np.ndarray:
        """End of stream: reflect-pad the tail (the offline convention),
        analyze and consume the remaining frames, return the last samples.
        The total emitted over push() and flush() is the offline output's
        ``(n // hop) * hop`` samples."""
        half = self.n_fft // 2
        n = self._n_raw
        n_frames_total = n // self.hop + 1
        if self._padded is None:
            self._padded = np.pad(self._pending, (half, 0), mode="reflect")
            self._pending = np.zeros(0, np.float32)
        raw_end = half + n  # padded index just past the real samples
        lastf_end = (n_frames_total - 1) * self.hop + self.n_fft
        need_suffix = max(0, lastf_end - raw_end)
        if need_suffix:
            raw_start_in_buf = max(0, half - self._pad_consumed)
            raw_in_buf = self._padded[raw_start_in_buf:]
            refl = raw_in_buf[-2 : -2 - need_suffix : -1]
            if len(refl) < need_suffix:  # extremely short signals
                reps = np.pad(raw_in_buf, (0, need_suffix), mode="wrap")[len(raw_in_buf):]
                refl = np.concatenate([refl, reps[len(refl):]])
            self._padded = np.concatenate([self._padded, refl])
        out = []
        while self._analyzed < n_frames_total:
            self._analyze(min(self.F, n_frames_total - self._analyzed))
        while self._consumed < n_frames_total:
            take = min(self.F, n_frames_total - self._consumed)
            self._consume(take, at_end=True)
            out.append(self._emit(self._consumed * self.hop))
        # the offline istft covers (n_frames - 1) * hop samples from the
        # padded offset half: emit the trailing covered span
        out.append(self._emit(half + (n_frames_total - 1) * self.hop))
        return np.concatenate(out) if out else np.zeros(0, np.float32)
