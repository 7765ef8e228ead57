"""Short-Time Objective Intelligibility, STOI and ESTOI (counterpart of
``speech_enhancement_by_s3prl_tpu/metrics/stoi.py``).

The published algorithm (Taal et al. 2011; ESTOI: Jensen & Taal 2016),
batched on the device of its inputs:

1. resample to 10 kHz (polyphase kaiser-windowed sinc, scipy-compatible), as
   one f32 matrix product over framed rows;
2. remove silent frames (40 dB dynamic range on the clean signal's framed
   energy; 256-sample hann frames, 50% overlap);
3. 512-point DFT of 256-sample hann frames, hop 128, as matrix products;
4. 15 third-octave band envelopes from 150 Hz;
5. length-30 sliding segments: normalization, clipping and per-band
   correlation (STOI) or row- and column-normalized segment correlation
   (ESTOI).

Shapes never depend on the data: silent-frame removal is a stable partition
(``torch.argsort(stable=True)``) with validity masks, so no value is read
back to the host inside an eval step. Every product runs in full f32: the
callers in ``metrics/__init__.py`` turn TF32 off around them, since a
reduced-precision contraction moves STOI by up to 0.09.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stft import _overlap_add

FS = 10000          # STOI internal rate
N_FRAME = 256       # frame length at 10 kHz
HOP = 128
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N_SEG = 30          # analysis segment length (384 ms)
BETA = -15.0        # lower SDR bound
DYN_RANGE = 40.0


@functools.lru_cache(maxsize=4)
def _resample_kernel(up: int, down: int, window_beta: float = 5.0):
    """Polyphase FIR (kaiser-windowed sinc), scipy.resample_poly-compatible."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    n = np.arange(-half_len, half_len + 1)
    h = up * f_c * np.sinc(f_c * n)
    h *= np.kaiser(2 * half_len + 1, window_beta)
    return np.asarray(h, dtype=np.float32)


@functools.lru_cache(maxsize=4)
def _polyphase_mat(up: int, down: int):
    """The zero-stuff -> FIR -> decimate resampler as a dense block map:
    every block of ``up`` consecutive outputs reads the same ``Wd``-sample
    input window advancing by ``down``, so

        y[up*s + j] = sum_w  x[down*s + omin + w] * W[w, j]

    with W built from the FIR taps (zero-interleaved per output phase).
    Returns (W (Wd, up), omin)."""
    h = _resample_kernel(up, down)
    L = len(h)
    p = L // 2
    # output m = up*s + j reads taps k = p - j*down + up*o at input offset
    # o from the block base down*s (the zero-stuffed index m*down + k - p
    # must be a multiple of up)
    omin = -(-(-p) // up)  # ceil(-p / up)
    omax = (L - 1 - p + (up - 1) * down) // up
    Wd = omax - omin + 1
    W = np.zeros((Wd, up), np.float32)
    for j in range(up):
        for o in range(omin, omax + 1):
            k = p - j * down + up * o
            if 0 <= k < L:
                W[o - omin, j] = h[k]
    return W, omin


def resample(x: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """(..., T) -> (..., ceil(T * up / down)) polyphase resample as one
    matrix product of the framed input rows (see ``_polyphase_mat``)."""
    if orig_sr == new_sr:
        return x
    g = math.gcd(orig_sr, new_sr)
    up, down = new_sr // g, orig_sr // g
    W, omin = _polyphase_mat(up, down)
    Wd = W.shape[0]
    lead = x.shape[:-1]
    t = x.shape[-1]
    xb = x.reshape(-1, t)

    n_out = -(-t * up // down)  # ceil
    n_blocks = -(-n_out // up)
    # frames[s, w] = x[down*s + omin + w], zeros outside [0, t)
    left = max(0, -omin)
    start = omin + left
    need = down * (n_blocks - 1) + start + Wd  # highest index + 1 into xp
    xp = F.pad(xb, (left, max(0, need - (t + left))))
    frames = xp[:, start:].unfold(-1, Wd, down)[:, :n_blocks]
    y = torch.matmul(frames, _polyphase_on(up, down, x.device))
    y = y.reshape(xb.shape[0], n_blocks * up)[:, :n_out]
    return y.reshape(lead + (n_out,))


@functools.lru_cache(maxsize=1)
def _stoi_window():
    # hann without endpoint zeros, as the STOI reference uses it
    w = np.hanning(N_FRAME + 2)[1:-1]
    return np.asarray(w, dtype=np.float32)


@functools.lru_cache(maxsize=1)
def _third_octave_matrix():
    """(n_bins, 15) binary band matrix over the 257-bin rfft grid."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUMBAND, dtype=np.float64)
    cf = MINFREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((len(f), NUMBAND), dtype=np.float32)
    for j in range(NUMBAND):
        lo_idx = int(np.argmin((f - lo[j]) ** 2))
        hi_idx = int(np.argmin((f - hi[j]) ** 2))
        obm[lo_idx:hi_idx, j] = 1.0
    return obm


@functools.lru_cache(maxsize=1)
def _dft_mats():
    """512-point real DFT of 256-sample windowed frames as matrices."""
    w = _stoi_window().astype(np.float64)
    n = np.arange(N_FRAME)[:, None]
    k = np.arange(NFFT // 2 + 1)[None, :]
    ang = 2.0 * math.pi * n * k / NFFT
    re = (w[:, None] * np.cos(ang)).astype(np.float32)
    im = (w[:, None] * -np.sin(ang)).astype(np.float32)
    return re, im


@functools.lru_cache(maxsize=1)
def _trimmed_band_mats():
    """DFT and band matrices restricted to the bins a third-octave band
    reads (bins 7..219 of 257). Exact: the other bins never reach a band
    sum."""
    re, im = _dft_mats()
    obm = _third_octave_matrix()
    used = np.flatnonzero(obm.any(axis=1))
    k0, k1 = int(used[0]), int(used[-1]) + 1
    return re[:, k0:k1], im[:, k0:k1], obm[k0:k1]


@functools.lru_cache(maxsize=8)
def _polyphase_on(up: int, down: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_polyphase_mat(up, down)[0]).to(device)


@functools.lru_cache(maxsize=8)
def _device_mats(device: torch.device) -> dict:
    """The window and the trimmed DFT and band matrices on ``device``, made
    once."""
    re, im, bands = (np.ascontiguousarray(m) for m in _trimmed_band_mats())
    return {k: torch.from_numpy(v).to(device) for k, v in (
        ("window", _stoi_window()), ("dft_re", re), ("dft_im", im), ("bands", bands))}


def _frame(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, N_FRAME) hop-128 frames (no padding)."""
    return x.unfold(-1, N_FRAME, HOP)[:, :n_frames]


def _remove_silent(x_frames, y_frames, frame_valid):
    """Stable-partition the frames whose CLEAN (x) windowed energy is within
    DYN_RANGE dB of the loudest frame; silent and invalid frames move to the
    end with zero weight. Returns (x_kept, y_kept, kept_mask)."""
    w = _device_mats(x_frames.device)["window"]
    xw = x_frames * w
    yw = y_frames * w
    energy = 20.0 * torch.log10(torch.linalg.vector_norm(xw, dim=-1) + 1e-12)  # (B, M)
    energy = torch.where(frame_valid, energy, -torch.inf)
    keep = (energy - energy.amax(dim=-1, keepdim=True) + DYN_RANGE) > 0
    keep = keep & frame_valid

    # kept frames first, in order: a static-shape stable partition
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    xk = torch.take_along_dim(xw, order[..., None], dim=1)
    yk = torch.take_along_dim(yw, order[..., None], dim=1)
    kept = torch.take_along_dim(keep, order, dim=1)
    xk = xk * kept[..., None]
    yk = yk * kept[..., None]
    return xk, yk, kept


def _ola_reframe(frames_w, kept):
    """Overlap-add windowed frames back to a signal, then frame it again:
    the reconstruction step of silent-frame removal."""
    M = frames_w.shape[1]
    sig = _overlap_add(frames_w, HOP)
    framed = _frame(sig, M)
    n_kept = kept.sum(dim=-1)  # (B,)
    valid = torch.arange(M, device=kept.device)[None, :] < n_kept[:, None]
    return framed, valid


def _band_envelopes(frames):
    """(B, M, 256) raw frames -> (B, M, 15) third-octave magnitudes."""
    mats = _device_mats(frames.device)
    re = torch.matmul(frames, mats["dft_re"])
    im = torch.matmul(frames, mats["dft_im"])
    power = re * re + im * im
    band_pow = torch.matmul(power, mats["bands"])
    return torch.sqrt(band_pow + 1e-20)


def _segments(env):
    """(B, M, J) -> (B, S, J, N_SEG) sliding length-30 segments,
    S = max(M - 29, 1). Fewer than 30 frames repeat the last one, as the JAX
    package's clamped gather does; such a segment is never valid."""
    M = env.shape[1]
    if M < N_SEG:
        env = torch.cat([env, env[:, -1:].expand(-1, N_SEG - M, -1)], dim=1)
    return env.unfold(1, N_SEG, 1)


def _correlation(a, b, dim=-1, eps=1e-12):
    a = a - a.mean(dim=dim, keepdim=True)
    b = b - b.mean(dim=dim, keepdim=True)
    num = (a * b).sum(dim=dim)
    den = torch.sqrt((a * a).sum(dim=dim) * (b * b).sum(dim=dim)) + eps
    return num / den


def _front_end(clean, processed, sample_rate, remove_silent, lengths):
    """The pipeline both scores share, up to the segments: returns
    (xs, ys (B, S, J, N_SEG), seg_valid (B, S), seg_count (B,))."""
    clean = clean.float()
    processed = processed.float()
    B, T0 = clean.shape
    if lengths is not None:
        t_mask = torch.arange(T0, device=clean.device)[None, :] < lengths[:, None]
        clean = clean * t_mask
        processed = processed * t_mask
        len10k = (lengths * FS) // sample_rate
    else:
        len10k = torch.full((B,), T0 * FS // sample_rate, device=clean.device)

    x = resample(clean, sample_rate, FS)
    y = resample(processed, sample_rate, FS)

    T = x.shape[-1]
    M = max((T - N_FRAME) // HOP + 1, 1)
    xf = _frame(x, M)
    yf = _frame(y, M)
    frame_valid = (
        torch.arange(M, device=x.device)[None, :] * HOP + N_FRAME
    ) <= len10k[:, None]

    if remove_silent:
        xk, yk, kept = _remove_silent(xf, yf, frame_valid)
        x_frames, valid = _ola_reframe(xk, kept)
        y_frames, _ = _ola_reframe(yk, kept)
    else:
        # raw frames: the DFT matrices already fold the hann window in
        x_frames, y_frames = xf, yf
        valid = frame_valid

    xs = _segments(_band_envelopes(x_frames))  # (B, S, J, N)
    ys = _segments(_band_envelopes(y_frames))
    S = xs.shape[1]
    # a segment is usable iff all its 30 frames are valid
    seg_valid = (
        torch.arange(S, device=x.device)[None, :] + N_SEG <= valid.sum(dim=-1)[:, None]
    ).float()  # (B, S)
    seg_count = torch.clamp(seg_valid.sum(dim=-1), min=1.0)
    return xs, ys, seg_valid, seg_count


def stoi_coeff_batch(
    clean: torch.Tensor,
    processed: torch.Tensor,
    sample_rate: int = 16000,
    extended: bool = False,
    remove_silent: bool = True,
    lengths=None,
) -> torch.Tensor:
    """Batched STOI (``extended``: ESTOI), (B, T) x (B, T) -> (B,).

    ``clean`` is the reference, ``processed`` the degraded or enhanced
    signal; ``lengths`` masks padded samples. ``remove_silent=False`` is the
    variant without silent-frame removal that the training objective uses."""
    xs, ys, seg_valid, seg_count = _front_end(
        clean, processed, sample_rate, remove_silent, lengths)
    d = _estoi_tail(xs, ys) if extended else _stoi_tail(xs, ys)
    return (d * seg_valid).sum(dim=-1) / seg_count


def _stoi_tail(xs, ys):
    norm_x = torch.linalg.vector_norm(xs, dim=-1, keepdim=True)
    norm_y = torch.linalg.vector_norm(ys, dim=-1, keepdim=True)
    alpha = norm_x / (norm_y + 1e-12)
    ys_n = ys * alpha
    clip = xs * (1.0 + 10.0 ** (-BETA / 20.0))
    ys_n = torch.minimum(ys_n, clip)
    d = _correlation(xs, ys_n, dim=-1)  # (B, S, J)
    return d.mean(dim=-1)  # (B, S)


def _estoi_tail(xs, ys):
    def row_col_norm(z):
        z = z - z.mean(dim=-1, keepdim=True)
        z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
        z = z - z.mean(dim=-2, keepdim=True)
        z = z / (torch.linalg.vector_norm(z, dim=-2, keepdim=True) + 1e-12)
        return z

    xn = row_col_norm(xs)
    yn = row_col_norm(ys)
    # d_m = (1/N) sum_j sum_n xn * yn: after the column (band-axis) unit
    # normalization each of the N time columns contributes at most 1
    return (xn * yn).sum(dim=(-1, -2)) / N_SEG  # (B, S)


def stoi_estoi_batch(
    clean: torch.Tensor,
    processed: torch.Tensor,
    sample_rate: int = 16000,
    remove_silent: bool = True,
    lengths=None,
):
    """STOI and ESTOI from one shared front end -> ((B,), (B,)), each with
    the bits of its ``stoi_coeff_batch`` call."""
    xs, ys, seg_valid, seg_count = _front_end(
        clean, processed, sample_rate, remove_silent, lengths)

    def agg(d):
        return (d * seg_valid).sum(dim=-1) / seg_count

    return agg(_stoi_tail(xs, ys)), agg(_estoi_tail(xs, ys))
