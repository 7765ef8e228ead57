"""PESQ (ITU-T P.862) perceptual model, batched on the device of its inputs
(counterpart of ``speech_enhancement_by_s3prl_tpu/metrics/pesq_jax.py``).

The reference scores PESQ through the ITU reference C code (the `pesq`
wheel), one utterance at a time on the host. This module implements the
P.862 perceptual model natively with the published structure and the
published constant tables (``metrics/p862_tables.py``):

  level alignment (350-3250 Hz band power -> 1e7) -> receive filtering
  (standard IRS receive table in nb mode) -> time-frequency decomposition
  (32 ms hann frames, 50% overlap) -> bark-band grouping (published bin
  counts, 100/nr power-density correction, Sp scale) -> partial frequency
  compensation -> time-varying gain compensation (audible-power ratio,
  0.2/0.8 first-order smoothing) -> modified Zwicker loudness (Sl scale,
  low-band exponent modification) -> center-clipped disturbance with
  masking -> asymmetry weighting -> weighted-L2(bark) / L6(320 ms) /
  L2(time) aggregation -> raw PESQ -> MOS-LQO mapping (P.862.1
  narrowband / P.862.2 wideband constants).

Remaining deviations from the ITU implementation, stated plainly:
- time alignment is one global delay per utterance (envelope coarse pass
  + sample-exact raw-signal fine correlation) plus, when
  ``realign=True``, the P.862 bad-interval refinement: intervals of
  consecutive frames whose disturbance exceeds the bad-frame threshold
  are re-aligned by raw-signal cross-correlation and re-scored, keeping
  the realigned disturbance when it is lower — the mechanism by which
  the ITU chain absorbs mid-utterance delay changes (its per-utterance
  splitting reduces to this when the piecewise delays disagree). The
  refinement caps intervals per utterance and frames per interval
  (static shapes: ``BAD_INTERVALS``, ``BAD_FRAMES``) where the ITU code is
  unbounded, and this framework's own enhancement pipeline is
  sample-aligned by construction (iSTFT with the noisy phase preserves
  timing), so the batched eval leaves it off (``realign=False``); the
  host per-utterance API (``metrics/pesq.py``) turns it on for external
  pairs;
- the IRS receive filter is applied in the power-spectral domain per
  frame (exact published magnitude response; the ITU filters the time
  signal, which additionally smears frame boundaries);
- the wideband input filter is a smooth analytic highpass.

Scores track P.862 MOS-LQO in ordering and absolute range; for
ITU-certified numbers run the ITU binary. Every product runs in full f32
(the callers in ``metrics/__init__.py`` turn TF32 off around them). Where
the JAX package slices with ``lax.dynamic_slice``, which clamps its start so
the slice stays in bounds, ``_take`` clamps the same way.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .p862_tables import TARGET_AVG_POWER, band_tables, irs_receive_gain

ZWICKER = 0.23

# -- P.862 bad-interval realignment constants (the published thresholds) --
THRESHOLD_BAD_FRAMES = 30.0   # weighted frame disturbance above = "bad"
MIN_BAD_FRAMES_IN_INTERVAL = 5
# the static bounds of the refinement: intervals re-aligned per utterance
# (earliest first) and frames re-scored per interval (from its start)
BAD_INTERVALS = 4
BAD_FRAMES = 64


def _table_bands(fs: int, n_bins: int, freqs: np.ndarray) -> dict:
    """Published-table band model: per-band FFT-bin runs with the 100/nr
    power-density correction and Sp scale baked into the grouping matrix."""
    T = band_tables(fs)
    nb = T["nb"]
    group = np.zeros((n_bins, nb), np.float64)
    start = 1  # DC excluded
    for j, n in enumerate(T["nr_of_hz_bands"]):
        group[start : start + int(n), j] = T["pow_dens_correction"][j] * T["sp"]
        start += int(n)
    assert start <= n_bins + 1
    return dict(
        nb=nb, group=group, p0=T["abs_thresh"], width=T["width_bark"],
        centre=T["centre_bark"], sl=T["sl"],
        irs_gain=irs_receive_gain(freqs),
    )


@functools.lru_cache(maxsize=4)
def _model_consts(fs: int) -> dict:
    """Frame geometry and the band model of the P.862 pipeline at ``fs``,
    as numpy arrays."""
    if fs == 8000:
        n_frame = 256
    elif fs == 16000:
        n_frame = 512
    else:
        raise ValueError(f"PESQ model supports 8k/16k, got {fs}")
    hop = n_frame // 2
    n_bins = n_frame // 2 + 1
    freqs = np.linspace(0, fs / 2, n_bins)

    bands = _table_bands(fs, n_bins, freqs)
    # the ITU chain computes the per-frame power spectrum as |FFT|^2 / N;
    # the DFT matrices are unnormalized, so 1/N goes into the grouping. This
    # anchors the absolute internal scale the model's additive constants
    # (+50 asymmetry offset, +1e3/+5e3 compensation floors, 1e5/1e7 frame
    # weights) are defined against.
    bands["group"] = bands["group"] / n_frame

    # modified Zwicker exponent per band (low-band modification)
    centre = bands["centre"]
    h = np.where(centre < 4.0, np.minimum(6.0 / (centre + 2.0), 2.0), 1.0)
    mzp = ZWICKER * h**0.15

    window = np.hanning(n_frame + 1)[:n_frame].astype(np.float32)
    n = np.arange(n_frame)[:, None].astype(np.float64)
    k = np.arange(n_bins)[None, :].astype(np.float64)
    ang = 2 * math.pi * n * k / n_frame
    dft_re = (window[:, None] * np.cos(ang)).astype(np.float32)
    dft_im = (window[:, None] * -np.sin(ang)).astype(np.float32)

    # wideband input filter: gentle highpass below 100 Hz (P.862.2 mode)
    f_safe = np.maximum(freqs, 1.0)
    wb_db = -24.0 * (np.log2(100.0 / f_safe).clip(min=0.0)) ** 2
    wb_gain = (10.0 ** (wb_db / 20.0)).astype(np.float32)

    return dict(
        n_frame=n_frame, hop=hop, n_bins=n_bins, nb=bands["nb"],
        group=bands["group"].astype(np.float32),
        p0=bands["p0"].astype(np.float32),
        width=bands["width"].astype(np.float32),
        mzp=mzp.astype(np.float32),
        sl=float(bands["sl"]),
        irs_gain=bands["irs_gain"].astype(np.float32),
        wb_gain=wb_gain,
        dft_re=dft_re, dft_im=dft_im,
    )


@functools.lru_cache(maxsize=8)
def _device_consts(fs: int, device: torch.device) -> dict:
    """``_model_consts`` with its arrays as tensors on ``device``, made once;
    the gains are squared (the receive filter acts on powers)."""
    C = dict(_model_consts(fs))
    for key in ("group", "p0", "width", "mzp", "dft_re", "dft_im"):
        C[key] = torch.from_numpy(C[key]).to(device)
    for mode, key in (("nb", "irs_gain"), ("wb", "wb_gain")):
        C[f"g2_{mode}"] = torch.from_numpy(C[key] * C[key]).to(device)
    C["aud_sel"] = torch.from_numpy(
        (np.arange(C["nb"]) >= 1).astype(np.float32)).to(device)
    return C


def _take(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """``x[..., s : s + size]`` for a start per leading index, as
    ``lax.dynamic_slice`` takes it: a negative start counts from the end,
    and the start is then clipped to [0, n - size] so the slice stays in
    bounds. x (..., n), start (...) -> (..., size)."""
    n = x.shape[-1]
    s = torch.clamp(torch.where(start < 0, start + n, start), 0, n - size)
    idx = s[..., None] + torch.arange(size, device=x.device)
    return torch.gather(x, -1, idx)


def _take_rows(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """Rows ``x[b, s : s + size]`` of x (B, M, J) for starts (B, K), clamped
    as ``_take``: -> (B, K, size, J)."""
    M = x.shape[1]
    s = torch.clamp(start, 0, M - size)
    idx = s[..., None] + torch.arange(size, device=x.device)  # (B, K, size)
    B, K = start.shape
    return torch.gather(
        x[:, None].expand(B, K, M, x.shape[-1]), 2,
        idx[..., None].expand(B, K, size, x.shape[-1]))


def _frames(x: torch.Tensor, n_frame: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_frame) frames at ``hop``; a signal
    shorter than a frame gives one frame of its samples with the last one
    repeated, as the JAX package's clamped gather does."""
    T = x.shape[-1]
    if T >= n_frame:
        return x.unfold(-1, n_frame, hop)
    idx = torch.clamp(torch.arange(n_frame, device=x.device), max=T - 1)
    return x[..., idx][..., None, :]


def _frames_power(x, C):
    fr = _frames(x, C["n_frame"], C["hop"])
    re = torch.matmul(fr, C["dft_re"])
    im = torch.matmul(fr, C["dft_im"])
    return re * re + im * im  # (B, M, bins)


def _fix_power_level(x, lengths, fs: int):
    """ITU level alignment: scale each utterance so its mean power over the
    valid samples, band-limited to 350-3250 Hz, equals 1e7
    (TARGET_AVG_POWER; the C code's fix_power_level). The transform
    zero-pads to a power of two, which changes neither the Parseval band
    energy nor the valid sample count."""
    T = x.shape[-1]
    nfft = 1 << (max(T, 2) - 1).bit_length()
    X = torch.fft.rfft(x.float(), n=nfft, dim=-1)
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    bandm = torch.from_numpy(
        ((freqs >= 350.0) & (freqs <= 3250.0)).astype(np.float32)).to(x.device)
    # Parseval (band excludes DC/Nyquist): sum_n x_bp^2 = 2 sum_band |X|^2/nfft
    energy = 2.0 * ((X.real ** 2 + X.imag ** 2) * bandm).sum(-1) / nfft
    denom = lengths.float() if lengths is not None else float(T)
    power = energy / denom
    scale = torch.sqrt(TARGET_AVG_POWER / torch.clamp(power, min=1e-12))
    return x * scale[:, None]


def _align_delay(ref: torch.Tensor, deg: torch.Tensor, max_delay: int) -> torch.Tensor:
    """Per-utterance delay estimate (samples), P.862-alignment style: a
    coarse pass cross-correlates 4 ms energy envelopes by FFT and takes the
    argmax within +/- max_delay, then a fine pass cross-correlates the raw
    signals within +/- one envelope cell. Positive delay = deg lags ref.
    ``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does."""
    dec = 64  # 4 ms at 16 kHz
    B, T = ref.shape
    n = (T // dec) * dec
    er_raw = ref[:, :n].abs().reshape(B, -1, dec).sum(-1)
    ed_raw = deg[:, :n].abs().reshape(B, -1, dec).sum(-1)
    er = er_raw - er_raw.mean(-1, keepdim=True)
    ed = ed_raw - ed_raw.mean(-1, keepdim=True)
    L = er.shape[-1]
    nfft = 1 << (2 * L - 1).bit_length()
    X = torch.fft.rfft(er, nfft)
    Y = torch.fft.rfft(ed, nfft)
    xc = torch.fft.irfft(torch.conj(X) * Y, nfft)
    # the search range stays within the envelope length (beyond L - 1 cells
    # the signals share no overlap, and nfft >= 2 * md + 1 needs it)
    md = max(min(max_delay // dec, L - 1), 1)
    # lags -md..md: negative lags live at nfft - |d|
    lags = torch.cat([torch.arange(0, md + 1), torch.arange(nfft - md, nfft)]).to(ref.device)
    best = torch.argmax(xc[:, lags], dim=-1)
    lag = torch.where(best <= md, best, best - (2 * md + 1))
    coarse = lag * dec

    # fine pass. A long signal takes a W-sample window centred on the
    # reference's highest-energy envelope cell (any window holding signal
    # energy votes the same lag for a bulk delay); a short one the
    # full-length FFT cross-correlation.
    W = 4096
    guard = max_delay + dec
    if T >= W + 2 * guard:
        center = torch.argmax(er_raw, dim=-1) * dec + dec // 2
        s_ref = torch.clamp(center - W // 2, guard, T - W - guard)
        s_deg = s_ref + coarse  # |coarse| <= max_delay keeps this in range
        ref_seg = _take(ref, s_ref, W)
        deg_wide = _take(deg, s_deg - dec, W + 2 * dec)
        # xc_seg[b, o] = sum_w ref_seg[b, w] * deg_wide[b, o + w]
        xc_seg = torch.matmul(deg_wide.unfold(-1, W, 1), ref_seg[..., None])[..., 0]
        return coarse + (torch.argmax(xc_seg, dim=-1) - dec)

    nfft2 = 1 << (2 * T - 1).bit_length()
    Xf = torch.fft.rfft(ref, nfft2)
    Yf = torch.fft.rfft(deg, nfft2)
    xcf = torch.fft.irfft(torch.conj(Xf) * Yf, nfft2)
    offsets = torch.arange(-dec, dec + 1, device=ref.device)
    idx = torch.remainder(coarse[:, None] + offsets[None, :], nfft2)
    fine_vals = torch.take_along_dim(xcf, idx, dim=-1)
    return coarse + offsets[torch.argmax(fine_vals, dim=-1)]


def _shift_back(x: torch.Tensor, delay: torch.Tensor, max_abs: int) -> torch.Tensor:
    """x[i, t] -> x[i, t + delay_i] (zero-padded): undo a per-utterance lag
    so deg lines up with ref; ``max_abs`` bounds |delay|."""
    T = x.shape[-1]
    delay = torch.clamp(delay, -max_abs, max_abs)
    padded = F.pad(x, (max_abs, max_abs))
    out = _take(padded, max_abs + delay, T)
    idx = torch.arange(T, device=x.device)[None, :] + delay[:, None]
    return out * ((idx >= 0) & (idx < T))


def _loudness(Bp, p0, mzp, sl):
    """Modified Zwicker loudness (Sl scale, per-band exponent)."""
    r = (0.5 + 0.5 * Bp / p0) ** mzp - 1.0
    return sl * (p0 / 0.5) ** mzp * torch.clamp(r, min=0.0)


def _frame_disturbance(L_ref, L_deg, B_ref_eq, B_deg_eq, w, W):
    """Per-frame symmetric and asymmetric disturbance from loudness pairs:
    masking deadzone, asymmetry weighting, pseudo-Lp bark aggregation (band
    0 excluded through the width vector ``w``). Shared by the main pass and
    the bad-interval realignment."""
    d = L_deg - L_ref
    m = 0.25 * torch.minimum(L_deg, L_ref)
    d_sym = torch.sign(d) * torch.clamp(d.abs() - m, min=0.0)

    asym = ((B_deg_eq + 50.0) / (B_ref_eq + 50.0)) ** 1.2
    asym = torch.where(asym < 3.0, 0.0, torch.clamp(asym, max=12.0))
    d_asym = d_sym * asym

    frame_sym = torch.sqrt(W * ((d_sym * w) ** 2).sum(-1))
    frame_asym = (d_asym.abs() * w).sum(-1)
    return frame_sym, frame_asym


def _bad_interval_realign(
    C, ref, deg, g2, frame_sym, frame_asym, fmask,
    B_ref_eq, L_ref, ratio_s, fw, w, W,
):
    """P.862 bad-interval refinement, batched with static shapes.

    Frames whose weighted disturbance exceeds THRESHOLD_BAD_FRAMES form
    intervals; intervals of at least MIN_BAD_FRAMES_IN_INTERVAL consecutive
    bad frames are re-aligned by raw-signal cross-correlation (search +/-
    the ITU SEARCHBUFFER of 75 decimated cells, 75 * n_frame / 16 samples at
    both rates) and re-scored through the same
    band -> gain -> loudness -> disturbance chain with the first pass's
    per-utterance frequency compensation and per-frame gain ratio (as the
    ITU code reuses its stored compensations); the realigned disturbances
    replace the originals where their interval sum is lower. At most
    BAD_INTERVALS intervals an utterance and BAD_FRAMES frames an interval."""
    K = BAD_INTERVALS
    n_frame, hop = C["n_frame"], C["hop"]
    Bsz, M = frame_sym.shape
    dev = frame_sym.device
    Lf = min(BAD_FRAMES, M)
    search = 75 * n_frame // 16
    Ws = (Lf - 1) * hop + n_frame  # window sample span

    bad = (frame_sym > THRESHOLD_BAD_FRAMES) & (fmask > 0)
    starts = bad & ~F.pad(bad[:, :-1], (1, 0))
    run_id = torch.cumsum(starts.long(), dim=1) * bad  # (B, M), 0 = not bad
    # frames a run holds: a scatter-add of ones, exact as segment_sum
    run_len = torch.zeros((Bsz, M + 1), device=dev).scatter_add_(
        1, run_id, torch.ones((Bsz, M), device=dev))
    qual = run_len >= MIN_BAD_FRAMES_IN_INTERVAL
    qual[:, 0] = False
    qrank = torch.cumsum(qual.long(), dim=1) * qual  # (B, M+1): 1..Q over qualifying
    frame_rank = torch.take_along_dim(qrank, run_id, dim=1)  # (B, M)

    ks = torch.arange(1, K + 1, device=dev)
    in_k = frame_rank[:, None, :] == ks[None, :, None]  # (B, K, M)
    tidx = torch.arange(M, device=dev)
    start_f = torch.where(in_k, tidx, M).amin(dim=-1)  # (B, K)
    valid = start_f < M
    f0 = torch.clamp(start_f, 0, max(M - Lf, 0))

    deg_pad = F.pad(deg, (search, search))
    s0 = f0 * hop
    ref_seg = _take(ref[:, None].expand(Bsz, K, -1), s0, Ws)  # (B, K, Ws)
    deg_wide = _take(deg_pad[:, None].expand(Bsz, K, -1), s0, Ws + 2 * search)
    # raw-signal cross-correlation over +/- search around the global
    # alignment (ITU compute_delay on the interval span), by FFT:
    # xc[d] = sum_w ref[w] * deg_wide[w + d], d in 0..2*search
    nfft = 1 << (Ws + 2 * search - 1).bit_length()
    xc = torch.fft.irfft(
        torch.conj(torch.fft.rfft(ref_seg, nfft)) * torch.fft.rfft(deg_wide, nfft), nfft,
    )[..., : 2 * search + 1]
    d_star = torch.argmax(xc, dim=-1)  # 0..2*search; shift = d_star - search
    deg_seg = _take(deg_wide, d_star, Ws)

    fr = _frames(deg_seg, n_frame, hop)  # (B, K, Lf, n_frame)
    re = torch.matmul(fr, C["dft_re"])
    im = torch.matmul(fr, C["dft_im"])
    P = (re * re + im * im) * g2
    Bd = torch.matmul(P, C["group"])
    ratio_sl = _take(ratio_s[:, None].expand(Bsz, K, M), f0, Lf)
    Bd_eq = Bd * ratio_sl[..., None]
    L_deg_bad = _loudness(Bd_eq, C["p0"], C["mzp"], C["sl"])
    L_ref_sl = _take_rows(L_ref, f0, Lf)
    B_ref_sl = _take_rows(B_ref_eq, f0, Lf)
    fs_new, fa_new = _frame_disturbance(L_ref_sl, L_deg_bad, B_ref_sl, Bd_eq, w, W)
    fw_sl = _take(fw[:, None].expand(Bsz, K, M), f0, Lf)
    fs_new = torch.clamp(fs_new / fw_sl, max=45.0)
    fa_new = torch.clamp(fa_new / fw_sl, max=45.0)
    # place each window back on the global frame axis (a dynamic update
    # slice: the start clamped so the window fits)
    pos = torch.clamp(f0, 0, M - Lf)[..., None] + torch.arange(Lf, device=dev)
    zeros = torch.zeros((Bsz, K, M), device=dev)
    fs_k = zeros.scatter(-1, pos, fs_new)
    fa_k = zeros.scatter(-1, pos, fa_new)
    win_k = zeros.scatter(-1, pos, torch.ones_like(fs_new))

    # per-interval acceptance: replace the interval's frames only when the
    # re-aligned interval disturbance sum is lower (the ITU acceptance
    # rule), on the frames of the interval inside the recompute window
    upd = in_k & (win_k > 0)  # (B, K, M)
    old_sum = torch.where(upd, frame_sym[:, None, :], 0.0).sum(-1)
    new_sum = torch.where(upd, fs_k, 0.0).sum(-1)
    accept = valid & (new_sum < old_sum)  # (B, K)
    take = upd & accept[..., None]  # disjoint across K (runs are disjoint)
    any_take = take.any(dim=1)
    fs_repl = torch.where(take, fs_k, 0.0).sum(1)
    fa_repl = torch.where(take, fa_k, 0.0).sum(1)
    frame_sym = torch.where(any_take, fs_repl, frame_sym)
    frame_asym = torch.where(any_take, fa_repl, frame_asym)
    return frame_sym, frame_asym


def pesq_batch(
    ref: torch.Tensor,
    deg: torch.Tensor,
    sample_rate: int = 16000,
    mode: str = "nb",
    lengths=None,
    align: bool = True,
    realign: bool = False,
) -> torch.Tensor:
    """Batched MOS-LQO, (B, T) x (B, T) -> (B,).

    ``align`` estimates one global delay per utterance (envelope
    cross-correlation coarse pass + sample-exact raw-signal fine pass;
    +/- 500 ms range) and shifts the degraded signal before scoring.
    ``realign`` also runs the P.862 bad-interval refinement
    (``_bad_interval_realign``)."""
    return pesq_batch_modes(ref, deg, sample_rate, (mode,), lengths, align, realign)[mode]


def pesq_batch_modes(
    ref: torch.Tensor,
    deg: torch.Tensor,
    sample_rate: int = 16000,
    modes=("nb", "wb"),
    lengths=None,
    align: bool = True,
    realign: bool = False,
) -> dict:
    """MOS-LQO for several P.862 modes from one shared front end: the delay
    search, the per-utterance shift, the level alignment and the framed
    power spectra do not depend on the mode; only the receive filter gain
    and the MOS mapping do. Each mode's scores have the bits of its
    ``pesq_batch`` call."""
    assert all(m in ("nb", "wb") for m in modes)
    fs = sample_rate
    C = _device_consts(fs, ref.device)

    ref = ref.float()
    deg = deg.float()
    # mask BEFORE the alignment search: padding past `lengths` must not feed
    # the envelope cross-correlation
    if lengths is not None:
        t_mask = torch.arange(ref.shape[-1], device=ref.device)[None, :] < lengths[:, None]
        ref = ref * t_mask
        deg = deg * t_mask
        frame_len_limit = (lengths - C["n_frame"]) // C["hop"] + 1
    else:
        frame_len_limit = None
    if align:
        delay = _align_delay(ref, deg, max_delay=fs // 2)
        # |delay| <= coarse (clamped to max_delay) + one fine cell (64)
        deg = _shift_back(deg, delay, max_abs=fs // 2 + 64)
        if lengths is not None:
            deg = deg * t_mask

    # level alignment on the raw (pre-filter) signals, as the ITU chain
    ref = _fix_power_level(ref, lengths, fs)
    deg = _fix_power_level(deg, lengths, fs)

    P_ref_raw = _frames_power(ref, C)
    P_deg_raw = _frames_power(deg, C)
    M = P_ref_raw.shape[1]
    if frame_len_limit is not None:
        fmask = (torch.arange(M, device=ref.device)[None, :]
                 < frame_len_limit[:, None]).float()
    else:
        fmask = torch.ones(P_ref_raw.shape[:2], device=ref.device)

    return {
        m: _pesq_mode_tail(C, m, ref, deg, P_ref_raw, P_deg_raw, fmask, realign)
        for m in modes
    }


def _smooth_ratio(ratio: torch.Tensor) -> torch.Tensor:
    """s_t = 0.2 s_{t-1} + 0.8 r_t with s_0 = r_0, over the frame axis, as a
    log-depth scan: the step (a, b): s -> a s + b composes as
    (a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2)."""
    a = torch.full_like(ratio, 0.2)
    a[:, 0] = 0.0
    b = 0.8 * ratio
    b[:, 0] = ratio[:, 0]
    k = 1
    while k < ratio.shape[1]:
        a_prev = F.pad(a[:, :-k], (k, 0), value=1.0)
        b_prev = F.pad(b[:, :-k], (k, 0), value=0.0)
        a, b = a_prev * a, a * b_prev + b
        k *= 2
    return b


def _pesq_mode_tail(C, mode, ref, deg, P_ref_raw, P_deg_raw, fmask, realign):
    """Everything after the shared front end: receive-filter gain, bark
    grouping, compensations, loudness, disturbance, Lp aggregation and the
    mode's MOS mapping."""
    # receive filtering in the power domain
    g2 = C[f"g2_{mode}"]
    P_ref = P_ref_raw * g2
    P_deg = P_deg_raw * g2

    # bark grouping -> pitch power densities (100/nr correction and Sp are
    # in the grouping matrix)
    G = C["group"]
    B_ref = torch.matmul(P_ref, G)
    B_deg = torch.matmul(P_deg, G)
    p0 = C["p0"]

    # partial frequency compensation (applied to the reference, as in PESQ)
    num = (B_deg * fmask[..., None]).sum(1) + 1e3
    den = (B_ref * fmask[..., None]).sum(1) + 1e3
    band_factor = torch.clamp(num / den, 0.01, 100.0)[:, None, :]
    B_ref_eq = B_ref * band_factor

    # time-varying gain compensation (applied to the degraded signal):
    # audible power = threshold-gated band power, band 0 excluded
    aud_sel = C["aud_sel"]

    def audible(Bp):
        return ((Bp > p0) * Bp * aud_sel).sum(-1)

    aud_ref = audible(B_ref_eq)
    aud_deg = audible(B_deg)
    ratio = (aud_ref + 5e3) / (aud_deg + 5e3)
    ratio_s = torch.clamp(_smooth_ratio(ratio), 3e-4, 5.0)
    B_deg_eq = B_deg * ratio_s[..., None]

    # modified Zwicker loudness (Sl scale, per-band exponent)
    L_ref = _loudness(B_ref_eq, p0, C["mzp"], C["sl"])
    L_deg = _loudness(B_deg_eq, p0, C["mzp"], C["sl"])

    # disturbance + pseudo-Lp bark aggregation (band 0 excluded via w)
    w = C["width"] * aud_sel
    W = w.sum()
    frame_sym, frame_asym = _frame_disturbance(L_ref, L_deg, B_ref_eq, B_deg_eq, w, W)

    # frame weighting by the reference's audible power
    fw = ((aud_ref + 1e5) / 1e7) ** 0.04
    frame_sym = torch.clamp(frame_sym / fw, max=45.0) * fmask
    frame_asym = torch.clamp(frame_asym / fw, max=45.0) * fmask

    if realign:
        frame_sym, frame_asym = _bad_interval_realign(
            C, ref, deg, g2, frame_sym, frame_asym, fmask,
            B_ref_eq, L_ref, ratio_s, fw, w, W,
        )
        frame_sym = frame_sym * fmask
        frame_asym = frame_asym * fmask

    # L6 over 320 ms sliding windows (20 frames at 50% overlap), L2 over time
    def agg(fd):
        win = 20
        Mv = fd.shape[1]
        S = max(Mv - win + 1, 1)
        idx = torch.arange(0, S, max(win // 2, 1), device=fd.device)
        # a window past the last frame repeats it (the JAX clamped gather)
        pos = torch.clamp(idx[:, None] + torch.arange(win, device=fd.device), max=Mv - 1)
        seg = fd[:, pos]
        seg_mask = fmask[:, pos]
        cnt = torch.clamp(seg_mask.sum(-1), min=1.0)
        l6 = ((seg ** 6).sum(-1) / cnt) ** (1 / 6)
        # prefer fully-valid 320 ms windows (masking == truncation); fall back
        # to partially-valid ones only for very short utterances
        fully = (seg_mask.amin(-1) > 0).float()
        partial = (seg_mask.sum(-1) > 0).float()
        has_fully = fully.sum(-1, keepdim=True) > 0
        seg_valid = torch.where(has_fully, fully, partial)
        n_seg = torch.clamp(seg_valid.sum(-1), min=1.0)
        return torch.sqrt(((l6 ** 2) * seg_valid).sum(-1) / n_seg)

    D = agg(frame_sym)
    DA = agg(frame_asym)

    raw = 4.5 - 0.1 * D - 0.0309 * DA
    if mode == "nb":
        return 0.999 + 4.0 / (1.0 + torch.exp(-1.4945 * raw + 4.6607))
    return 0.999 + 4.0 / (1.0 + torch.exp(-1.3669 * raw + 3.8224))
