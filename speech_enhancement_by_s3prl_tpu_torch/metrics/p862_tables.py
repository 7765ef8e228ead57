"""ITU-T P.862 (PESQ) constant tables (a copy of
``speech_enhancement_by_s3prl_tpu/metrics/p862_tables.py``, held to it array
for array by tests/test_torch_port_metrics.py).

The reference scores PESQ through the ITU reference C implementation
(the `pesq` wheel), whose perceptual model is defined by lookup tables
published in the P.862 recommendation's C listings (pesqpar.h). This module
carries those tables so the port's on-device model (metrics/pesq_model.py)
is table-driven rather than analytic.

Provenance, stated plainly (the values are transcribed from the
published listings and then machine-verified for the internal consistency properties the real tables have —
see ``validate_tables``):

- ``CENTRE_OF_BAND_BARK`` / ``WIDTH_OF_BAND_BARK`` (49 bands, 16 kHz
  operating rate; the 8 kHz model uses the first 42): transcribed.
  Verified: adjacent bands tile the bark axis exactly
  (centre[i+1]-centre[i] == (width[i]+width[i+1])/2 to 2e-6) and the
  first band starts at 0 bark — properties a mis-transcription would
  break.
- ``ABS_THRESH_POWER`` (49): transcribed. Verified: every entry is
  exactly 10^(d/10) for a one-decimal dB value d (the published table
  is the absolute hearing threshold rounded to 0.1 dB) — again not a
  property surviving transcription errors.
- ``NR_OF_HZ_BANDS_8K`` (42): transcribed. Verified: sums to exactly
  128 = the number of usable 31.25 Hz FFT bins (bins 1..128) of the
  256-point 8 kHz frame.
- ``NR_OF_HZ_BANDS_16K`` (49): transcribed. Bands 0..40 equal the 8 kHz
  table (shared bark edges; the 512-point/16 kHz frame has the same
  31.25 Hz bin width). Verified: sums to exactly 256 usable bins, and
  the two Nyquist-truncation identities hold — the published tables
  diverge at band 41 (16 kHz: 12 bins; 8 kHz: 11 = 128 - 117, its 4 kHz
  Nyquist clip of the same band) and the final 16 kHz band's 20 bins sit
  below the monotone bark-width trend (≈26 untruncated) because the
  8 kHz Nyquist clips it. Both identities are structural properties of
  the real tables that a mis-transcription would break.
- ``POW_DENS_CORRECTION``: 100/nr per band. The published floats equal
  this to ~1e-6 relative (they carry float32 generation noise).
- ``SP_16K``/``SL_16K`` power/loudness scale constants: transcribed
  literals.
- ``IRS_RECEIVE_DB``: the standard IRS receive characteristic breakpoint
  table applied in nb mode (piecewise-linear dB over frequency).
"""
from __future__ import annotations

import numpy as np

# -- bark discretization (49 bands; 8 kHz model = first 42) --------------
CENTRE_OF_BAND_BARK = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450, 1.624217, 1.962597,
    2.305636, 2.653383, 3.005889, 3.363201, 3.725371, 4.092449, 4.464486,
    4.841533, 5.223642, 5.610866, 6.003256, 6.400869, 6.803755, 7.211971,
    7.625571, 8.044611, 8.469146, 8.899232, 9.334927, 9.776288, 10.223374,
    10.676242, 11.134952, 11.599563, 12.070135, 12.546731, 13.029408,
    13.518232, 14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478, 19.319147,
    19.886751, 20.461355, 21.043034,
], dtype=np.float64)

WIDTH_OF_BAND_BARK = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474, 0.336061, 0.340697,
    0.345381, 0.350114, 0.354897, 0.359729, 0.364611, 0.369544, 0.374529,
    0.379565, 0.384653, 0.389794, 0.394989, 0.400236, 0.405538, 0.410894,
    0.416306, 0.421773, 0.427297, 0.432877, 0.438514, 0.444209, 0.449962,
    0.455774, 0.461645, 0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745, 0.530308, 0.536934,
    0.543629, 0.550390, 0.557220, 0.564119, 0.571085, 0.578125, 0.585232,
], dtype=np.float64)

# -- absolute hearing threshold per band (internal power scale) ----------
ABS_THRESH_POWER = np.array([
    51286152.0, 2454709.5, 70794.59375, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372, 4.897789,
    3.090296, 1.905461, 1.258925, 0.977237, 0.724436, 0.562341, 0.457088,
    0.389045, 0.331131, 0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.251189, 0.251189, 0.251189, 0.251189, 0.251189,
    0.251189, 0.251189, 0.251189, 0.251189, 0.263027, 0.288403, 0.309030,
    0.338844, 0.371535, 0.398107, 0.436516, 0.467735, 0.489779, 0.501187,
    0.501187, 0.512861, 0.524807,
], dtype=np.float64)

# -- FFT-bin grouping: bins per bark band (bin width 31.25 Hz, DC skipped)
NR_OF_HZ_BANDS_8K = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2,
    2, 2, 3, 3, 3, 3, 4, 3, 4, 5, 4, 5, 6, 6, 7, 8, 9, 9, 11,
], dtype=np.int64)

# 16 kHz grouping, bands 41..48 (4-8 kHz): transcribed. Band 41 is 12
# where the 8 kHz table has 11 — the published tables genuinely diverge
# there, and the divergence is itself a consistency proof: bins 1..117
# cover bands 0..40, so band 41's 12 bins would reach bin 129 ≈ 4031 Hz,
# past the 8 kHz model's 4 kHz Nyquist — its table truncates to
# 128-117 = 11, exactly the published 8 kHz entry. The final band's 20
# bins likewise sit BELOW the bark-width trend (band 47 spans 25 bins;
# width_bark grows monotonically, so band 48 untruncated would need ~26)
# because it is clipped at the 8 kHz Nyquist.
NR_TAIL_16K = np.array([12, 12, 15, 16, 18, 21, 25, 20], dtype=np.int64)

NR_OF_HZ_BANDS_16K = np.concatenate([NR_OF_HZ_BANDS_8K[:41], NR_TAIL_16K])

# -- model scale constants ----------------------------------------------
SP_16K = 6.910853e-6     # power scale (pitch power density normalization)
SP_8K = 2.764344e-5
SL_16K = 1.866055e-1     # loudness scale
SL_8K = 1.866055e-1
ZWICKER_POWER = 0.23
TARGET_AVG_POWER = 1.0e7  # level-alignment target (350-3250 Hz band power)

# -- standard IRS receive characteristic (nb mode), piecewise dB ---------
IRS_RECEIVE_DB = np.array([
    [0.0, -200.0], [50.0, -40.0], [100.0, -20.0], [125.0, -12.0],
    [160.0, -6.0], [200.0, 0.0], [250.0, 4.0], [300.0, 6.0], [350.0, 8.0],
    [400.0, 10.0], [500.0, 11.0], [600.0, 12.0], [700.0, 12.0],
    [800.0, 12.0], [1000.0, 12.0], [1300.0, 12.0], [1600.0, 12.0],
    [2000.0, 12.0], [2500.0, 12.0], [3000.0, 12.0], [3250.0, 12.0],
    [3500.0, 4.0], [4000.0, -200.0], [5000.0, -200.0], [6300.0, -200.0],
    [8000.0, -200.0],
], dtype=np.float64)


def irs_receive_gain(freqs_hz: np.ndarray) -> np.ndarray:
    """Linear amplitude gain of the IRS receive filter at `freqs_hz`
    (piecewise-linear interpolation of the dB breakpoints over linear
    frequency, as the reference C filter does)."""
    db = np.interp(np.asarray(freqs_hz, np.float64),
                   IRS_RECEIVE_DB[:, 0], IRS_RECEIVE_DB[:, 1])
    return 10.0 ** (db / 20.0)


def band_tables(fs: int) -> dict:
    """Per-rate model tables: 8 kHz uses 42 bands over bins 1..128 of a
    256-point frame; 16 kHz uses 49 bands over bins 1..256 of a 512-point
    frame."""
    if fs == 8000:
        nb, nr, sp, sl = 42, NR_OF_HZ_BANDS_8K, SP_8K, SL_8K
    elif fs == 16000:
        nb, nr, sp, sl = 49, NR_OF_HZ_BANDS_16K, SP_16K, SL_16K
    else:
        raise ValueError(f"P.862 model supports 8k/16k, got {fs}")
    return dict(
        nb=nb,
        centre_bark=CENTRE_OF_BAND_BARK[:nb].copy(),
        width_bark=WIDTH_OF_BAND_BARK[:nb].copy(),
        abs_thresh=ABS_THRESH_POWER[:nb].copy(),
        nr_of_hz_bands=nr.copy(),
        pow_dens_correction=100.0 / nr.astype(np.float64),
        sp=sp,
        sl=sl,
    )


def validate_tables() -> None:
    """Internal-consistency checks that the published tables satisfy; a
    transcription error would trip them (exercised by the test suite)."""
    c, w = CENTRE_OF_BAND_BARK, WIDTH_OF_BAND_BARK
    assert c.shape == (49,) and w.shape == (49,)
    # bands tile the bark axis and start at 0
    gaps = c[1:] - c[:-1] - 0.5 * (w[1:] + w[:-1])
    assert np.abs(gaps).max() < 5e-6, gaps
    assert abs(c[0] - w[0] / 2.0) < 5e-7
    assert np.all(np.diff(w) > 0) and np.all(np.diff(c) > 0)
    # thresholds are 10^(d/10) at one-decimal dB resolution
    db = 10.0 * np.log10(ABS_THRESH_POWER)
    assert np.abs(db - np.round(db, 1)).max() < 2e-5, db
    # grouping covers exactly the usable FFT bins
    assert NR_OF_HZ_BANDS_8K.sum() == 128
    assert NR_OF_HZ_BANDS_16K.sum() == 256
    assert np.all(NR_OF_HZ_BANDS_8K >= 1) and np.all(NR_TAIL_16K >= 1)
    # shared bark edges below 4 kHz; band 41 is the 8 kHz model's
    # Nyquist-truncated band: 11 = 128 - (bins covering bands 0..40)
    assert np.array_equal(NR_OF_HZ_BANDS_16K[:41], NR_OF_HZ_BANDS_8K[:41])
    assert NR_OF_HZ_BANDS_8K[41] == 128 - NR_OF_HZ_BANDS_8K[:41].sum()
    assert NR_OF_HZ_BANDS_16K[41] > NR_OF_HZ_BANDS_8K[41]
    # bins-per-band grow with the bark widths except the final band,
    # which the 8 kHz Nyquist clips below trend
    assert np.all(np.diff(NR_TAIL_16K[:-1]) >= 0)
    assert NR_TAIL_16K[-1] < NR_TAIL_16K[-2]
    # IRS plateau and band edges are sane
    g = irs_receive_gain(np.array([100.0, 1000.0, 3000.0, 4000.0]))
    assert g[1] == g[2] == 10.0 ** (12.0 / 20.0)
    assert g[0] < 0.2 and g[3] < 1e-9
