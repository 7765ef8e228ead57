"""The port's scoreboard metrics (STOI, ESTOI, the P.862 model) against the
JAX package on the CPU.

- The P.862 tables and the conformance battery are copies: held to the JAX
  files array for array.
- The battery's pinned scores (``docs/CONFORMANCE.json``) within the
  tolerances of tests/test_metrics_battery.py, with no JAX compile.
- A small ragged batch through both packages: STOI and ESTOI within 1e-4,
  PESQ within 2e-3 MOS, SI-SDR within 1e-4 dB, the estimated delays equal
  exactly. Two batches, because the fine delay pass branches on the padded
  length: a 4096-sample window for T >= 4096 + 2 * (8000 + 64) = 20224
  samples, the full-length FFT below. The window batch holds a row shorter
  than 20224 samples, a row delayed by a few hundred samples with a delay
  jump in its last quarter (which the bad-interval realignment takes up),
  and a row whose fine window is clipped against the end of the signal. It
  runs once more with ``realign=True``.

The JAX side runs as its own tests run it on the CPU (Precision.HIGHEST);
its results are shared through module-scoped fixtures, since each new shape
costs seconds of XLA compiles.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.metrics import p862_tables as j_tables
from speech_enhancement_by_s3prl_tpu.metrics import pesq_jax as j_pesq
from speech_enhancement_by_s3prl_tpu.metrics import si_sdr_batch as j_si_sdr_batch
from speech_enhancement_by_s3prl_tpu.metrics import stoi as j_stoi
from speech_enhancement_by_s3prl_tpu_torch import metrics
from speech_enhancement_by_s3prl_tpu_torch.metrics import battery as t_battery
from speech_enhancement_by_s3prl_tpu_torch.metrics import p862_tables as t_tables
from speech_enhancement_by_s3prl_tpu_torch.metrics import pesq as t_pesq_host
from speech_enhancement_by_s3prl_tpu_torch.metrics import pesq_model as t_pesq
from speech_enhancement_by_s3prl_tpu_torch.metrics import stoi as t_stoi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
# both packages run the same f32 pipeline with sums in other orders
STOI_TOL = 1e-4
PESQ_TOL = 2e-3
SISDR_TOL = 1e-4
WINDOW_MIN = 4096 + 2 * (SR // 2 + 64)  # the fine pass's window branch from here


# -- signals ---------------------------------------------------------------------

def _speech(n, seed, burst=None):
    """Speech-like: a pitch-wandering harmonic stack plus shaped noise under a
    syllabic envelope (aperiodic, so cross-correlation peaks are sharp);
    ``burst`` (start, end) keeps it loud there and quiet elsewhere."""
    rng = np.random.default_rng(seed)
    f0 = 110 + 15 * seed + 20 * np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(a * np.sin(k * phase) for k, a in enumerate([0.5, 0.3, 0.2, 0.1], 1))
    x = x + 0.3 * np.convolve(rng.standard_normal(n), np.hanning(9), "same")
    if burst is None:
        env = (rng.random(n // 1600 + 1) > 0.4).astype(np.float64).repeat(1600)[:n]
        x = x * np.convolve(env, np.hanning(801) / 400, "same")
    else:
        idx = np.arange(n)
        x = x * np.where((idx >= burst[0]) & (idx < burst[1]), 1.0, 0.02)
    return (0.1 * x / np.abs(x).max()).astype(np.float32)


def _burst_probe(n, seed):
    """Dense noise bursts over the first 3/4 anchor the global alignment; two
    sparse louder bursts against silence in the last quarter score as bad
    frames once they slip (the trigger of P.862's bad-interval
    realignment). Returns (signal, start of the last quarter)."""
    rng = np.random.default_rng(seed)
    x = np.zeros(n, np.float32)
    anchor_end = n * 3 // 4
    pos = 0
    while pos < anchor_end - 2000:
        on = int(rng.uniform(0.08, 0.15) * SR)
        x[pos:pos + on] = rng.standard_normal(on) * 0.3
        pos += on + int(rng.uniform(0.03, 0.1) * SR)
    for pos in (anchor_end + 2500, anchor_end + 7000):
        x[pos:pos + 2400] = rng.standard_normal(2400) * 0.35
    return x, anchor_end


def _delayed(x, d, seed, noise=0.02):
    """x delayed by d samples (d < 0: advanced), zero-filled, plus noise."""
    rng = np.random.default_rng(seed + 100)
    y = np.zeros_like(x)
    if d >= 0:
        y[d:] = x[: len(x) - d]
    else:
        y[:d] = x[-d:]
    return (y + noise * np.abs(x).max() * rng.standard_normal(len(x))).astype(np.float32)


def _window_batch():
    """T = 44000 >= WINDOW_MIN. Row 0 has 19000 samples (< WINDOW_MIN) and
    leads by 150; row 1 lags by 300; row 2 is loud only near its end, so its
    fine window is clipped to the last legal start, and lags by 7960
    samples, which puts its degraded window within a cell of the end of the
    signal; row 3 slips by 2000 samples in its last quarter, where the
    bad-interval realignment takes it up (its loud sparse bursts also draw
    the fine window, so its global delay is whatever both packages find)."""
    T = 44000
    ref = np.zeros((4, T), np.float32)
    deg = np.zeros_like(ref)
    ref[0, :19000] = _speech(19000, 0)
    deg[0, :19000] = _delayed(ref[0, :19000], -150, 0)
    ref[1, :30000] = _speech(30000, 1)
    deg[1, :30000] = _delayed(ref[1, :30000], 300, 1)
    ref[2] = _speech(T, 2, burst=(33900, 35900))
    deg[2] = _delayed(ref[2], 7960, 2)
    x, anchor_end = _burst_probe(T, 21)
    y = (x + 0.001 * np.random.default_rng(26).standard_normal(T)).astype(np.float32)
    y[anchor_end + 2000:] = y[anchor_end:-2000].copy()
    ref[3], deg[3] = x, y
    return ref, deg, np.array([19000, 30000, T, T])


def _fft_batch():
    """T = 19000 < WINDOW_MIN: the full-length FFT branch of the fine pass."""
    T = 19000
    ref = np.zeros((2, T), np.float32)
    deg = np.zeros_like(ref)
    for i, (L, d) in enumerate(((19000, 250), (15000, -90))):
        ref[i, :L] = _speech(L, 3 + i)
        deg[i, :L] = _delayed(ref[i, :L], d, 3 + i)
    return ref, deg, np.array([19000, 15000])


BATCHES = {"window": _window_batch, "fft": _fft_batch}
# the bulk delays put in (None: the realignment probe's)
WANT_DELAYS = {"window": [-150, 300, 7960, None], "fft": [250, -90]}


def _masked(ref, deg, lengths):
    m = np.arange(ref.shape[-1])[None, :] < lengths[:, None]
    return ref * m, deg * m


@pytest.fixture(scope="module")
def batches():
    return {k: make() for k, make in BATCHES.items()}


@pytest.fixture(scope="module")
def jax_side(batches):
    """Every JAX result the parity cases read, computed once."""
    out = {}
    for key, (ref, deg, lengths) in batches.items():
        jr, jd, jl = jnp.asarray(ref), jnp.asarray(deg), jnp.asarray(lengths)
        mr, md = _masked(ref, deg, lengths)
        res = {
            "delay": np.asarray(j_pesq._align_delay(jnp.asarray(mr), jnp.asarray(md),
                                                    max_delay=SR // 2)),
            "pesq": {m: np.asarray(v) for m, v in j_pesq.pesq_batch_modes(
                jr, jd, SR, ("nb", "wb"), lengths=jl, realign=False).items()},
        }
        if key == "window":
            res["pesq_realign"] = {m: np.asarray(v) for m, v in j_pesq.pesq_batch_modes(
                jr, jd, SR, ("nb", "wb"), lengths=jl, realign=True).items()}
            s, e = j_stoi.stoi_estoi_batch(jr, jd, SR, lengths=jl)
            res["stoi"], res["estoi"] = np.asarray(s), np.asarray(e)
            res["sisdr"] = np.asarray(j_si_sdr_batch(jd, jr, jl))
        out[key] = res
    return out


@pytest.fixture(scope="module")
def port_side(batches):
    out = {}
    for key, (ref, deg, lengths) in batches.items():
        tr, td, tl = (torch.from_numpy(a) for a in (ref, deg, lengths))
        mr, md = (torch.from_numpy(a) for a in _masked(ref, deg, lengths))
        res = {
            "delay": t_pesq._align_delay(mr, md, max_delay=SR // 2).numpy(),
            "pesq": {m: v.numpy() for m, v in t_pesq.pesq_batch_modes(
                tr, td, SR, ("nb", "wb"), lengths=tl, realign=False).items()},
        }
        if key == "window":
            res["pesq_realign"] = {m: v.numpy() for m, v in t_pesq.pesq_batch_modes(
                tr, td, SR, ("nb", "wb"), lengths=tl, realign=True).items()}
            res.update({k: v.numpy() for k, v in metrics.batch_scores(
                ["stoi", "estoi", "sisdr"], td, tr, tl, SR).items()})
        out[key] = res
    return out


# -- the copies --------------------------------------------------------------------

TABLE_NAMES = ["CENTRE_OF_BAND_BARK", "WIDTH_OF_BAND_BARK", "ABS_THRESH_POWER",
               "NR_OF_HZ_BANDS_8K", "NR_TAIL_16K", "NR_OF_HZ_BANDS_16K", "SP_16K", "SP_8K",
               "SL_16K", "SL_8K", "ZWICKER_POWER", "TARGET_AVG_POWER", "IRS_RECEIVE_DB"]


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_p862_tables_equal_the_jax_file(name):
    got, want = getattr(t_tables, name), getattr(j_tables, name)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_p862_tables_hold_no_name_the_jax_file_lacks():
    public = lambda mod: {n for n in vars(mod) if n.isupper()}  # noqa: E731
    assert public(t_tables) == public(j_tables) == set(TABLE_NAMES)
    t_tables.validate_tables()


@pytest.mark.parametrize("fs", [8000, 16000])
def test_band_tables_and_model_constants_equal_jax(fs):
    got, want = t_tables.band_tables(fs), j_tables.band_tables(fs)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    freqs = np.linspace(0, fs / 2, 129)
    np.testing.assert_array_equal(t_tables.irs_receive_gain(freqs),
                                  j_tables.irs_receive_gain(freqs))
    got, want = t_pesq._model_consts(fs), j_pesq._model_consts(fs)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_battery_generator_equals_the_conformance_script():
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from metrics_conformance import battery
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    want, got = battery(), t_battery.battery()
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (_, c1, d1), (_, c2, d2) in zip(got, want):
        assert c1.dtype == c2.dtype and d1.dtype == d2.dtype
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(d1, d2)


# -- the battery's pins --------------------------------------------------------------

PINS = t_battery.pins(os.path.join(REPO, "docs", "CONFORMANCE.json"))


@pytest.mark.parametrize("idx,name", [(i, n) for i, (n, _, _) in
                                      enumerate(t_battery.battery())])
def test_battery_scores_hold_the_pins(idx, name):
    _, clean, deg = t_battery.battery()[idx]
    c, d = torch.from_numpy(clean)[None], torch.from_numpy(deg)[None]
    lengths = torch.tensor([len(clean)])
    got = metrics.batch_scores(["pesq_nb", "pesq_wb", "stoi", "estoi"], d, c, lengths, SR)
    pin = PINS[name]
    for m, tol in (("pesq_nb", t_battery.PESQ_TOL), ("pesq_wb", t_battery.PESQ_TOL),
                   ("stoi", t_battery.STOI_TOL), ("estoi", t_battery.STOI_TOL)):
        assert abs(float(got[m][0]) - pin[m]) < tol, (name, m, float(got[m][0]), pin[m])
    # the per-utterance API scores the same
    assert abs(metrics.stoi_eval(deg, clean) - float(got["stoi"][0])) < 1e-6


@pytest.mark.parametrize("length", [16000, 24001, 160000])
def test_resample_matches_jax(length):
    x = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    want = np.asarray(j_stoi.resample(jnp.asarray(x), SR, t_stoi.FS))
    got = t_stoi.resample(torch.from_numpy(x), SR, t_stoi.FS).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# -- parity with JAX on ragged batches -------------------------------------------------

@pytest.mark.parametrize("key", list(BATCHES))
def test_delays_equal_jax_exactly(key, batches, jax_side, port_side):
    ref = batches[key][0]
    assert (ref.shape[-1] >= WINDOW_MIN) == (key == "window")
    np.testing.assert_array_equal(port_side[key]["delay"], jax_side[key]["delay"])
    for got, want in zip(port_side[key]["delay"], WANT_DELAYS[key]):
        assert want is None or got == want, (port_side[key]["delay"], WANT_DELAYS[key])


def test_window_row_is_clipped_against_the_end(batches):
    """Row 2's fine window starts at its last legal place, and its degraded
    window ends within one 64-sample cell of the signal's end: the case in
    which a slice that did not clamp as ``lax.dynamic_slice`` does would
    read past the end."""
    ref, deg, lengths = batches["window"]
    T, W, dec, guard = ref.shape[-1], 4096, 64, SR // 2 + 64
    n = (T // dec) * dec
    env = np.abs(ref[2, :n]).reshape(-1, dec).sum(-1)
    center = int(np.argmax(env)) * dec + dec // 2
    assert center - W // 2 > T - W - guard
    s_ref = T - W - guard
    end = s_ref + WANT_DELAYS["window"][2] - dec + W + 2 * dec
    assert T - dec <= end <= T


@pytest.mark.parametrize("metric,tol", [("stoi", STOI_TOL), ("estoi", STOI_TOL),
                                        ("sisdr", SISDR_TOL)])
def test_stoi_estoi_sisdr_match_jax(metric, tol, jax_side, port_side):
    got, want = port_side["window"][metric], jax_side["window"][metric]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("key,mode", [(k, m) for k in BATCHES for m in ("nb", "wb")])
def test_pesq_matches_jax(key, mode, jax_side, port_side):
    got, want = port_side[key]["pesq"][mode], jax_side[key]["pesq"][mode]
    assert np.isfinite(got).all() and ((1.0 <= got) & (got <= 5.0)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=PESQ_TOL)


@pytest.mark.parametrize("mode", ["nb", "wb"])
def test_pesq_with_realign_matches_jax(mode, jax_side, port_side):
    got = port_side["window"]["pesq_realign"][mode]
    want = jax_side["window"]["pesq_realign"][mode]
    np.testing.assert_allclose(got, want, rtol=0, atol=PESQ_TOL)
    # the slipped row's bad frames (nb: the wideband gain leaves its frames
    # under the threshold) are re-aligned on both sides
    for side in (port_side, jax_side):
        gain = side["window"]["pesq_realign"][mode] - side["window"]["pesq"][mode]
        assert (gain[3] > 0.05) == (mode == "nb"), (mode, gain)


@pytest.mark.parametrize("start", [-7, 0, 50, 90, 200])
def test_take_clamps_as_dynamic_slice(start):
    x = np.arange(2 * 100, dtype=np.float32).reshape(2, 100)
    size = 10
    want = np.stack([np.asarray(jax.lax.dynamic_slice(jnp.asarray(row), (s,), (size,)))
                     for row, s in zip(x, (start, start + 3))])
    got = t_pesq._take(torch.from_numpy(x), torch.tensor([start, start + 3]), size).numpy()
    np.testing.assert_array_equal(got, want)


def test_host_pesq_runs_the_model_with_realign(batches):
    """Without the ITU wheel (neither machine has it) ``pesq_nb_eval`` scores
    one utterance with the device model, the bad-interval realignment on."""
    assert t_pesq_host.itu_pesq_fn() is None
    ref, deg, _ = batches["window"]
    with pytest.warns(UserWarning, match="P.862 model"):
        t_pesq_host._warn_approximate.cache_clear()
        got = metrics.pesq_nb_eval(deg[3], ref[3])
    want = t_pesq.pesq_batch(torch.from_numpy(ref[3:]), torch.from_numpy(deg[3:]), SR, "nb",
                             realign=True)[0]
    plain = t_pesq.pesq_batch(torch.from_numpy(ref[3:]), torch.from_numpy(deg[3:]), SR, "nb")[0]
    assert got == float(want) and got > float(plain) + 0.05
