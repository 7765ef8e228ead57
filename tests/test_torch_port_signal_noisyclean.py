"""The rest of the port's data path against the JAX package on the CPU:
``utils/signal.py`` (``remove_silence``, ``Resampler``), ``NoisyCleanDataset``
(the same pairs, sample and crops bit for bit) and ``--trainset
NoisyCleanDataset`` through the port's Runner, and ``OnlineDataset``'s
``pseudo_modes`` items for each pseudo case, bit for bit."""
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from speech_enhancement_by_s3prl_tpu.data import datasets as j_datasets
from speech_enhancement_by_s3prl_tpu.utils import signal as j_signal
from speech_enhancement_by_s3prl_tpu_torch import run_downstream
from speech_enhancement_by_s3prl_tpu_torch.data import datasets
from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import write_wav
from speech_enhancement_by_s3prl_tpu_torch.utils import signal

SR = 16000
# Resampler: one strided convolution of the zero-stuffed input on both sides,
# its taps summed in other orders (f32 rounding of a few dozen products)
RESAMPLE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one thread. In a test run of several
    workers every core is busy, and torch's default pool of a thread a core
    waits on threads descheduled for the other processes: measured, a 0.07 s
    scoring call took 4 s on 8 threads and 0.07 s on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal(3000), np.zeros(2000),
                        0.3 * rng.standard_normal(2500)]).astype(np.float32)
    return x, (0.5 * x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)


@pytest.mark.parametrize("use_ref", [False, True])
@pytest.mark.parametrize("framelen,hop", [(256, 128), (200, 80)])
def test_remove_silence_matches_jax(use_ref, framelen, hop):
    """The kept frames, their order and the overlap-add: the same frames
    summed at the same positions, so the outputs agree to f32 rounding."""
    x, y = _pair(framelen + hop)
    want = j_signal.remove_silence(jnp.asarray(x), jnp.asarray(y), framelen=framelen,
                                   hop=hop, use_ref=use_ref)
    got = signal.remove_silence(torch.from_numpy(x), torch.from_numpy(y), framelen=framelen,
                                hop=hop, use_ref=use_ref)
    assert int(got[2]) == int(want[2]) < len(x)
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("orig,new", [(16000, 8000), (8000, 16000), (16000, 22050),
                                      (44100, 16000), (16000, 16000)])
def test_resampler_matches_jax(orig, new):
    wav = np.random.default_rng(orig + new).standard_normal((2, 3, 1234)).astype(np.float32)
    want = np.asarray(j_signal.Resampler()(jnp.asarray(wav), orig, new))
    got = signal.Resampler()(torch.from_numpy(wav), orig, new).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESAMPLE_RTOL * np.abs(want).max())


# -- NoisyCleanDataset -----------------------------------------------------------------

@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """Two roots of clean/noisy pairs (0.2-0.5 s) tagged ``fileid_<n>``; a
    decoy ``fileid_11`` beside ``fileid_1`` tests the exact id match."""
    root = tmp_path_factory.mktemp("paired")
    rng = np.random.default_rng(0)
    for split, ids in (("tr", range(12)), ("te", range(20, 24))):
        os.makedirs(root / split / "clean")
        os.makedirs(root / split / "noisy")
        for i in ids:
            n = int(rng.integers(3200, 8000))
            clean = 0.1 * rng.standard_normal(n)
            write_wav(str(root / split / "clean" / f"c_fileid_{i}.wav"), clean, SR)
            write_wav(str(root / split / "noisy" / f"n_fileid_{i}.wav"),
                      clean + 0.05 * rng.standard_normal(n), SR)
    return root


@pytest.mark.parametrize("kwargs", [
    {"max_sec": 0.25},
    {"max_sec": 0.25, "sample_ratio": 0.5, "select_sampled": False},
    {"max_sec": 1.0, "sample_ratio": 0.5, "sample_num": 9},
    {"max_sec": 0.3, "sample_num": 30, "seed": 5},
])
def test_noisyclean_pairs_and_crops_match_jax(paired, kwargs):
    roots = [str(paired / "tr"), str(paired / "te")]
    ours = datasets.NoisyCleanDataset(roots, **kwargs)
    theirs = j_datasets.NoisyCleanDataset(roots, **kwargs)
    assert ours.clean_pths == theirs.clean_pths and len(ours) == len(theirs)
    for idx in range(len(ours)):
        assert ours._find_noisy(ours.clean_pths[idx]) == theirs._find_noisy(
            theirs.clean_pths[idx])
        for seed in (idx, 1000 + idx):
            datasets.set_item_seed(seed)
            j_datasets.set_item_seed(seed)
            try:
                a, b = ours[idx], theirs[idx]
            finally:
                datasets.set_item_seed(None)
                j_datasets.set_item_seed(None)
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
            assert a.shape[1] == 2 and a.shape[0] <= round(kwargs["max_sec"] * SR)
    for sub in ({}, {"sample_seed": 3}):
        assert ours.get_subset(0.5, **sub).clean_pths == theirs.get_subset(
            0.5, **sub).clean_pths


def test_noisyclean_refuses_what_it_cannot_pair(paired, tmp_path):
    with pytest.raises(ValueError, match="no clean files"):
        datasets.NoisyCleanDataset([str(tmp_path)])
    os.makedirs(tmp_path / "clean")
    os.makedirs(tmp_path / "noisy")
    write_wav(str(tmp_path / "clean" / "c_fileid_1.wav"), np.zeros(800), SR)
    ds = datasets.NoisyCleanDataset([str(tmp_path)])
    with pytest.raises(ValueError, match="ambiguous"):
        ds[0]


def test_trainset_noisyclean_through_the_runner(paired, tmp_path):
    """``--trainset NoisyCleanDataset`` trains and evaluates (two-channel
    items: noisy and clean) through the port's CLI."""
    config = {
        "dataloader": {"batch_size": 2, "eval_batch_size": 2},
        "preprocessor": {"input_channel": 0, "target_channel": 1,
                         "baseline": {"feat_type": "linear", "log": False, "delta": 0,
                                      "cmvn": False}},
        "runner": {"learning_rate": 1e-3, "warmup_proportion": 0.07,
                   "gradient_clipping": 1.0, "total_step": 3, "log_step": 3,
                   "eval_step": 3, "max_keep": 1, "eval_splits": ["test"],
                   "eval_metrics": ["sisdr"]},
        "objective": {"L1": {}},
        "model": {"LSTM": {"hidden_size": 8, "num_layers": 1, "bidirectional": True}},
        "NoisyCleanDataset_train": {"roots": [str(paired / "tr")], "max_sec": 0.4},
        "NoisyCleanDataset_test": {"roots": [str(paired / "te")]},
    }
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(config))
    run_downstream.main(["--config", str(cfg), "--name", "nc", "--expdir", str(tmp_path),
                         "--downstream", "LSTM", "--objective", "L1", "--from_rawfeature",
                         "--trainset", "NoisyCleanDataset", "--n_jobs", "1", "--cpu"])
    scalars = [yaml.safe_load(line) for line in open(tmp_path / "nc" / "scalars.jsonl")]
    assert [s["tag"] for s in scalars] == ["loss", "gradient norm", "steps_per_sec",
                                           "test_loss", "test_sisdr"]
    assert all(np.isfinite(s["value"]) for s in scalars)


# -- OnlineDataset pseudo cases ------------------------------------------------------

@pytest.fixture(scope="module")
def mixing(tmp_path_factory):
    root = tmp_path_factory.mktemp("mix")
    rng = np.random.default_rng(1)
    for sub, n in (("speech", 4), ("noise", 3)):
        os.makedirs(root / sub)
        for k in range(n):
            write_wav(str(root / sub / f"{k}.wav"),
                      0.1 * rng.standard_normal(int(rng.integers(3000, 7000))), SR)
    pseudo = [[(0.05 * rng.standard_normal(int(rng.integers(2000, 6000)))).astype(np.float32)
               for _ in range(3)] for _ in range(2)]
    return root, pseudo


@pytest.mark.parametrize("modes", [[0], [1], [2], [3], [0, 1, 2, 3]])
@pytest.mark.parametrize("infinite,half_noise", [(True, None), (False, "front")])
def test_online_pseudo_items_match_jax_bit_for_bit(mixing, modes, infinite, half_noise):
    root, (pseudo_clean, pseudo_noise) = mixing
    conf = dict(speech={"filestrs": str(root / "speech")},
                noise={"filestrs": str(root / "noise")}, snrs=[-5, 0, 5],
                infinite=infinite, half_noise=half_noise, pseudo_modes=modes,
                pseudo_clean=pseudo_clean, pseudo_noise=pseudo_noise)
    ours, theirs = datasets.OnlineDataset(**conf), j_datasets.OnlineDataset(**conf)
    cases = set()
    for idx in range(len(ours)):
        for seed in (7 * idx, 7 * idx + 1, 7 * idx + 2):
            datasets.set_item_seed(seed)
            j_datasets.set_item_seed(seed)
            try:
                (a, ca), (b, cb) = ours[idx], theirs[idx]
            finally:
                datasets.set_item_seed(None)
                j_datasets.set_item_seed(None)
            assert ca == cb and ca in modes and np.array_equal(a, b)
            cases.add(ca)
            if ca in (2, 3):  # the speech channel is one of the pseudo-clean wavs
                assert len(a) in {len(w) for w in pseudo_clean}
    assert cases == set(modes) or len(modes) == 4
    # without pseudo wavs a pseudo case takes the real ones
    plain = dict(conf, pseudo_clean=None, pseudo_noise=None)
    datasets.set_item_seed(3)
    j_datasets.set_item_seed(3)
    try:
        (a, ca), (b, cb) = (datasets.OnlineDataset(**plain)[0],
                            j_datasets.OnlineDataset(**plain)[0])
    finally:
        datasets.set_item_seed(None)
        j_datasets.set_item_seed(None)
    assert ca == cb and np.array_equal(a, b)
