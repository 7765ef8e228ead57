"""The port's experiment tools (``speech_enhancement_by_s3prl_tpu_torch/tools``)
on the CPU, against the JAX package's scripts where both compute the same
thing: ``make_splits`` writing the vendored ``lists/`` byte for byte (and
``duration_filter`` / the splits as ``scripts/make_splits.py``'s);
``extract_results`` on fabricated ``scalars.jsonl`` runs, first / last and the
pattern, its CSV text the one ``scripts/extract_results.py`` writes from the
same scalars; ``experiment_active_adaptation``'s corpus
byte-identical to the JAX script's from the same seed, its configs equal,
and a 1-step run at the smallest sizes writing ``results.json`` with the JAX
script's keys; ``endurance_run.analyze`` on fabricated runs; and the sweep
drivers ``run_active.sh`` / ``run_uniform.sh``."""
import hashlib
import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import write_wav
from speech_enhancement_by_s3prl_tpu_torch.tools import (
    endurance_run,
    experiment_active_adaptation,
    extract_results,
    make_splits,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TOOLS = os.path.join(REPO, "speech_enhancement_by_s3prl_tpu_torch", "tools")
LISTS = ["libri-test-clean-10s.txt", "libri-adapt.txt", "libri-test.txt",
         "libri-dev-all.txt", "libri-dev-few.txt"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one thread (a busy multi-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_scripts(monkeypatch):
    monkeypatch.syspath_prepend(SCRIPTS)


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# -- make_splits -------------------------------------------------------------------------

def test_make_splits_regenerates_the_vendored_lists(tmp_path):
    lists = os.path.join(REPO, "lists")
    make_splits.main(["--from-master", os.path.join(lists, "libri-test-clean-10s.txt"),
                      "--from-dev-master", os.path.join(lists, "libri-dev-all.txt"),
                      "--out-dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == sorted(LISTS)
    for name in LISTS:
        assert _digest(tmp_path / name) == _digest(os.path.join(lists, name)), name


def test_make_splits_functions_match_jax(tmp_path, jax_scripts):
    import make_splits as j_splits

    master = [f"test-clean/{i}/{i}/{i}-{i}-{i:04d}.flac" for i in range(300)]
    for seed, adapt, test in ((1227, 10, 1200), (5, 7, 100)):
        assert make_splits.split_master(master, seed, adapt, test) == j_splits.split_master(
            master, seed, adapt, test)
        assert make_splits.split_dev(master[::-1], seed, adapt) == j_splits.split_dev(
            master[::-1], seed, adapt)
    # a LibriSpeech-shaped root of WAVs from 0.5 to 2 s, filtered at 1 s
    rng = np.random.default_rng(0)
    for k, sec in enumerate((0.5, 2.0, 1.0, 1.5, 0.75)):
        d = tmp_path / "test-clean" / str(k % 2) / "7"
        d.mkdir(parents=True, exist_ok=True)
        write_wav(str(d / f"{k % 2}-7-{k:04d}.wav"),
                  0.1 * rng.standard_normal(int(sec * 16000)).astype(np.float32), 16000)
    got = make_splits.duration_filter(str(tmp_path), "test-clean", 1.0)
    assert got == j_splits.duration_filter(str(tmp_path), "test-clean", 1.0)
    assert len(got) == 3 and all(not p.startswith("/") for p in got)


def test_make_splits_needs_an_input(tmp_path):
    with pytest.raises(SystemExit):
        make_splits.main(["--out-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# -- extract_results ---------------------------------------------------------------------

RUNS = {"exp_noise3_run": {"test_stoi": [(1, 0.75), (2, 0.8125)], "test_sisdr": [(1, 13.0)]},
        "exp_noise11_run": {"test_stoi": [(1, 0.875), (5, 0.5)], "test_sisdr": [(1, 21.0)],
                            "loss": [(1, 2.5)]},
        "exp_noise7_run": {"test_sisdr": [(1, -3.25), (3, 4.5)]},
        "exp_noise5_run": {"loss": [(1, 1.0)]},  # none of the tags: no row
        "other": {"test_stoi": [(1, 0.25)]}}   # the pattern does not match


def _fabricate(root):
    """RUNS as ``scalars.jsonl`` files, one directory a run, plus a stray
    file and an empty run directory."""
    for name, tags in RUNS.items():
        d = root / name
        d.mkdir()
        lines = sorted((step, tag, value) for tag, pts in tags.items() for step, value in pts)
        with open(d / "scalars.jsonl", "w") as f:
            for step, tag, value in lines:
                f.write(json.dumps({"step": step, "tag": tag, "value": value}) + "\n")
    (root / "exp_noise9_file").write_text("not a run")
    (root / "exp_noise13_empty").mkdir()


@pytest.mark.parametrize("which,want", [
    ("first", {3: {"test_stoi": 0.75, "test_sisdr": 13.0},
               7: {"test_sisdr": -3.25},
               11: {"test_stoi": 0.875, "test_sisdr": 21.0}}),
    ("last", {3: {"test_stoi": 0.8125, "test_sisdr": 13.0},
              7: {"test_sisdr": 4.5},
              11: {"test_stoi": 0.5, "test_sisdr": 21.0}}),
])
def test_extract_results_first_and_last(tmp_path, which, want):
    _fabricate(tmp_path)
    rows = extract_results.collect(str(tmp_path), ["test_stoi", "test_sisdr"], which)
    assert rows == want
    out = str(tmp_path / "res.csv")
    assert extract_results.main([str(tmp_path), "--tags", "test_stoi", "test_sisdr",
                                 "--which", which, "--out", out]) == out
    with open(out) as f:
        lines = f.read().splitlines()
    assert lines[0] == "noise_type,test_stoi,test_sisdr"
    assert [ln.split(",")[0] for ln in lines[1:]] == ["3", "7", "11"]
    assert lines[2] == f"7,,{want[7]['test_sisdr']}"  # a run without test_stoi


def test_extract_results_pattern_labels_runs(tmp_path):
    _fabricate(tmp_path)
    rows = extract_results.collect(str(tmp_path), ["test_stoi", "loss"], "first",
                                   pattern=r"^(other|exp_noise5_run)$")
    assert rows == {"other": {"test_stoi": 0.25}, "exp_noise5_run": {"loss": 1.0}}
    lines = extract_results.write_csv(str(tmp_path / "o.csv"), rows)
    assert lines == [["noise_type", "loss", "test_stoi"], ["exp_noise5_run", "1.0", ""],
                     ["other", "", "0.25"]]


@pytest.mark.parametrize("which,text", [
    ("first", "noise_type,test_stoi,test_sisdr\n3,0.75,13.0\n7,,-3.25\n11,0.875,21.0\n"),
    ("last", "noise_type,test_stoi,test_sisdr\n3,0.8125,13.0\n7,,4.5\n11,0.5,21.0\n"),
])
def test_extract_results_csv_text(tmp_path, which, text):
    """The CSV text scripts/extract_results.py (pandas) writes for the same
    scalars as TensorBoard events, read once from it (the values are exact
    in float32); the JAX script is not run here, since its event reader
    imports TensorFlow (~15 s)."""
    _fabricate(tmp_path)
    out = extract_results.main([str(tmp_path), "--tags", "test_stoi", "test_sisdr",
                                "--which", which, "--out", str(tmp_path / "o.csv")])
    with open(out, newline="") as f:
        assert f.read().replace("\r\n", "\n") == text


# -- experiment_active_adaptation --------------------------------------------------------

def test_gen_corpus_writes_the_jax_scripts_bytes(tmp_path, jax_scripts):
    import experiment_active_adaptation as j_ex

    sizes = dict(n_speech_train=2, n_speech_test=1, n_white=1, n_pink=1, n_tonal_train=1,
                 n_tonal_test=1)
    experiment_active_adaptation.gen_corpus(str(tmp_path / "port"),
                                            np.random.default_rng(5), **sizes)
    j_ex.gen_corpus(str(tmp_path / "jax"), np.random.default_rng(5), **sizes)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 12
    for rel in files:
        with open(tmp_path / "port" / rel, "rb") as f, open(tmp_path / "jax" / rel, "rb") as g:
            assert f.read() == g.read(), rel
    ported = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                    for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert ported == files


def test_experiment_configs_match_jax(tmp_path, jax_scripts):
    import endurance_run as j_endurance
    import experiment_active_adaptation as j_ex

    args = experiment_active_adaptation.get_parser().parse_args(
        ["--workdir", str(tmp_path), "--hidden", "8", "--query_num", "2", "--snrs", "0", "5"])
    for pseudo in (None, [0, 1, 2, 3]):
        assert experiment_active_adaptation.downstream_config(
            str(tmp_path), args, "ns", "nt", 7, pseudo) == j_ex.downstream_config(
            str(tmp_path), args, "ns", "nt", 7, pseudo)
    e_args = endurance_run.get_parser().parse_args(
        ["--workdir", str(tmp_path), "--steps", "40", "--layers", "1"])
    written = []
    for build in (endurance_run.build_config, j_endurance.build_config):
        with open(build(e_args, str(tmp_path))) as f:
            written.append(f.read())
    assert written[0] == written[1] and "media_step: 4000" in written[0]


# the JAX script's results.json: its stages' keys
ENRICHMENT_KEYS = {"match_rate", "mean_score", "hist_match_rate", "hist_mean_score", "n"}
EVAL_TAGS = {"test_loss", "test_stoi", "test_pesq_nb", "test_sisdr"}


def test_experiment_runs_end_to_end(tmp_path, capsys):
    argv = ["--workdir", str(tmp_path / "wd"), "--cpu", "--up_steps", "1", "--down_steps",
            "1", "--adapt_steps", "2", "--hidden", "8", "--up_hidden", "8", "--up_layers",
            "1", "--max_time", "1000", "--batch_size", "2", "--active_batch_size", "2",
            "--query_num", "2", "--enrich_batches", "1"]
    results = experiment_active_adaptation.main(argv)
    with open(tmp_path / "wd" / "results.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(results))
    assert set(saved) == {"config", "active", "uniform", "enrichment"}
    assert set(saved["enrichment"]) == {"white", "pink", "tonal_train", "tonal_target"}
    for domain, rates in saved["enrichment"].items():
        assert set(rates) == ENRICHMENT_KEYS and rates["n"] == 2, domain
        assert all(np.isfinite(v) for v in rates.values())
    for mode in ("active", "uniform"):
        assert set(saved[mode]) == EVAL_TAGS
        assert all(set(v) == {"init", "final"} and np.isfinite(list(v.values())).all()
                   for v in saved[mode].values())
    # the JAX script's flags, --device in place of --cpu
    assert saved["config"]["device"] == "cpu" and "cpu" not in saved["config"]
    for up in ("noisy2clean", "noisy2noise"):
        assert os.path.exists(tmp_path / "wd" / "upstreams" / up / "states-2.ckpt")

    # the adaptation runs' CSV
    out = extract_results.main([str(tmp_path / "wd" / "adapt"), "--pattern",
                                r"^(active|uniform)$", "--tags", "test_stoi", "test_sisdr",
                                "--which", "last", "--out", str(tmp_path / "adapt.csv")])
    with open(out) as f:
        lines = f.read().splitlines()
    assert lines[0] == "noise_type,test_stoi,test_sisdr"
    assert [ln.split(",")[0] for ln in lines[1:]] == ["active", "uniform"]
    assert float(lines[1].split(",")[1]) == saved["active"]["test_stoi"]["final"]

    # a second call reuses every finished stage
    capsys.readouterr()
    experiment_active_adaptation.main(argv)
    log = capsys.readouterr().out
    assert log.count("[experiment] reusing upstream") == 2
    assert "reusing finished active run" in log and "reusing finished uniform run" in log
    assert "[runner] step" not in log


def test_experiment_refuses_a_missing_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiment_active_adaptation.main(["--workdir", str(tmp_path / "wd")])
    assert not (tmp_path / "wd").exists()


# -- endurance_run.analyze ---------------------------------------------------------------

def _soak(root, steps=4000, rss=(800.0,) * 12, rotating=3, best=(("dev", 2), ("test", 1)),
          final_loss=0.5):
    """A fabricated endurance workdir: scalars at the active.yaml cadence, the
    checkpoints of a run and an RSS trace."""
    run = root / "exp" / "endurance"
    run.mkdir(parents=True)
    with open(run / "scalars.jsonl", "w") as f:
        for step in range(500, steps + 1, 500):
            loss = 2.0 + (final_loss - 2.0) * step / steps
            f.write(json.dumps({"step": step, "tag": "loss", "value": loss}) + "\n")
            if step % 1000 == 0:
                for tag in ("dev_loss", "test_stoi"):
                    f.write(json.dumps({"step": step, "tag": tag, "value": 0.5}) + "\n")
    for k in range(rotating):
        (run / f"states-{2000 * (k + 1)}.ckpt").write_bytes(b"")
    for split, n in best:
        (run / split).mkdir()
        for k in range(n):
            (run / split / f"states-{1000 * (k + 1)}.ckpt").write_bytes(b"")
    with open(root / "rss.csv", "w") as f:
        f.write("wall_s,rss_mb\n" + "".join(f"{30 * i},{v}\n" for i, v in enumerate(rss)))
    return endurance_run.get_parser().parse_args(
        ["--workdir", str(root), "--steps", str(steps), "--analyze_only"])


def test_endurance_analyze_passes_a_sound_run(tmp_path):
    args = _soak(tmp_path)
    report = endurance_run.analyze(args, str(tmp_path / "exp"), str(tmp_path / "rss.csv"))
    assert report["ok"] and set(report["checks"]) == {
        "log_cadence", "eval_cadence", "loss_decreases", "ckpt_rotation",
        "save_best_per_split", "rss_bounded"}
    assert report["rss"]["drift_mb"] == 0.0 and report["rss"]["samples"] == 12
    with open(report["eval_curves_csv"]) as f:
        rows = f.read().splitlines()
    assert rows[0] == "tag,step,value" and len(rows) == 1 + 2 * 4
    # the CLI writes the report and exits 0
    with pytest.raises(SystemExit) as done:
        endurance_run.main(["--workdir", str(tmp_path), "--steps", "4000", "--analyze_only"])
    assert done.value.code == 0
    with open(tmp_path / "report.json") as f:
        assert json.load(f)["ok"] is True


def test_endurance_analyze_fails_a_leaking_run(tmp_path):
    args = _soak(tmp_path, rss=(800.0,) * 6 + (2600.0,) * 6, rotating=4, final_loss=2.5)
    report = endurance_run.analyze(args, str(tmp_path / "exp"), str(tmp_path / "rss.csv"))
    failed = {k for k, v in report["checks"].items() if not v["ok"]}
    assert not report["ok"] and failed == {"rss_bounded", "ckpt_rotation", "loss_decreases"}
    with pytest.raises(SystemExit) as done:
        endurance_run.main(["--workdir", str(tmp_path), "--steps", "4000", "--analyze_only"])
    assert done.value.code == 1


def test_endurance_monitor_reads_the_childs_rss(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "import time; x = bytearray(50 << 20); "
                             "time.sleep(1.0)"])
    assert endurance_run.monitor(proc, str(tmp_path / "rss.csv"), 0.05) == 0
    with open(tmp_path / "rss.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == "wall_s,rss_mb" and len(rows) >= 5
    assert max(float(r.split(",")[1]) for r in rows[1:]) > 50  # the child's 50 MiB


# -- the sweep scripts -------------------------------------------------------------------

@pytest.mark.parametrize("script,name,config,sampled", [
    ("run_active.sh", "active", "config/active.yaml", True),
    ("run_uniform.sh", "uniform", "config/pseudo_noise.yaml", False),
])
def test_sweep_scripts_run_the_ports_cli(tmp_path, script, name, config, sampled):
    """Each noise subdirectory runs ``python -m ...run_downstream`` with the
    JAX script's flags; arguments past the fifth are passed on."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "python"
    fake.write_text(f'#!/bin/bash\necho "$@" >> {tmp_path / "calls.txt"}\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    for noise in ("babble", "car"):
        (tmp_path / "noise" / noise).mkdir(parents=True)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}
    subprocess.run(["bash", os.path.join(TOOLS, script), str(tmp_path / "noise"), "n2c.ckpt",
                    "n2n.ckpt", "d.ckpt", "out", "--cpu"], check=True, env=env, cwd=REPO,
                   capture_output=True, text=True, timeout=60)
    calls = (tmp_path / "calls.txt").read_text().splitlines()
    assert len(calls) == 2
    for call, noise in zip(calls, ("babble", "car")):
        argv = call.split()
        assert argv[:2] == ["-m", "speech_enhancement_by_s3prl_tpu_torch.run_downstream"]
        assert argv[argv.index("--name") + 1] == f"{name}_{noise}"
        assert argv[argv.index("--config") + 1] == config
        assert argv[argv.index("--test_noise") + 1] == f"{tmp_path / 'noise' / noise}/"
        assert ("--active_sampling" in argv and "--sync_sampler" in argv) == sampled
        for flag in ("--eval_init", "--save_best", "--from_rawfeature"):
            assert flag in argv
        assert argv[-1] == "--cpu" and argv[argv.index("--expdir") + 1] == "out"
    with open(os.path.join(SCRIPTS, script)) as f:  # the JAX script's flags, all of them
        jax_flags = {w for w in f.read().split() if w.startswith("--")}
    assert jax_flags <= set(calls[0].split())
