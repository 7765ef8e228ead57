"""The port's exported serving program (``--artifact``) on the CPU.

A from_rawfeature ``Residual`` checkpoint written by the JAX package (hidden
16, 2 bidirectional layers, 40 log-mels with 2 deltas) is exported by
``tools/export_model.py`` (1 s and 2 s buckets) and held against: its
manifest and files; the port's live CPU enhancer on the same checkpoint
(1e-6 of the output RMS; the program replays the eager path's operations);
the JAX package's own artifact of the checkpoint (``utils/export_artifact``,
5e-5 of the RMS, the enhance slice's limit); one program serving 1 and 3
rows (the symbolic batch); a request longer than the largest bucket; the
HTTP server (``/enhance``, ``/healthz``, ``/stream`` 400 with the JAX reason)
and the enhance CLI with ``--artifact`` and their refusals. An upstream-mode
checkpoint (a frozen S3PRL transformer under a ``Residual`` head) exported
the same way against its live enhancer; ``load_enhance`` in a process where
jax and the port's ``models`` / ``runner`` cannot be imported; the sample-rate
and device rules; and ``torch.library.opcheck`` on the three ops the
programs call (B1, B4, B5). Torch on one thread."""
import http.client
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.models.heads import build_head as j_build_head
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import save_checkpoint as j_save
from speech_enhancement_by_s3prl_tpu.utils import export_artifact as j_export
from speech_enhancement_by_s3prl_tpu_torch import enhance as t_enhance
from speech_enhancement_by_s3prl_tpu_torch import serve
from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import read_wav, write_wav
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import library
from speech_enhancement_by_s3prl_tpu_torch.run_downstream import PRETRAIN_ONLINE
from speech_enhancement_by_s3prl_tpu_torch.tools import export_model
from speech_enhancement_by_s3prl_tpu_torch.utils import export_artifact as EA
from tests.test_torch_port_serve_http import (
    _audio,
    _jax_ckpt,
    _pcm,
    _post,
    _quantized,
    _wav_body,
)
from tests.test_torch_port_transformer import _s3prl_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
BUCKETS = [SR, 2 * SR]
# the program against the live enhancer it was exported from: the same
# operations on the same inputs (expected bit for bit)
LIVE_TOL = 1e-6
# against the JAX package's artifact: the enhance slice's limit for enhanced
# waveforms (f32 sums in other orders through STFT, LSTM and iSTFT)
JAX_TOL = 5e-5


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rms_err(got, want):
    return float(np.abs(got - want).max() / np.sqrt(np.mean(want ** 2)))


def _export(ckpt, out, *extra):
    torch.set_num_threads(1)
    return export_model.main(["--ckpt", ckpt, "--out", str(out), "--device", "cpu",
                              "--max_sec", "2", *extra])


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX-written checkpoint, its port artifact and the live enhancer."""
    root = tmp_path_factory.mktemp("artifact")
    ckpt = _jax_ckpt(root / "ckpt", True)
    art = root / "art"
    paths = _export(ckpt, art)
    live = serve.build_enhancer(ckpt, device="cpu")
    return {"ckpt": ckpt, "art": str(art), "paths": paths, "live": live, "root": root}


@pytest.fixture(scope="module")
def jax_artifact(flagship):
    """The JAX package's own artifact of the same checkpoint, 1 s bucket, on
    the CPU (its serve.py's build_raw_enhancer and export_enhance)."""
    sys.path.insert(0, REPO)
    import serve as j_serve

    params, enhance_raw, _ = j_serve.build_raw_enhancer(flagship["ckpt"], SR, -25.0)
    out = str(flagship["root"] / "jax_art")
    j_export.export_enhance(enhance_raw, params, [SR], out, sample_rate=SR,
                            platforms=("cpu",))
    return j_export.load_enhance(out)


def test_manifest_and_files(flagship):
    manifest = json.load(open(os.path.join(flagship["art"], "manifest.json")))
    assert manifest["sample_rate"] == SR and manifest["buckets"] == BUCKETS
    assert manifest["device"] == "cpu" and "torch.export" in manifest["format"]
    assert sorted(flagship["paths"]) == BUCKETS
    assert sorted(os.listdir(flagship["art"])) == [
        "enhance_T16000.pt2", "enhance_T32000.pt2", "manifest.json"]
    program = torch.export.load(flagship["paths"][SR])
    calls = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    # B4, B1 for each of the 2 layers, B5: the kernels the card launches
    assert [c for c in calls if c.startswith("se_torch.")] == [
        "se_torch.stft.default", "se_torch.lstm_recurrence.default",
        "se_torch.lstm_recurrence.default", "se_torch.decode.default"]


@pytest.mark.parametrize("rows", [1, 3])
def test_symbolic_batch_against_the_live_enhancer_and_jax(flagship, jax_artifact, rows):
    """One program serves 1 and 3 rows; the rows are ragged within the 1 s
    bucket. Against the live enhancer and the JAX artifact."""
    fns = EA.load_enhance(flagship["art"], "cpu")
    wavs = np.stack([_audio(SR, seed=40 + r) for r in range(rows)])
    lens = np.array([SR - 1500 * r for r in range(rows)], np.int64)
    for w, n in zip(wavs, lens):
        w[n:] = 0.0  # the serving path pads so
    with torch.inference_mode():
        got = fns[SR](torch.from_numpy(wavs), torch.from_numpy(lens)).numpy()
    assert got.shape == (rows, SR) and np.isfinite(got).all()
    live = flagship["live"].run_batch([w[:n] for w, n in zip(wavs, lens)])
    want = np.asarray(jax_artifact[SR](jnp.asarray(wavs), jnp.asarray(lens, jnp.int32)))
    for r, n in enumerate(lens):
        assert _rms_err(got[r, :n], live[r]) <= LIVE_TOL
        assert _rms_err(got[r, :n], want[r, :n]) <= JAX_TOL


def test_artifact_enhancer_serves_like_build_enhancer(flagship):
    """``build_artifact_enhancer``: groups padded into the manifest's
    buckets, a 2.5 s request streamed in crossfaded windows of the largest
    (2 s), a row past it refused by ``run_batch``."""
    art = serve.build_artifact_enhancer(flagship["art"], SR, device="cpu")
    live = serve.build_enhancer(flagship["ckpt"], device="cpu", max_bucket_ms=2000)
    group = [_audio(9000, seed=50), _audio(20000, seed=51)]
    for got, want in zip(art.run_batch(group), live.run_batch(group)):
        assert got.shape == want.shape and _rms_err(got, want) <= LIVE_TOL
    long = _audio(40000, seed=52)
    got = art(long)
    assert got.shape == long.shape and _rms_err(got, live(long)) <= LIVE_TOL
    assert art.max_len == 2 * SR and art.bucket_of(17000) == 2 * SR
    with pytest.raises(ValueError, match="longer than the largest bucket"):
        art.run_batch([long])
    with pytest.raises(ValueError, match="exported at 16000 Hz"):
        serve.build_artifact_enhancer(flagship["art"], 8000, device="cpu")


def test_http_server_with_an_artifact(flagship, capsys):
    server = serve.make_server(["--artifact", flagship["art"], "--port", "0", "--device",
                                "cpu", "--workers", "2"])
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        wav = _audio(12000, seed=53)
        status, body = _post(server, "/enhance", _wav_body(wav))
        assert status == 200
        want = serve.build_enhancer(flagship["ckpt"], device="cpu")(wav)
        assert np.abs(_pcm(body) - _quantized(want)).max() <= 1
        status, body = _post(server, "/stream", b"\x00" * 64)
        assert status == 400 and b"artifact serving bakes full-utterance programs" in body
        conn = http.client.HTTPConnection(*server.server_address[:2], timeout=60)
        conn.request("GET", "/healthz")
        info = json.loads(conn.getresponse().read())
        conn.close()
        assert info["status"] == "ok" and info["requests"] == 1
    finally:
        server.shutdown()
        server.server_close()
    assert "/stream off: artifact serving" in capsys.readouterr().out


def test_enhance_cli_with_an_artifact(flagship, tmp_path, capsys):
    """``enhance --artifact`` writes the files ``--ckpt`` writes (one 16-bit
    step), and refuses JAX's flags."""
    inputs = tmp_path / "in"
    inputs.mkdir()
    for i, n in enumerate((9000, 30000, 20000)):
        write_wav(str(inputs / f"clip{i}.wav"), _audio(n, seed=60 + i), SR)
    outs = {}
    for flag, src in (("--artifact", flagship["art"]), ("--ckpt", flagship["ckpt"])):
        out = tmp_path / flag[2:]
        t_enhance.main([flag, src, "--inputs", str(inputs), "--outdir", str(out),
                        "--device", "cpu"])
        outs[flag] = {f: read_wav(str(out / f))[0][0] for f in sorted(os.listdir(out))}
    assert sorted(outs["--artifact"]) == ["clip0.wav", "clip1.wav", "clip2.wav"]
    for name, got in outs["--artifact"].items():
        want = outs["--ckpt"][name]
        assert got.shape == want.shape and np.abs(got - want).max() <= 1.5 / 32768
    art = ["--artifact", flagship["art"], "--inputs", str(inputs)]
    for argv, item in ((art + ["--ckpt", flagship["ckpt"]], "exactly one"),
                       (["--inputs", str(inputs)], "exactly one"),
                       (art + ["--target_level", "-20"], "--target_level is baked"),
                       (art + ["--dckpt", "x"], "export time")):
        with pytest.raises(SystemExit):
            t_enhance.main(argv + ["--device", "cpu"])
        assert item in capsys.readouterr().err


def test_upstream_backed_checkpoint(tmp_path):
    """An upstream-mode checkpoint (a frozen S3PRL transformer, hidden 32,
    2 layers, under a ``Residual`` head of 8) exported and served against
    its live enhancer: the upstream runs inside the program."""
    rng = np.random.default_rng(71)
    enc, head = _s3prl_state(rng, D_in=80, out=201)
    enc = {k: v * 0.2 for k, v in enc.items()}
    s3prl = str(tmp_path / "states-1000.ckpt")
    torch.save({"Transformer": enc, "SpecHead": head, "Settings": {"Config": {
        "transformer": {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
                        "intermediate_size": 64, "input_dim": 80, "layer_norm_eps": "1e-12"},
        "online": PRETRAIN_ONLINE}, "Paras": {}}}, s3prl)
    residual = {"hidden_size": 8, "num_layers": 1, "bidirectional": True,
                "activation": "Sigmoid", "cmvn": False}
    model = j_build_head("Residual", input_size=32, output_size=201, **residual)
    params = model.init(jax.random.PRNGKey(3), features=jnp.zeros((1, 101, 32)),
                        linears=jnp.zeros((1, 101, 201)))
    config = {"preprocessor": {"baseline": {"feat_type": "mel", "log": True, "delta": 2,
                                            "cmvn": False}},
              "model": {"Residual": residual}}
    paras = {"downstream": "Residual", "upstream": "transformer", "ckpt": s3prl,
             "from_rawfeature": False, "from_waveform": False}
    ckpt = j_save(str(tmp_path / "down"), 1, params, {}, config, paras)
    _export(ckpt, tmp_path / "art", "--max_sec", "1")
    art = serve.build_artifact_enhancer(str(tmp_path / "art"), SR, device="cpu")
    live = serve.build_enhancer(ckpt, device="cpu")
    group = [_audio(SR, seed=72), _audio(11000, seed=73)]
    for got, want in zip(art.run_batch(group), live.run_batch(group)):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _rms_err(got, want) <= LIVE_TOL


def test_load_enhance_needs_neither_jax_nor_the_model_code(flagship):
    """``load_enhance`` in a fresh process where jax, flax, the JAX package
    and the port's ``models`` and ``runner`` cannot be imported."""
    script = f"""
import sys
for name in ("jax", "jaxlib", "flax", "speech_enhancement_by_s3prl_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.startswith(("speech_enhancement_by_s3prl_tpu_torch.models",
                            "speech_enhancement_by_s3prl_tpu_torch.runner")):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
torch.set_num_threads(1)
from speech_enhancement_by_s3prl_tpu_torch.utils.export_artifact import load_enhance
fns = load_enhance({flagship['art']!r}, "cpu")
with torch.inference_mode():
    out = fns[{SR}](torch.zeros(2, {SR}) + 0.01, torch.tensor([{SR}, 8000]))
assert out.shape == (2, {SR}) and bool(torch.isfinite(out).all())
blocked = [m for m in sys.modules if m.startswith((
           "speech_enhancement_by_s3prl_tpu_torch.models",
           "speech_enhancement_by_s3prl_tpu_torch.runner"))]
assert not blocked, blocked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_load_enhance_moves_or_refuses_another_device(flagship, tmp_path, monkeypatch):
    """A manifest naming another device type: the program is moved with
    ``move_to_device_pass`` where torch has it (here a CPU program recorded
    as exported on the card, moved to the CPU, computes as before), and the
    mismatch is refused where it has not."""
    moved = tmp_path / "moved"
    moved.mkdir()
    for name in os.listdir(flagship["art"]):
        os.symlink(os.path.join(flagship["art"], name), moved / name)
    os.unlink(moved / "manifest.json")
    manifest = json.load(open(os.path.join(flagship["art"], "manifest.json")))
    json.dump(dict(manifest, device="cuda"), open(moved / "manifest.json", "w"))
    wav, lens = torch.from_numpy(_audio(SR, seed=80)[None]), torch.tensor([SR])
    with torch.inference_mode():
        want = EA.load_enhance(flagship["art"], "cpu")[SR](wav, lens)
        got = EA.load_enhance(str(moved), "cpu")[SR](wav, lens)
    assert torch.equal(got, want)
    import torch.export.passes as passes

    monkeypatch.delattr(passes, "move_to_device_pass")
    with pytest.raises(RuntimeError, match="exported on cuda"):
        EA.load_enhance(str(moved), "cpu")


def test_opcheck_of_the_three_ops():
    """Schema, fake kernel (a symbolic batch) and dispatch of each op, on
    small CPU tensors: B1 in f32, its bf16-h and bf16-hs forms and a bf16
    xw; B4 at the flagship geometry and at n_fft 254; B5 at powers 2 and 1."""
    g = torch.Generator().manual_seed(0)
    xw = torch.randn(2, 3, 5, 32, generator=g)
    w = 0.3 * torch.randn(2, 8, 32, generator=g)
    cases = [(library.lstm_recurrence, (xw, w, False, False)),
             (library.lstm_recurrence, (xw, w, False, True)),
             (library.lstm_recurrence, (xw[:1].clone(), w[:1].clone(), True, False)),
             (library.lstm_recurrence, (xw.to(torch.bfloat16), w, False, False)),
             (library.stft, (torch.randn(3, 1000, generator=g), 400, 400, 160)),
             (library.stft, (torch.randn(2, 700, generator=g), 254, 254, 100))]
    pred, uph = torch.rand(2, 7, 201, generator=g), torch.randn(2, 7, 402, generator=g)
    cases += [(library.decode, (pred, uph, 400, 400, 160, 2.0)),
              (library.decode, (pred, uph, 400, 400, 160, 1.0))]
    for op, args in cases:
        torch.library.opcheck(op, args)
    out = library.lstm_recurrence(xw, w, False, True)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3, 5, 8)
