"""The port's HTTP front end (``serve.main`` / ``make_server``) on the CPU,
serving checkpoints written by the JAX package's ``save_checkpoint`` (so the
weight bridge is on the path): ``/healthz``; ``/enhance`` with WAV and FLAC
bodies against ``build_enhancer`` in the same process (exactly) and against
the JAX server's reply (one 16-bit step); a bad body; ``--workers 4`` with
concurrent requests of two buckets against their solo responses (one step;
byte-identical under ``--fixed_batch``, also with a ``--max_batch`` of 6);
``_pad_group`` against JAX's;
``/stream`` with chunked and Content-Length bodies against the port's
streamer bit for bit, its first bytes before the body ends, and its 400 on a
bidirectional checkpoint; the refused flags (JAX's rules for --ckpt /
--artifact) and the card default."""
import argparse
import http.client
import io
import json
import os
import socket
import sys
import threading
import time
import wave

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.models.heads import build_head as j_build_head
from speech_enhancement_by_s3prl_tpu.ops.features import (
    OnlinePreprocessor as JPreprocessor,
)
from speech_enhancement_by_s3prl_tpu.ops.features import get_feat_config
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import save_checkpoint
from speech_enhancement_by_s3prl_tpu_torch import serve
from speech_enhancement_by_s3prl_tpu_torch.data.loader import default_buckets
from speech_enhancement_by_s3prl_tpu_torch.tools import serve_load, stream_client
from tests import torch_port_flac_writer as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
# one 16-bit PCM step: float32 sums in other orders (other row counts, or
# the other package) may round a sample to the neighbouring step
PCM_STEP = 1


def _jax_ckpt(path, bidirectional):
    """A from_rawfeature Residual (hidden 16, 2 layers, 40 log-mels with 2
    deltas, CMVN-free) saved by the JAX package."""
    baseline = get_feat_config("mel", 0, log=True, delta=2, cmvn=False)
    cfg = dict(hidden_size=16, num_layers=2, bidirectional=bidirectional,
               activation="Sigmoid", cmvn=False)
    config = {"preprocessor": {"input_channel": 0, "target_channel": 1,
                               "baseline": dict(baseline)},
              "model": {"Residual": cfg}}
    paras = {"downstream": "Residual", "from_rawfeature": True, "upstream": "transformer",
             "ckpt": "", "dckpt": ""}
    feat_list = [dict(baseline), dict(baseline), get_feat_config("linear", 0),
                 get_feat_config("uphase", 0), get_feat_config("linear", 0),
                 get_feat_config("uphase", 0)]
    pre = JPreprocessor(feat_list=feat_list)
    dims = pre.feat_dims()
    model = j_build_head("Residual", input_size=dims[1], output_size=dims[2], **cfg)
    feats = pre(jnp.zeros((1, 1, SR), jnp.float32))
    params = model.init(jax.random.PRNGKey(0), features=feats[1], linears=feats[2])
    save_checkpoint(str(path), 1, params, {}, config, paras)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return {bidir: _jax_ckpt(tmp_path_factory.mktemp(f"ckpt{int(bidir)}"), bidir)
            for bidir in (False, True)}


def _serve(argv):
    server = serve.make_server(argv)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def servers(ckpts):
    """Port servers on the one-direction checkpoint: single-threaded,
    --workers 4, and --workers 4 --fixed_batch --max_batch 4."""
    base = ["--ckpt", ckpts[False], "--port", "0", "--device", "cpu"]
    out = {"single": _serve(base),
           "workers": _serve(base + ["--workers", "4", "--batch_window_ms", "200"]),
           "fixed": _serve(base[:-2] + ["--cpu", "--workers", "4", "--batch_window_ms",
                                        "200", "--fixed_batch", "--max_batch", "4"])}
    yield out
    for server in out.values():
        server.shutdown()
        server.server_close()


def _jax_server(ckpt):
    """The JAX package's serve.main on a thread (its tests' wiring)."""
    sys.path.insert(0, REPO)
    import serve as j_serve
    from http.server import HTTPServer

    args = argparse.Namespace(ckpt=ckpt, host="127.0.0.1", port=0, sample_rate=SR,
                              target_level=-25.0, cpu=True)
    holder = {}
    real_parse, real_serve = argparse.ArgumentParser.parse_args, HTTPServer.serve_forever

    def capture(self):
        holder["server"] = self
        real_serve(self)

    argparse.ArgumentParser.parse_args = lambda self, *a, **k: args
    HTTPServer.serve_forever = capture
    try:
        threading.Thread(target=j_serve.main, daemon=True).start()
        for _ in range(600):
            if "server" in holder:
                break
            time.sleep(0.2)
    finally:
        argparse.ArgumentParser.parse_args, HTTPServer.serve_forever = real_parse, real_serve
    assert "server" in holder, "the JAX server did not start"
    return holder["server"]


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * (200 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _wav_body(wav):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.rint(np.clip(wav * 32767.0, -32768, 32767)).astype("<i2").tobytes())
    return buf.getvalue()


def _post(server, path, body, headers=None):
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _pcm(body):
    with wave.open(io.BytesIO(body), "rb") as w:
        assert w.getframerate() == SR and w.getnchannels() == 1
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def _quantized(out):
    return np.rint(np.clip(out * 32767.0, -32768, 32767)).astype(np.int32)


def test_healthz(servers):
    host, port = servers["single"].server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    info = json.loads(resp.read())
    conn.close()
    assert resp.status == 200 and info["status"] == "ok"
    assert info["device"] == "cpu" and info["devices"] == ["cpu"]
    assert {"requests", "audio_seconds", "wall_seconds"} <= set(info)


def test_enhance_wav_and_flac(servers, ckpts):
    """The reply's PCM is the int16 of build_enhancer(...)(wav) in this
    process, exactly; the JAX server's reply on the same checkpoint agrees
    within one 16-bit step."""
    enhancer = serve.build_enhancer(ckpts[False], device="cpu")
    wav = _audio(3 * 4096 + 1000, seed=1)
    pcm16 = np.rint(np.clip(_audio(4 * 4096, seed=2) * 32767.0, -32768, 32767))
    flac_wav = (pcm16 / 32768.0).astype(np.float32)  # what the decoder returns
    bodies = [(wav, _wav_body(wav)), (flac_wav, W.mono16(pcm16))]
    replies = []
    for ref_in, body in bodies:
        status, reply = _post(servers["single"], "/enhance", body)
        assert status == 200
        if body[:4] != b"fLaC":  # the WAV body quantizes the input
            ref_in = np.rint(np.clip(ref_in * 32767.0, -32768, 32767)) / 32768.0
        want = _quantized(enhancer(np.asarray(ref_in, np.float32)))
        np.testing.assert_array_equal(_pcm(reply), want)
        replies.append(_pcm(reply))
    j_server = _jax_server(ckpts[False])
    try:
        for (_, body), got in zip(bodies, replies):
            status, reply = _post(j_server, "/enhance", body)
            assert status == 200
            assert int(np.abs(_pcm(reply) - got).max()) <= PCM_STEP
    finally:
        j_server.shutdown()
        j_server.server_close()


def test_bad_bodies_answer_400(servers):
    for body in (b"this is not audio", b"fLaC" + b"\x00" * 40):
        status, reply = _post(servers["single"], "/enhance", body)
        assert status == 400 and reply.startswith(b"decode error")
    status, _ = _post(servers["single"], "/nowhere", b"x")
    assert status == 404


def _spy_rows(monkeypatch):
    """Record the row count of every device batch ``run_batch`` pads."""
    rows, real = [], serve._pad_group

    def spy(*a, **k):
        batch, lens = real(*a, **k)
        rows.append(batch.shape[0])
        return batch, lens

    monkeypatch.setattr(serve, "_pad_group", spy)
    return rows


@pytest.mark.parametrize("mode", ["workers", "fixed"])
def test_concurrent_requests_of_two_buckets(servers, mode, monkeypatch):
    """Eight concurrent requests, four in the 1 s bucket and four in the 2 s
    one, coalesced by the micro-batcher: each within one 16-bit step of its
    solo response (byte-identical under --fixed_batch); every device batch a
    power of two rows (exactly --max_batch under --fixed_batch)."""
    server = servers[mode]
    rows = _spy_rows(monkeypatch)
    bodies = [_wav_body(_audio(n, seed=10 + k)) for k, n in
              enumerate([9000, 12000, 15000, 16000, 20000, 24000, 28000, 31000])]
    solo = [_pcm(_post(server, "/enhance", b)[1]) for b in bodies]
    answers = [None] * len(bodies)

    def ask(k):
        answers[k] = _post(server, "/enhance", bodies[k])

    threads = [threading.Thread(target=ask, args=(k,)) for k in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    for (status, reply), ref in zip(answers, solo):
        assert status == 200
        if mode == "fixed":
            np.testing.assert_array_equal(_pcm(reply), ref)
        else:
            assert int(np.abs(_pcm(reply) - ref).max()) <= PCM_STEP
    if mode == "fixed":
        assert set(rows) == {4}
    else:
        assert rows and all(r & (r - 1) == 0 for r in rows) and max(rows) <= 4


def test_fixed_batch_of_a_max_batch_not_a_power_of_two(ckpts, monkeypatch):
    """--fixed_batch --max_batch 6: a solo request and a group of five both
    run as exactly 6 rows (rounding to a power of two first would give the
    group 8, then 12), and every reply is byte-identical to its solo reply."""
    server = _serve(["--ckpt", ckpts[False], "--port", "0", "--device", "cpu", "--workers",
                     "6", "--batch_window_ms", "300", "--fixed_batch", "--max_batch", "6"])
    try:
        rows = _spy_rows(monkeypatch)
        bodies = [_wav_body(_audio(n, seed=20 + k)) for k, n in
                  enumerate([9000, 10000, 11000, 12000, 13000])]
        solo = [_post(server, "/enhance", b)[1] for b in bodies]
        assert rows == [6] * len(bodies)
        answers = [None] * len(bodies)

        def ask(k):
            answers[k] = _post(server, "/enhance", bodies[k])

        threads = [threading.Thread(target=ask, args=(k,)) for k in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        assert set(rows) == {6} and len(rows) < 2 * len(bodies)  # some group coalesced
        for (status, reply), ref in zip(answers, solo):
            assert status == 200 and reply == ref
    finally:
        server.shutdown()
        server.server_close()


def test_pad_group_matches_jax():
    sys.path.insert(0, REPO)
    import serve as j_serve

    buckets = default_buckets(SR, 4000)
    rng = np.random.default_rng(0)
    for n_rows in (1, 3, 5):
        wavs = [rng.standard_normal(int(m)).astype(np.float32)
                for m in rng.integers(1000, 30000, size=n_rows)]
        for batch_round in (1, 4, 6):
            for round_pow2 in (True, False):
                got = serve._pad_group(wavs, buckets, batch_round, round_pow2)
                want = j_serve._pad_group(wavs, buckets, batch_round, round_pow2)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])


def _stream_ref(server, wav):
    streamer = server.stream_proto.clone()
    return np.concatenate([streamer.push(wav), streamer.flush()])


def test_stream_chunked_and_content_length(servers):
    server = servers["single"]
    wav = _audio(2 * SR + 333, seed=3)
    raw = wav.astype("<f4").tobytes()
    cuts = list(range(0, len(raw), 7001)) + [len(raw)]  # pieces off the float grid
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=300)
    conn.request("POST", "/stream", body=iter([raw[a:b] for a, b in zip(cuts, cuts[1:])]),
                 encode_chunked=True)
    resp = conn.getresponse()
    assert resp.status == 200
    got = np.frombuffer(resp.read(), "<f4")
    conn.close()
    np.testing.assert_array_equal(got, _stream_ref(server, wav))
    short = _audio(SR, seed=4)
    status, body = _post(server, "/stream", short.astype("<f4").tobytes())
    assert status == 200
    np.testing.assert_array_equal(np.frombuffer(body, "<f4"), _stream_ref(server, short))


def test_stream_emits_before_the_body_ends(servers):
    server = servers["single"]
    host, port = server.server_address[:2]
    raw = _audio(2 * SR, seed=5).astype("<f4").tobytes()
    s = socket.create_connection((host, port), timeout=120)
    try:
        s.sendall(f"POST /stream HTTP/1.1\r\nHost: {host}:{port}\r\n"
                  "Transfer-Encoding: chunked\r\n\r\n".encode())
        quarter = len(raw) // 4
        for k in range(3):  # 1.5 s sent, the body still open
            piece = raw[k * quarter:(k + 1) * quarter]
            s.sendall(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
        data = b""
        deadline = time.time() + 60
        while time.time() < deadline:
            data += s.recv(65536)
            if b"\r\n\r\n" in data and len(data.split(b"\r\n\r\n", 1)[1]) >= 1024:
                break
        assert data.startswith(b"HTTP/1.1 200")
        assert len(data.split(b"\r\n\r\n", 1)[1]) >= 1024, "no audio before the body ended"
        tail = raw[3 * quarter:]
        s.sendall(f"{len(tail):x}\r\n".encode() + tail + b"\r\n0\r\n\r\n")
        while s.recv(65536):
            pass
    finally:
        s.close()


def test_a_crowd_of_connects_is_taken_at_once(ckpts):
    """Forty connects complete while the server accepts none yet (the
    stdlib's listen backlog of 5 drops the SYNs past it, and a client sends
    its SYN again only after a second)."""
    server = serve.make_server(["--ckpt", ckpts[False], "--port", "0", "--device", "cpu",
                                "--workers", "4"])
    host, port = server.server_address[:2]
    socks = []
    try:
        for _ in range(40):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.settimeout(0.5)
            s.connect((host, port))
            socks.append(s)
    finally:
        for s in socks:
            s.close()
        server.server_close()
    assert len(socks) == 40


def test_stream_client_tool(servers):
    server = servers["single"]
    wav = _audio(SR + 4321, seed=7)
    url = "http://%s:%d/stream" % server.server_address[:2]
    status, out, stats = stream_client.stream(url, wav, SR, chunk_ms=100.0)
    assert status == 200
    np.testing.assert_array_equal(out, _stream_ref(server, wav))
    assert 0.0 < stats["first_audio_s"] <= stats["wall_s"] and stats["max_lag_s"] > 0.0


def test_serve_load_tool(servers):
    """The load tool's levels and its confinement check, against the
    --workers and the --fixed_batch servers."""
    for mode in ("workers", "fixed"):
        out = serve_load.run_load(servers[mode].server_address[1], [1, 3], 2, [0.5, 1.5],
                                  fixed_batch=mode == "fixed")
        assert out["identity_ok"] and set(out["levels"]) == {"1", "3"}
        for level, res in out["levels"].items():
            assert res["requests"] == 2 * int(level)
            assert 0.0 < res["p50_ms"] <= res["p99_ms"] <= res["max_ms"]
            assert res["aggregate_rtf"] > 0.0
        if mode == "fixed":
            assert out["probe_exact_frac"] == 1.0


def test_stream_on_a_bidirectional_checkpoint_answers_400(ckpts):
    server = _serve(["--ckpt", ckpts[True], "--port", "0", "--device", "cpu"])
    try:
        assert server.stream_proto is None
        status, body = _post(server, "/stream", b"\x00" * 64)
        assert status == 400 and b"unidirectional" in body
        url = "http://%s:%d/stream" % server.server_address[:2]
        status, body, _ = stream_client.stream(url, _audio(SR, seed=8), SR)
        assert status == 400 and b"unidirectional" in body
        status, _ = _post(server, "/enhance", _wav_body(_audio(8000, seed=6)))
        assert status == 200
    finally:
        server.shutdown()
        server.server_close()


def test_refused_flags_and_the_card_default(ckpts, capsys):
    """--ckpt / --artifact follow the JAX server's rules: exactly one of
    them, and with --artifact no --mesh (artifact serving is single-device),
    --target_level, --upstream_ckpt / --dckpt or --fixed_batch (export-time
    choices, or the checkpoint's)."""
    ckpt = ["--ckpt", ckpts[False]]
    art = ["--artifact", "no-artifact-dir"]
    for argv, item in ((art + ["--mesh", "2"], "--artifact serving is single-device"),
                       (ckpt + art, "exactly one"),
                       ([], "exactly one of --ckpt"),
                       (art + ["--target_level", "-20"], "--target_level is baked"),
                       (art + ["--upstream_ckpt", "x"], "export time"),
                       (art + ["--dckpt", "x"], "export time"),
                       (art + ["--fixed_batch"], "--fixed_batch needs --ckpt")):
        with pytest.raises(SystemExit):
            serve.make_server(argv + ["--device", "cpu"])
        assert item in capsys.readouterr().err
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.make_server(["--ckpt", ckpts[False], "--port", "0"])


def test_kernel_build_path_from_two_threads_runs_one_compiler(tmp_path, monkeypatch):
    """Two handler threads reaching a kernel's first call at once start one
    compiler and load one library (``ops/cuda/_build.load`` holds a lock
    around the build and the load). The compiler is a stub that records its
    calls and copies an existing shared library to its ``-o`` path."""
    from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a source the stub never reads\n")
    calls = tmp_path / "calls"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f"echo call >> '{calls}'\n"
        "sleep 0.5\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=\"$2\"; shift; done\n"
        f"cp '{torch._C.__file__}' \"$out\"\n")
    stub.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "_loaded", {})
    barrier = threading.Barrier(2)
    libs = []

    def first_call():
        barrier.wait()
        libs.append(_build.load("k"))

    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert calls.read_text().split() == ["call"]
    assert len(libs) == 2 and libs[0] is libs[1]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [_build.library_path("k").name, _build.library_path("k").with_suffix(".log").name])
