"""The one-direction LSTM in bf16 (``--compute_dtype bf16``) against the JAX
package, on the CPU.

JAX's only form of a one-direction layer is the ``lax.scan`` cell
(``LstmCellScan`` running ``_lstm_scan``). In bf16 its step product takes h
rounded to bf16 against a bf16 W_hh^T, h and c stay f32; the jaxpr of its
gradient rounds the carried dh product to bf16 once a step and sums the
cotangent of W_hh^T as a bf16 carry of the reverse scan, rounding after every
step. The port's bf16-h form of B1 / B2 fwd / B2 bwd and its dW_hh^T kernel
(``ops/cuda/lstm_kernel.py``, ``h_bf16=True``) compute that function; on the
CPU the wrappers run their plain versions, which these tests hold:

- the plain forms against ``_lstm_scan`` in bf16: hs, dxw and the carried
  (hT, cT), and dW_hh^T to one bf16 unit in the last place on a share of its
  elements (``DW_SHARE``); an f32 sum rounded once at the end, which lies as
  far from JAX's bf16 gradient as bf16 lies from f32, fails that check at
  both lengths;
- the kernels' PyTorch models (the cluster forward, the three-phase
  backward) against the plain versions;
- the one-direction ``LSTM`` / ``Residual`` heads within the window of
  ``tests/test_torch_port_bf16.py`` and every w_hh gradient to the same
  ulp check; a JAX bf16 one-direction checkpoint served by the port, also
  over HTTP (``/enhance``, ``/stream``);
  ``StatefulStreamer`` on a bf16 head against JAX's streamer and the port's
  offline path; both scoring engines on bf16 heads against the JAX
  package's (embeddings and the ``match > 0`` set); ``run_downstream``
  training a one-direction ``Residual`` in bf16 and resuming in bf16;
- the bidirectional bf16 head, whose reference is JAX's Pallas path, held
  against JAX's default scan path too, within the window (ROADMAP §C,
  "Checked").
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import serve as j_serve
from speech_enhancement_by_s3prl_tpu.active import sampler as j_sampler
from speech_enhancement_by_s3prl_tpu.models import heads as j_heads
from speech_enhancement_by_s3prl_tpu.models.lstm import _lstm_scan
from speech_enhancement_by_s3prl_tpu.objectives import build_objective as j_objective
from speech_enhancement_by_s3prl_tpu.ops.features import OnlinePreprocessor as JPre
from speech_enhancement_by_s3prl_tpu.ops.features import get_feat_config as j_feat
from speech_enhancement_by_s3prl_tpu.ops.streaming import StatefulStreamer as JStreamer
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from speech_enhancement_by_s3prl_tpu.runner.trainer import StepBuilder as JStepBuilder
from speech_enhancement_by_s3prl_tpu_torch import entry, serve
from speech_enhancement_by_s3prl_tpu_torch.active import sampler
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from speech_enhancement_by_s3prl_tpu_torch.objectives import build_objective
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
from speech_enhancement_by_s3prl_tpu_torch.ops.features import (
    OnlinePreprocessor,
    get_feat_config,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import StatefulStreamer
from speech_enhancement_by_s3prl_tpu_torch.runner import optim
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
    find_resume_ckpt,
    load_checkpoint,
)
from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import StepBuilder
from tests.test_torch_port_bf16 import (
    PARAM_NEAR,
    _audio,
    _head_inputs,
    _window_grads,
    window,
)
from tests.test_torch_port_runner import _config, _flags, _write_yaml, corpus  # noqa: F401
from tests.test_torch_port_serve_http import (
    _pcm,
    _post,
    _quantized,
    _serve,
    _stream_ref,
    _wav_body,
)
from tests.test_torch_port_stream_stateful import _drive, _rel, _wav

BF16 = torch.bfloat16
# dW_hh^T within one bf16 unit in the last place of JAX's on at least this
# share of its elements. The port and JAX add the same bf16 numbers in the
# same order; only a step's sum over the batch rows runs in another order,
# which can flip one rounding (and a later step's cancellation can widen that
# one unit). Measured 1.0 at every case here, and 0.999 at (B, T, H) = (6,
# 200, 16); an f32 sum rounded once gives 0.66 (T = 29) and 0.33 (T = 200).
DW_SHARE = 0.99
# hs against the scan, absolute: the same exact products (bf16 x bf16) summed
# in other orders; a flipped rounding of h to bf16 (2^-9 of |h|) moves the
# later steps by ~1e-6. Measured 9e-8 at T = 29, 1.1e-6 at T = 200.
HS_TOL = 1e-5
# dxw relative to its largest |value|, by T: a flipped rounding of the carried
# dh product moves an element by up to 2^-9 of the carry. Measured 1.4e-7 (T =
# 29) and 4.7e-5 (T = 200); the f32 backward on the same residuals (h and the
# carry not rounded) is 9e-4 and 6.3e-4 away.
DXW_TOL = {29: 1e-5, 200: 2e-4}
# an embedding coordinate: within one bf16 unit of JAX's (the rounded W_ih /
# W_hh gradients) or EMB_ATOL of the largest |coordinate| (the f32 ones, as
# tests/test_torch_port_active.py holds them), on at least EMB_SHARE of them
EMB_ATOL, EMB_SHARE = 1e-5, 0.99
# a served waveform, relative to its RMS: the same function in other
# summation orders (tests/test_torch_port_stream_stateful.py's limit)
WAV_TOL = 5e-5
ONE_DIR = dict(hidden_size=16, num_layers=2, bidirectional=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one thread (a busy multi-worker run
    starves torch's default pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ulps(a, b) -> np.ndarray:
    """Elementwise distance in bf16 units in the last place of two arrays of
    bf16 values held in f32: their bf16 bit patterns ordered as integers."""
    def ordered(x):
        bits = torch.from_numpy(np.array(x, np.float32)).to(BF16)
        bits = bits.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs().numpy()


def bf16_valued(x) -> bool:
    x = np.array(x, np.float32)
    return np.array_equal(torch.from_numpy(x).to(BF16).float().numpy(), x)


def ulp_share(got, want) -> float:
    """Share of elements within one bf16 unit; both must hold bf16 values."""
    assert bf16_valued(got) and bf16_valued(want)
    return float(np.mean(ulps(got, want) <= 1))


# -- the plain forms against the scan ------------------------------------------------

def _scan_inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((4 * H, H)) / np.sqrt(H)).astype(np.float32)
    cot = rng.standard_normal((B, T, H)).astype(np.float32)
    return xw, w_hh, cot


def _jax_scan_grads(xw, w_hh, cot, dt):
    """hs and the gradients of xw and W_hh of JAX's scan cell in ``dt``,
    unrolled by 4 as ``LstmCellScan`` runs it."""
    H = w_hh.shape[1]

    def loss(xw, w_hh):
        hs = _lstm_scan(xw, w_hh.astype(dt).T, H, 4, dt)
        return (hs * cot).sum(), hs

    (_, hs), (dxw, dw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(xw), jnp.asarray(w_hh))
    return np.asarray(hs), np.asarray(dxw), np.asarray(dw)


def _port_scan_grads(xw, w_hh, cot):
    """The port's one-direction layer from xw: LstmBidirTm in its bf16-h form,
    W_hh^T handed in with bf16 values, as ``LSTMStack`` hands it."""
    x = torch.from_numpy(xw).requires_grad_()
    w = torch.from_numpy(w_hh).requires_grad_()
    hs = L.lstm_bidir_tm(x[None].contiguous(), w.T[None].to(BF16).float().contiguous(),
                         h_bf16=True)
    dxw, dw = torch.autograd.grad((hs[0] * torch.from_numpy(cot)).sum(), [x, w])
    return hs[0].detach().numpy(), dxw.numpy(), dw.numpy()


@pytest.mark.parametrize("T", [29, 200])
def test_plain_bf16_h_forms_match_jax_scan_cell(T):
    xw, w_hh, cot = _scan_inputs(2, T, 16, seed=T)
    jhs, jdxw, jdw = _jax_scan_grads(xw, w_hh, cot, jnp.bfloat16)
    hs, dxw, dw = _port_scan_grads(xw, w_hh, cot)
    np.testing.assert_allclose(hs, jhs, rtol=0, atol=HS_TOL)
    assert np.abs(dxw - jdxw).max() <= DXW_TOL[T] * np.abs(jdxw).max()
    assert L.lstm_bidir_tm_fc.launches == L.lstm_bidir_tm_bwd.launches == 0
    assert ulp_share(dw, jdw) >= DW_SHARE
    # an f32 sum rounded once: the f32 backward's dW_hh^T on the same
    # residuals, rounded to bf16 at the end, falls outside the check
    t = [torch.from_numpy(a)[None] for a in (xw, cot)]
    w_t = torch.from_numpy(w_hh).T[None].to(BF16).float().contiguous()
    hs_t, cs_t = L.lstm_bidir_tm_fc_ref(t[0], w_t, h_bf16=True)
    dxw_t, _ = L.lstm_bidir_tm_bwd_ref(t[0], w_t, hs_t, cs_t, t[1], h_bf16=True)
    once = torch.matmul(torch.cat([torch.zeros_like(hs_t[:, :, :1]), hs_t[:, :, :-1]], 2)
                        .to(BF16).float().reshape(1, -1, 16).transpose(1, 2),
                        dxw_t.reshape(1, -1, 64))[0].T.to(BF16).float().numpy()
    assert ulp_share(once, jdw) < DW_SHARE


def test_plain_bf16_h_form_with_a_carried_state_matches_jax_scan_cell():
    B, T, H = 3, 17, 16
    xw, w_hh, _ = _scan_inputs(B, T, H, seed=5)
    rng = np.random.default_rng(6)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    c0 = rng.standard_normal((B, H)).astype(np.float32)
    w_t = jnp.asarray(w_hh).astype(jnp.bfloat16).T
    want, (wh, wc) = _lstm_scan(jnp.asarray(xw), w_t, H, 4, jnp.bfloat16,
                                init_state=(jnp.asarray(h0), jnp.asarray(c0)),
                                return_final=True)
    tw = torch.from_numpy(w_hh).T[None].to(BF16).float().contiguous()
    state = (torch.from_numpy(h0)[None], torch.from_numpy(c0)[None])
    hs, (hT, cT) = L.lstm_bidir_tm(torch.from_numpy(xw)[None], tw, state=state,
                                   return_state=True, h_bf16=True)
    for got, ref in ((hs[0], want), (hT[0], wh), (cT[0], wc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=HS_TOL)
    # h0 is rounded for the first product only: the f32 h0 gives other bits
    # than its rounded copy, and the returned hT, cT are not rounded
    rounded = (state[0].to(BF16).float(), state[1])
    assert torch.equal(L.lstm_bidir_tm(torch.from_numpy(xw)[None], tw, state=rounded,
                                       h_bf16=True), hs)
    assert not bf16_valued(hT) and not bf16_valued(cT)
    # the f32 form of the same call rounds nothing and differs
    assert not torch.equal(L.lstm_bidir_tm(torch.from_numpy(xw)[None], tw, state=state), hs)
    assert L.lstm_bidir_tm.launches == L.lstm_bidir_tm.h_bf16 == 0


@pytest.mark.parametrize("ndir,B,T,H,batch_block", [(1, 3, 9, 16, 2), (2, 2, 5, 8, 1),
                                                     (1, 1, 1, 24, 1)])
def test_kernel_models_of_the_bf16_h_forms_match_the_plain_versions(ndir, B, T, H,
                                                                     batch_block):
    """The cluster forward (``lstm_bidir_tm_fwd_model``) and the three-phase
    backward (``lstm_bidir_tm_bwd_model``, whose third phase is the dW_hh^T
    kernel's plain version) in the bf16-h form against the plain versions;
    with W_hh^T holding bf16 values the forward's slices add exact products."""
    rng = np.random.default_rng(B + T)
    xw = torch.from_numpy(rng.standard_normal((ndir, B, T, 4 * H)).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.standard_normal((ndir, H, 4 * H))).astype(np.float32))
    w = w.to(BF16).float()
    dhs = torch.from_numpy(rng.standard_normal((ndir, B, T, H)).astype(np.float32))
    h0 = torch.from_numpy((0.5 * rng.standard_normal((ndir, B, H))).astype(np.float32))
    hs, cs = L.lstm_bidir_tm_fc_ref(xw, w, h_bf16=True)
    mhs, mcs = L.lstm_bidir_tm_fwd_model(xw, w, batch_block, with_cell=True, h_bf16=True)
    torch.testing.assert_close(mhs, hs, rtol=0, atol=1e-6)
    torch.testing.assert_close(mcs, cs, rtol=0, atol=1e-6)
    state = (h0, torch.zeros_like(h0))
    torch.testing.assert_close(
        L.lstm_bidir_tm_fwd_model(xw, w, batch_block, state=state, h_bf16=True),
        L.lstm_bidir_tm_ref(xw, w, state=state, h_bf16=True), rtol=0, atol=1e-6)
    dxw, dw = L.lstm_bidir_tm_bwd_ref(xw, w, hs, cs, dhs, h_bf16=True)
    mdxw, mdw = L.lstm_bidir_tm_bwd_model(xw, w, hs, cs, dhs, batch_block=batch_block,
                                          h_bf16=True)
    torch.testing.assert_close(mdxw, dxw, rtol=0, atol=1e-5 * float(dxw.abs().max()))
    assert ulp_share(mdw.numpy(), dw.numpy()) == 1.0
    assert torch.equal(L.lstm_bidir_tm_dw_bf16(hs, dxw), dw)
    assert L.lstm_bidir_tm_dw_bf16.launches == 0
    if T == 1:  # no h_{t-1}: nothing to sum
        assert not dw.any()


# -- the heads ------------------------------------------------------------------------

def _w_hh_share(port_grads, jax_grads):
    names = [n for n in jax_grads if n.endswith(".w_hh")]
    assert names
    return min(ulp_share(np.asarray(port_grads[n]), np.asarray(jax_grads[n])) for n in names)


@pytest.mark.parametrize("name", ["LSTM", "Residual"])
def test_one_direction_heads_in_bf16_match_jax_scan_cell(name):
    cfg = dict(ONE_DIR, activation="Sigmoid" if name == "Residual" else "Identity")
    feats, linears, cot = _head_inputs(31)
    jhead = {dt: j_heads.build_head(name, 12, 10, compute_dtype=dt, **cfg)
             for dt in ("bf16", "f32")}
    params = jhead["f32"].init(jax.random.PRNGKey(7), jnp.asarray(feats),
                               jnp.asarray(linears))["params"]
    sides = {}
    for dt in ("bf16", "f32"):
        def loss(p, dt=dt):
            out, _ = jhead[dt].apply({"params": p}, jnp.asarray(feats), jnp.asarray(linears))
            return (out * cot).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        sides[("jax", dt)] = (np.asarray(out), flax_to_state_dict(jax.device_get(grads)))
        port = t_heads.build_head(name, 12, 10, compute_dtype=dt, **cfg)
        port.load_state_dict(flax_to_state_dict(params))
        out, _ = port(torch.from_numpy(feats), torch.from_numpy(linears))
        names = [n for n, _ in port.named_parameters()]
        g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), list(port.parameters()))
        sides[("port", dt)] = (out.detach().numpy(), {n: x.numpy() for n, x in zip(names, g)})
    _window_grads([sides[k] for k in (("port", "bf16"), ("port", "f32"), ("jax", "bf16"),
                                      ("jax", "f32"))], f"one-direction {name}")
    assert _w_hh_share(sides[("port", "bf16")][1], sides[("jax", "bf16")][1]) >= DW_SHARE


@pytest.fixture(scope="module")
def one_dir_bf16_ckpt(tmp_path_factory):
    """A checkpoint written by the JAX package for the flagship's features
    into a one-direction Residual (2 layers of 16) with ``Paras.compute_dtype``
    bf16, on seeded weights."""
    small = dict(hidden_size=16, num_layers=2, bidirectional=False)
    _, model = entry.build(device="cpu", generator=torch.Generator().manual_seed(4), **small)
    config, paras = entry.flagship_settings(compute_dtype="bf16", **small)
    path = str(tmp_path_factory.mktemp("bf16_one_direction"))
    j_save_checkpoint(path, 1, state_dict_to_flax(model.state_dict()), None, config, paras)
    return path


def test_jax_bf16_one_direction_checkpoint_served_by_the_port(one_dir_bf16_ckpt):
    """The checkpoint served by both packages: JAX on its scan cell, its only
    form, the port on the bf16-h form, the same function. The served
    waveforms agree to WAV_TOL of their RMS, ten times closer than the port's
    own f32 serving of the same weights (the bf16 form is live)."""
    wav = _audio(9000, 2)
    want = np.asarray(j_serve.build_enhancer(one_dir_bf16_ckpt, 16000, -25.0)(wav))
    port = serve.build_enhancer(one_dir_bf16_ckpt, device="cpu", max_bucket_ms=2000)
    assert port.model.compute_dtype == BF16 and not port.model.lstm.bidirectional
    got = port(wav)
    port.model.compute_dtype = port.model.lstm.compute_dtype = torch.float32
    f32 = port(wav)
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    assert np.abs(got - want).max() <= WAV_TOL * rms
    assert np.abs(f32 - want).max() > 10 * np.abs(got - want).max()


def test_http_server_serves_the_bf16_one_direction_checkpoint(one_dir_bf16_ckpt):
    """``/enhance`` and ``/stream`` of ``serve.make_server`` on the checkpoint:
    the reply's PCM is that of ``build_enhancer`` in this process, and the
    stream's samples are those of the server's bf16 streamer."""
    server = _serve(["--ckpt", one_dir_bf16_ckpt, "--port", "0", "--device", "cpu"])
    try:
        assert server.stream_proto.model.compute_dtype == BF16
        enhancer = serve.build_enhancer(one_dir_bf16_ckpt, device="cpu")
        wav = _audio(3 * 4096 + 1000, 1)
        status, reply = _post(server, "/enhance", _wav_body(wav))
        assert status == 200
        heard = np.rint(np.clip(wav * 32767.0, -32768, 32767)) / 32768.0
        np.testing.assert_array_equal(_pcm(reply),
                                      _quantized(enhancer(heard.astype(np.float32))))
        short = _audio(16000 + 333, 4)
        status, body = _post(server, "/stream", short.astype("<f4").tobytes())
        assert status == 200
        np.testing.assert_array_equal(np.frombuffer(body, "<f4"), _stream_ref(server, short))
    finally:
        server.shutdown()
        server.server_close()


def test_bidirectional_bf16_head_within_the_window_of_jax_scan_path():
    """ROADMAP §C, "Checked": the port's bidirectional bf16 head follows JAX's
    Pallas path (h f32), while JAX's default scan path rounds h to bf16 each
    step; the two lie within the window of each other."""
    cfg = dict(hidden_size=16, num_layers=2, bidirectional=True, activation="Sigmoid",
               cmvn=False)
    feats, linears, cot = _head_inputs(21)
    jhead = {dt: j_heads.build_head("Residual", 12, 10, compute_dtype=dt, use_pallas=False,
                                    **cfg) for dt in ("bf16", "f32")}
    params = jhead["f32"].init(jax.random.PRNGKey(5), jnp.asarray(feats),
                               jnp.asarray(linears))["params"]
    sides = {}
    for dt in ("bf16", "f32"):
        def loss(p, dt=dt):
            out, _ = jhead[dt].apply({"params": p}, jnp.asarray(feats), jnp.asarray(linears))
            return (out * cot).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        sides[("jax", dt)] = (np.asarray(out), flax_to_state_dict(jax.device_get(grads)))
        port = t_heads.build_head("Residual", 12, 10, compute_dtype=dt, **cfg)
        port.load_state_dict(flax_to_state_dict(params))
        out, _ = port(torch.from_numpy(feats), torch.from_numpy(linears))
        names = [n for n, _ in port.named_parameters()]
        g = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), list(port.parameters()))
        sides[("port", dt)] = (out.detach().numpy(), {n: x.numpy() for n, x in zip(names, g)})
    # near <= 1.5 and the upper bound of the ratio, on the output, the whole
    # gradient and each parameter's; the ratio's lower bound does not apply:
    # the port rounds less than the scan path by design (h stays f32), measured
    # 0.40 for dlstm.l0_fwd.w_hh
    order = (("port", "bf16"), ("port", "f32"), ("jax", "bf16"), ("jax", "f32"))
    what = "bidirectional head vs the scan path"
    near, _ = window(*(sides[k][0] for k in order), f"{what} output", low=0.0)
    # the two JAX paths do differ: the port (the Pallas path's function) is not
    # the scan's bf16 output
    assert near > 0.05
    names = sorted(sides[("jax", "f32")][1])
    grads = [[np.asarray(sides[k][1][n], np.float64) for n in names] for k in order]
    scales = [np.sqrt(np.mean(g ** 2)) for g in grads[3]]
    window(*(np.concatenate([g.ravel() / c for g, c in zip(gs, scales)]) for gs in grads),
           f"{what} gradient", low=0.0)
    for i, n in enumerate(names):
        window(*(gs[i] for gs in grads), f"{what} d{n}", PARAM_NEAR, 0.0)


# -- streaming ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_stream_pair():
    fl = [get_feat_config("mel", 0, log=True, delta=2, cmvn=False),
          get_feat_config("linear", 0), get_feat_config("uphase", 0)]
    jfl = [j_feat("mel", 0, log=True, delta=2, cmvn=False), j_feat("linear", 0),
           j_feat("uphase", 0)]
    jpre = JPre(feat_list=jfl, n_mels=8)
    cfg = dict(input_size=jpre.feat_dims()[0], output_size=201, activation="Sigmoid",
               cmvn=False, compute_dtype="bf16", **ONE_DIR)
    model = t_heads.build_head("Residual", generator=torch.Generator().manual_seed(3),
                               **cfg).eval()
    jparams = state_dict_to_flax(model.state_dict())
    jmodel = j_heads.build_head("Residual", **cfg)
    return fl, jfl, (jparams, jmodel, jpre), (model, OnlinePreprocessor(feat_list=fl, n_mels=8))


def test_stateful_streamer_on_a_bf16_head_matches_jax_and_the_offline_path(bf16_stream_pair):
    fl, jfl, (params, jmodel, jpre), (model, pre) = bf16_stream_pair
    assert model.compute_dtype == BF16
    wav = _wav(16000 * 2 + 777, seed=5)
    sizes = np.random.default_rng(5).integers(900, 9000, size=64)
    want = _drive(JStreamer(params, jmodel, jpre, feat_cfg=jfl[0], frames_per_chunk=40),
                  wav, sizes)
    got = _drive(StatefulStreamer(model, pre, feat_cfg=fl[0], frames_per_chunk=40), wav,
                 sizes)
    # the tolerances of tests/test_torch_port_stream_stateful.py: the same
    # function in other summation orders
    assert _rel(got, want) < WAV_TOL
    with torch.inference_mode():
        feats = pre.extract(torch.from_numpy(wav)[None, None], fl)
        predicted, _ = model(feats[0], feats[1])
        offline = pre.istft(predicted, feats[2])
    np.testing.assert_allclose(got, offline[0].numpy(), atol=2e-5)


# -- scoring --------------------------------------------------------------------------

def _score_builders(bidirectional):
    """The JAX and the port's step builders over one bf16 head with the same
    weights (the SISDR objective, 2 layers of 8); a bidirectional head on
    JAX's Pallas path (the port's reference), a one-direction one on its scan
    cell."""
    name = "LSTM" if bidirectional else "Residual"
    cfg = dict(hidden_size=8, num_layers=2, bidirectional=bidirectional,
               compute_dtype="bf16")
    feats = lambda g: [g("linear", 0)] * 3 + [g("phase", 0), g("linear", 1), g("phase", 1)]
    pm = t_heads.build_head(name, input_size=201, output_size=201,
                            generator=torch.Generator().manual_seed(9), **cfg)
    jm = j_heads.build_head(name, input_size=201, output_size=201, use_pallas=bidirectional,
                            **cfg)
    jsb = JStepBuilder(preprocessor=JPre(feat_list=feats(j_feat)), model=jm,
                       objective=j_objective("SISDR"), optimizer=optax.adam(1e-3))
    psb = StepBuilder(preprocessor=OnlinePreprocessor(feat_list=feats(get_feat_config)),
                      model=pm, objective=build_objective("SISDR"),
                      optimizer=optim.build_optimizer("Adam", 1e-3, 0.07, 10))
    return jsb, state_dict_to_flax(pm.state_dict()), psb


def _score_batch():
    rng = np.random.default_rng(8)
    wavs = (0.1 * rng.standard_normal((3, 3, 4000))).astype(np.float32)
    return wavs, np.array([4000, 3000, 2000])


def _close_embeddings(got, want):
    """The share of coordinates within one bf16 unit of JAX's, or EMB_ATOL of
    the largest |coordinate|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    near = np.abs(got - want) <= EMB_ATOL * np.abs(want).max()
    return float(np.mean(near | (ulps(got, want) <= 1)))


@pytest.fixture(scope="module")
def scoring_sides():
    """By (bidirectional, impl): JAX's embeddings, the port's, and the port's
    query (``mean=True``) of the batch. A bidirectional bf16 head's per-row
    reference is ``jax.grad`` of each row's own loss on the Pallas path, one
    row at a time (JAX's ``mean=True`` on a batch of that row): ``vmap(grad)``
    does not take the Pallas kernel; it is what ``vmap(grad)`` computes. Its
    first row is also the reference of the port's ``mean=True`` on that row.
    A one-direction bf16 head's reference is JAX's ``vmap(grad)`` through the
    scan cell."""
    wavs, lengths = _score_batch()
    out = {}
    for bidirectional in (True, False):
        jsb, params, psb = _score_builders(bidirectional)
        port = sampler.make_scoring_fn(psb, None)
        query = port(psb.model, wavs, lengths, mean=True).numpy()
        for impl in (("vmap", "capture") if bidirectional else ("vmap",)):
            if bidirectional and impl == "vmap":
                jrow = j_sampler.make_scoring_fn(jsb, None, impl="vmap")
                want = np.concatenate([np.asarray(jrow(params, wavs[i:i + 1],
                                                       lengths[i:i + 1], mean=True))
                                       for i in range(len(wavs))])
                out["row_mean"] = (want[:1], port(psb.model, wavs[:1], lengths[:1],
                                                  mean=True).numpy())
            else:
                want = np.asarray(j_sampler.make_scoring_fn(jsb, None, impl=impl)(
                    params, wavs, lengths))
            got = sampler.make_scoring_fn(psb, None, impl=impl)(psb.model, wavs, lengths)
            out[(bidirectional, impl)] = (want, got.numpy(), query)
    return out


@pytest.mark.parametrize("bidirectional,impl", [(True, "vmap"), (True, "capture"),
                                                (False, "vmap")],
                         ids=["bidir-vmap", "bidir-capture", "one_direction-vmap"])
def test_scoring_engines_on_bf16_heads_match_jax(scoring_sides, bidirectional, impl):
    """Embeddings close to JAX's, and the same candidates pass ``match > 0``
    against the batch's query."""
    want, got, query = scoring_sides[(bidirectional, impl)]
    assert _close_embeddings(got, want) >= EMB_SHARE
    q = torch.from_numpy(query)
    assert torch.equal(sampler.thresholding(sampler.matching(q, torch.from_numpy(got))),
                       sampler.thresholding(sampler.matching(q, torch.from_numpy(want))))
    if (bidirectional, impl) == (True, "vmap"):
        assert _close_embeddings(*scoring_sides["row_mean"][::-1]) >= EMB_SHARE


def test_per_row_engine_rounds_a_bf16_head_as_jax_does(scoring_sides):
    """Where the per-row engine of a bf16 head rounds: a bidirectional head's
    W_ih / W_hh coordinates hold bf16 values (the capture engine's do not),
    and a one-direction head takes one backward per row, whose dW_hh is the
    step-by-step bf16 sum."""
    _, vmap_rows, _ = scoring_sides[(True, "vmap")]
    _, capture_rows, _ = scoring_sides[(True, "capture")]
    _, one_dir_rows, _ = scoring_sides[(False, "vmap")]
    def head(bidirectional):
        return t_heads.build_head("LSTM" if bidirectional else "Residual", 201, 201,
                                  hidden_size=8, num_layers=2, bidirectional=bidirectional,
                                  compute_dtype="bf16")

    bidir = head(True)
    params = dict(bidir.named_parameters())
    names = sampler._leaf_order(params)
    at = np.cumsum([0] + [params[n].numel() for n in names])
    for i, n in enumerate(names):
        if n.endswith((".w_ih", ".w_hh")):
            assert bf16_valued(vmap_rows[:, at[i]:at[i + 1]]), n
            assert not bf16_valued(capture_rows[:, at[i]:at[i + 1]]), n
    assert sampler._captures(bidir)
    one_dir = head(False)
    assert not sampler._captures(one_dir)
    params = dict(one_dir.named_parameters())
    names = sampler._leaf_order(params)
    at = np.cumsum([0] + [params[n].numel() for n in names])
    w_hh = [i for i, n in enumerate(names) if n.endswith(".w_hh")]
    assert w_hh and all(bf16_valued(one_dir_rows[:, at[i]:at[i + 1]]) for i in w_hh)


# -- training -------------------------------------------------------------------------

def test_run_downstream_trains_a_one_direction_residual_in_bf16_and_resumes(corpus, tmp_path):  # noqa: F811
    from speech_enhancement_by_s3prl_tpu_torch import run_downstream

    config = _config(corpus, total_step=2, eval_step=2, save_step=2)
    config["model"]["Residual"]["bidirectional"] = False
    cfg = _write_yaml(tmp_path / "cfg.yaml", config)
    run_downstream.main(["--config", cfg, *_flags(tmp_path), "--compute_dtype", "bf16"])
    run_dir = tmp_path / "run"
    payload = load_checkpoint(find_resume_ckpt(str(run_dir)))
    assert payload["Settings"]["Paras"]["compute_dtype"] == "bf16"
    assert payload["Global_step"] == 3
    args, config = run_downstream.get_downstream_args(["--resume", str(run_dir), "--cpu"])
    assert args.compute_dtype == "bf16"
    config["runner"]["total_step"] = 3
    runner = run_downstream.build_runner(args, config)
    model = runner.downstream_model
    assert model.compute_dtype == BF16 and not model.lstm.bidirectional
    runner.set_model()
    runner.train()
    assert load_checkpoint(find_resume_ckpt(str(run_dir)))["Global_step"] == 4


def test_one_direction_bf16_train_step_runs_the_bf16_h_forms(monkeypatch):
    """A train step of a one-direction bf16 head goes through the forms: B2 fwd
    and B2 bwd with ``h_bf16`` (each layer once), nothing of the f32 form."""
    seen = []
    fc, bwd = L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd

    def record(fn, name, at):  # h_bf16 is argument `at`
        def wrapped(*args, **kw):
            seen.append((name, args[at] if len(args) > at else kw.get("h_bf16", False)))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(L, "lstm_bidir_tm_fc", record(fc, "fwd", 2))
    monkeypatch.setattr(L, "lstm_bidir_tm_bwd", record(bwd, "bwd", 5))
    builder = dataclasses.replace(
        entry.build_train(device="cpu", compute_dtype="bf16", bidirectional=False,
                          hidden_size=16, num_layers=2),
        optimizer=optim.build_optimizer("Adam", 1e-3, 0.07, 10))
    rng = np.random.default_rng(1)
    wavs = (0.1 * rng.standard_normal((2, 3, 4000))).astype(np.float32)
    _, stats = builder.train_step(builder.init_state(), torch.from_numpy(wavs),
                                  torch.tensor([4000, 3000]))
    assert np.isfinite(float(stats["loss"]))
    assert seen == [("fwd", True)] * 2 + [("bwd", True)] * 2
