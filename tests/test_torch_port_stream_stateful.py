"""Carried recurrent state and the stateful streamer of the port against the
JAX package.

- B1 continuing from (h0, c0): the plain recurrence against JAX
  ``_lstm_scan(..., init_state=, return_final=True)``, the kernel's model
  ``lstm_bidir_tm_fwd_model`` against the plain version, two carried pieces
  against one run, and the refusals (autograd with a state, a bidirectional
  stack);
- the one-direction ``LSTMStack`` and the ``LSTM`` / ``Residual`` heads with
  ``lstm_state`` against the JAX modules through the weight bridge;
- ``ops/streaming.StatefulStreamer`` against the JAX ``StatefulStreamer`` and
  against the port's offline enhance, its emitted length, latency,
  ``clone()`` / ``reset()`` and refusals.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from speech_enhancement_by_s3prl_tpu.models.heads import build_head as j_build_head
from speech_enhancement_by_s3prl_tpu.models.lstm import LSTMStack as JLSTMStack
from speech_enhancement_by_s3prl_tpu.models.lstm import _lstm_scan
from speech_enhancement_by_s3prl_tpu.ops.features import (
    OnlinePreprocessor as JPreprocessor,
)
from speech_enhancement_by_s3prl_tpu.ops.streaming import StatefulStreamer as JStreamer
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.models.heads import build_head
from speech_enhancement_by_s3prl_tpu_torch.models.lstm import LSTMStack
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
from speech_enhancement_by_s3prl_tpu_torch.ops.features import (
    OnlinePreprocessor,
    get_feat_config,
)
from speech_enhancement_by_s3prl_tpu_torch.ops.streaming import StatefulStreamer

# B1's plain recurrence against the JAX scan: the same f32 operations, sums in
# other orders (the existing B1 tolerance)
SCAN_TOL = 2e-6
# modules through the weight bridge (projection, recurrence, Dense)
MODULE_TOL = 5e-6
# waveforms, relative to the RMS (tests/test_torch_port_streaming.py)
WAV_TOL = 5e-5
# the streamer against the offline path, absolute: the JAX test's own limit
# (tests/test_streaming_stateful.py)
OFFLINE_TOL = 2e-5
HIDDEN, LAYERS, N_MELS = 16, 2, 8


def _state_inputs(ndir, B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((ndir, B, T, 4 * H)).astype(np.float32)
    w = (0.3 * rng.standard_normal((ndir, H, 4 * H))).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((ndir, B, H))).astype(np.float32)
    c0 = rng.standard_normal((ndir, B, H)).astype(np.float32)
    return xw, w, h0, c0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("ndir,B,T,H", [(1, 3, 17, 16), (2, 2, 9, 8), (1, 1, 1, 24)])
def test_plain_recurrence_with_state_matches_jax_scan(ndir, B, T, H):
    xw, w, h0, c0 = _state_inputs(ndir, B, T, H, seed=B + T)
    want, (wh, wc) = _lstm_scan(jnp.asarray(xw), jnp.asarray(w), H, 1, jnp.float32,
                                init_state=(jnp.asarray(h0), jnp.asarray(c0)),
                                return_final=True)
    txw, tw, th0, tc0 = _t(xw, w, h0, c0)
    hs, (hT, cT) = L.lstm_bidir_tm(txw, tw, state=(th0, tc0), return_state=True)
    for got, ref in ((hs, want), (hT, wh), (cT, wc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=SCAN_TOL)
    assert L.lstm_bidir_tm.launches == 0  # CPU tensors: the plain version
    # with no state and no return_state, the stateless call's bits
    assert torch.equal(L.lstm_bidir_tm(txw, tw), L.lstm_bidir_tm_ref(txw, tw))
    zeros = torch.zeros_like(th0)
    hz, (hzT, czT) = L.lstm_bidir_tm(txw, tw, state=(zeros, zeros), return_state=True)
    assert torch.equal(hz, L.lstm_bidir_tm(txw, tw)) and torch.equal(hzT, hz[:, :, -1])


@pytest.mark.parametrize("batch_block", [1, 2])
def test_kernel_model_with_state_matches_plain(batch_block):
    xw, w, h0, c0 = _t(*_state_inputs(1, 3, 13, 24, seed=5))
    hs, cs = L.lstm_bidir_tm_fwd_model(xw, w, batch_block=batch_block, with_cell=True,
                                       state=(h0, c0))
    ref, (rh, rc) = L.lstm_bidir_tm_ref(xw, w, state=(h0, c0), return_state=True)
    assert float((hs - ref).abs().max()) <= 1e-6
    assert float((cs[:, :, -1] - rc).abs().max()) <= 1e-6


def test_two_carried_pieces_equal_one_run():
    xw, w, h0, c0 = _t(*_state_inputs(1, 2, 20, 16, seed=7))
    whole, (h, c) = L.lstm_bidir_tm(xw, w, state=(h0, c0), return_state=True)
    a, st = L.lstm_bidir_tm(xw[:, :, :7].contiguous(), w, state=(h0, c0), return_state=True)
    b, (h2, c2) = L.lstm_bidir_tm(xw[:, :, 7:].contiguous(), w, state=st, return_state=True)
    assert torch.equal(torch.cat([a, b], dim=2), whole)
    assert torch.equal(h2, h) and torch.equal(c2, c)
    # the kernel's model too, and T = 0 hands the state through
    m1 = L.lstm_bidir_tm_fwd_model(xw[:, :, :7], w, with_cell=True, state=(h0, c0))
    m2 = L.lstm_bidir_tm_fwd_model(xw[:, :, 7:], w, state=(m1[0][:, :, -1], m1[1][:, :, -1]))
    assert torch.equal(torch.cat([m1[0], m2], dim=2),
                       L.lstm_bidir_tm_fwd_model(xw, w, state=(h0, c0)))
    empty, (he, ce) = L.lstm_bidir_tm(xw[:, :, :0], w, state=(h0, c0), return_state=True)
    assert empty.shape == (1, 2, 0, 16) and he is h0 and ce is c0


def test_state_refusals():
    xw, w, h0, c0 = _t(*_state_inputs(1, 2, 5, 8, seed=1))
    with pytest.raises(RuntimeError, match="A3"):
        L.lstm_bidir_tm(xw.requires_grad_(), w, state=(h0, c0))
    with pytest.raises(RuntimeError, match="A3"):
        L.lstm_bidir_tm(xw, w, return_state=True)
    with pytest.raises(ValueError, match="h0 must be"):
        L.lstm_bidir_tm(xw.detach(), w, state=(h0[:, :1], c0))
    stack = LSTMStack(5, 8, num_layers=1, bidirectional=True)
    x = torch.zeros(2, 4, 5)
    with pytest.raises(ValueError, match="unidirectional"):
        stack(x, return_state=True)
    with pytest.raises(ValueError, match="unidirectional"):
        stack(x, initial_state=[(torch.zeros(2, 8), torch.zeros(2, 8))])


def test_one_direction_stack_with_state_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 20, 5)).astype(np.float32)
    jstack = JLSTMStack(HIDDEN, num_layers=LAYERS, bidirectional=False)
    params = jstack.init(jax.random.PRNGKey(0), jnp.asarray(x))
    stack = LSTMStack(5, HIDDEN, num_layers=LAYERS)
    stack.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    init = [tuple((0.5 * rng.standard_normal((3, HIDDEN))).astype(np.float32)
                  for _ in range(2)) for _ in range(LAYERS)]
    want, wstate = jstack.apply(params, jnp.asarray(x[:, 9:]),
                                initial_state=[tuple(map(jnp.asarray, s)) for s in init],
                                return_state=True)
    with torch.no_grad():
        got, state = stack(torch.from_numpy(x[:, 9:]),
                           initial_state=[tuple(map(torch.from_numpy, s)) for s in init],
                           return_state=True)
        # split in two carried pieces = one pass
        full = stack(torch.from_numpy(x))
        a, st = stack(torch.from_numpy(x[:, :9]), return_state=True)
        b, _ = stack(torch.from_numpy(x[:, 9:]), initial_state=st, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODULE_TOL)
    for (h, c), (wh, wc) in zip(state, wstate):
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=MODULE_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(wc), atol=MODULE_TOL)
    assert torch.equal(torch.cat([a, b], dim=1), full)


@pytest.mark.parametrize("name", ["LSTM", "Residual"])
def test_heads_with_lstm_state_match_jax(name):
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 15, 12)).astype(np.float32)
    lin = rng.random((2, 15, 201)).astype(np.float32)
    cfg = dict(input_size=12, output_size=201, hidden_size=HIDDEN, num_layers=LAYERS,
               bidirectional=False)
    jhead = j_build_head(name, **cfg)
    params = jhead.init(jax.random.PRNGKey(1), features=jnp.asarray(feats),
                        linears=jnp.asarray(lin))
    head = build_head(name, **cfg).eval()
    head.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    init = tuple(tuple((0.3 * rng.standard_normal((2, HIDDEN))).astype(np.float32)
                       for _ in range(2)) for _ in range(LAYERS))
    want, waux = jhead.apply(params, features=jnp.asarray(feats), linears=jnp.asarray(lin),
                             lstm_state=tuple(tuple(map(jnp.asarray, s)) for s in init))
    with torch.no_grad():
        got, aux = head(torch.from_numpy(feats), torch.from_numpy(lin),
                        lstm_state=tuple(tuple(map(torch.from_numpy, s)) for s in init))
        plain, plain_aux = head(torch.from_numpy(feats), torch.from_numpy(lin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=MODULE_TOL)
    for (h, c), (wh, wc) in zip(aux["lstm_state"], waux["lstm_state"]):
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=MODULE_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(wc), atol=MODULE_TOL)
    assert "lstm_state" not in plain_aux


# -- the streamer -------------------------------------------------------------

def _feat_list(delta):
    down = get_feat_config("mel", 0, log=True, delta=delta, cmvn=False)
    return [down, get_feat_config("linear", 0), get_feat_config("uphase", 0)]


@pytest.fixture(scope="module", params=[0, 2], ids=["delta0", "delta2"])
def pair(request):
    """The JAX streamer's (params, model, preprocessor) and the port's (model,
    preprocessor) with bridged weights, at ``delta`` 0 and 2."""
    fl = _feat_list(request.param)
    jpre = JPreprocessor(feat_list=fl, n_mels=N_MELS)
    cfg = dict(input_size=jpre.feat_dims()[0], output_size=201, hidden_size=HIDDEN,
               num_layers=LAYERS, bidirectional=False, activation="Sigmoid", cmvn=False)
    jmodel = j_build_head("Residual", **cfg)
    f0 = jpre.extract(jnp.zeros((1, 1, 16000), jnp.float32), fl)
    params = jmodel.init(jax.random.PRNGKey(0), features=f0[0], linears=f0[1])
    model = build_head("Residual", **cfg).eval()
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return fl, (params, jmodel, jpre), (model, OnlinePreprocessor(feat_list=fl, n_mels=N_MELS))


def _wav(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _drive(streamer, wav, sizes):
    out, pos = [], 0
    for size in sizes:
        if pos >= len(wav):
            break
        out.append(streamer.push(wav[pos:pos + int(size)]))
        pos += int(size)
    if pos < len(wav):
        out.append(streamer.push(wav[pos:]))
    out.append(streamer.flush())
    return np.concatenate(out)


def _rel(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.sqrt(np.mean(ref ** 2)))


def test_streamer_matches_jax_streamer(pair):
    fl, (params, jmodel, jpre), (model, pre) = pair
    wav = _wav(16000 * 3 + 777, seed=0)  # not hop or chunk aligned
    sizes = np.random.default_rng(0).integers(900, 9000, size=64)  # ragged pushes
    want = _drive(JStreamer(params, jmodel, jpre, feat_cfg=fl[0], frames_per_chunk=40),
                  wav, sizes)
    got = _drive(StatefulStreamer(model, pre, feat_cfg=fl[0], frames_per_chunk=40), wav,
                 sizes)
    assert _rel(got, want) < WAV_TOL


def test_streamer_matches_offline_enhance(pair):
    """Sample-exact against the port's offline path (features, head, iSTFT
    with the noisy phase), and against the offline renorm when the renorm is
    applied to the concatenation."""
    from speech_enhancement_by_s3prl_tpu_torch.ops.audio import masked_normalize_decibel

    fl, _, (model, pre) = pair
    wav = _wav(16000 * 2 + 333, seed=1)
    got = _drive(StatefulStreamer(model, pre, feat_cfg=fl[0], frames_per_chunk=40), wav,
                 np.random.default_rng(1).integers(500, 7000, size=64))
    with torch.inference_mode():
        feats = pre.extract(torch.from_numpy(wav)[None, None], fl)
        predicted, _ = model(feats[0], feats[1])
        offline = pre.istft(predicted, feats[2])
    assert got.shape == tuple(offline.shape[1:])
    np.testing.assert_allclose(got, offline[0].numpy(), atol=OFFLINE_TOL)
    mask = torch.ones_like(offline, dtype=torch.bool)
    np.testing.assert_allclose(
        masked_normalize_decibel(torch.from_numpy(got)[None], -25.0, mask)[0].numpy(),
        masked_normalize_decibel(offline, -25.0, mask)[0].numpy(), atol=OFFLINE_TOL)


def test_streamer_length_latency_clone_and_reset(pair):
    fl, _, (model, pre) = pair
    hop, F = pre.config.stft.hop_length, 25
    proto = StatefulStreamer(model, pre, feat_cfg=fl[0], frames_per_chunk=F)
    wav = _wav(16000 * 2 + 51, seed=2)
    a = proto.clone()
    emitted, first_at = 0, None
    for i in range(0, len(wav), 1600):  # 100 ms pushes
        emitted += len(a.push(wav[i:i + 1600]))
        if emitted and first_at is None:
            first_at = i + 1600
    total = emitted + len(a.flush())
    assert total == (len(wav) // hop) * hop
    # constant latency: output starts once the chunks of analysis that hold
    # one model chunk plus its 2 * delta rows of right context have arrived,
    # and most of it comes before flush
    frames = -(-(F + 2 * int(fl[0]["delta"])) // F) * F
    assert first_at <= (frames + 2) * hop + 1600
    assert emitted > 0.7 * total
    # clone() and reset() start a fresh stream on the same model: same bits
    once = _drive(proto.clone(), wav, [1600] * 30)
    b = proto.clone()
    b.push(wav[:5000])
    b.reset()
    assert np.array_equal(_drive(b, wav, [1600] * 30), once)
    assert proto._consumed == 0 and proto._state is proto._zero_state


def test_streamer_refusals():
    pre = OnlinePreprocessor(feat_list=_feat_list(2), n_mels=N_MELS)
    d = pre.feat_dims()[0]
    bidir = build_head("Residual", input_size=d, output_size=201, hidden_size=8,
                       num_layers=1, bidirectional=True)
    with pytest.raises(ValueError, match="unidirectional"):
        StatefulStreamer(bidir, pre)
    linear = build_head("LinearResidual", input_size=d, output_size=201, cmvn=False)
    with pytest.raises(ValueError, match="unidirectional"):
        StatefulStreamer(linear, pre)
    uni = build_head("Residual", input_size=d, output_size=201, hidden_size=8,
                     num_layers=1, bidirectional=False)
    with pytest.raises(ValueError, match="cmvn=False"):
        StatefulStreamer(uni, pre, feat_cfg=get_feat_config("mel", 0, log=True, cmvn=True))
    with pytest.raises(ValueError, match="mel features"):
        StatefulStreamer(uni, pre, feat_cfg=get_feat_config("linear", 0))
