"""The port's active-learning sampler against the JAX package on the CPU.

Per-sample gradient embeddings of the port's engines against the JAX
package's on the same weights (``models/convert.py``) and inputs (3 rows of
up to 0.5 s): the ``vmap`` engine against JAX's ``vmap(grad)`` for a
bidirectional ``LSTM`` head (2 layers of 8, L1 and SISDR, ``active_layerid``
0, 1 and None), a one-direction ``Residual`` head, a ``Linear`` head and a
``SpecHead`` (the loop of one backward per utterance); ``capture`` against
JAX's ``capture``; ``mean=True``; ``matching``, ``thresholding``,
``hist_scoring``; the capture-to-vmap positive-scale contract; the capture
streams of the stacks and heads; a bad ``active_layerid``; the fallback of
``capture`` on a head it does not take; ``AsyncSampler``'s lifecycle and
snapshot; and ``metrics.full_f32`` entered from two threads.
"""
import dataclasses
import os
import sys
import threading

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_enhancement_by_s3prl_tpu.active import sampler as j_sampler
from speech_enhancement_by_s3prl_tpu.models.heads import build_head as j_build_head
from speech_enhancement_by_s3prl_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
)
from speech_enhancement_by_s3prl_tpu.objectives import build_objective as j_objective
from speech_enhancement_by_s3prl_tpu.ops.features import OnlinePreprocessor as JPre
from speech_enhancement_by_s3prl_tpu.ops.features import get_feat_config as j_feat
from speech_enhancement_by_s3prl_tpu.runner.trainer import StepBuilder as JStepBuilder
from speech_enhancement_by_s3prl_tpu_torch.active import sampler
from speech_enhancement_by_s3prl_tpu_torch.metrics import full_f32
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.models.heads import build_head
from speech_enhancement_by_s3prl_tpu_torch.models.lstm import Capture, LSTMStack
from speech_enhancement_by_s3prl_tpu_torch.models.transformer import TransformerConfig
from speech_enhancement_by_s3prl_tpu_torch.objectives import build_objective
from speech_enhancement_by_s3prl_tpu_torch.ops.features import (
    OnlinePreprocessor,
    get_feat_config,
)
from speech_enhancement_by_s3prl_tpu_torch.runner import optim
from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import StepBuilder

# Embeddings relative to their largest |value|: the same f32 forward (STFT,
# two small BLSTM layers or a Dense, the objective) and backward with sums in
# other orders; measured at most 1.3e-6
EMB_RTOL = 1e-5
MATCH_ATOL = 1e-5

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


LSTM_CFG = dict(hidden_size=8, num_layers=2, bidirectional=True)
HEADS = {
    "LSTM": ("LSTM", LSTM_CFG),
    "Residual1": ("Residual", dict(hidden_size=8, num_layers=2, bidirectional=False)),
    "Linear": ("Linear", {}),
    "SpecHead": ("SpecHead", {"config": dict(hidden_size=16, num_hidden_layers=1,
                                             num_attention_heads=2, intermediate_size=32)}),
}


def _builders(head, objective, params=None):
    """The JAX and the port's step builders over one head, the port's
    weights carried from the JAX init (or from ``params``)."""
    name, cfg = HEADS[head]
    feats = lambda g: [g("linear", 0)] * 3 + [g("phase", 0), g("linear", 1), g("phase", 1)]
    jcfg = dict(cfg)
    if "config" in cfg:
        jcfg["config"] = JTransformerConfig(**cfg["config"])
    jm = j_build_head(name, input_size=201, output_size=201, **jcfg)
    jsb = JStepBuilder(preprocessor=JPre(feat_list=feats(j_feat)), model=jm,
                       objective=j_objective(objective), optimizer=optax.adam(1e-3))
    if params is None:
        wavs, lengths = _batch()
        params = jax.device_get(jsb.init_state(jax.random.PRNGKey(0), jnp.asarray(wavs),
                                               jnp.asarray(lengths)).params)
    pcfg = dict(cfg)
    if "config" in cfg:
        pcfg["config"] = TransformerConfig(**cfg["config"])
    pm = build_head(name, input_size=201, output_size=201, **pcfg)
    pm.load_state_dict(flax_to_state_dict(params))
    psb = StepBuilder(preprocessor=OnlinePreprocessor(feat_list=feats(get_feat_config)),
                      model=pm, objective=build_objective(objective),
                      optimizer=optim.build_optimizer("Adam", 1e-3, 0.07, 10))
    return jsb, params, psb


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    wavs = (0.1 * rng.standard_normal((3, 3, 8000))).astype(np.float32)
    return wavs, np.array([8000, 6000, 4000])


# (head, objective, active_layerid, impl) of each comparison: the vmap engine
# on the whole grid of the bidirectional head, capture on a part of it (the
# port's capture is held to its vmap engine on the whole grid below)
CASES = [("LSTM", obj, lid, "vmap") for obj in ("L1", "SISDR") for lid in (0, 1, None)]
CASES += [("LSTM", "L1", 0, "capture"), ("LSTM", "L1", None, "capture"),
          ("LSTM", "SISDR", 1, "capture")]
CASES += [("Residual1", "SISDR", lid, "vmap") for lid in (0, None)]
CASES += [("Linear", "sisdr", None, "vmap"), ("SpecHead", "SISDR", None, "vmap")]
MEANS = [("LSTM", "L1", None), ("LSTM", "SISDR", 1)]


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX embedding of CASES and MEANS, computed once."""
    wavs, lengths = _batch()
    sides, out, inits = {}, {}, {}
    for head, obj, lid, impl in CASES + [(h, o, lid, "mean") for h, o, lid in MEANS]:
        if (head, obj) not in sides:
            sides[(head, obj)] = _builders(head, obj, inits.get(head))
            inits[head] = sides[(head, obj)][1]
        jsb, params, _ = sides[(head, obj)]
        fn = j_sampler.make_scoring_fn(jsb, lid, impl="vmap" if impl == "mean" else impl)
        out[(head, obj, lid, impl)] = np.asarray(fn(params, wavs, lengths,
                                                    mean=impl == "mean"))
    return sides, out


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("head,objective,layerid,impl", CASES)
def test_embeddings_match_jax(jax_results, head, objective, layerid, impl):
    sides, want = jax_results
    _, _, psb = sides[(head, objective)]
    wavs, lengths = _batch()
    got = sampler.make_scoring_fn(psb, layerid, impl=impl)(psb.model, wavs, lengths)
    want = want[(head, objective, layerid, impl)]
    assert got.shape == want.shape and got.shape[0] == 3
    assert _rel(got.detach().numpy(), want) <= EMB_RTOL


@pytest.mark.parametrize("head,objective,layerid", MEANS)
def test_mean_embedding_and_matching_match_jax(jax_results, head, objective, layerid):
    sides, want = jax_results
    _, _, psb = sides[(head, objective)]
    wavs, lengths = _batch()
    fn = sampler.make_scoring_fn(psb, layerid)
    q = fn(psb.model, wavs, lengths, mean=True)
    jq = want[(head, objective, layerid, "mean")]
    assert q.shape == jq.shape and q.shape[0] == 1
    assert _rel(q.detach().numpy(), jq) <= EMB_RTOL
    t = fn(psb.model, wavs, lengths)
    jt = want[(head, objective, layerid, "vmap")]
    m = sampler.matching(q, t)
    jm = np.asarray(j_sampler.matching(jnp.asarray(jq), jnp.asarray(jt)))
    np.testing.assert_allclose(m.detach().numpy(), jm, atol=MATCH_ATOL)
    assert np.array_equal(sampler.thresholding(m).numpy(),
                          np.asarray(j_sampler.thresholding(jnp.asarray(jm))))


@pytest.mark.parametrize("layerid", [0, 1, None])
@pytest.mark.parametrize("objective", ["L1", "SISDR"])
def test_capture_equals_vmap_up_to_a_positive_scale(jax_results, objective, layerid):
    """Row i of ``capture`` is row i of ``vmap`` times one positive number
    (the objective's batch-reduction weight of that row), so the matches
    agree. The ratio is read on the coordinates above 1e-4 of a row's
    largest, where f32 rounding of the two backward passes is far below it."""
    sides, _ = jax_results
    _, _, psb = sides[("LSTM", "L1")]
    psb = dataclasses.replace(psb, objective=build_objective(objective))
    wavs, lengths = _batch()
    ev = sampler.make_scoring_fn(psb, layerid)(psb.model, wavs, lengths).detach().numpy()
    ec = sampler.make_scoring_fn(psb, layerid, impl="capture")(
        psb.model, wavs, lengths).detach().numpy()
    for i in range(3):
        m = np.abs(ev[i]) > 1e-4 * np.abs(ev[i]).max()
        r = ec[i][m] / ev[i][m]
        assert r.mean() > 0 and r.std() / r.mean() < 1e-3
    q = sampler.make_scoring_fn(psb, layerid)(psb.model, wavs, lengths, mean=True)
    np.testing.assert_allclose(sampler.matching(q, torch.from_numpy(ev)).numpy(),
                               sampler.matching(q, torch.from_numpy(ec)).numpy(),
                               atol=MATCH_ATOL)


def test_capture_falls_back_on_a_head_it_does_not_take(jax_results):
    sides, _ = jax_results
    _, _, psb = sides[("Residual1", "SISDR")]
    wavs, lengths = _batch()
    with pytest.warns(UserWarning, match="vmap engine"):
        fn = sampler.make_scoring_fn(psb, 0, impl="capture")
    assert fn.impl == "vmap"
    assert torch.equal(fn(psb.model, wavs, lengths),
                       sampler.make_scoring_fn(psb, 0)(psb.model, wavs, lengths))
    _, _, lstm = sides[("LSTM", "L1")]
    with pytest.warns(UserWarning):
        assert sampler.make_scoring_fn(lstm, 2, impl="capture").impl == "vmap"
    with pytest.raises(ValueError, match="unknown scoring impl"):
        sampler.make_scoring_fn(lstm, impl="grad")


@pytest.mark.parametrize("head", ["LSTM", "Linear"])
def test_a_bad_layerid_raises(jax_results, head):
    sides, _ = jax_results
    _, _, psb = sides[(head, "L1" if head == "LSTM" else "sisdr")]
    wavs, lengths = _batch()
    for impl, mean in (("vmap", False), ("vmap", True)):
        with pytest.raises(ValueError, match="l99_"):
            sampler.make_scoring_fn(psb, 99, impl=impl)(psb.model, wavs, lengths, mean=mean)


def test_layer_split_and_leaf_order_follow_the_flax_tree(jax_results):
    """The layer selection over the port's names, and the leaf order of the
    embedding: the JAX package's tree, path for path."""
    sides, _ = jax_results
    _, jparams, psb = sides[("LSTM", "L1")]
    params = dict(psb.model.named_parameters())
    sel = sampler._select_layer(params, 1)
    assert sorted(sel) == [f"lstm.l1_{d}.{w}" for d in ("bwd", "fwd")
                           for w in ("b_hh", "b_ih", "w_hh", "w_ih")]
    assert all(sel[n] is params[n] for n in sel)
    assert sampler._select_layer(params, None) == params
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jnames = ["/".join(str(k.key) for k in path[1:]) for path, _ in jleaves]
    assert [n.replace(".", "/").replace("weight", "kernel")
            for n in sampler._leaf_order(params)] == jnames


def test_captured_streams_of_stacks_and_heads():
    """A captured layer records its input on the direction axis, its input
    projection (the tensor the recurrence reads) and its output, as the
    ``Capture`` selects; ``build_head`` takes the JAX modules'
    ``capture_layer`` and builds the same head."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 5, generator=g)
    for bidirectional, dirs in ((True, 2), (False, 1)):
        stack = LSTMStack(5, 4, 2, bidirectional, generator=g)
        cap = Capture("all")
        out = stack(x, capture=cap)
        assert torch.equal(out, stack(x))
        assert sorted(cap) == sorted(f"l{k}_{s}" for k in (0, 1) for s in ("xs", "xw", "hs"))
        assert cap["l0_xs"].shape == (dirs, 2, 7, 5) and cap["l1_xs"].shape == (dirs, 2, 7,
                                                                                4 * dirs)
        assert cap["l0_xw"].shape == (dirs, 2, 7, 16) and cap["l0_hs"].shape == (dirs, 2, 7, 4)
        assert torch.equal(cap["l1_hs"][0], out[..., :4])
        one = Capture(1)
        stack(x, capture=one)
        assert sorted(one) == ["l1_hs", "l1_xs", "l1_xw"]
    head = build_head("Residual", input_size=5, output_size=3, hidden_size=4, num_layers=2,
                      bidirectional=True, capture_layer=0,
                      generator=torch.Generator().manual_seed(1))
    same = build_head("Residual", input_size=5, output_size=3, hidden_size=4, num_layers=2,
                      bidirectional=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(head(x, torch.ones(2, 7, 3))[0], same(x, torch.ones(2, 7, 3))[0])
    zero = Capture(0)
    head(x, torch.ones(2, 7, 3), capture=zero)
    assert sorted(zero) == ["l0_hs", "l0_xs", "l0_xw"]
    full = Capture("all")
    head(x, torch.ones(2, 7, 3), capture=full)
    assert {"scaling_xs", "scaling_xw"} <= set(full) and full["scaling_xs"].shape == (2, 7, 8)
    with pytest.raises(ValueError, match="stateless"):
        LSTMStack(5, 4, 1, False)(x, initial_state=None, return_state=True,
                                  capture=Capture("all"))


def test_hist_scoring_matches_jax():
    wavs = np.random.default_rng(2).standard_normal((4, 3, 8000)).astype(np.float32)
    pre, jpre = OnlinePreprocessor(), JPre()
    for mean in (False, True):
        got = sampler.hist_scoring(pre, torch.from_numpy(wavs), mean=mean)
        want = np.asarray(j_sampler.hist_scoring(jpre, jnp.asarray(wavs), mean=mean))
        assert got.shape == want.shape == ((1, 201) if mean else (4, 201))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    scores = jnp.asarray([0.9, 0.5, 0.81])
    assert sampler.hist_thresholding(torch.tensor([0.9, 0.5, 0.81])).tolist() == np.asarray(
        j_sampler.hist_thresholding(scores)).tolist()


# -- AsyncSampler -----------------------------------------------------------------------

class _Loader:
    """Batches of (lengths, wavs, cases): every case once a batch."""

    def __init__(self, n_batches=3):
        self.n = n_batches

    def __iter__(self):
        rng = np.random.default_rng(len(threading.enumerate()))
        for _ in range(self.n):
            wavs = (0.1 * rng.standard_normal((4, 3, 4000))).astype(np.float32)
            yield np.array([4000, 3000, 2000, 1000]), wavs, np.arange(4)


def test_async_sampler_lifecycle_and_snapshot(jax_results, monkeypatch):
    sides, _ = jax_results
    _, _, psb = sides[("LSTM", "L1")]
    model = psb.model
    scored_models = []
    fn = sampler.make_scoring_fn(psb)

    def scoring(m, wavs, lengths, **kw):
        scored_models.append(m)
        return fn(m, wavs, lengths, **kw)

    monkeypatch.setattr(sampler, "matching",
                        lambda q, t: torch.ones(t.shape[0]))
    wavs, lengths = _batch()
    s = sampler.AsyncSampler(scoring, model, None, lambda: _Loader(), (lengths, wavs),
                             sample_num=2)
    assert not s.alive
    before = {k: v.clone() for k, v in model.state_dict().items()}
    s.start()
    with torch.no_grad():  # the trainer's update does not reach the snapshot
        for p in model.parameters():
            p.add_(1.0)
    assert s.query_scores.shape[0] == 3
    deadline = 200
    while deadline and sum(len(v) for v in s._buffers.values()) < 8:
        threading.Event().wait(0.05)
        deadline -= 1
    got = s.collect()
    assert sorted(got) == [0, 1, 2, 3] and all(1 <= len(v) <= 2 for v in got.values())
    sample = got[1][0]
    assert sample["wavs"].shape == (3000, 3) and sample["match_score"] == 1.0
    assert all(m is s.snapshot for m in scored_models) and s.snapshot is not model
    assert all(torch.equal(v, before[k]) for k, v in s.snapshot.state_dict().items())
    s.stop()
    assert not s.alive
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(1.0)

    def failing(m, wavs, lengths, **kw):
        if wavs.shape[0] == 4:
            raise RuntimeError("scoring failed")
        return fn(m, wavs, lengths, **kw)

    bad = sampler.AsyncSampler(failing, model, None, lambda: _Loader(), (lengths, wavs), 2)
    bad.start()
    bad._thread.join(timeout=30)
    with pytest.raises(RuntimeError, match="thread failed"):
        bad.collect()
    bad.stop()


def test_full_f32_holds_across_two_threads(monkeypatch):
    """Two threads entering and leaving in interleaved order: TF32 stays off
    while either is inside, and the flags the process had come back after
    the last exit."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    events = [threading.Event() for _ in range(4)]
    seen = {}

    def first():
        with full_f32():
            seen["a_in"] = flags()
            events[0].set()
            events[1].wait(5)
        seen["a_out"] = flags()
        events[2].set()

    def second():
        events[0].wait(5)
        with full_f32():
            events[1].set()
            events[2].wait(5)
            seen["b_in"] = flags()
        events[3].set()

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert seen == {"a_in": (False, False), "a_out": (False, False), "b_in": (False, False)}
    assert flags() == (True, True)


def test_full_f32_under_many_threads():
    """More threads than cores entering and leaving with a short switch
    interval: no thread ever sees TF32 on inside, and the count returns to
    0 with the flags restored (a lost update of the count would leave them
    off, or turn them on under a thread still inside)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    bad = []

    def worker():
        for _ in range(200):
            with full_f32():
                if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
                    bad.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
