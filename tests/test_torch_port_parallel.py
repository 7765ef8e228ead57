"""The port's data parallelism (``parallel/``) on the CPU, two gloo ranks.

One worker script (``tests/torch_port_parallel_worker.py``) runs once as two
processes that meet through a rendezvous file; each takes the data-parallel
train step on its rows of the same global batches, and the mesh eval of one
batch. It is held against:

- the port's single-process step on the global batch: every dropout mask bit
  for bit (the ranks' rows of the single process's masks), the loss and
  gradient norm within 1e-6 relative (the same f32 arithmetic summed in two
  halves), the parameters after 2 steps within 2e-6;
- the JAX package's ``make_parallel_train_step`` on a 2 x 1 mesh of the CPU's
  virtual devices, through the weight bridge, at the tolerances of
  tests/test_parallel.py (loss rtol 1e-5, parameters atol 2e-5);
- each other: the two ranks end each run with the same bits;
- the single-device eval, at tests/test_runner_mesh.py's tolerances (loss
  rtol 2e-4, scores rtol 2e-3): the BLSTM head under ``L1`` on 8 rows, and
  the ``Residual`` head under ``WSD`` on the 4 rows of its train case.

The cases: a BLSTM head under ``L1`` with ragged lengths (the ``LSTM`` head,
which predicts the log spectrum that L1 reads), the flagship ``Residual``
head under ``SISDR`` and under ``WSD`` (whose voice threshold reads the
largest frame energy across the ranks; the loudest frame lies on rank 0
only), at hidden 8; and the Mockingjay joint finetune (hidden
32, 2 layers, dropout 0.1 live) replaying the salts the JAX step draws, under
``SE_ATTN_IMPL=flash SE_HIDDEN_DROPOUT_IMPL=hash``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from speech_enhancement_by_s3prl_tpu import objectives as j_objectives
from speech_enhancement_by_s3prl_tpu.models import heads as j_heads
from speech_enhancement_by_s3prl_tpu.models import spec_head as j_spec
from speech_enhancement_by_s3prl_tpu.models import transformer as j_tf
from speech_enhancement_by_s3prl_tpu.parallel import mesh as j_mesh
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu_torch.models import transformer as t_tf
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.parallel import mesh as t_mesh
from tests.torch_port_parallel_worker import (
    LR,
    MOCKINGJAY,
    OBJECTIVE_ARGS,
    RESIDUAL,
    TOTAL,
    port_builder,
    recording_masks,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
WORLD = 2
# a worker's own limit: a hung rendezvous fails the test, not the suite
WORKER_TIMEOUT = 120
CASES = {"L1": ("lstm", "L1"), "SISDR": ("residual", "SISDR"), "WSD": ("residual", "WSD"),
         "mockingjay": ("mockingjay", "SISDR")}
STEPS = 2
# the port's two ranks against its single process: the same f32 arithmetic,
# the loss and each gradient summed as two halves
PORT_LOSS_RTOL, PORT_PARAM_ATOL = 1e-6, 2e-6
# against the JAX mesh step (tests/test_parallel.py)
JAX_LOSS_RTOL, JAX_PARAM_ATOL = 1e-5, 2e-5
# the mesh eval against the single-device eval (tests/test_runner_mesh.py)
EVAL_LOSS_RTOL, EVAL_SCORE_RTOL = 2e-4, 2e-3


def _batch(seed, rows=4, n=SR):
    """``rows`` 1 s rows of ragged lengths (zero past each length), as
    (wavs (B, 3, n) f32, lengths (B,) int64)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    clean = (0.1 * np.sin(2 * np.pi * (200 + 50 * np.arange(rows))[:, None] * t)
             + 0.01 * rng.standard_normal((rows, n)))
    noise = 0.1 * rng.standard_normal((rows, n))
    wavs = np.stack([clean + noise, clean, noise], axis=1).astype(np.float32)
    lengths = np.array([n, n * 11 // 16, n * 13 // 16, n // 2] * (rows // 4))
    for i, length in enumerate(lengths):
        wavs[i, :, length:] = 0.0
    return wavs, lengths


def _fading_batch(seed):
    """``_batch`` with each row's clean speech fading in over 60 dB: with the
    ragged lengths the batch's loudest frame is the end of row 0, on rank 0
    only, and rank 1's loudest (row 2's end) lies about 12 dB under it. So
    ``WSD``'s voice threshold (``OBJECTIVE_ARGS``: 6 dB under the loudest frame)
    leaves rank 1 no voiced frame, where rank 1's own loudest frame would
    voice its top 6 dB."""
    wavs, lengths = _batch(seed)
    clean = wavs[:, 1] * np.geomspace(1e-3, 1.0, wavs.shape[-1], dtype=np.float32)
    wavs[:, 1], wavs[:, 0] = clean, clean + wavs[:, 2]
    return wavs, lengths


def _jax_builder(kind, objective):
    opt = j_optim.build_optimizer("BertAdam", LR, 0.07, TOTAL)
    if kind == "mockingjay":
        cfg = j_tf.TransformerConfig(**MOCKINGJAY)
        return dataclasses.replace(
            graft._build(delta=1), model=j_spec.Mockingjay(output_size=201, config=cfg),
            from_waveform=True, from_rawfeature=False, donate=False, optimizer=opt)
    builder = dataclasses.replace(
        graft._build(use_pallas=False, **RESIDUAL), donate=False, optimizer=opt,
        objective=j_objectives.build_objective(objective, **OBJECTIVE_ARGS.get(objective, {})))
    if kind == "lstm":
        builder = dataclasses.replace(builder, model=j_heads.build_head(
            "LSTM", input_size=builder.preprocessor.feat_dims()[1], output_size=201,
            bidirectional=True, use_pallas=False, **RESIDUAL))
    return builder


class _SaltRecorder:
    """Wraps ``jax.random.bits`` so that a jitted step reports every salt it
    draws, in program order (``jax.debug.callback(ordered=True)``)."""

    def __init__(self, monkeypatch):
        self.salts = []
        orig = jax.random.bits

        def keep(value):
            self.salts.append(tuple(int(s) for s in np.asarray(value).reshape(-1)))

        def bits(key, shape=(), dtype=None):
            out = orig(key, shape, dtype)
            jax.debug.callback(keep, out, ordered=True)
            return out

        monkeypatch.setattr(jax.random, "bits", bits)


def _jax_case(kind, objective, batches):
    """The JAX mesh step on 2 devices for ``STEPS`` steps: (the initial
    weights as a state dict, the salts of each step, [(loss, grad norm)],
    the final weights as a state dict)."""
    builder = _jax_builder(kind, objective)
    wavs, lengths = batches[0]
    state = builder.init_state(jax.random.PRNGKey(0), jnp.asarray(wavs),
                               jnp.asarray(lengths))
    weights = flax_to_state_dict(jax.device_get(state.params))
    salts = []
    with pytest.MonkeyPatch.context() as mp:
        if kind == "mockingjay":
            mp.setenv("SE_ATTN_IMPL", "flash")
            mp.setenv("SE_HIDDEN_DROPOUT_IMPL", "hash")
            # the salts depend on the step's key and count: record them from
            # the single-device steps (the mesh step's salts are theirs)
            with pytest.MonkeyPatch.context() as rec_mp:
                rec = _SaltRecorder(rec_mp)
                single, at = jax.jit(builder.train_step_raw()), state
                for k, (w, n) in enumerate(batches):
                    rec.salts.clear()
                    at, _ = single(at, jnp.asarray(w), jnp.asarray(n),
                                   jax.random.PRNGKey(5 + k), None)
                    jax.effects_barrier()
                    salts.append(list(rec.salts))
        step, state = j_mesh.make_parallel_train_step(builder, j_mesh.make_mesh(WORLD), state)
        stats = []
        for k, (w, n) in enumerate(batches):
            state, st = step(state, jnp.asarray(w), jnp.asarray(n), jax.random.PRNGKey(5 + k))
            stats.append((float(st["loss"]), float(st["grad_norm"])))
    return weights, salts, stats, flax_to_state_dict(jax.device_get(state.params))


def _single(kind, objective, weights, batches, salts):
    """The port's single-process steps on the global batches, recording the
    masks: ([(loss, grad norm)], final weights, masks)."""
    builder = port_builder(kind, objective)
    builder.model.load_state_dict(weights)
    state = builder.init_state()
    stats = []
    with recording_masks() as masks:
        for k, (w, n) in enumerate(batches):
            replay = t_tf.SaltStream(salts=salts[k]) if salts else None
            state, st = builder.train_step(state, torch.from_numpy(w), torch.from_numpy(n),
                                           salts=replay)
            stats.append((float(st["loss"]), float(st["grad_norm"])))
    return stats, {k: v.detach().clone() for k, v in state.params.items()}, masks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side of every case: the JAX mesh step, the port's single process
    and the two ranks' results (the worker's output, one dict a rank). The
    port's sides (the ranks inherit the variables) replay the JAX step's salts
    on the hash routes, which the variables name."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SE_ATTN_IMPL", "flash")
        mp.setenv("SE_HIDDEN_DROPOUT_IMPL", "hash")
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("parallel")
    jax_sides, singles, train = {}, {}, {}
    for name, (kind, objective) in CASES.items():
        batches = [(_fading_batch if objective == "WSD" else _batch)(k) for k in range(STEPS)]
        weights, salts, stats, final = _jax_case(kind, objective, batches)
        jax_sides[name] = (stats, final)
        singles[name] = _single(kind, objective, weights, batches, salts)
        train[name] = {"kind": kind, "objective": objective, "weights": weights,
                       "salts": salts,
                       "batches": [(torch.from_numpy(w), torch.from_numpy(n))
                                   for w, n in batches]}
    evals, single_eval = {}, {}
    for name, kind, batch in (("L1", "lstm", _batch(9, rows=8)),
                              ("WSD", "residual", _fading_batch(9))):
        eval_builder = port_builder(kind, name)
        eval_wavs, eval_lengths = (torch.from_numpy(x) for x in batch)
        single_eval[name] = eval_builder.eval_step(eval_wavs, eval_lengths)
        evals[name] = {"kind": kind, "objective": name,
                       "weights": eval_builder.model.state_dict(),
                       "batch": (eval_wavs, eval_lengths)}
    torch.save({"train": train, "eval": evals}, tmp / "in.pt")

    init = "file://" + str(tmp / "rendezvous")
    worker = os.path.join(REPO, "tests", "torch_port_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(WORLD), init,
                               str(tmp / "in.pt"), str(tmp / f"out{r}.pt")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "1"})
             for r in range(WORLD)]
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    ranks = [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"jax": jax_sides, "single": singles, "ranks": ranks,
            "single_eval": single_eval}


def test_two_gloo_ranks_sum_and_name_their_rank(runs):
    for r, res in enumerate(runs["ranks"]):
        assert res["psum"] == 3.0
        assert res["topology"].startswith(f"process {r}/2 | gloo")


def test_ranks_take_the_largest_value_and_rank_0s_batch(runs):
    """``StepReduce.max`` (``WSD``'s threshold) and ``broadcast_batch`` (the
    active sampler's batch, chosen on rank 0)."""
    for res in runs["ranks"]:
        assert res["max"] == 6.0
        lengths, wavs = res["broadcast"]
        assert torch.equal(lengths, torch.arange(3)) and lengths.dtype == torch.int64
        assert torch.equal(wavs, torch.zeros(3, 2, 5))


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_step_is_the_single_process_step(runs, name):
    stats, params, masks = runs["single"][name]
    for res in runs["ranks"]:
        got = res[name]
        for (loss, norm), (want_loss, want_norm) in zip(got["stats"], stats):
            np.testing.assert_allclose(loss, want_loss, rtol=PORT_LOSS_RTOL)
            np.testing.assert_allclose(norm, want_norm, rtol=PORT_LOSS_RTOL)
        for k, want in params.items():
            np.testing.assert_allclose(got["params"][k].numpy(), want.numpy(),
                                       atol=PORT_PARAM_ATOL, rtol=0, err_msg=k)
    # every mask the ranks drew is their rows of the single process's
    assert len(masks) == len(runs["ranks"][0][name]["masks"])
    assert (len(masks) > 0) == (name == "mockingjay")
    for i, (site, mask) in enumerate(masks):
        rows = mask.shape[0] // WORLD
        for r, res in enumerate(runs["ranks"]):
            got_site, got = res[name]["masks"][i]
            assert got_site == site
            assert torch.equal(got, mask[r * rows:(r + 1) * rows]), (name, i, site, r)


@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_step_matches_the_jax_mesh_step(runs, name):
    stats, params = runs["jax"][name]
    for res in runs["ranks"]:
        for (loss, norm), (want_loss, want_norm) in zip(res[name]["stats"], stats):
            np.testing.assert_allclose(loss, want_loss, rtol=JAX_LOSS_RTOL)
            np.testing.assert_allclose(norm, want_norm, rtol=JAX_LOSS_RTOL)
        for k, want in params.items():
            np.testing.assert_allclose(res[name]["params"][k].numpy(), want.numpy(),
                                       atol=JAX_PARAM_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_end_with_the_same_bits(runs, name):
    first, second = (res[name] for res in runs["ranks"])
    assert first["stats"] == second["stats"]
    assert all(torch.equal(first["params"][k], second["params"][k]) for k in first["params"])


def _check_mesh_eval(runs, name, rows):
    want = runs["single_eval"][name]
    for res in runs["ranks"]:
        got = res["eval"][name]
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=EVAL_LOSS_RTOL)
        for k, v in want["scores"].items():
            assert got["scores"][k].shape == v.shape == (rows,)
            np.testing.assert_allclose(got["scores"][k].numpy(), v.numpy(),
                                       rtol=EVAL_SCORE_RTOL)
        assert torch.equal(got["wav_predicted"], want["wav_predicted"])


def test_mesh_eval_matches_the_single_device_eval(runs):
    _check_mesh_eval(runs, "L1", 8)


def test_mesh_eval_of_wsd_matches_the_single_device_eval(runs):
    """``WSD`` scored over the two ranks: its voice threshold reads the
    loudest frame of the whole batch, which lies on rank 0 only."""
    _check_mesh_eval(runs, "WSD", 4)


def test_mesh_refuses_a_model_axis_and_parses_the_jax_forms():
    """A model axis is ported (ROADMAP A12b): ``make_mesh(2, 2)`` needs a
    group of 4 ranks, and without one it is refused as any other mesh the
    world does not fill."""
    assert t_mesh.parse_mesh("4") == (4, 1) and t_mesh.parse_mesh("2x1") == (2, 1)
    assert t_mesh.parse_mesh("2X2") == (2, 2)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        t_mesh.make_mesh(2, 2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        t_mesh.make_mesh(2)  # no process group: one rank
    mesh = t_mesh.make_mesh(1)
    x = torch.arange(6)
    assert torch.equal(t_mesh.rank_rows(x, mesh), x)
    assert t_mesh.rank_span(6, t_mesh.Mesh(3, rank=2)) == (4, 2)
    with pytest.raises(ValueError, match="does not split"):
        t_mesh.rank_span(5, t_mesh.Mesh(2, rank=1))


def test_one_rank_step_is_the_step_without_a_mesh():
    """On one rank the share w / W is exactly 1: the data-parallel step gives
    the bits of the plain step, for a loss whose weight is the frame count."""
    torch.set_num_threads(1)
    wavs, lengths = (torch.from_numpy(x) for x in _batch(3))
    weights, sides = port_builder("lstm", "L1").model.state_dict(), []
    for parallel in (False, True):
        builder = port_builder("lstm", "L1")
        builder.model.load_state_dict(weights)
        state = builder.init_state()
        step = builder.train_step
        if parallel:
            step, state = t_mesh.make_parallel_train_step(builder, t_mesh.make_mesh(1), state)
        for _ in range(2):
            state, stats = step(state, wavs, lengths)
        sides.append((float(stats["loss"]), {k: v.detach().clone()
                                             for k, v in state.params.items()}))
    assert sides[0][0] == sides[1][0]
    assert all(torch.equal(sides[0][1][k], sides[1][1][k]) for k in sides[0][1])


def test_a_rank_on_cuda_takes_its_own_card_or_is_refused(monkeypatch):
    """``initialize_distributed`` on ``cuda``: ``LOCAL_RANK`` picks the card
    and a local rank past this node's cards is refused; ``cuda:i`` names the
    card itself (two gloo ranks sharing card 0)."""
    from speech_enhancement_by_s3prl_tpu_torch.parallel import distributed as t_dist

    picked, joined = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setattr(t_dist.dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw["rank"])))
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert t_dist.initialize_distributed("file:///unused", 4, 3, device="cuda")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="asks for card 2, but this node shows 2"):
        t_dist.initialize_distributed("file:///unused", 4, 2, device="cuda")
    assert t_dist.initialize_distributed("file:///unused", 4, 2, device="cuda:0",
                                         backend="gloo")
    assert picked == [1, 0] and joined == [("nccl", 3), ("gloo", 2)]
