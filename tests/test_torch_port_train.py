"""The port's training slice against the JAX package on the CPU: objectives,
optimizers, the train step (clip, non-finite guard, a 3-step trajectory),
the eval step, and checkpoints with optimizer state written by either
package.

The JAX side of the step comparisons runs the flagship structure with the
scan recurrence, which tests/test_pallas_lstm.py pins to the Pallas kernel's
gradient; the port's ``LstmBidirTm`` is held against the Pallas VJP itself in
tests/test_torch_port_lstm_grad.py.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import __graft_entry__ as graft
from speech_enhancement_by_s3prl_tpu import objectives as j_objectives
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu.runner.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from speech_enhancement_by_s3prl_tpu_torch import entry, objectives
from speech_enhancement_by_s3prl_tpu_torch.models.convert import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from speech_enhancement_by_s3prl_tpu_torch.runner import optim
from speech_enhancement_by_s3prl_tpu_torch.runner.checkpoint import (
    load_checkpoint,
    optimizer_payload,
    optimizer_state_from_payload,
    save_checkpoint,
)

SMALL = dict(hidden_size=8, num_layers=2)
LR, TOTAL = 1e-3, 10  # a short schedule, so that the updates are not tiny
# Loss and gradient norm: the same f32 pipeline (STFT, log-mel + deltas, two
# BLSTM layers, Dense, SISDR) with sums in other orders.
LOSS_RTOL = 1e-5
# Parameters after each update: the updates are ~lr * 3 per step, and Adam's
# normalization keeps a gradient's f32 rounding relative, so the parameters
# agree to a small multiple of f32 rounding of their size (~0.5).
PARAM_ATOL = 1e-6


def _batch(seed, n=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    clean = (0.1 * np.sin(2 * np.pi * (200 + 50 * np.arange(2))[:, None] * t)
             + 0.01 * rng.standard_normal((2, n)))
    noise = 0.1 * rng.standard_normal((2, n))
    wavs = np.stack([clean + noise, clean, noise], axis=1).astype(np.float32)
    return wavs, np.array([n, n * 3 // 4])


@pytest.fixture(scope="module")
def jax_side():
    """The JAX flagship at hidden 8, 2 layers (scan recurrence), BertAdam
    with a 10-step schedule, its initial state and its jitted steps."""
    builder = dataclasses.replace(
        graft._build(use_pallas=False, **SMALL),
        optimizer=j_optim.build_optimizer("BertAdam", LR, 0.07, TOTAL), donate=False,
    )
    wavs, lengths = _batch(0)
    state = builder.init_state(jax.random.PRNGKey(0), jnp.asarray(wavs),
                               jnp.asarray(lengths))
    steps = {clip: jax.jit(dataclasses.replace(builder, grad_clip=clip).train_step_raw())
             for clip in (1.0, 0.01)}
    return builder, jax.device_get(state), steps


def _port_builder(params, clip=1.0):
    builder = dataclasses.replace(
        entry.build_train(device="cpu", **SMALL),
        optimizer=optim.build_optimizer("BertAdam", LR, 0.07, TOTAL), grad_clip=clip,
    )
    builder.model.load_state_dict(flax_to_state_dict(params))
    return builder


def _assert_params_close(port_builder, jax_params, atol=PARAM_ATOL):
    ref = flax_to_state_dict(jax.device_get(jax_params))
    got = port_builder.model.state_dict()
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=atol, rtol=0,
                                   err_msg=k)


# -- objectives ---------------------------------------------------------------

def _objective_ctx(seed):
    rng = np.random.default_rng(seed)
    B, T, F = 3, 12, 10
    lin_tar = (rng.standard_normal((B, T, F)) ** 2).astype(np.float32)
    lin_inp = (lin_tar + rng.standard_normal((B, T, F)) ** 2).astype(np.float32)
    offset = (1 / (1 + np.exp(-rng.standard_normal((B, T, F))))).astype(np.float32)
    masks = (np.arange(T)[None, :] < np.array([12, 9, 5])[:, None]).astype(np.float32)
    return {
        "predicted": (lin_inp * offset).astype(np.float32),
        "log_predicted": rng.standard_normal((B, T, F)).astype(np.float32),
        "linear_inp": lin_inp,
        "linear_tar": lin_tar,
        "offset": offset,
        "stft_length_masks": masks,
    }


@pytest.mark.parametrize("name,cfg", [
    ("L1", {}), ("SISDR", {}), ("sisdr", {}),
    ("WSD", {"alpha": 0.3, "db_interval": 50}), ("WSD", {"db_interval": 3}),
])
def test_objectives_match_jax(name, cfg):
    ctx = _objective_ctx(seed=len(name) + len(cfg))
    ref, _ = j_objectives.build_objective(name, **cfg)(
        **{k: jnp.asarray(v) for k, v in ctx.items()})
    loss, aux = objectives.build_objective(name, **cfg)(
        **{k: torch.from_numpy(v) for k, v in ctx.items()})
    assert aux == {}
    np.testing.assert_allclose(float(loss), float(ref), rtol=LOSS_RTOL, atol=0)


def test_objectives_mask_padded_frames():
    ctx = _objective_ctx(seed=1)
    padded = dict(ctx)
    for key in ("predicted", "log_predicted", "linear_tar"):
        padded[key] = ctx[key].copy()
        padded[key][2, 5:] = 123.0  # frames past utterance 2's length
    for name in ("L1", "SISDR", "sisdr"):
        fn = objectives.build_objective(name)
        a, _ = fn(**{k: torch.from_numpy(v) for k, v in ctx.items()})
        b, _ = fn(**{k: torch.from_numpy(v) for k, v in padded.items()})
        assert torch.allclose(a, b, rtol=1e-6), name


@pytest.mark.parametrize("name", ["stoi", "estoi", "pmsqe"])
def test_perceptual_objectives_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        objectives.build_objective(name)


# -- optimizers ---------------------------------------------------------------

def _tree(rng):
    """A flax-shaped tree with decayed weights, biases and a LayerNorm scale."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"params": {
        "lstm": {"l0_fwd": {"w_ih": a(8, 3), "w_hh": a(8, 2), "b_ih": a(8), "b_hh": a(8)}},
        "enc_ln": {"scale": a(4), "bias": a(4)},
        "scaling_layer": {"kernel": a(4, 5), "bias": a(5)},
    }}


@pytest.mark.parametrize("name", ["BertAdam", "Adam"])
def test_optimizer_five_updates_match_optax(name):
    rng = np.random.default_rng(11)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jopt = j_optim.build_optimizer(name, 0.1, 0.3, TOTAL)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    popt = optim.build_optimizer(name, 0.1, 0.3, TOTAL)
    pparams = flax_to_state_dict(params)
    pstate = popt.init(pparams)
    for g in grads:
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        pupdates, pstate = popt.update(flax_to_state_dict(g), pstate, pparams)
        pparams = {k: p + pupdates[k] for k, p in pparams.items()}
    # five updates of ~0.1 * 3 on values ~1, f32 rounding a step
    ref = flax_to_state_dict(jax.device_get(jparams))
    for k in ref:
        np.testing.assert_allclose(pparams[k].numpy(), ref[k].numpy(), atol=2e-6, rtol=0,
                                   err_msg=k)
    jmu, jnu, jcount = jstate[0].mu, jstate[0].nu, jstate[0].count
    assert int(pstate["count"]) == int(jcount) == 5
    for ours, theirs in ((pstate["mu"], jmu), (pstate["nu"], jnu)):
        theirs = flax_to_state_dict(jax.device_get(theirs))
        for k in theirs:
            np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_bert_adam_decays_by_flax_path():
    """One step with a zero gradient moves exactly the decayed tensors, by
    lr(x = 1/total) * 0.01 * p: the decay follows the flax path (biases,
    LSTM biases and LayerNorm scales are exempt), the schedule is read at
    the post-increment count, and there is no bias correction."""
    params = flax_to_state_dict(_tree(np.random.default_rng(12)))
    opt = optim.build_optimizer("BertAdam", 1.0, 0.5, TOTAL)
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    updates, state = opt.update(zeros, opt.init(params), params)
    lr1 = (1 / TOTAL) / 0.5
    decayed = {k for k in params if updates[k].abs().sum() > 0}
    assert decayed == {"lstm.l0_fwd.w_ih", "lstm.l0_fwd.w_hh", "scaling_layer.weight"}
    for k in decayed:
        torch.testing.assert_close(updates[k], -lr1 * 0.01 * params[k])
    assert int(state["count"]) == 1


def test_warmup_linear_schedule_matches_jax():
    ours = optim.warmup_linear_schedule(4e-5, 0.07, 100)
    theirs = j_optim.warmup_linear_schedule(4e-5, 0.07, 100)
    for step in (0, 1, 3, 7, 8, 50, 99, 100, 120):
        np.testing.assert_allclose(float(ours(torch.tensor(step))), float(theirs(step)),
                                   rtol=1e-6, atol=0)


# -- train and eval steps -------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, 0.01])
def test_train_trajectory_matches_jax(jax_side, clip):
    """Three steps from identical weights and batches: the loss, gradient
    norm and parameters after each step, and the optimizer state after the
    last. At clip 0.01 the global clip scales every gradient (the norm is
    ~0.03 here); at 1.0 it does not."""
    _, state, steps = jax_side
    port = _port_builder(state.params, clip)
    pstate = port.init_state()
    rng = jax.random.PRNGKey(0)
    for k in range(3):
        wavs, lengths = _batch(k)
        state, jstats = steps[clip](state, jnp.asarray(wavs), jnp.asarray(lengths), rng, None)
        pstate, stats = port.train_step(pstate, torch.from_numpy(wavs),
                                        torch.from_numpy(lengths))
        np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(stats["grad_norm"]), float(jstats["grad_norm"]),
                                   rtol=LOSS_RTOL)
        assert not bool(stats["skipped"]) and not bool(jstats["skipped"])
        _assert_params_close(port, state.params)
    assert int(pstate.step) == int(state.step) == 3
    assert int(pstate.opt_state["count"]) == int(state.opt_state[0].count) == 3
    mu = flax_to_state_dict(jax.device_get(state.opt_state[0].mu))
    for k, v in mu.items():
        scale = float(np.abs(v.numpy()).max()) + 1e-12
        assert float((pstate.opt_state["mu"][k] - v).abs().max()) / scale < 1e-4, k


def test_non_finite_batch_is_skipped_like_jax(jax_side):
    _, state, steps = jax_side
    port = _port_builder(state.params)
    pstate = port.init_state()
    wavs, lengths = _batch(0)
    pstate, _ = port.train_step(pstate, torch.from_numpy(wavs), torch.from_numpy(lengths))
    before = {k: p.clone() for k, p in pstate.params.items()}
    opt_before = optimizer_payload(pstate.opt_state)
    wavs[1, 0, 500] = np.nan
    pstate, stats = port.train_step(pstate, torch.from_numpy(wavs), torch.from_numpy(lengths))
    assert bool(stats["skipped"]) and not torch.isfinite(stats["grad_norm"])
    assert all(torch.equal(before[k], p) for k, p in pstate.params.items())
    after = optimizer_payload(pstate.opt_state)
    assert int(after["count"]) == int(opt_before["count"]) == 1
    for key in ("mu", "nu"):
        for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(after[key])[0],
                                  jax.tree_util.tree_flatten_with_path(opt_before[key])[0]):
            assert np.array_equal(a, b)
    assert int(pstate.step) == 2
    # the JAX step does the same
    jstate, jstats = steps[1.0](state, jnp.asarray(wavs), jnp.asarray(lengths),
                                jax.random.PRNGKey(0), None)
    assert bool(jstats["skipped"]) and int(jstate.step) == 1
    assert int(jstate.opt_state[0].count) == 0
    for a, b in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(state.params)):
        assert np.array_equal(np.asarray(a), b)


def test_eval_step_matches_jax(jax_side):
    builder, state, _ = jax_side
    wavs, lengths = _batch(5)
    ref = jax.jit(builder.eval_step_raw("first"))(
        state.params, jnp.asarray(wavs), jnp.asarray(lengths), None)
    port = _port_builder(state.params)
    out = port.eval_step(torch.from_numpy(wavs), torch.from_numpy(lengths), wav_out="first")
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), rtol=LOSS_RTOL)
    assert set(out["scores"]) == {"sisdr"}
    # SI-SDR in dB of the renormalized, decoded waveforms
    np.testing.assert_allclose(out["scores"]["sisdr"].numpy(),
                               np.asarray(ref["scores"]["sisdr"]), rtol=0, atol=1e-3)
    for key in ("wav_predicted", "wav_inp", "wav_tar"):
        got, want = out[key].numpy(), np.asarray(ref[key])
        assert got.shape == want.shape == (1, wavs.shape[-1])
        assert np.abs(got - want).max() <= 5e-5 * np.sqrt(np.mean(want ** 2)), key


def test_step_builder_refuses_what_is_not_ported():
    # the upstream mode (neither from_rawfeature nor from_waveform) is ported
    # and needs the upstream that feeds the head
    with pytest.raises(ValueError, match="needs an upstream"):
        dataclasses.replace(entry.build_train(device="cpu", **SMALL), from_rawfeature=False)
    # the metrics are ported: only a name the registry does not know is refused
    dataclasses.replace(entry.build_train(device="cpu", **SMALL),
                        eval_metrics=("sisdr", "stoi", "pesq_nb"))
    with pytest.raises(ValueError, match="unknown metric"):
        dataclasses.replace(entry.build_train(device="cpu", **SMALL),
                            eval_metrics=("sisdr", "mosnet"))


# -- checkpoints with optimizer state -----------------------------------------------

def test_checkpoint_round_trip_with_optimizer_state(jax_side, tmp_path):
    _, state, _ = jax_side
    port = _port_builder(state.params)
    pstate = port.init_state()
    for k in range(2):
        wavs, lengths = _batch(k)
        pstate, _ = port.train_step(pstate, torch.from_numpy(wavs), torch.from_numpy(lengths))
    config, paras = entry.flagship_settings(**SMALL)
    path = save_checkpoint(str(tmp_path), 2, port.model,
                           optimizer_payload(pstate.opt_state), config, paras)
    payload = load_checkpoint(path)
    # moments keyed by flax path: the Dense moments transposed like the kernel
    assert payload["Optimizer"]["mu"]["params"]["scaling_layer"]["kernel"].shape == (16, 201)
    restored = optimizer_state_from_payload(payload["Optimizer"], "cpu")
    assert int(restored["count"]) == 2
    for key in ("mu", "nu"):
        assert restored[key].keys() == pstate.opt_state[key].keys()
        assert all(torch.equal(restored[key][k], v) for k, v in pstate.opt_state[key].items())
    assert optimizer_state_from_payload(None, "cpu") is None


def test_resume_from_jax_checkpoint_continues_like_jax(jax_side, tmp_path):
    """A checkpoint the JAX package wrote after two steps restores the
    weights, the moments, the optimizer count and the global step; the next
    step then matches the JAX package's next step."""
    _, state, steps = jax_side
    rng = jax.random.PRNGKey(0)
    for k in range(2):
        wavs, lengths = _batch(k)
        state, _ = steps[1.0](state, jnp.asarray(wavs), jnp.asarray(lengths), rng, None)
    config, paras = entry.flagship_settings(**SMALL)
    path = j_save_checkpoint(str(tmp_path), int(state.step), state.params, state.opt_state,
                             config, paras)
    payload = load_checkpoint(path)
    port = _port_builder(payload["Downstream"])
    pstate = port.init_state()
    pstate.opt_state = optimizer_state_from_payload(payload["Optimizer"], "cpu")
    pstate.step = torch.tensor(payload["Global_step"], dtype=torch.int32)
    assert payload["Global_step"] == 2 and int(pstate.opt_state["count"]) == 2
    nu = flax_to_state_dict(jax.device_get(state.opt_state[0].nu))
    assert all(torch.equal(pstate.opt_state["nu"][k], v) for k, v in nu.items())

    wavs, lengths = _batch(2)
    state, jstats = steps[1.0](state, jnp.asarray(wavs), jnp.asarray(lengths), rng, None)
    pstate, stats = port.train_step(pstate, torch.from_numpy(wavs), torch.from_numpy(lengths))
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=LOSS_RTOL)
    _assert_params_close(port, state.params)
    assert int(pstate.step) == int(state.step) == 3


def test_jax_optimizer_entry_with_diverging_counts_is_refused(jax_side, tmp_path):
    _, state, _ = jax_side
    adam, mask, sched, flip = state.opt_state
    broken = (adam, mask, sched._replace(count=sched.count + 1), flip)
    path = j_save_checkpoint(str(tmp_path), 0, state.params, broken, {}, {})
    with pytest.raises(ValueError, match="schedule count"):
        optimizer_state_from_payload(load_checkpoint(path)["Optimizer"], "cpu")
    assert state_dict_to_flax({}) == {"params": {}}
