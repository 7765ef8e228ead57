"""The port's perceptual objectives against the JAX package on the CPU: the
bark matrix bit for bit, PMSQE and the ``stoi`` / ``estoi`` objectives (loss
and input gradient against ``jax.grad``), the tie rules of their max, min
and clip, the eval step with each and a PMSQE train step against the JAX
steps, the STOI objective failing a train step as it does in the JAX
package, and every objective called with TF32 off."""
import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from speech_enhancement_by_s3prl_tpu import objectives as j_objectives
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu.runner.trainer import make_context as j_make_context
from speech_enhancement_by_s3prl_tpu_torch import entry, objectives
from speech_enhancement_by_s3prl_tpu_torch.metrics import stoi as t_stoi
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.runner import optim
from speech_enhancement_by_s3prl_tpu_torch.runner.trainer import make_context

# the modules, not the ``pmsqe`` objective classes of the packages
j_pmsqe = importlib.import_module("speech_enhancement_by_s3prl_tpu.objectives.pmsqe")
t_pmsqe = importlib.import_module("speech_enhancement_by_s3prl_tpu_torch.objectives.pmsqe")

SR = 16000
# the same f32 pipeline with sums in other orders
LOSS_RTOL = 1e-5
# input gradient, relative to its largest |value|
GRAD_TOL = 1e-5
SMALL = dict(hidden_size=8, num_layers=2)
LR, TOTAL = 1e-3, 10
PARAM_ATOL = 1e-6
# PMSQE inputs: one shape for every case, so the JAX gradient compiles once
B, T, F = 2, 50, 201


def _grad_err(got, want):
    return float(np.abs(got - want).max()), GRAD_TOL * float(np.abs(want).max())


# -- PMSQE ----------------------------------------------------------------------------

@pytest.mark.parametrize("n_freq,sample_rate", [(201, 16000), (257, 16000), (129, 8000)])
def test_bark_matrix_is_the_jax_matrix_bit_for_bit(n_freq, sample_rate):
    ours = t_pmsqe.bark_matrix(n_freq, sample_rate)
    theirs = j_pmsqe.bark_matrix(n_freq, sample_rate)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)


@pytest.fixture(scope="module")
def jax_pmsqe():
    obj = j_objectives.build_objective("pmsqe")
    return jax.jit(jax.value_and_grad(
        lambda p, t, m: obj(predicted=p, linear_tar=t, stft_length_masks=m)[0]))


def _pmsqe_case(case):
    rng = np.random.default_rng(42)
    tar = (rng.standard_normal((B, T, F)) ** 2).astype(np.float32)
    src = tar * (0.5 + 0.25 * rng.standard_normal((B, T, F)).astype(np.float32)) ** 2
    masks = np.ones((B, T), np.float32)
    masks[1, 40:] = 0
    if case == "ragged":  # other spectra, a shorter second row, silent bins
        rng = np.random.default_rng(7)
        tar = (rng.standard_normal((B, T, F)) ** 2 * 1e3).astype(np.float32)
        src = (tar + rng.standard_normal((B, T, F)) ** 2 * 3e2).astype(np.float32)
        tar[:, :, 150:] = src[:, :, 150:] = 0.0
        masks = (np.arange(T)[None, :] < np.array([T, 33])[:, None]).astype(np.float32)
    elif case == "identical":
        src = tar.copy()
    return src, tar, masks


@pytest.mark.parametrize("case", ["pin", "ragged", "identical"])
def test_pmsqe_loss_and_gradient_match_jax(jax_pmsqe, case):
    src, tar, masks = _pmsqe_case(case)
    ref, ref_g = jax_pmsqe(jnp.asarray(src), jnp.asarray(tar), jnp.asarray(masks))
    x = torch.from_numpy(src).requires_grad_()
    loss, aux = objectives.build_objective("pmsqe")(
        predicted=x, linear_tar=torch.from_numpy(tar), stft_length_masks=torch.from_numpy(masks))
    loss.backward()
    loss = float(loss.detach())
    assert aux == {}
    np.testing.assert_allclose(loss, float(ref), rtol=LOSS_RTOL, atol=0)
    err, tol = _grad_err(x.grad.numpy(), np.asarray(ref_g))
    assert err <= tol, (err, tol)
    if case == "pin":  # tests/test_objectives_perceptual.py's pin of the loss scale
        np.testing.assert_allclose(loss, 0.54332, rtol=1e-3)
    if case == "identical":
        assert loss < 0.05


# -- the STOI objectives ---------------------------------------------------------------

def _wav_case(valid=11200):
    """2 rows of 1 s, the second ``valid`` samples long."""
    rng = np.random.default_rng(3)
    n = SR
    t = np.arange(n) / SR
    tar = np.stack([0.1 * np.sin(2 * np.pi * (150 + 60 * b) * t) * (1 + np.sin(2 * np.pi * 3 * t))
                    + 0.02 * rng.standard_normal(n) for b in range(2)]).astype(np.float32)
    pred = (tar + 0.05 * rng.standard_normal(tar.shape)).astype(np.float32)
    masks = (np.arange(n)[None, :] < np.array([n, valid])[:, None]).astype(np.float32)
    return pred, tar, masks


@pytest.fixture(scope="module")
def jax_stoi():
    out = {}
    for name in ("stoi", "estoi"):
        obj = j_objectives.build_objective(name)
        out[name] = jax.jit(jax.value_and_grad(
            lambda p, t, m, obj=obj: obj(wav_predicted=p, wav_tar=t, length_masks=m)[0]))
    return out


@pytest.mark.parametrize("name,valid", [("stoi", 11200), ("estoi", 11200), ("stoi", 6000)])
def test_stoi_objective_loss_and_gradient_match_jax(jax_stoi, name, valid):
    """With 10000 samples of padding a row holds 30-frame segments of
    silence, which the objectives count (they mask the waveforms and pass
    no lengths, as in the JAX package). STOI's correlation takes a square
    root at 0 there, and the row's input gradient is NaN in both packages;
    the STOI objective is an eval loss in both, which takes no gradient.
    The JAX package's ESTOI normalizes such a segment's rounding residue to
    unit length, so the packages differ there: that case is the next test's
    (ROADMAP C5)."""
    pred, tar, masks = _wav_case(valid)
    ref, ref_g = jax_stoi[name](jnp.asarray(pred), jnp.asarray(tar), jnp.asarray(masks))
    x = torch.from_numpy(pred).requires_grad_()
    loss, aux = objectives.build_objective(name)(
        wav_predicted=x, wav_tar=torch.from_numpy(tar), length_masks=torch.from_numpy(masks))
    loss.backward()
    loss = float(loss.detach())
    assert aux == {} and -1.0 < loss < 0.0
    np.testing.assert_allclose(loss, float(ref), rtol=LOSS_RTOL, atol=0)
    ref_g, got_g = np.asarray(ref_g), x.grad.numpy()
    nan_rows = np.isnan(ref_g).any(axis=1)
    assert np.array_equal(np.isnan(got_g), np.isnan(ref_g))
    assert nan_rows.tolist() == [False, name == "stoi" and valid == 6000]
    err, tol = _grad_err(got_g[~nan_rows], ref_g[~nan_rows])
    assert err <= tol, (err, tol)
    if not nan_rows[1]:  # the padded samples get no gradient on either side
        assert not ref_g[1, valid:].any() and not got_g[1, valid:].any()


def test_estoi_objective_on_a_row_padded_over_segments_pins_fault_c5(jax_stoi):
    """ROADMAP C5, pinned: a row padded over whole 30-frame segments, as
    config/vcb.yaml's eval batches pad theirs (up to 2.75 s). The objectives
    count those segments of silence, in both packages. The port scores each
    one exactly 0, and so the segment whose only sound is its first frame
    (``metrics.stoi._center`` makes a constant row zero in any summation
    order; a band column that every band repeats counts as zero). The JAX
    package normalizes the rounding residue of such a segment to unit length
    and scores it by the order of a sum. So the losses differ, by the
    measured delta (-0.4103 against -0.3366), while the unpadded row's
    gradient agrees. A fix of C5 changes these numbers."""
    valid = 6000
    pred, tar, masks = _wav_case(valid)
    ref, ref_g = jax_stoi["estoi"](jnp.asarray(pred), jnp.asarray(tar), jnp.asarray(masks))
    x = torch.from_numpy(pred).requires_grad_()
    loss, _ = objectives.build_objective("estoi")(
        wav_predicted=x, wav_tar=torch.from_numpy(tar), length_masks=torch.from_numpy(masks))
    loss.backward()
    loss, ref = float(loss.detach()), float(ref)
    np.testing.assert_allclose([ref, loss], [-0.4103, -0.3366], atol=5e-4)
    assert abs(loss - ref) > 1000 * LOSS_RTOL * abs(ref)
    err, tol = _grad_err(x.grad.numpy()[0], np.asarray(ref_g)[0])
    assert err <= tol, (err, tol)
    # frame 29 holds the row's last sample (3750 at 10 kHz) and the
    # resampler's tail; the segments from it on hold at most one frame of
    # sound and score exactly 0, the segments before it do not
    xs, ys, _, _ = t_stoi._front_end(torch.from_numpy(tar * masks), torch.from_numpy(pred * masks),
                                     SR, False, None)
    d = t_stoi._estoi_tail(xs, ys)
    last = (valid * t_stoi.FS // SR - 1) // t_stoi.HOP
    assert d.shape[1] - last >= 10 and not d[1, last:].any()
    assert d[1, :last].abs().min() > 0


# -- ties ------------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["loudness at zero", "gain clip at its bounds",
                                   "max and min at a tie"])
def test_ties_split_the_gradient_like_jax(where):
    """JAX's maximum and minimum give each side half the gradient at a tie,
    and ``jnp.clip`` (maximum then minimum) half at a bound; ``torch.clamp``
    would give all of it. The port's PMSQE loudness (bark power 0, as in
    silent bins and masked frames), its gain clip and STOI's clip follow
    JAX."""
    x = np.array([0.0, 3e-4, 5.0, 1.0, 1e4, 7.0], np.float32)
    if where == "loudness at zero":
        jfn = lambda v: j_pmsqe.PMSQE._loudness(None, v).sum()  # noqa: E731
        tfn = lambda v: t_pmsqe.PMSQE._loudness(v).sum()  # noqa: E731
    elif where == "gain clip at its bounds":
        jfn = lambda v: jnp.clip(v, 3e-4, 5.0).sum()  # noqa: E731
        tfn = lambda v: t_pmsqe._clip(v, 3e-4, 5.0).sum()  # noqa: E731
    else:
        y = np.array([0.0, 3e-4, 6.0, 1.0, 2.0, 7.0], np.float32)
        jfn = lambda v: (jnp.minimum(v, y) + 2 * jnp.maximum(v, y)).sum()  # noqa: E731
        tfn = lambda v: (torch.minimum(v, torch.from_numpy(y))  # noqa: E731
                         + 2 * torch.maximum(v, torch.from_numpy(y))).sum()
    want = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
    v = torch.from_numpy(x).requires_grad_()
    tfn(v).backward()
    np.testing.assert_array_equal(v.grad.numpy(), want)
    if where != "loudness at zero":
        assert 0.5 in want or 1.5 in want  # a tie was hit


# -- whole steps -----------------------------------------------------------------------

def _batch(seed, n=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    clean = (0.1 * np.sin(2 * np.pi * (200 + 50 * np.arange(2))[:, None] * t)
             * (1 + np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal((2, n)))
    noise = 0.1 * rng.standard_normal((2, n))
    wavs = np.stack([clean + noise, clean, noise], axis=1).astype(np.float32)
    return wavs, np.array([n, n * 3 // 4])


@pytest.fixture(scope="module")
def jax_side():
    """The JAX flagship at hidden 8, 2 layers (scan recurrence), BertAdam
    with a 10-step schedule, and its initial state."""
    builder = dataclasses.replace(
        graft._build(use_pallas=False, **SMALL),
        optimizer=j_optim.build_optimizer("BertAdam", LR, 0.07, TOTAL), donate=False,
    )
    wavs, lengths = _batch(0)
    state = builder.init_state(jax.random.PRNGKey(0), jnp.asarray(wavs),
                               jnp.asarray(lengths))
    return builder, jax.device_get(state)


def _port_builder(params, objective):
    builder = dataclasses.replace(
        entry.build_train(device="cpu", **SMALL),
        optimizer=optim.build_optimizer("BertAdam", LR, 0.07, TOTAL),
        objective=objectives.build_objective(objective),
    )
    builder.model.load_state_dict(flax_to_state_dict(params))
    return builder


@pytest.mark.parametrize("objective", ["stoi", "estoi", "pmsqe"])
def test_eval_step_loss_matches_jax(jax_side, objective):
    builder, state = jax_side
    jbuilder = dataclasses.replace(builder, objective=j_objectives.build_objective(objective))
    wavs, lengths = _batch(5)
    ref = jax.jit(jbuilder.eval_step_raw("first"))(
        state.params, jnp.asarray(wavs), jnp.asarray(lengths), None)
    out = _port_builder(state.params, objective).eval_step(
        torch.from_numpy(wavs), torch.from_numpy(lengths), wav_out="first")
    assert np.isfinite(float(out["loss"]))
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]), rtol=LOSS_RTOL)


def test_pmsqe_train_step_matches_jax(jax_side):
    """The parameter gradients of the loss, then one whole step: loss,
    gradient norm and the updated parameters."""
    builder, state = jax_side
    jbuilder = dataclasses.replace(builder, objective=j_objectives.build_objective("pmsqe"))
    wavs, lengths = _batch(1)
    port = _port_builder(state.params, "pmsqe")
    jctx = j_make_context(jbuilder.preprocessor, jnp.asarray(wavs), jnp.asarray(lengths), 0, 1)
    jgrads = flax_to_state_dict(jax.device_get(jax.jit(jax.grad(
        lambda p: jbuilder.loss_fn(p, jctx)[0]))(state.params)))
    pstate = port.init_state()
    loss, _ = port.loss_fn(make_context(port.preprocessor, torch.from_numpy(wavs),
                                        torch.from_numpy(lengths), 0, 1))
    grads = torch.autograd.grad(loss, [pstate.params[k] for k in jgrads])
    for k, g in zip(jgrads, grads):
        err, tol = _grad_err(g.numpy(), jgrads[k].numpy())
        assert err <= tol, (k, err, tol)

    new, jstats = jax.jit(jbuilder.train_step_raw())(
        state, jnp.asarray(wavs), jnp.asarray(lengths), jax.random.PRNGKey(0), None)
    _, stats = port.train_step(pstate, torch.from_numpy(wavs), torch.from_numpy(lengths))
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(stats["grad_norm"]), float(jstats["grad_norm"]),
                               rtol=LOSS_RTOL)
    assert not bool(stats["skipped"]) and not bool(jstats["skipped"])
    ref = flax_to_state_dict(jax.device_get(new.params))
    got = port.model.state_dict()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("objective", ["stoi", "estoi"])
def test_stoi_objective_fails_a_train_step_like_jax(jax_side, objective):
    """The train step's context holds no waveform: both packages fail on
    the missing argument (there the STOI objectives are eval losses)."""
    builder, state = jax_side
    wavs, lengths = _batch(1)
    jstep = dataclasses.replace(
        builder, objective=j_objectives.build_objective(objective)).train_step_raw()
    with pytest.raises(TypeError, match="wav_predicted"):
        jax.jit(jstep)(state, jnp.asarray(wavs), jnp.asarray(lengths),
                       jax.random.PRNGKey(0), None)
    port = _port_builder(state.params, objective)
    with pytest.raises(TypeError, match="wav_predicted"):
        port.train_step(port.init_state(), torch.from_numpy(wavs), torch.from_numpy(lengths))


def test_objectives_run_with_tf32_off_in_both_steps(jax_side, monkeypatch):
    """A caller with TF32 on: the objective still runs with it off, in the
    train and the eval step, and the caller's settings come back."""
    _, state = jax_side
    port = _port_builder(state.params, "pmsqe")
    seen = []
    inner = port.objective

    def watched(**ctx):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return inner(**ctx)

    port = dataclasses.replace(port, objective=watched)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    wavs, lengths = (torch.from_numpy(a) for a in _batch(2))
    port.train_step(port.init_state(), wavs, lengths)
    port.eval_step(wavs, lengths, wav_out="first")
    assert seen == [(False, False), (False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("value", [0.1, 0.7, 1.1])
def test_center_makes_a_constant_row_exactly_zero(value):
    """A segment of silence is a constant envelope. Less its mean it is the
    rounding of that mean, which depends on the order of the sum (on the CPU
    already, for these values); ``_center`` takes the first element off
    first, so the row is exactly zero in any order, on the card too (where
    the ``stoi`` objective's NaN gradient rows must then match the CPU's)."""
    z = torch.full((2, 15, 30), value)
    assert (z - z.mean(dim=-1, keepdim=True)).any()
    assert not t_stoi._center(z, -1).any() and not t_stoi._center(z, -2).any()
    x = torch.rand(2, 15, 30, dtype=torch.float64)
    torch.testing.assert_close(t_stoi._center(x, -1), x - x.mean(dim=-1, keepdim=True))


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_coeff_batch_runs_under_autograd_with_the_values_of_inference(extended):
    """Under autograd the scores keep the bits of an inference call, with
    and without silent-frame removal, and a gradient reaches the input."""
    pred, tar, _ = _wav_case()
    lengths = torch.tensor([SR, 11200])
    for remove_silent in (False, True):
        p = torch.from_numpy(pred).requires_grad_()
        score = t_stoi.stoi_coeff_batch(torch.from_numpy(tar), p, SR, extended=extended,
                                        remove_silent=remove_silent, lengths=lengths)
        with torch.inference_mode():
            again = t_stoi.stoi_coeff_batch(torch.from_numpy(tar), torch.from_numpy(pred), SR,
                                            extended=extended, remove_silent=remove_silent,
                                            lengths=lengths)
        assert torch.equal(score.detach(), again)
        score.sum().backward()
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0
