"""The dropout-live train steps of the port against the JAX package's on the
CPU, from one step key and no salt replay (the masks themselves:
tests/test_torch_port_flax_dropout.py).

- the Mockingjay joint finetune (2 layers, hidden 32) two steps under JAX's
  defaults, the bench's flash + hash routes and the chunked path, against
  ``train_step_raw(..., rng)``: loss, gradient norm and every parameter;
- the upstream finetune step (``--dropout 0.1``, spec_aug on) the same way;
- a two-rank ``--mesh 2`` step (tests/torch_port_flax_dropout_worker.py)
  under the default routes drawing the single process's masks, D1's and
  B3's flax form, row for row, and its stats;
- the active sampler over a live upstream: the mean and per-row embeddings
  from JAX's scoring keys.
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
from speech_enhancement_by_s3prl_tpu.models import heads as j_heads
from speech_enhancement_by_s3prl_tpu.models import upstream as j_up
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu_torch import entry
from speech_enhancement_by_s3prl_tpu_torch.models import heads as t_heads
from speech_enhancement_by_s3prl_tpu_torch.models import upstream as t_up
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.runner import optim
from tests.test_torch_port_flax_dropout import ROUTES, key_of, routes  # noqa: F401
from tests.test_torch_port_mockingjay import (
    LR,
    RESIDUAL,
    TOTAL,
    _assert_params_close,
    _assert_stats_close,
    _batch,
    _configs,
    _jax_mockingjay,
    _port_mockingjay,
    s3prl_ckpt,  # noqa: F401 (a fixture)
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 300


@pytest.mark.parametrize("route", ["defaults", "flash_and_hash", "chunked_hash"])
def test_mockingjay_steps_match_jax_from_the_same_key(routes, route):
    """Two dropout-live steps of the joint finetune from one step key (JAX's
    ``train_step_raw(..., rng)``; the port's ``train_step(..., rng=)``), no
    salt replay: loss, gradient norm and every parameter."""
    routes.set(ROUTES[route])
    jcfg, tcfg = _configs(0.1)
    builder, state = _jax_mockingjay(jcfg)
    step = jax.jit(builder.train_step_raw())  # traced here, under the variables
    port = _port_mockingjay(tcfg, state.params)
    pstate = port.init_state()
    for k in range(2):
        wavs, lengths = _batch(10 + k)
        state, jstats = step(state, jnp.asarray(wavs), jnp.asarray(lengths),
                             jax.random.PRNGKey(5 + k), None)
        pstate, stats = port.train_step(pstate, torch.from_numpy(wavs),
                                        torch.from_numpy(lengths), rng=key_of(5 + k))
        _assert_stats_close(stats, jstats)
        _assert_params_close(port.model, state.params)


def test_upstream_finetune_step_matches_jax_from_the_same_key(s3prl_ckpt):  # noqa: F811
    """The upstream mode with ``--dropout 0.1`` and spec_aug on: the upstream
    draws its bands and masks from the step's key, as JAX's does."""
    jup = j_up.build_upstream("transformer", 80, s3prl_ckpt, dropout=0.1)
    jup.options.spec_aug = True
    jhead = j_heads.build_head("Residual", input_size=32, output_size=201, **RESIDUAL)
    jb = dataclasses.replace(
        graft._build(delta=1), model=jhead, upstream=jup, from_rawfeature=False,
        donate=False, optimizer=j_optim.build_optimizer("BertAdam", LR, 0.07, TOTAL))
    wavs, lengths = _batch(0)
    state = jax.device_get(jb.init_state(jax.random.PRNGKey(1), jnp.asarray(wavs),
                                         jnp.asarray(lengths)))
    pup = t_up.build_upstream("transformer", 80, s3prl_ckpt, dropout=0.1)
    pup.options.spec_aug = True
    phead = t_heads.build_head("Residual", input_size=32, output_size=201, **RESIDUAL)
    phead.load_state_dict(flax_to_state_dict(state.params))
    pb = dataclasses.replace(
        entry.build_train(device="cpu", hidden_size=8, num_layers=1), model=phead,
        upstream=pup, from_rawfeature=False,
        optimizer=optim.build_optimizer("BertAdam", LR, 0.07, TOTAL))
    pstate = pb.init_state()
    jstep = jax.jit(jb.train_step_raw())
    for k in range(2):
        wavs, lengths = _batch(k)
        state, jstats = jstep(state, jnp.asarray(wavs), jnp.asarray(lengths),
                              jax.random.PRNGKey(3 + k), jb.upstream_params())
        pstate, stats = pb.train_step(pstate, torch.from_numpy(wavs),
                                      torch.from_numpy(lengths), rng=key_of(3 + k))
        _assert_stats_close(stats, jstats)
        _assert_params_close(phead, state.params)


# -- a two-rank mesh ----------------------------------------------------------------

def test_two_ranks_draw_the_single_process_masks(tmp_path):
    """``--mesh 2`` under JAX's default routes: each rank's D1 masks and B3
    flax-form masks are its rows of the single process's, and the stats the
    single process's."""
    from tests.torch_port_flax_dropout_worker import mockingjay_case, recording

    builder, batches = mockingjay_case()
    weights = {k: v.clone() for k, v in builder.model.state_dict().items()}
    state = builder.init_state()
    with recording() as single:
        stats = []
        for k, (w, n) in enumerate(batches):
            state, st = builder.train_step(state, w, n, rng=key_of(5 + k))
            stats.append((float(st["loss"]), float(st["grad_norm"])))
    torch.save({"weights": weights}, tmp_path / "in.pt")
    init = "file://" + str(tmp_path / "rendezvous")
    worker = os.path.join(REPO, "tests", "torch_port_flax_dropout_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", init,
                               str(tmp_path / "in.pt"), str(tmp_path / f"out{r}.pt")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "1"}) for r in range(2)]
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    ranks = [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(2)]
    rows = batches[0][0].shape[0] // 2
    for r, res in enumerate(ranks):
        assert len(res["masks"]) == len(single) > 0
        for (site, got), (site_s, want) in zip(res["masks"], single):
            assert site == site_s
            assert torch.equal(got, want[r * rows:(r + 1) * rows]), site
        for (loss, norm), (want_loss, want_norm) in zip(res["stats"], stats):
            np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
            np.testing.assert_allclose(norm, want_norm, rtol=1e-6)


def test_sampler_draws_jaxs_keys_through_a_live_upstream(s3prl_ckpt):  # noqa: F811
    """The active sampler scoring a head over an upstream whose dropout
    ``--dropout`` puts live: the mean embedding from the batch's key and the
    per-row (vmap) embeddings, row i from ``split(rng, B)[i]`` on a batch of
    one, as the JAX sampler draws them; within 1e-5 of the largest value."""
    from speech_enhancement_by_s3prl_tpu.active import sampler as j_sampler
    from speech_enhancement_by_s3prl_tpu_torch.active import sampler as t_sampler

    jup = j_up.build_upstream("transformer", 80, s3prl_ckpt, dropout=0.1)
    jhead = j_heads.build_head("Residual", input_size=32, output_size=201, **RESIDUAL)
    jb = dataclasses.replace(graft._build(delta=1), model=jhead, upstream=jup,
                             from_rawfeature=False, donate=False)
    wavs, lengths = _batch(6)
    state = jb.init_state(jax.random.PRNGKey(1), jnp.asarray(wavs), jnp.asarray(lengths))
    pup = t_up.build_upstream("transformer", 80, s3prl_ckpt, dropout=0.1)
    phead = t_heads.build_head("Residual", input_size=32, output_size=201, **RESIDUAL)
    phead.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))
    pb = dataclasses.replace(entry.build_train(device="cpu", hidden_size=8, num_layers=1),
                             model=phead, upstream=pup, from_rawfeature=False)
    jscore = j_sampler.make_scoring_fn(jb, None, impl="vmap")
    pscore = t_sampler.make_scoring_fn(pb, None, impl="vmap")
    for mean in (True, False):
        want = np.asarray(jscore(state.params, wavs, lengths, mean=mean,
                                 rng=jax.random.PRNGKey(4)))
        got = pscore(phead, torch.from_numpy(wavs), torch.from_numpy(lengths), mean=mean,
                     rng=key_of(4)).detach().numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), mean
        other = pscore(phead, torch.from_numpy(wavs), torch.from_numpy(lengths), mean=mean,
                       rng=key_of(5)).detach().numpy()
        assert np.abs(other - want).max() > 1e-3 * np.abs(want).max()
