"""The port's tensor parallelism (``--mesh DxM``, ``parallel/mesh.py``) on
the CPU, over gloo ranks, and B3's head offset.

One worker script (``tests/torch_port_model_parallel_worker.py``) runs once
per mesh shape: as two processes for ``1x2`` and as four for ``2x2``, all six
at once, each group meeting through its own rendezvous file and each process
with its own time limit. Each rank takes the tensor-parallel train step on its
rows and shards of the same global batches, writes and resumes a checkpoint of
the full tree, and scores an eval batch over all the ranks. It is held
against:

- the port's single process on the global batch, dropout live: every dropout
  mask bit for bit (the rank's rows and, for B3, its heads of the single
  process's masks), the loss and gradient norm within 1e-6 relative, the
  gathered parameters after 2 steps within 2e-6;
- the JAX package's ``make_parallel_train_step`` on a 2 x 2 mesh of the CPU's
  virtual devices, through the weight bridge, at dropout 0 (its masks under a
  model axis come from its non-flash attention), at the tolerances of
  tests/test_parallel.py (loss rtol 1e-5, parameters atol 2e-5);
- itself: the replicated parameters bit for bit across each model group and
  every rank's stats the same; the resumed step's loss within 1e-6 of the
  continued run's (``__graft_entry__.py``'s round trip);
- the single-device eval, at tests/test_runner_mesh.py's tolerances.

The cases: the flagship structure (``Residual``, a BLSTM of 16, SISDR) and the
Mockingjay joint finetune (hidden 32, 4 heads, 2 layers, FFN 64).
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
from speech_enhancement_by_s3prl_tpu.models import spec_head as j_spec
from speech_enhancement_by_s3prl_tpu.models import transformer as j_tf
from speech_enhancement_by_s3prl_tpu.parallel import mesh as j_mesh
from speech_enhancement_by_s3prl_tpu.runner import optim as j_optim
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.models.spec_head import Mockingjay
from speech_enhancement_by_s3prl_tpu_torch.models.transformer import TransformerConfig
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A
from speech_enhancement_by_s3prl_tpu_torch.parallel import mesh as t_mesh
from tests.torch_port_model_parallel_worker import (
    LR,
    MOCKINGJAY,
    RESIDUAL,
    TOTAL,
    port_builder,
    recording_masks,
    row_parallel_case,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
# a worker's own limit: a hung rendezvous fails the test, not the suite
WORKER_TIMEOUT = 120
STEPS = 2
# name: (kind, dropout rate, held against)
CASES = {"residual": ("residual", 0.0, ("single", "jax")),
         "mockingjay": ("mockingjay", 0.1, ("single",)),
         "mockingjay0": ("mockingjay", 0.0, ("jax",))}
# the ranks against the port's single process: the same f32 arithmetic, each
# product and norm summed in other parts
PORT_LOSS_RTOL, PORT_PARAM_ATOL = 1e-6, 2e-6
# against the JAX mesh step (tests/test_parallel.py)
JAX_LOSS_RTOL, JAX_PARAM_ATOL = 1e-5, 2e-5
# the mesh eval against the single-device eval (tests/test_runner_mesh.py)
EVAL_LOSS_RTOL, EVAL_SCORE_RTOL = 2e-4, 2e-3
# the resumed step's loss against the continued run's (__graft_entry__.py)
RESUME_ATOL = 1e-6


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


def _jax_builder(kind, dropout):
    opt = j_optim.build_optimizer("BertAdam", LR, 0.07, TOTAL)
    if kind == "mockingjay":
        cfg = j_tf.TransformerConfig(**MOCKINGJAY, hidden_dropout_prob=dropout,
                                     attention_probs_dropout_prob=dropout)
        return dataclasses.replace(
            graft._build(delta=1), model=j_spec.Mockingjay(output_size=201, config=cfg),
            from_waveform=True, from_rawfeature=False, donate=False, optimizer=opt)
    return dataclasses.replace(graft._build(use_pallas=False, **RESIDUAL), donate=False,
                               optimizer=opt)


def _jax_case(kind, dropout, batches, mesh_step):
    """(the initial weights as a state dict, the JAX 2 x 2 mesh step's
    [(loss, grad norm)] and final weights, or None without ``mesh_step``)."""
    builder = _jax_builder(kind, dropout)
    wavs, lengths = batches[0]
    state = builder.init_state(jax.random.PRNGKey(0), jnp.asarray(wavs), jnp.asarray(lengths))
    weights = flax_to_state_dict(jax.device_get(state.params))
    if not mesh_step:
        return weights, None
    step, state = j_mesh.make_parallel_train_step(
        builder, j_mesh.make_mesh(4, model_parallel=2), state)
    stats = []
    for k, (w, n) in enumerate(batches):
        state, st = step(state, jnp.asarray(w), jnp.asarray(n), jax.random.PRNGKey(5 + k))
        stats.append((float(st["loss"]), float(st["grad_norm"])))
    return weights, (stats, flax_to_state_dict(jax.device_get(state.params)))


def _single(kind, dropout, weights, batches):
    """The port's single-process steps on the global batches, recording the
    masks: ([(loss, grad norm)], final weights, masks)."""
    builder = port_builder(kind, dropout)
    builder.model.load_state_dict(weights)
    state = builder.init_state()
    stats = []
    with recording_masks() as masks:
        for w, n in batches:
            state, st = builder.train_step(state, torch.from_numpy(w), torch.from_numpy(n))
            stats.append((float(st["loss"]), float(st["grad_norm"])))
    return stats, {k: v.detach().clone() for k, v in state.params.items()}, masks


def _spawn(tmp, name, world, payload):
    torch.save(payload, tmp / f"{name}.in.pt")
    init = "file://" + str(tmp / f"{name}.rendezvous")
    worker = os.path.join(REPO, "tests", "torch_port_model_parallel_worker.py")
    return [subprocess.Popen([sys.executable, worker, str(r), str(world), init,
                              str(tmp / f"{name}.in.pt"), str(tmp / f"{name}.out{r}.pt")],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env={**os.environ, "OMP_NUM_THREADS": "1"})
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side of every case: the JAX mesh steps, the port's single
    process, and each mesh shape's ranks (the worker's output, one dict a
    rank). The port's sides (the ranks inherit the variables) draw on the
    hash routes, whose masks the recorder reads."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SE_ATTN_IMPL", "flash")
        mp.setenv("SE_HIDDEN_DROPOUT_IMPL", "hash")
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("model_parallel")
    batches = [_batch(k) for k in range(STEPS)]
    nxt = _batch(STEPS)
    jax_sides, singles, train = {}, {}, {}
    for name, (kind, dropout, against) in CASES.items():
        weights, jax_sides[name] = _jax_case(kind, dropout, batches, "jax" in against)
        if "single" in against:
            singles[name] = _single(kind, dropout, weights, batches)
        train[name] = {"kind": kind, "dropout": dropout, "weights": weights,
                       "batches": [(torch.from_numpy(w), torch.from_numpy(n))
                                   for w, n in batches]}
    train["mockingjay"]["next"] = tuple(torch.from_numpy(x) for x in nxt)
    eval_builder = port_builder("residual")
    eval_batch = tuple(torch.from_numpy(x) for x in _batch(9, rows=8))
    single_eval = eval_builder.eval_step(*eval_batch)
    evals = {"kind": "residual", "weights": eval_builder.model.state_dict(),
             "batch": eval_batch}
    procs = {}
    for name, (data, model) in MESHES.items():
        workdir = tmp / name
        workdir.mkdir()
        procs[name] = _spawn(tmp, name, data * model,
                             {"mesh": (data, model), "train": train, "eval": evals,
                              "workdir": str(workdir)})
    ranks = {}
    for name, group in procs.items():
        for r, p in enumerate(group):
            try:
                _, err = p.communicate(timeout=WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                for q in (q for g in procs.values() for q in g):
                    q.kill()
                raise
            assert p.returncode == 0, f"{name} rank {r} failed:\n{err[-3000:]}"
        ranks[name] = [torch.load(tmp / f"{name}.out{r}.pt", weights_only=False)
                       for r in range(len(group))]
    return {"jax": jax_sides, "single": singles, "ranks": ranks, "single_eval": single_eval}


def _cases(against):
    return [pytest.param(mesh, name, id=f"{mesh}-{name}") for mesh in MESHES
            for name, case in CASES.items() if against in case[2]]


@pytest.mark.parametrize("mesh,name", _cases("single"))
def test_model_parallel_step_is_the_single_process_step(runs, mesh, name):
    stats, params, masks = runs["single"][name]
    data, model = MESHES[mesh]
    for res in runs["ranks"][mesh]:
        got = res[name]
        for (loss, norm), (want_loss, want_norm) in zip(got["stats"], stats):
            np.testing.assert_allclose(loss, want_loss, rtol=PORT_LOSS_RTOL)
            np.testing.assert_allclose(norm, want_norm, rtol=PORT_LOSS_RTOL)
        for k, want in params.items():
            np.testing.assert_allclose(got["params"][k].numpy(), want.numpy(),
                                       atol=PORT_PARAM_ATOL, rtol=0, err_msg=k)
        # every mask the rank drew is its rows (and, for B3, heads) of the
        # single process's
        assert len(got["masks"]) == len(masks)
        assert (len(masks) > 0) == (name == "mockingjay")
        for (site, _, mask), (got_site, head0, got_mask) in zip(masks, got["masks"]):
            assert got_site == site
            rows = mask.shape[0] // data
            want = mask[res["d"] * rows:(res["d"] + 1) * rows]
            if site == "attention":
                heads = mask.shape[1] // model
                assert head0 == res["m"] * heads
                want = want[:, head0:head0 + heads]
            assert torch.equal(got_mask, want), (site, res["d"], res["m"])


@pytest.mark.parametrize("mesh,name", _cases("jax"))
def test_model_parallel_step_matches_the_jax_mesh_step(runs, mesh, name):
    stats, params = runs["jax"][name]
    for res in runs["ranks"][mesh]:
        for (loss, norm), (want_loss, want_norm) in zip(res[name]["stats"], stats):
            np.testing.assert_allclose(loss, want_loss, rtol=JAX_LOSS_RTOL)
            np.testing.assert_allclose(norm, want_norm, rtol=JAX_LOSS_RTOL)
        for k, want in params.items():
            np.testing.assert_allclose(res[name]["params"][k].numpy(), want.numpy(),
                                       atol=JAX_PARAM_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("mesh,name", [pytest.param(m, n, id=f"{m}-{n}")
                                       for m in MESHES for n in CASES])
def test_replicated_parameters_keep_one_set_of_bits_in_a_model_group(runs, mesh, name):
    ranks = runs["ranks"][mesh]
    for res in ranks:
        assert res[name]["stats"] == ranks[0][name]["stats"]
        assert res[name]["sharded"] == ranks[0][name]["sharded"] != []
    for a in ranks:
        for b in ranks:
            if a["d"] == b["d"]:
                for k, v in a[name]["replicated"].items():
                    assert torch.equal(v, b[name]["replicated"][k]), (k, a["m"], b["m"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_model_parallel_checkpoint_is_the_full_tree_and_resumes(runs, mesh):
    """A checkpoint written from the mesh holds the full tree (the format of
    a run without a mesh), and the step resumed from it on the mesh gives the
    continued run's loss."""
    want_keys = sorted(runs["single"]["mockingjay"][1])
    full_shapes = {k: tuple(v.shape) for k, v in runs["single"]["mockingjay"][1].items()}
    for res in runs["ranks"][mesh]:
        got = res["mockingjay"]["resume"]
        assert got["file_keys"] == want_keys
        assert got["file_mu_shapes"] == full_shapes
        np.testing.assert_allclose(got["resumed"][0], got["continued"][0], atol=RESUME_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got["resumed"][1], got["continued"][1], rtol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_eval_over_every_rank_matches_the_single_device(runs, mesh):
    want = runs["single_eval"]
    for res in runs["ranks"][mesh]:
        got = res["eval"]
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=EVAL_LOSS_RTOL)
        for k, v in want["scores"].items():
            assert got["scores"][k].shape == v.shape == (8,)
            np.testing.assert_allclose(got["scores"][k].numpy(), v.numpy(),
                                       rtol=EVAL_SCORE_RTOL)
        assert torch.equal(got["wav_predicted"], want["wav_predicted"])


@pytest.mark.parametrize("mesh,dtype", [pytest.param(m, d, id=f"{m}-{str(d)[6:]}")
                                        for m in MESHES for d in (torch.float32, torch.bfloat16)])
def test_row_parallel_dense_is_the_whole_dense(runs, mesh, dtype):
    """``ModelAxis.row_parallel`` over the model group against the whole
    ``Dense``: f32 within 1e-6 of the largest value; bf16 (exact products
    summed in f32 across the ranks, rounded once, the bias added in bf16)
    within one bf16 unit of it."""
    layer, x = row_parallel_case()
    with torch.no_grad():
        want = layer(x.to(dtype)).float()
    limit = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    for res in runs["ranks"][mesh]:
        got = res["row_parallel"][str(dtype)]
        assert got.dtype == dtype and got.shape == want.shape
        assert float((got.float() - want).abs().max() / want.abs().max()) <= limit


def _mockingjay_params(heads=4, hidden=32, intermediate=64, share_layer=False):
    cfg = TransformerConfig(input_dim=16, hidden_size=hidden, num_hidden_layers=2,
                            num_attention_heads=heads, intermediate_size=intermediate,
                            share_layer=share_layer)
    return dict(Mockingjay(input_size=16, output_size=33, config=cfg).named_parameters())


def test_param_shardings_put_the_megatron_pairing_on_a_mockingjay_tree():
    """tests/test_parallel.py's layout on the port's names: qkv (by heads) and
    ``intermediate`` column-parallel with their biases, every ``layer_*``'s
    output kernel row-parallel, the spec head's output and the LayerNorms
    replicated."""
    params = _mockingjay_params()
    specs = t_mesh.param_shardings(t_mesh.Mesh(1, 0, model=2), params, n_heads=4)
    qkv = [k for k in params if ".attention.qkv." in k]
    assert qkv and all(specs[k] == t_mesh.Shard(0, 3) for k in qkv)
    inter = [k for k in params if ".intermediate." in k]
    assert inter and all(specs[k] == t_mesh.Shard(0) for k in inter)
    rows = [k for k in params if ".layer_" in k and k.endswith("output.weight")]
    assert len(rows) == 4 and all(specs[k] == t_mesh.Shard(1) for k in rows)
    out_bias = [k for k in params if ".layer_" in k and k.endswith("output.bias")]
    assert out_bias and all(specs[k] is None for k in out_bias)
    assert specs["spechead.output.weight"] is None
    assert all(specs[k] is None for k in params if "_ln." in k or "spec_transform" in k)
    # by heads: rank m's qkv rows are the q, k and v rows of its heads
    # a shared layer (``layer_shared``) shards as the layers do
    shared = _mockingjay_params(share_layer=True)
    specs = t_mesh.param_shardings(t_mesh.Mesh(1, 0, model=2), shared, n_heads=4)
    assert {k for k, v in specs.items() if v is not None} == {
        f"mockingjay.layer_shared.{n}" for n in (
            "attention.qkv.weight", "attention.qkv.bias", "attention.output.weight",
            "intermediate.weight", "intermediate.bias", "output.weight")}
    w = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(3 * 8, 2)  # H = 8, N = 4, D = 2
    got = t_mesh.shard_tensor(w, t_mesh.Shard(0, 3), 1, 2)
    assert torch.equal(got, torch.cat([w[4:8], w[12:16], w[20:24]]))


def test_param_shardings_replicate_what_the_model_axis_does_not_divide():
    """tests/test_parallel.py's divisibility guard with the port's guards: 3
    heads over 2 ranks replicate the attention (JAX would cut the 3H = 96
    columns of qkv), an FFN of 63 replicates the FFN pair, a 4H of 64 shards
    the LSTM's gate rows; a 1-rank model axis shards nothing."""
    params = _mockingjay_params(heads=3, hidden=48, intermediate=63)
    specs = t_mesh.param_shardings(t_mesh.Mesh(1, 0, model=2), params, n_heads=3)
    assert all(specs[k] is None for k in params if ".attention." in k)
    assert all(specs[k] is None for k in params if ".intermediate." in k)
    assert all(specs[k] is None for k in params if k.endswith(".output.weight"))
    lstm = dict(port_builder("residual").model.named_parameters())
    specs = t_mesh.param_shardings(t_mesh.Mesh(1, 0, model=2), lstm)
    gates = [k for k in lstm if k.split(".")[-1] in ("w_ih", "w_hh", "b_ih", "b_hh")]
    assert len(gates) == 8 and all(specs[k] == t_mesh.Shard(0) for k in gates)
    assert specs["scaling_layer.weight"] is None
    assert all(v is None for v in t_mesh.param_shardings(t_mesh.Mesh(2), lstm).values())


def test_train_state_moments_follow_their_parameters():
    """``shard_train_state`` slices each ``mu`` / ``nu`` as its parameter,
    matched by name (tests/test_runner_mesh.py's path-matched moments)."""
    builder = port_builder("mockingjay")
    state = builder.init_state()
    gen = torch.Generator().manual_seed(3)
    for moment in ("mu", "nu"):
        state.opt_state[moment] = {k: torch.randn(v.shape, generator=gen)
                                   for k, v in state.opt_state[moment].items()}
    mesh = t_mesh.Mesh(1, 1, model=2)  # rank 1: m = 1
    tp = t_mesh.TensorParallel.of(builder.model, mesh)
    sharded = t_mesh.shard_train_state(mesh, state, tp)
    assert sharded.opt_state["count"] is state.opt_state["count"]
    for k, p in sharded.params.items():
        spec = tp.specs[k]
        full = dict(builder.model.named_parameters())[k].detach()
        want = full if spec is None else t_mesh.shard_tensor(full, spec, 1, 2)
        assert torch.equal(p.detach(), want), k
        for moment in ("mu", "nu"):
            m = state.opt_state[moment][k]
            assert torch.equal(sharded.opt_state[moment][k],
                               m if spec is None else t_mesh.shard_tensor(m, spec, 1, 2)), k
    assert tp.sharded and all("mockingjay.layer_" in k for k in tp.sharded)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_ref_at_a_head_offset_is_those_heads_of_the_full_call(dtype):
    """B3's plain versions on heads [2, 4) of 4 at ``head0`` 2 against heads
    [2, 4) of the full call, rate 0.1 at a batch offset: the masks bit for
    bit, out, lse, dq, dk and dv within 1e-6 of their largest value."""
    gen = torch.Generator().manual_seed(23)
    B, T, N, D = 2, 37, 4, 16
    q, k, v, dout = (torch.randn(B, T, N * D, generator=gen).to(dtype) for _ in range(4))
    args = (D ** -0.5, 0.1, (0x12345678, 0x9ABCDEF0), None, 3)
    with recording_masks() as masks:
        out, lse = A.flash_attention_fwd(q, k, v, *args, n_heads=N)
        grads = A.flash_attention_bwd(q, k, v, out, lse, dout, *args, n_heads=N)
    cut = slice(2 * D, 4 * D)
    part = tuple(x[..., cut].contiguous() for x in (q, k, v, out, dout))
    with recording_masks() as part_masks:
        out2, lse2 = A.flash_attention_fwd(*part[:3], *args, n_heads=2, head0=2,
                                           n_heads_total=N)
        grads2 = A.flash_attention_bwd(*part[:3], part[3], lse[:, 2:], part[4], *args,
                                       n_heads=2, head0=2, n_heads_total=N)
    assert len(masks) == len(part_masks) == 2
    for (_, _, full), (_, head0, mine) in zip(masks, part_masks):
        assert head0 == 2 and torch.equal(mine, full[:, 2:])
    assert not torch.equal(part_masks[0][2], masks[0][2][:, :2])  # the offset matters
    for got, want in zip((out2, lse2) + grads2, (out[..., cut], lse[:, 2:])
                         + tuple(g[..., cut] for g in grads)):
        want = want.float()
        err = float((got.float() - want).abs().max() / want.abs().max())
        assert err <= 1e-6, err


def test_dryrun_multichip_on_four_cpu_ranks(tmp_path):
    """``entry.dryrun_multichip(4, device="cpu")``: every check of JAX's
    ``dryrun_multichip`` passes on a 2 x 2 mesh of gloo ranks."""
    code = ("import sys; sys.path.insert(0, %r); import torch; torch.set_num_threads(1); "
            "from speech_enhancement_by_s3prl_tpu_torch.entry import dryrun_multichip; "
            "dryrun_multichip(4, device='cpu', out=%r)" % (REPO, str(tmp_path / "res")))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=WORKER_TIMEOUT, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[dryrun_multichip]")]
    assert len(lines) == 7 and "mesh data=2 model=2" in lines[0]
    assert "12 model-sharded params" in lines[4]
    res = [torch.load(f"{tmp_path / 'res'}.{r}", weights_only=False) for r in range(4)]
    assert all(r["loss"] == res[0]["loss"] and r["resume"] == res[0]["resume"] for r in res)
