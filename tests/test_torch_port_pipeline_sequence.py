"""The port's wavefront pipeline (``parallel/pipeline.py``) and its
sequence-parallel encoder (``parallel/sequence.py``) on the CPU, over gloo
ranks: the cases of tests/test_pipeline_lstm.py and
tests/test_sequence_parallel.py.

One worker script (``tests/torch_port_pipeline_sequence_worker.py``) runs
once as eight processes that meet through a rendezvous file, each with its
own time limit: the pipelines on the first L of them, the encoder on the
(data, seq) meshes of all eight. Each result is held, within 2e-5, against
the same JAX function on the CPU's virtual devices (through the weight
bridge) and against the port's single-process module (``LSTMStack``,
``TransformerEncoder``). The refusals and ``pad_frames_for_seq`` run in
this process.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh

from speech_enhancement_by_s3prl_tpu.models.lstm import LSTMStack as JaxLSTMStack
from speech_enhancement_by_s3prl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    TransformerEncoder as JaxEncoder,
)
from speech_enhancement_by_s3prl_tpu.parallel import pipeline as j_pipe
from speech_enhancement_by_s3prl_tpu.parallel import sequence as j_seq
from speech_enhancement_by_s3prl_tpu_torch.models.convert import flax_to_state_dict
from speech_enhancement_by_s3prl_tpu_torch.models.lstm import LSTMStack
from speech_enhancement_by_s3prl_tpu_torch.models.transformer import (
    MAX_POSITIONS,
    TransformerConfig,
    TransformerEncoder,
)
from speech_enhancement_by_s3prl_tpu_torch.parallel import pipeline as t_pipe
from speech_enhancement_by_s3prl_tpu_torch.parallel import sequence as t_seq
from speech_enhancement_by_s3prl_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
# a worker's own limit: a hung rendezvous fails the test, not the suite
WORKER_TIMEOUT = 120
ATOL = 2e-5  # tests/test_pipeline_lstm.py, tests/test_sequence_parallel.py
# name: (L, B, T, H, n_chunks, seed) as tests/test_pipeline_lstm.py
PIPES = {"L4-chunks8": (4, 2, 64, 8, 8, 0), "L2-chunk1": (2, 1, 16, 4, 1, 1)}
# name: (data, seq, batch, frames, downsample_rate, key) as
# tests/test_sequence_parallel.py (the downsample case on a 2 x 4 mesh of the
# eight ranks; JAX runs it on 1 x 4)
SEQS = {"2x4": (2, 4, 4, 40, 1, 1), "4x2": (4, 2, 4, 40, 1, 1), "1x8": (1, 8, 4, 40, 1, 1),
        "2x4-dr2": (2, 4, 2, 48, 2, 2)}


def _small_cfg(**kw):
    return dict(input_dim=16, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, **kw)


def _pipe_case(L, B, T, H, n_chunks, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((B, T, H)), dtype=jnp.float32)
    model = JaxLSTMStack(H, num_layers=L, bidirectional=False)
    params = model.init(jax.random.PRNGKey(seed), x)
    mesh = JaxMesh(np.array(jax.devices()[:L]), axis_names=("pipe",))
    out = j_pipe.pipeline_lstm(x, j_pipe.stack_lstm_params(params, L), mesh, n_chunks=n_chunks)
    weights = flax_to_state_dict(jax.device_get(params))
    stack = LSTMStack(H, H, L, bidirectional=False)
    stack.load_state_dict(weights)
    xt = torch.from_numpy(np.array(x))
    with torch.no_grad():
        ref = stack(xt)
    return {"jax": np.asarray(out), "port": ref,
            "in": {"L": L, "x": xt, "n_chunks": n_chunks,
                   "stacked": t_pipe.stack_lstm_params(weights, L)}}


def _seq_case(data, seq, batch, frames, dr, key):
    cfg = _small_cfg(downsample_rate=dr)
    enc = JaxEncoder(JaxConfig(**cfg))
    spec = jax.random.normal(jax.random.PRNGKey(key), (batch, frames, 16), jnp.float32)
    params = enc.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                      spec)["params"]
    jax_seq = 4 if dr > 1 else seq  # tests/test_sequence_parallel.py's own mesh
    mesh = j_seq.make_seq_mesh(jax_seq * (1 if dr > 1 else data), seq_parallel=jax_seq)
    out = j_seq.sequence_parallel_encoder(enc, mesh)(params, spec)
    weights = flax_to_state_dict(jax.device_get(params))
    encoder = TransformerEncoder(TransformerConfig(**cfg))
    encoder.load_state_dict(weights)
    encoder.eval()
    st = torch.from_numpy(np.array(spec))
    with torch.no_grad():
        ref = encoder(st)
    return {"jax": np.asarray(out), "port": ref,
            "in": {"config": cfg, "weights": weights, "spec": st, "seq": seq}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("pipeline_sequence")
    pipes = {k: _pipe_case(*v) for k, v in PIPES.items()}
    seqs = {k: _seq_case(*v) for k, v in SEQS.items()}
    # the encoder's refusals, on every rank of the 2 x 4 mesh
    seqs["2x4"]["in"]["refuse"] = {"time": torch.zeros(4, 42, 16),
                                   "batch": torch.zeros(3, 40, 16)}
    torch.save({"pipeline": {k: v["in"] for k, v in pipes.items()},
                "sequence": {k: v["in"] for k, v in seqs.items()}}, tmp / "in.pt")
    init = "file://" + str(tmp / "rendezvous")
    worker = os.path.join(REPO, "tests", "torch_port_pipeline_sequence_worker.py")
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
    return {"pipes": pipes, "seqs": seqs, "ranks": ranks}


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_lstm_matches_jax_and_the_stack(runs, name):
    case = runs["pipes"][name]
    L, n_chunks = PIPES[name][0], PIPES[name][4]
    for r, res in enumerate(runs["ranks"]):
        if r >= L:
            assert name not in res["pipeline"]
            continue
        got = res["pipeline"][name]
        np.testing.assert_allclose(got["out"].numpy(), case["jax"], atol=ATOL)
        np.testing.assert_allclose(got["out"].numpy(), case["port"].numpy(), atol=ATOL)
        # B1 from the carried state, once a chunk
        assert got["b1_with_state"] == [True] * n_chunks


@pytest.mark.parametrize("name", list(SEQS))
def test_sequence_parallel_encoder_matches_jax_and_the_encoder(runs, name):
    case = runs["seqs"][name]
    data, seq = SEQS[name][:2]
    for res in runs["ranks"]:
        got = res["sequence"][name]
        assert got["mesh"] == (WORLD // seq, seq) and got["mesh"][0] == data
        assert got["training_kept"]
        np.testing.assert_allclose(got["out"].numpy(), case["jax"], atol=ATOL)
        np.testing.assert_allclose(got["out"].numpy(), case["port"].numpy(), atol=ATOL)


def test_sequence_parallel_encoder_refuses_what_jax_asserts(runs):
    """A T that seq * downsample does not divide and a batch that the data
    axis does not divide, on every rank of a 2 x 4 mesh; more positions than
    the table holds, here."""
    for res in runs["ranks"]:
        assert "must divide time 42" in res["refused"]["time"]
        assert "must divide batch 3" in res["refused"]["batch"]
    encoder = TransformerEncoder(TransformerConfig(**_small_cfg()))
    fn = t_seq.sequence_parallel_encoder(encoder, Mesh(1))
    with pytest.raises(ValueError, match="exceed the position-encoding table"):
        fn(torch.zeros(1, MAX_POSITIONS + 1, 16))
    out = fn(torch.ones(1, 8, 16))  # a mesh of one rank is the encoder itself
    with torch.no_grad():
        assert torch.equal(out, encoder.eval()(torch.ones(1, 8, 16)))


def test_pad_frames_for_seq_matches_jax():
    for t in (37, 40):
        spec = np.ones((2, t, 16), np.float32)
        want, want_t = j_seq.pad_frames_for_seq(jnp.asarray(spec), seq=4, dr=2)
        got, got_t = t_seq.pad_frames_for_seq(torch.from_numpy(spec), seq=4, dr=2)
        assert got_t == want_t == t and got.shape[1] == 40
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_pipeline_lstm_refuses_a_gradient_an_indivisible_time_and_a_model_axis():
    """Inference only, as B1 with a carried state (ROADMAP A3); ``n_chunks``
    must divide T (JAX asserts it); the pipe is a data axis. A pipe of one
    rank is the stack itself."""
    stack = LSTMStack(4, 4, 1, bidirectional=False)
    x = torch.randn(2, 12, 4)
    stacked = t_pipe.stack_lstm_params(stack, 1)
    with pytest.raises(RuntimeError, match="ROADMAP.md A3"):
        t_pipe.pipeline_lstm(x.requires_grad_(), stacked, Mesh(1), n_chunks=3)
    x = x.detach()
    with pytest.raises(ValueError, match="must divide the time axis 12"):
        t_pipe.pipeline_lstm(x, stacked, Mesh(1), n_chunks=5)
    with pytest.raises(ValueError, match="data axis"):
        t_pipe.pipeline_lstm(x, stacked, Mesh(1, 0, model=2), n_chunks=3)
    with torch.no_grad():
        np.testing.assert_allclose(t_pipe.pipeline_lstm(x, stacked, Mesh(1), n_chunks=3),
                                   stack(x), atol=ATOL)
