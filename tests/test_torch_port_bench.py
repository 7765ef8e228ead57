"""The port's cost model (``utils/costs.py``) and benchmark harness
(``bench.py``), on the CPU.

- The cost model's rules, as ``tests/test_costs.py`` pins the JAX walker's:
  exact product and batched-product counts (also where autograd is off and
  composite ops reach the mode whole), a loop's products and elementwise ops,
  the backward counted, a recomputed forward (``torch.utils.checkpoint``)
  counted again, the bytes of a weight read over steps (each eager product
  reads it; inside B1 it counts once), an op of another namespace (an
  ``se_torch`` op called without its wrapper) opaque.
- Each hand-written kernel through its wrapper (B1 and its stream, carried
  and bf16-h forms, B2 fwd / bwd in theirs, the bf16 dW_hh^T, B3 fwd / bwd
  f32 and bf16, B4, B5, B6, B7): exactly its formula, once, whatever the
  plain version dispatches.
- The bounds ``chip_smoke.py`` prints, now read from the formulas, against
  their values before the move; ``roofline``'s ``mfu`` on the H100 table.
- Parity with the JAX package at B=2, 1 s: the flagship enhance's products
  against the closed-form LSTM + head count of
  ``tests/test_costs.py::test_flagship_enhance_flops_match_hand_count``
  exactly, and the enhance, the train step and a 2-layer Mockingjay step
  against JAX ``program_cost`` of its non-Pallas program (each tolerance and
  its reason beside it).
- The harness as subprocesses at ``BENCH_CPU=1``, B=2, 1 s, 1 call: the
  enhance line, ``run_all`` restricted to enhance, the loader in both
  formats; ``run_all``'s headline when enhance fails and a bad JSON line
  (``subprocess.run`` stubbed, as tests/test_bench_smoke.py does); a device
  mode without a card raising; ``write_wav_pcm16`` of the int16 the pipeline
  mode quantizes on the device byte-identical to ``write_wav`` of the floats.

No test reads a ``BENCHMARK.json``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from speech_enhancement_by_s3prl_tpu.utils.costs import program_cost as jax_program_cost
from speech_enhancement_by_s3prl_tpu_torch import bench, entry
from speech_enhancement_by_s3prl_tpu_torch.data.audio_io import write_wav, write_wav_pcm16
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import attention_kernel as A
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import decode_kernel as D
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import library
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L
from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import stft_kernel as S
from speech_enhancement_by_s3prl_tpu_torch.tools.profile_step import build_mode
from speech_enhancement_by_s3prl_tpu_torch.utils import costs
from speech_enhancement_by_s3prl_tpu_torch.utils.costs import program_cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SECONDS, SR = 2, 1, 16000
T = SR * SECONDS
# frames of a 1 s row (hop 160), the flagship's widths
M, H, I = T // 160 + 1, 256, 120
# the JAX package's STFT is a DFT product: n_fft * 2 (n_fft // 2 + 1) real
# multiply-adds a frame and channel, where the port runs B4's FFT
DFT_PER_FRAME = 2 * 400 * 402


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rng_tensor(shape, seed, dtype=torch.float32, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dtype)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def classes(**flops):
    out = dict.fromkeys(costs.CLASSES, 0.0)
    out.update(flops)
    return out


# -- the rules --------------------------------------------------------------

def test_plain_matmul_flops_exact():
    x, w = torch.zeros(8, 16), torch.zeros(16, 32)
    c = program_cost(lambda x, w: x @ w, x, w)
    assert c["dot_flops"] == 2 * 8 * 16 * 32
    assert c["flops"] == c["dot_flops"]  # no elementwise op
    assert c["flops_by_class"] == classes(f32=2 * 8 * 16 * 32)
    assert c["opaque_calls"] == 0 and c["unbounded_loops"] == 0
    # a product is classed by its operands: bf16 operands, the bf16 class
    c = program_cost(lambda x, w: x @ w, x.bfloat16(), w.bfloat16())
    assert c["flops_by_class"] == classes(bf16=2 * 8 * 16 * 32)


@pytest.mark.parametrize("autograd", ["on", "off"])
def test_batched_product_flops(autograd):
    x, w = torch.zeros(4, 8, 16), torch.zeros(4, 16, 32)

    def f(x, w):
        if autograd == "off":  # einsum reaches the mode whole: decomposed there
            with torch.inference_mode():
                return torch.einsum("bmk,bkn->bmn", x, w)
        return torch.einsum("bmk,bkn->bmn", x, w)

    c = program_cost(f, x, w)
    assert c["dot_flops"] == 2 * 4 * 8 * 16 * 32
    assert c["flops"] == c["dot_flops"]


def test_loop_products_and_elementwise():
    """test_costs.py's scan: eager, every step's product and its tanh and add
    dispatch, 100 of each."""
    w, xs = torch.zeros(16, 16), torch.zeros(100, 8, 16)

    def f(w, xs):
        c = torch.zeros(8, 16)
        for t in range(100):
            c = torch.tanh(c @ w + xs[t])
        return c

    c = program_cost(f, w, xs)
    assert c["dot_flops"] == 100 * 2 * 8 * 16 * 16
    assert c["flops"] == c["dot_flops"] + 100 * 2 * 8 * 16


def test_backward_counted():
    x, w = torch.zeros(8, 16), torch.zeros(16, 32, requires_grad=True)
    base = program_cost(lambda w, x: (x @ w).sum(), w, x)["dot_flops"]

    def grad(w, x):
        (x @ w).sum().backward()
        return w.grad

    # the forward and one product of the same size for dL/dw (x takes none)
    assert program_cost(grad, w, x)["dot_flops"] == 2 * base


def test_checkpoint_recompute_counted_again():
    from torch.utils.checkpoint import checkpoint

    w = torch.zeros(16, 16, requires_grad=True)
    x = torch.zeros(8, 16)
    body = lambda w, x: torch.tanh(x @ w)  # noqa: E731

    def plain(w, x):
        body(w, x).sum().backward()

    def remat(w, x):
        checkpoint(body, w, x, use_reentrant=False).sum().backward()

    p, r = program_cost(plain, w, x), program_cost(remat, w, x)
    product = 2 * 8 * 16 * 16
    assert p["dot_flops"] == 2 * product
    # the forward runs again inside the backward
    assert r["dot_flops"] == 3 * product
    assert r["flops"] > p["flops"]


def test_weight_bytes_over_steps():
    """test_costs.py's loop-invariant weight: eager, each step's product reads
    the (16, 16) weight again; inside B1, W_hh^T counts once over T steps."""
    w, xs = torch.zeros(16, 16), torch.zeros(1000, 8, 16)

    def f(w, xs):
        c = torch.zeros(8, 16)
        for t in range(1000):
            c = c @ w
        return c

    c = program_cost(f, w, xs)
    row, w_bytes = 8 * 16 * 4, 16 * 16 * 4
    io = 1000 * row + w_bytes + row
    assert c["hbm_bytes_model"] == io + 1000 * (row + w_bytes + row)

    for steps in (10, 1000):
        xw, w_hh_t = torch.zeros(2, 1, steps, 4 * 8), torch.zeros(2, 8, 32)
        c = program_cost(L.lstm_bidir_tm, xw, w_hh_t)
        hs = 2 * steps * 8 * 4
        # xw and W_hh^T in, hs out: the kernel's formula, then the program's
        # inputs and output
        assert c["hbm_bytes_model"] == (nbytes(xw) + nbytes(w_hh_t) + hs) * 2


def test_other_namespace_is_opaque():
    """An op of another namespace with no wrapper around it (here B4's
    ``se_torch::stft``, as an exported program replays it) counts nothing
    and is flagged."""
    c = program_cost(library.stft, torch.zeros(2, 4000), 400, 400, 160)
    assert c["opaque_calls"] == 1 and c["flops"] == 0 and c["kernels"] == {}


# -- the kernels' formulas through their wrappers -----------------------------

def held(c, cost, io_bytes, name, count=1, other=0.0):
    """``c`` is exactly the formula ``cost``, counted ``count`` times for
    ``name``, plus ``other`` flops of the caller's own ops."""
    want = classes(**{k: v * count for k, v in cost.flops.items()})
    want["other"] += other
    assert c["kernels"] == {name: count}, c["kernels"]
    assert c["flops_by_class"] == want, (c["flops_by_class"], want)
    assert c["dot_flops"] == cost.dot_flops * count
    assert c["hbm_bytes_model"] == cost.nbytes * count + io_bytes
    assert c["opaque_calls"] == 0


@pytest.mark.parametrize("form", ["f32", "xw_bf16", "hs_bf16", "both"])
def test_b1_counts_its_formula(form):
    ndir, b, t, h = 2, 3, 17, 8
    xw = rng_tensor((ndir, b, t, 4 * h), 0, scale=0.5)
    xw = xw.bfloat16() if form in ("xw_bf16", "both") else xw
    w = rng_tensor((ndir, h, 4 * h), 1, scale=0.3)
    hs_dtype = torch.bfloat16 if form in ("hs_bf16", "both") else torch.float32
    out = L.lstm_bidir_tm(xw, w, hs_dtype=hs_dtype)
    c = program_cost(lambda xw, w: L.lstm_bidir_tm(xw, w, hs_dtype=hs_dtype), xw, w)
    cost = costs.lstm_cost(ndir, b, t, h, xw_bytes=xw.element_size(),
                           out_bytes=2 if hs_dtype == torch.bfloat16 else 4)
    held(c, cost, nbytes(xw, w, out), "B1")


@pytest.mark.parametrize("form", ["carried", "bf16_h"])
def test_b1_one_direction_forms(form):
    b, t, h = 2, 9, 8
    xw, w = rng_tensor((1, b, t, 4 * h), 2), rng_tensor((1, h, 4 * h), 3, scale=0.3)
    if form == "carried":
        state = (rng_tensor((1, b, h), 4), rng_tensor((1, b, h), 5))
        fn = lambda xw, w, s: L.lstm_bidir_tm(xw, w, state=s, return_state=True)  # noqa: E731
        c = program_cost(fn, xw, w, state)
        hs, (h_t, c_t) = fn(xw, w, state)
        held(c, costs.lstm_cost(1, b, t, h, carried=True),
             nbytes(xw, w, *state, hs, h_t, c_t), "B1")
    else:
        c = program_cost(lambda xw, w: L.lstm_bidir_tm(xw, w, h_bf16=True), xw, w)
        cost = costs.lstm_cost(1, b, t, h, h_bf16=True)
        assert set(cost.flops) == {"bf16"}
        held(c, cost, nbytes(xw, w, xw.new_empty(1, b, t, h)), "B1")


@pytest.mark.parametrize("form", ["f32", "xw_bf16", "vjp_bf16", "bf16_h"])
def test_b2_counts_its_formulas(form):
    """B2 fwd and B2 bwd under autograd (``LstmBidirTm``), each once; the
    caller's sum and nothing else beside them. The bf16-h form's dW_hh^T
    kernel is part of B2 bwd's count (its wrapper, which the card calls inside
    B2 bwd, adds nothing there)."""
    ndir = 1 if form == "bf16_h" else 2
    b, t, h = 2, 7, 8
    xw = rng_tensor((ndir, b, t, 4 * h), 6, scale=0.5)
    xw = xw.bfloat16() if form == "xw_bf16" else xw
    w = rng_tensor((ndir, h, 4 * h), 7, scale=0.3)
    res = torch.bfloat16 if form == "vjp_bf16" else torch.float32
    h_bf16 = form == "bf16_h"

    def step(xw, w):
        xw, w = xw.detach().requires_grad_(), w.detach().requires_grad_()
        hs = L.lstm_bidir_tm(xw, w, h_bf16=h_bf16, res_dtype=res)
        loss = hs.sum()
        loss.backward()
        return loss

    c = program_cost(step, xw, w)
    out_bytes = 2 if res == torch.bfloat16 else 4
    fwd = costs.lstm_cost(ndir, b, t, h, cell=True, xw_bytes=xw.element_size(),
                          out_bytes=out_bytes, h_bf16=h_bf16)
    bwd = costs.lstm_bwd_cost(ndir, b, t, h, xw.element_size(), out_bytes, h_bf16)
    assert c["kernels"] == {"B2 fwd": 1, "B2 bwd": 1}
    want = classes()
    for part in (fwd, bwd):
        for k, v in part.flops.items():
            want[k] += v
    want["other"] += ndir * b * t * h  # the sum
    assert c["flops_by_class"] == want
    assert c["dot_flops"] == fwd.dot_flops + bwd.dot_flops
    assert c["hbm_bytes_model"] == fwd.nbytes + bwd.nbytes + nbytes(xw, w) + 4


def test_dw_bf16_counts_its_formula():
    hs, da = rng_tensor((1, 3, 11, 8), 8), rng_tensor((1, 3, 11, 32), 9)
    c = program_cost(L.lstm_bidir_tm_dw_bf16, hs, da)
    held(c, costs.dw_bf16_cost(1, 3, 11, 8), nbytes(hs, da) + 4 * 8 * 32, "B2 bwd dW_hh^T bf16")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_b3_counts_its_formulas(dtype):
    """B3 fwd and bwd through ``FlashAttention`` (dropout live, a key bias),
    and B3 fwd alone; the hash masks the plain version builds count
    nothing."""
    b, t, n, d = 2, 19, 2, 32
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (rng_tensor((b, t, n * d), s, dt) for s in (10, 11, 12))
    kbias = torch.zeros(b, t)
    suffix = " bf16" if dtype == "bf16" else ""

    def step(q, k, v):
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = A.flash_attention(q, k, v, 0.125, 0.1, (3, 4), kbias, n_heads=n)
        loss = out.float().sum()
        loss.backward()
        return loss

    c = program_cost(step, q, k, v)
    fwd = costs.attention_cost(b, t, n, d, bf16=dtype == "bf16")
    bwd = costs.attention_cost(b, t, n, d, backward=True, bf16=dtype == "bf16")
    assert c["kernels"] == {"B3 fwd" + suffix: 1, "B3 bwd" + suffix: 1}
    cls = "bf16" if dtype == "bf16" else "tf32x3"
    assert c["flops_by_class"] == classes(**{cls: fwd.dot_flops + bwd.dot_flops,
                                             "other": b * t * n * d})
    c = program_cost(lambda q, k, v: A.flash_attention(q, k, v, 0.125, n_heads=n), q, k, v)
    held(c, fwd, nbytes(q, k, v, q), "B3 fwd" + suffix)


def test_b4_b5_count_their_formulas():
    wavs = rng_tensor((2, 3, 4000), 13, scale=0.1)
    c = program_cost(S.stft_fused, wavs, 400, 400, 160)
    spec = S.stft_fused(wavs, 400, 400, 160)
    held(c, costs.stft_cost(6, 26, 400, 160), nbytes(wavs, spec), "B4")
    pred, uph = rng_tensor((3, 26, 201), 14).abs(), rng_tensor((3, 26, 402), 15)
    c = program_cost(D.decode_ola, pred, uph, 400, 400, 160)
    out = D.decode_ola(pred, uph, 400, 400, 160)
    held(c, costs.decode_cost(3, 26, 400, 160), nbytes(pred, uph, out), "B5")


def test_b6_b7_count_their_formulas():
    b, t, h, d = 3, 13, 8, 12
    xw, w = rng_tensor((2, b, t, 4 * h), 16), rng_tensor((2, h, 4 * h), 17, scale=0.3)
    c = program_cost(L.lstm_bidir_bb, xw, w)
    held(c, costs.lstm_cost(2, b, t, h, cls="tf32x3"), nbytes(xw, w) + 2 * b * t * h * 4, "B6")
    xs, w_ih = rng_tensor((2, b, t, d), 18), rng_tensor((2, d, 4 * h), 19, scale=0.3)
    bias = rng_tensor((2, 4 * h), 20)
    c = program_cost(L.lstm_bidir_fused, xs, w_ih, bias, w)
    held(c, costs.lstm_fused_cost(b, t, d, h), nbytes(xs, w_ih, bias, w) + 2 * b * t * h * 4,
         "B7")


# -- the bounds and the peaks ------------------------------------------------

TT = 1001
# the bounds as chip_smoke.py printed them before their counts moved into
# utils/costs.py, (ms, what binds)
BOUND_PINS = (
    ("lstm_bound", (1, TT, H), {}, 0.015666038447761196, "operations"),
    ("lstm_bound", (64, TT, H), {}, 1.0026264606567166, "operations"),
    ("lstm_bound", (6, TT, H), {"extra_streams": 1}, 0.09399623068656716, "operations"),
    ("lstm_bound", (6, TT, H), {"products": 3, "extra_streams": 3,
                                "peak": costs.PEAK_TF32}, 0.1145044992, "operations"),
    ("lstm_bound", (64, TT, H), {"products": 3, "extra_streams": 3},
     3.0078793819701493, "operations"),
    ("lstm_bound", (256, TT, H), {"peak": costs.PEAK_TF32}, 1.6285084330666666, "operations"),
    ("lstm_bound", (1, TT, H), {"D": 512, "peak": costs.PEAK_TF32}, 0.019084083199999997,
     "operations"),
    ("lstm_bound", (6, TT, H), {"D": 512}, 0.2819886920597015, "operations"),
    ("carried_bound", (1, 48, H), {}, 0.00038728597014925375, "bytes"),
    ("attention_bound", (6, TT, 12, 64, 2), {}, 0.11193262080000001, "operations"),
    ("attention_bound", (6, TT, 12, 64, 5), {"peak": costs.PEAK_F32}, 0.6891374041791045,
     "operations"),
    ("attention_bound", (64, TT, 12, 64, 5), {}, 2.984869888, "operations"),
    ("attention_bound_bf16", (6, TT, 12, 64, 2), {}, 0.01867429972901921, "operations"),
    ("attention_bound_bf16", (64, TT, 12, 64, 5), {}, 0.497981326107179, "operations"),
    ("stft_bound", (64, 1001, 400, 160), {}, 0.04297902089552239, "bytes"),
    ("decode_bound", (12, 1001, 400, 160), {}, 0.01094949014925373, "bytes"),
    ("bf16_h_bound", (6, TT, H, "b1"), {}, 0.009492327164179104, "bytes"),
    ("bf16_h_bound", (6, TT, H, "fc"), {}, 0.01132819104477612, "bytes"),
    ("bf16_h_bound", (6, TT, H, "bwd"), {}, 0.02226797979049545, "operations"),
    ("bf16_h_bound", (352, 201, H, "dw"), {}, 0.11196119878665318, "operations"),
    ("bf16_h_bound", (1, TT, H, "dw"), {}, 0.007825194029850747, "operations"),
    ("dw_first_bound", (6, TT, H), {}, 0.04695116417910448, "operations"),
    ("stream_bound", (768, TT, H, "b1", False, True), {}, 12.031517527880597, "operations"),
    ("stream_bound", (352, TT, H, "fc", False, True), {}, 5.51444553361194, "operations"),
    ("stream_bound", (352, TT, H, "bwd", False, True), {}, 2.23995379688071, "operations"),
    ("stream_bound", (6, TT, H, "bwd", True, False), {}, 0.1145044992, "operations"),
)


@pytest.mark.parametrize("name,args,kwargs,ms,by", BOUND_PINS)
def test_bounds_unchanged_by_the_move(name, args, kwargs, ms, by):
    got = getattr(costs, name)(*args, **kwargs)
    assert got[1] == by
    # the same counts over the same peaks; a class's peak is now divided once
    # (165e12 for three TF32 passes) where it multiplied the count: 1 ulp
    assert got[0] == pytest.approx(ms, rel=1e-12)


def test_roofline_reads_each_class_at_its_peak():
    h100 = costs.PEAKS[costs.H100]
    cost = {"flops_by_class": classes(f32=67e12, tf32x3=165e12, bf16=989e12 / 2),
            "hbm_bytes_model": 3.35e12}
    r = costs.roofline(cost, 4.0, costs.H100)
    # 1 s + 1 s + 0.5 s of the peaks' time in 4 s
    assert r["mfu"] == pytest.approx(2.5 / 4.0, rel=1e-12)
    assert r["hbm_util_model"] == pytest.approx(0.25, rel=1e-12)
    assert h100["tf32x3"] == pytest.approx(495e12 / 3)
    with pytest.raises(LookupError, match="NVIDIA A100"):
        costs.roofline(cost, 1.0, "NVIDIA A100-SXM4-80GB")


# -- parity with the JAX package ---------------------------------------------

@pytest.fixture(scope="module")
def jax_costs():
    """JAX ``program_cost`` (a jaxpr walk, no compile) of the flagship's
    enhance and train step and of a 2-layer Mockingjay step, on the non-Pallas
    program, at B=2, 1 s; the state abstract (``jax.eval_shape``)."""
    from speech_enhancement_by_s3prl_tpu.models.spec_head import Mockingjay
    from speech_enhancement_by_s3prl_tpu.models.transformer import TransformerConfig

    wavs = jax.ShapeDtypeStruct((B, 3, T), jnp.float32)
    lengths = jax.ShapeDtypeStruct((B,), jnp.int32)
    zeros = (jnp.zeros((B, 3, T)), jnp.full((B,), T, jnp.int32))
    key = jax.random.PRNGKey(0)
    out = {}
    builder = graft._build(use_pallas=False)
    state = jax.eval_shape(lambda: builder.init_state(key, *zeros))
    out["enhance"] = jax_program_cost(graft.make_enhance(builder), state.params, wavs, lengths)
    out["train"] = jax_program_cost(builder.train_step_raw(), state, wavs, lengths, key,
                                    builder.upstream_params())
    mj = dataclasses.replace(
        graft._build(delta=1), from_waveform=True, from_rawfeature=False,
        model=Mockingjay(output_size=201, config=TransformerConfig(
            input_dim=80, num_hidden_layers=2), compute_dtype=jnp.float32))
    state = jax.eval_shape(lambda: mj.init_state(key, *zeros))
    out["mockingjay"] = jax_program_cost(mj.train_step_raw(), state, wavs, lengths, key,
                                         mj.upstream_params())
    return out


@pytest.fixture(scope="module")
def port_costs():
    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import TransformerConfig

    torch.set_num_threads(1)
    out = {}
    step = build_mode("enhance", B, utt_sec=SECONDS, device="cpu")
    out["enhance"] = program_cost(lambda m, w, n: step.enhance(w, n).sum(), step.model,
                                  step.wavs, step.lengths)
    step = build_mode("train", B, utt_sec=SECONDS, device="cpu")
    builder = step.builder
    out["train"] = program_cost(lambda s, w, n: builder.train_step(s, w, n),
                                builder.init_state(), step.wavs, step.lengths)
    mj = entry.build_mockingjay_train(TransformerConfig(input_dim=80, num_hidden_layers=2),
                                      "f32", device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    out["mockingjay"] = program_cost(lambda s, w, n: mj.train_step(s, w, n), mj.init_state(),
                                     step.wavs, step.lengths)
    return out


def test_flagship_enhance_products_match_hand_count(port_costs):
    """test_costs.py's closed form of the LSTM + head products, exactly: the
    port's products beside it are the two log-mel projections of the
    preprocessor (the downstream input and the upstream input), and B4's
    FFT counts none."""
    lstm = 0
    for layer_in in (I, 2 * H, 2 * H):
        lstm += 2 * (layer_in * 4 * H + H * 4 * H)
    hand = 2.0 * B * M * (lstm + 2 * H * 201)
    mel = 2.0 * B * M * 201 * 40
    c = port_costs["enhance"]
    assert c["dot_flops"] == hand + 2 * mel
    assert c["kernels"] == {"B4": 1, "B1": 3, "B5": 1}
    assert c["opaque_calls"] == 0


def test_enhance_against_jax(port_costs, jax_costs):
    """The JAX program takes the STFT of three channels as a DFT product,
    which B4 replaces by an FFT (no products): beside that the products are
    the same, exactly. The totals within 1% (elementwise passes of the same
    functions counted by two walkers) and the modelled bytes within 5%."""
    p, j = port_costs["enhance"], jax_costs["enhance"]
    dft = 3 * B * M * DFT_PER_FRAME
    assert j["dot_flops"] == p["dot_flops"] + dft
    assert p["flops"] + dft == pytest.approx(j["flops"], rel=0.01)
    assert p["hbm_bytes_model"] == pytest.approx(j["hbm_bytes_model"], rel=0.05)


def test_train_step_against_jax(port_costs, jax_costs):
    """Products: B2 bwd recomputes the gate pre-activations from hs (one h @
    W_hh^T a step and layer more than JAX's reverse scan, which keeps them),
    and JAX's training STFT (two channels) is a DFT product: beside those,
    exactly. Totals within 2%. Bytes: JAX's walker counts the (H, 4H) result
    of the reverse scan's dW_hh^T product at every step (1 MiB a step,
    direction and layer), which B2 bwd writes once; with those, within 5%."""
    p, j = port_costs["train"], jax_costs["train"]
    recompute = 3 * 2 * 2 * B * M * H * 4 * H
    dft = 2 * B * M * DFT_PER_FRAME
    assert p["kernels"] == {"B4": 1, "B2 fwd": 3, "B2 bwd": 3}
    assert j["dot_flops"] == p["dot_flops"] - recompute + dft
    assert p["flops"] - recompute + dft == pytest.approx(j["flops"], rel=0.02)
    per_step_dw = 3 * 2 * M * H * 4 * H * 4
    assert p["hbm_bytes_model"] + per_step_dw == pytest.approx(j["hbm_bytes_model"], rel=0.05)


def test_mockingjay_step_against_jax(port_costs, jax_costs):
    """2 layers, f32, dropout live, both on JAX's default routes: B3 bwd
    recomputes the logits (5 products a layer against JAX's 4 through the
    einsum attention), B4 is an FFT where JAX's STFT is a DFT product, and the
    hidden dropout is D1 (5 sites, forward and backward) where JAX draws
    bits: products within 1%, totals within 2%, bytes within 5%."""
    p, j = port_costs["mockingjay"], jax_costs["mockingjay"]
    assert p["kernels"] == {"B4": 1, "B3 fwd": 2, "B3 bwd": 2, "D1": 10}
    assert p["dot_flops"] == pytest.approx(j["dot_flops"], rel=0.01)
    assert p["flops"] == pytest.approx(j["flops"], rel=0.02)
    assert p["hbm_bytes_model"] == pytest.approx(j["hbm_bytes_model"], rel=0.05)


# -- the harness ---------------------------------------------------------------

def run_bench(timeout=600, **env):
    full = dict(os.environ, BENCH_CPU="1", BENCH_BATCH=str(B), BENCH_UTT_SEC=str(SECONDS),
                BENCH_ITERS="1", OMP_NUM_THREADS="1")
    full.update(env)
    out = subprocess.run([sys.executable, "-m", "speech_enhancement_by_s3prl_tpu_torch.bench"],
                         env=full, cwd=REPO, capture_output=True, text=True, timeout=timeout,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


ROOFLINE_KEYS = {"flops_per_step", "dot_flops_per_step", "flops_by_class", "tflops",
                 "hbm_gbytes_per_step_model", "hbm_gbps_model", "flops_src", "opaque_calls"}


def test_bench_enhance_line():
    line = run_bench(BENCH_MODE="enhance")
    assert {"metric", "value", "unit", "vs_baseline", "card"} <= set(line)
    assert line["metric"] == "enhance_rtf_per_chip" and line["value"] > 0
    assert line["card"] == "cpu" and line["batch"] == B
    assert ROOFLINE_KEYS <= set(line)
    assert line["flops_per_step"] > 0 and line["hbm_gbytes_per_step_model"] > 0
    assert line["opaque_calls"] == 0
    assert line["kernels_counted"] == {"B4": 1, "B1": 3, "B5": 1}
    # the CPU has no peak table: the fields say so, none is guessed
    assert "mfu" not in line and "no peak table" in line["roofline_error"]


def test_bench_all_restricted_to_enhance():
    line = run_bench(BENCH_MODES="enhance", BENCH_MODE="all")
    assert {"metric", "value", "unit", "vs_baseline", "modes"} <= set(line)
    assert line["metric"] == "enhance_rtf_per_chip" and line["value"] > 0
    assert list(line["modes"]) == ["enhance"]
    assert line["modes"]["enhance"]["value"] == line["value"]


def test_bench_all_headline_falls_back_and_survives_bad_json(monkeypatch, capsys):
    fake = {
        "enhance": types.SimpleNamespace(returncode=1, stdout="", stderr="build failed"),
        "train": types.SimpleNamespace(
            returncode=0, stderr="",
            stdout='{"metric": "train_audio_rtf_per_chip", "value": 7100.0, '
                   '"unit": "x_realtime", "vs_baseline": 710.0}'),
        "eval": types.SimpleNamespace(returncode=0, stdout="Exception ignored in atexit",
                                      stderr=""),
    }
    monkeypatch.setenv("BENCH_MODES", "enhance,train,eval")
    monkeypatch.setattr(bench.subprocess, "run",
                        lambda cmd, env=None, **kw: fake[env["BENCH_MODE"]])
    bench.run_all()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 7100.0 and line["metric"] == "train_audio_rtf_per_chip"
    assert "build failed" in line["modes"]["enhance"]["error"]
    assert "non-JSON" in line["modes"]["eval"]["error"]


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_bench_loader_mode(fmt):
    line = run_bench(BENCH_MODE="loader", BENCH_LOADER_FILES="6", BENCH_LOADER_FORMAT=fmt,
                     BENCH_BATCH="4")
    assert line["metric"] == "loader_audio_rtf_per_host" and line["value"] > 0
    assert line["format"] == fmt


def test_device_mode_without_a_card_raises(monkeypatch):
    """A device mode without a card raises before it sets anything (the
    stream-form default it sets would reach later tests of this process)."""
    monkeypatch.delenv("BENCH_CPU", raising=False)
    monkeypatch.delenv("SE_LSTM_XW_BF16", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_device()
    monkeypatch.setenv("BENCH_MODE", "enhance")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    assert "SE_LSTM_XW_BF16" not in os.environ


def test_pcm16_writer_matches_float_writer(tmp_path):
    """The pipeline mode's int16 (``torch.clamp(torch.round(x * 32767))`` on
    the device, half to even as ``np.rint``) written by ``write_wav_pcm16``:
    the bytes ``write_wav`` writes for the floats, half-integers included."""
    wav = np.clip(np.random.default_rng(3).normal(scale=0.4, size=SR), -1.2, 1.2).astype(
        np.float32)
    wav[:8] = np.array([0.5, -0.5, 1.5, -1.5, 2.5, 0.0, 1.0, -1.0], np.float32) / 32767.0
    pcm = torch.clamp(torch.round(torch.from_numpy(wav) * 32767.0), -32768.0, 32767.0).to(
        torch.int16).numpy()
    a, b = str(tmp_path / "f32.wav"), str(tmp_path / "i16.wav")
    write_wav(a, wav, SR)
    write_wav_pcm16(b, pcm, SR)
    assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="int16"):
        write_wav_pcm16(b, wav, SR)
