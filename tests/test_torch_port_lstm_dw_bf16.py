"""The bf16-h form's dW_hh^T: the algorithm of ``csrc/lstm_dw_bf16.cu``
(``lstm_bidir_tm_dw_bf16_model``: da split into three bf16 terms, the step
products exact and summed by K slices of 4 batch rows, the carry added in bf16
pairs) against the plain version (``lstm_bidir_tm_dw_bf16_ref``: each step an
f32 product in row order, acc = bf16(acc + bf16(step))), on the CPU.

The plain version is held against the JAX package's reverse ``lax.scan`` by
``tests/test_torch_port_bf16_one_direction.py``; here no JAX runs. The share
of elements within one bf16 unit is the limit the card script holds the kernel
to (``BF16H_DW_KERNEL_SHARE`` of ``chip_smoke.py``, phase 13 (a)): the two
orders of the step sum may round a step product differently where it lies on
a rounding boundary, and a flipped step rounding moves the carry by at most a
unit of the carry's last place."""
import numpy as np
import pytest
import torch

from speech_enhancement_by_s3prl_tpu_torch.ops.cuda import lstm_kernel as L

# chip_smoke.py's BF16H_DW_KERNEL_SHARE and BF16H_DW_SHARE
KERNEL_SHARE, ONCE_ROUNDED_BELOW = 0.999, 0.99


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, T, H, seed, ndir=1):
    rng = np.random.default_rng(seed)
    hs = np.tanh(rng.standard_normal((ndir, B, T, H))).astype(np.float32)
    da = (0.1 * rng.standard_normal((ndir, B, T, 4 * H))).astype(np.float32)
    return torch.from_numpy(hs), torch.from_numpy(da)


def _ordered(x):
    assert torch.equal(x.to(torch.bfloat16).float(), x), "not a bf16 value"
    bits = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _within_one_unit(a, b):
    return float(((_ordered(a) - _ordered(b)).abs() <= 1).double().mean())


@pytest.mark.parametrize("ndir,B,T,H", [
    (1, 1, 200, 16),
    (1, 6, 200, 16),
    (1, 3, 57, 36),  # H not a multiple of the kernel's 64 x 32 tile
    (1, 10, 57, 36),  # B above one K slice of 4 rows and above one group of 8
    (2, 5, 40, 8),  # two directions
])
def test_kernel_model_matches_the_plain_version(ndir, B, T, H):
    hs, da = _inputs(B, T, H, 1900 + 7 * B + H, ndir)
    ref = L.lstm_bidir_tm_dw_bf16_ref(hs, da)
    model = L.lstm_bidir_tm_dw_bf16_model(hs, da)
    assert model.shape == ref.shape == (ndir, H, 4 * H)
    assert _within_one_unit(model, ref) >= KERNEL_SHARE
    # an f32 sum over all steps rounded once is not this function: the share
    # tells it apart
    once = L._bf16(torch.einsum("dbti,dbtj->dij", L._bf16(hs[:, :, :-1]), da[:, :, 1:]))
    assert _within_one_unit(once, ref) < ONCE_ROUNDED_BELOW


@pytest.mark.parametrize("T", [1, 2])
def test_kernel_model_at_one_and_two_steps(T):
    hs, da = _inputs(3, T, 12, 1917 + T)
    model = L.lstm_bidir_tm_dw_bf16_model(hs, da)
    assert torch.equal(model, L.lstm_bidir_tm_dw_bf16_ref(hs, da))
    if T == 1:
        assert not model.any()


def test_split_terms_are_bf16_and_sum_back_exactly():
    rng = np.random.default_rng(1919)
    x = rng.standard_normal(200_000) * 2.0 ** rng.integers(-90, 90, 200_000)
    x = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = L.split_bf16x3(x)
    for term in (hi, mid, lo):
        assert torch.equal(L._bf16(term), term)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # each term lies below half a bf16 unit of the one before
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())


def test_max_batch_follows_the_kernels_shared_memory():
    # a batch row of one step: two staged runs of 72 + 40 floats (padded
    # rows) and two buffers of 384 bytes of fragments, in groups of 8 rows
    # within 232,448 bytes; that is the chunk a step's rows are staged in,
    # no longer a limit on B
    assert L.DW_BF16_CHUNK_ROWS == 136
    assert L.DW_BF16_CHUNK_ROWS * (2 * 4 * (72 + 40) + 2 * 384) <= 232448
    assert (L.DW_BF16_CHUNK_ROWS + 8) * (2 * 4 * (72 + 40) + 2 * 384) > 232448
    # lstm_dw_bf16_f32's cut: ceil(B / 8) groups in the fewest chunks of at
    # most 17 groups, each of equal groups but the ragged last
    assert L.dw_bf16_chunks(136) == [(0, 136)]
    assert L.dw_bf16_chunks(137) == [(0, 72), (72, 137)]
    assert L.dw_bf16_chunks(352) == [(0, 120), (120, 240), (240, 352)]
    for B in (1, 5, 8, 9, 136, 137, 140, 272, 273, 352, 1000):
        chunks = L.dw_bf16_chunks(B)
        assert chunks[0][0] == 0 and chunks[-1][1] == B
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(lo % 8 == 0 and hi - lo <= L.DW_BF16_CHUNK_ROWS for lo, hi in chunks)


@pytest.mark.parametrize("B,T,H", [(140, 12, 8), (272, 6, 4)])
def test_kernel_model_past_one_chunk(B, T, H):
    """Past one chunk of a step's rows (B = 140: 72 + 68 rows; 272: two of
    136) the kernel sums a step in chains of 32 rows, each from zero, added
    to the step's sum: the model in that order agrees with the plain version
    under the card's share limit, while a once-rounded sum does not. Up to
    one chunk the step is one chain over all rows."""
    hs, da = _inputs(B, T, H, 1931 + B)
    assert L.dw_bf16_chains(136) == [(0, 136)]
    chains = L.dw_bf16_chains(B)
    assert chains[0][0] == 0 and chains[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(chains, chains[1:]))
    assert all(hi - lo <= L.DW_BF16_CHAIN_ROWS for lo, hi in chains)
    assert all(any(lo <= a < hi for a, _ in chains) for lo, hi in L.dw_bf16_chunks(B))
    ref = L.lstm_bidir_tm_dw_bf16_ref(hs, da)
    model = L.lstm_bidir_tm_dw_bf16_model(hs, da)
    assert _within_one_unit(model, ref) >= KERNEL_SHARE
    once = L._bf16(torch.einsum("dbti,dbtj->dij", L._bf16(hs[:, :, :-1]), da[:, :, 1:]))
    assert _within_one_unit(once, ref) < ONCE_ROUNDED_BELOW
