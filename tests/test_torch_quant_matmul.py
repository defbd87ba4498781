"""PyTorch port, fused int4 dequant-matmul: ``int4_matmul_plain`` (the
function of the K3 kernel, ``csrc/int4_matmul.cu``) held against the JAX
Pallas ``int4_matmul`` in interpret mode on the CPU, and the routes of
``quantized_matmul``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speech_distill_tpu.ops import quant as jquant
from speech_distill_tpu.ops.quant_matmul import (
    int4_matmul as jax_int4_matmul, quantized_matmul as jax_quantized_matmul)
from speech_distill_tpu_torch.core.config import qwen3_tiny
from speech_distill_tpu_torch.ops import _cuda, quant_matmul
from speech_distill_tpu_torch.ops.quant import (dequantize_array, unpack_int4,
                                                quantize_array_int4,
                                                quantize_array_int8)
from speech_distill_tpu_torch.ops.quant_matmul import (
    int4_matmul, int4_matmul_plain, int4_route, quantized_matmul)

K, N = 1024, 512
# both sides: the same bf16 x, an exact integer grid, fp32 sums of 1024
# products of magnitude ~7 (|y| ~ 200) in another order, one fp32 scale
ATOL = 1e-3


def _leaf(seed=3):
    w = np.random.default_rng(seed).normal(size=(K, N)).astype(np.float32)
    jleaf = jquant.quantize_array_int4(jnp.asarray(w))
    leaf = {k: torch.from_numpy(np.array(v)) for k, v in jleaf.items()}
    return jleaf, leaf


@pytest.mark.parametrize("M", [1, 3, 16, 33])
def test_plain_matches_pallas_interpret(M):
    jleaf, leaf = _leaf()
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    ref = np.asarray(jax_int4_matmul(jnp.asarray(x), jleaf["q4"],
                                     jleaf["scale"].reshape(1, N),
                                     interpret=True))
    got = int4_matmul_plain(torch.from_numpy(x), leaf["q4"], leaf["scale"])
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # the CPU wrapper is the plain version and launches nothing
    before = _cuda.launches["int4_matmul"]
    same = int4_matmul(torch.from_numpy(x), leaf["q4"], leaf["scale"])
    assert _cuda.launches["int4_matmul"] == before
    torch.testing.assert_close(same, got, atol=0, rtol=0)


def test_leading_batch_dims_match_pallas_interpret():
    jleaf, leaf = _leaf()
    x = np.random.default_rng(7).normal(size=(2, 5, K)).astype(np.float32)
    ref = np.asarray(jax_quantized_matmul(jnp.asarray(x), jleaf,
                                          interpret=True))
    with int4_route("plain"):
        got = quantized_matmul(torch.from_numpy(x), leaf)
    assert got.shape == (2, 5, N)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_plain_is_exact_on_bf16_inputs_and_keeps_dtype():
    """On bf16 x the plain version is the fp32 product of the bf16 values
    with the integer grid, scaled after the sum, rounded once to bf16."""
    _, leaf = _leaf(seed=4)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, K)).astype(np.float32)).to(torch.bfloat16)
    got = int4_matmul_plain(x, leaf["q4"], leaf["scale"])
    grid = torch.cat([(leaf["q4"] >> 4).float() - 8,
                      (leaf["q4"] & 0xF).float() - 8])
    want = ((x.double() @ grid.double()) * leaf["scale"].double()).to(
        torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=2 ** -7)


def test_routes():
    """auto on the CPU is dequantize-then-matmul (the JAX route off the
    TPU); an int8 leaf takes it on every route."""
    _, leaf = _leaf(seed=5)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, K)).astype(np.float32))
    deq = x @ dequantize_array(leaf, torch.float32)
    torch.testing.assert_close(quantized_matmul(x, leaf), deq, atol=0,
                               rtol=0)
    with int4_route("plain"):
        torch.testing.assert_close(
            quantized_matmul(x, leaf),
            int4_matmul_plain(x, leaf["q4"], leaf["scale"]), atol=0, rtol=0)
        q8 = quantize_array_int8(torch.from_numpy(np.random.default_rng(
            2).normal(size=(K, N)).astype(np.float32)))
        torch.testing.assert_close(quantized_matmul(x, q8),
                                   x @ dequantize_array(q8, torch.float32),
                                   atol=0, rtol=0)
    with pytest.raises(ValueError, match="route"):
        with int4_route("pallas"):
            pass


def test_auto_route_on_a_card_takes_the_kernel_only_where_it_fits(
        monkeypatch):
    """'auto' with the CUDA check stubbed: the int4 leaf of qwen3_tiny's k
    projection (64 -> 32, packed [32, 32]) is off the kernel's tiles, so
    it takes dequantize-then-matmul, exactly, as JAX falls back where its
    kernel does not fit (it raised in the kernel wrapper before); a leaf
    of whole tiles still goes to the kernel."""
    cfg = qwen3_tiny()
    d_in = cfg.hidden_size
    d_out = cfg.num_key_value_heads * cfg.head_dim
    rng = np.random.default_rng(11)
    small = quantize_array_int4(torch.from_numpy(
        rng.normal(size=(d_in, d_out)).astype(np.float32)))
    assert tuple(small["q4"].shape) == (32, 32)
    x = torch.from_numpy(rng.normal(size=(3, d_in)).astype(np.float32))
    calls = []

    def kernel(x, packed, scale):
        calls.append(tuple(packed.shape))
        return int4_matmul_plain(x, packed, scale)

    monkeypatch.setattr(quant_matmul, "_on_cuda", lambda t: True)
    monkeypatch.setattr(quant_matmul, "int4_matmul", kernel)
    got = quantized_matmul(x, small)
    torch.testing.assert_close(got, x @ dequantize_array(small,
                                                         torch.float32),
                               atol=0, rtol=0)
    assert calls == []
    _, leaf = _leaf(seed=12)
    xk = torch.from_numpy(rng.normal(size=(3, K)).astype(np.float32))
    quantized_matmul(xk, leaf)
    assert calls == [(K // 2, N)]


def test_zero_codes_and_zero_columns():
    """Nibble 0 (-8, which the quantizer never writes) and an all-zero
    column (scale 0 after the 1e-12 guard) come out right."""
    w = np.random.default_rng(6).normal(size=(64, 128)).astype(np.float32)
    w[:, 5] = 0.0
    leaf = quantize_array_int4(torch.from_numpy(w))
    packed = leaf["q4"].clone()
    packed[0, :] = 0x08                      # row 0 -> -8, row 32 -> 0
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 64)).astype(np.float32))
    got = int4_matmul_plain(x, packed, leaf["scale"])
    want = x.to(torch.bfloat16).double() @ (
        dequantize_array({"q4": packed, "scale": leaf["scale"]},
                         torch.float32).double())
    assert torch.all(got[:, 5] == 0)
    torch.testing.assert_close(got.double(), want, atol=1e-4, rtol=1e-5)


# the 0.6B's projections (K, N): q, k/v, o, gate/up, down
PROJ_06B = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
            (3072, 1024)]


@pytest.mark.parametrize("K_,N_", [(256, 512), (512, 256), (256, 768),
                                   (768, 256)], ids=["q", "o", "gate",
                                                     "down"])
@pytest.mark.parametrize("M", [17, 64, 65])
def test_plain_matches_pallas_interpret_at_tile_edges(M, K_, N_):
    """M on the kernel's tile edges (16 decode rows, 64-row prefill tiles)
    at the 0.6B's projection aspect ratios scaled down by 4."""
    w = np.random.default_rng(K_ + N_).normal(size=(K_, N_)).astype(
        np.float32)
    jleaf = jquant.quantize_array_int4(jnp.asarray(w))
    leaf = {k: torch.from_numpy(np.array(v)) for k, v in jleaf.items()}
    x = np.random.default_rng(M).normal(size=(M, K_)).astype(np.float32)
    ref = np.asarray(jax_int4_matmul(jnp.asarray(x), jleaf["q4"],
                                     jleaf["scale"].reshape(1, N_), bm=64,
                                     bn=128, bk2=64, interpret=True))
    got = int4_matmul_plain(torch.from_numpy(x), leaf["q4"], leaf["scale"])
    assert got.shape == (M, N_)
    # sums of K_ <= 768 products of magnitude ~7 (|y| ~ 100)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("M", [16, 1024])
@pytest.mark.parametrize("K_,N_", PROJ_06B)
def test_k3_plan_covers_every_packed_step_once(K_, N_, M):
    """The kernel's plan at every 0.6B projection, a decode step (M 16)
    and a 1,024-token prefill: no empty split, every 16-row decode step
    (64-row prefill stage) of the packed rows in exactly one split, at
    most a portable cluster of splits, and at most two decode steps for
    any warp of a block (the two it has in flight at once)."""
    K2 = K_ // 2
    plan = quant_matmul.k3_plan(M, N_, K2)
    rows = quant_matmul.DECODE_STEP if M <= 16 else quant_matmul.BLOCK_K2
    assert plan.route == ("decode" if M <= 16 else "prefill")
    assert plan.steps * rows == K2
    assert 1 <= plan.splits <= quant_matmul.MAX_SPLITS
    covered = []
    for split in range(plan.splits):
        steps = range(split * plan.per,
                      min(plan.steps, (split + 1) * plan.per))
        assert len(steps) > 0
        covered += steps
    assert covered == list(range(plan.steps))
    if M <= 16:
        assert plan.per <= 2 * quant_matmul.DECODE_WARPS
    else:
        assert plan.splits == 1


def test_bit_trick_dequant_is_exact_for_every_nibble():
    """The kernel's conversion emulated on the CPU: (nibble | 0x4300) as
    bf16 is 128 + nibble, and one bf16 subtraction of 136 (0x4308) gives
    nibble - 8 exactly, for all 16 nibbles."""
    nib = torch.arange(16, dtype=torch.int32)
    biased = (nib | 0x4300).to(torch.int16).view(torch.bfloat16)
    assert torch.equal(biased.float(), 128.0 + nib.float())
    k136 = torch.tensor([0x4308], dtype=torch.int16).view(torch.bfloat16)
    assert k136.item() == 136.0
    got = biased - k136                       # bf16 arithmetic
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), nib.float() - 8)


def _byte_perm(a: int, b: int, sel: int) -> int:
    """CUDA's __byte_perm: result byte n is byte (sel >> 4n) & 7 of the
    eight bytes of b:a."""
    src = a | (b << 32)
    return sum(((src >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def test_word_dequant_matches_unpack():
    """The kernel's word path emulated: byte i of packed rows r and r + 1
    (one 32-bit word of each) permuted into the two halves of a word,
    masked (high nibbles after a shift by 4), or-ed with 0x4300 and less
    136 in bf16, gives the k pair (r, r + 1) of both nibble planes as
    ``unpack_int4`` does."""
    rng = np.random.default_rng(0)
    packed = torch.from_numpy(rng.integers(0, 256, (2, 4), dtype=np.uint8))
    grid = unpack_int4(packed).float()          # [4, 4]: rows 0, 1, 2, 3
    a, b = (int.from_bytes(bytes(packed[r].tolist()), "little")
            for r in range(2))
    k136 = torch.tensor([0x4308], dtype=torch.int16).view(torch.bfloat16)
    for i in range(4):
        r = _byte_perm(a, b, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12))
        for plane, word in ((0, ((r >> 4) & 0x000F000F) | 0x43004300),
                            (1, (r & 0x000F000F) | 0x43004300)):
            halves = torch.tensor([word & 0xFFFF, word >> 16],
                                  dtype=torch.int32).to(torch.int16)
            vals = (halves.view(torch.bfloat16) - k136).float()
            # plane 0: contraction rows 0, 1; plane 1: K/2 + 0, K/2 + 1
            assert vals.tolist() == grid[2 * plane:2 * plane + 2, i].tolist()
