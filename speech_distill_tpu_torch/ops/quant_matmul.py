"""Fused int4 dequantize-matmul (port of
``speech_distill_tpu/ops/quant_matmul.py``).

:func:`int4_matmul` computes ``y = x @ ((nibble - 8) * scale)`` from the
packed split-halves weight (``ops/quant.quantize_array_int4``: the high
nibble is contraction row r, the low nibble row K/2 + r) without ever
writing the bf16 weight to memory: on CUDA tensors it launches the
hand-written kernel ``csrc/int4_matmul.cu`` (the counterpart of the TPU
``_kernel``: a decode kernel for M <= 16 whose contraction splits,
:func:`k3_plan`, meet in one thread-block cluster, and a wgmma
prefill kernel) or raises; on CPU tensors it runs
:func:`int4_matmul_plain`.

The route :func:`quantized_matmul` and ``models/qwen3._proj`` take for a
2-D int4 leaf is set by :func:`int4_route`:

* ``"auto"`` (default): CUDA inputs launch the kernel where it takes the
  leaf (:func:`kernel_takes`, as JAX takes its kernel only where the
  shape fits); other leaves, and CPU inputs, take dequantize-then-matmul,
  the route the JAX model takes off the TPU;
* ``"plain"``: :func:`int4_matmul_plain` on any device (the kernel's
  function in plain tensor code, the reference the kernel is held to).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple

import torch

from speech_distill_tpu_torch.ops import _cuda
from speech_distill_tpu_torch.ops.quant import dequantize_array, unpack_int4

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
# what the kernel takes: whole 128-column tiles and 64-row packed stages
BLOCK_N, BLOCK_K2 = 128, 64
# decode (M <= DECODE_ROWS): 16-row packed steps over the DECODE_WARPS
# warps of a block of 128 columns, at most MAX_SPLITS contraction splits
# (one portable thread-block cluster a column tile)
DECODE_ROWS, DECODE_STEP, DECODE_WARPS, MAX_SPLITS = 16, 16, 8, 8
ROUTES = ("auto", "plain")
_route = ["auto"]


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def kernel_takes(x: torch.Tensor, packed: torch.Tensor) -> bool:
    """Whether :func:`int4_matmul` takes x and the packed [K/2, N] grid:
    whole 64-row packed stages, whole 128-column tiles, fp32/bf16 x."""
    K2, N = packed.shape
    return (K2 % BLOCK_K2 == 0 and N % BLOCK_N == 0
            and x.dtype in _OUT_CODE)


@contextlib.contextmanager
def int4_route(name: str):
    """Within the block, 2-D int4 leaves take the route ``name``."""
    if name not in ROUTES:
        raise ValueError(f"int4 route {name!r} not in {ROUTES}")
    old, _route[0] = _route[0], name
    try:
        yield
    finally:
        _route[0] = old


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain tensor code: x rounded to bf16, the
    unpacked integer grid (exact), an fp32 product, the per-column scale
    applied after the sum, the result in x.dtype."""
    xb = x.to(torch.bfloat16).float()
    acc = xb @ unpack_int4(packed).float()
    return (acc * scale.float().reshape(1, -1)).to(x.dtype)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant_int4(packed, scale).

    x [M, K] (any float dtype; bf16 operands, fp32 accumulation), packed
    [K/2, N] uint8 split-halves nibbles, scale [1, N] fp32. Returns [M, N]
    in x.dtype. CPU tensors take :func:`int4_matmul_plain`; CUDA tensors
    launch ``csrc/int4_matmul.cu`` or raise."""
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scale)
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"int4_matmul takes x [M, K] and packed [K/2, N], "
                         f"got {tuple(x.shape)} / {tuple(packed.shape)}")
    M, K = x.shape
    K2, N = packed.shape
    if K != 2 * K2 or scale.numel() != N:
        raise ValueError(f"x {tuple(x.shape)}, packed {tuple(packed.shape)} "
                         f"and scale {tuple(scale.shape)} do not match")
    if not kernel_takes(x, packed):
        raise ValueError(f"int4_matmul needs K/2 % {BLOCK_K2} == 0, "
                         f"N % {BLOCK_N} == 0 and fp32/bf16 x, got "
                         f"K/2={K2}, N={N}, {x.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError(f"int4_matmul takes uint8 packed and fp32 scale, "
                         f"got {packed.dtype}/{scale.dtype}")
    for name, t in (("packed", packed), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    # the kernel's operand is x rounded to bf16 (a bf16 x is used in place;
    # its two halves are column slices at row stride K)
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("int4_matmul needs 16-byte aligned x and packed")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    splits = k3_plan(M, N, K2).splits
    fn = _cuda.function("int4_matmul")
    _cuda.launches["int4_matmul"] += 1
    _cuda.check(fn(_cuda.ptr(xb), _cuda.ptr(packed), _cuda.ptr(scale),
                   _cuda.ptr(out), M, N, K2, K, splits, _OUT_CODE[x.dtype],
                   _cuda.stream_of(x)), "int4_matmul")
    return out


class K3Plan(NamedTuple):
    """How one call of the kernel walks the packed rows: the decode
    kernel (M <= :data:`DECODE_ROWS`) over ``splits`` contraction splits
    of ``per`` 16-row steps (the last may have fewer), one cluster a
    128-column tile; the prefill kernel over all ``steps`` 64-row stages
    (``splits`` 1)."""
    route: str                      # "decode" or "prefill"
    splits: int
    per: int                        # steps a split
    steps: int                      # packed steps of the contraction


def k3_plan(M: int, N: int, K2: int) -> K3Plan:
    """The kernel's plan for x [M, 2 K2] and packed [K2, N]. Decode is
    latency-bound (one projection is ~1.6 MB of weight): one step a warp
    where :data:`MAX_SPLITS` (a portable cluster) allows, then as few
    splits as give the same steps a split (so none is empty); their sums
    meet in the cluster's shared memory. The blocks of every split fit
    on the card at once (at most 8 x N / 128 blocks of 256 threads)."""
    if M > DECODE_ROWS:
        steps = K2 // BLOCK_K2
        return K3Plan("prefill", 1, steps, steps)
    steps = K2 // DECODE_STEP
    want = max(1, min(MAX_SPLITS, -(-steps // DECODE_WARPS)))
    per = -(-steps // want)
    return K3Plan("decode", -(-steps // per), per, steps)


def quantized_matmul(x: torch.Tensor, leaf: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
    """``x @ dequant(leaf)`` with leading batch dims on x. A 2-D int4 leaf
    takes the route of :func:`int4_route` ("auto" launches the kernel only
    on a card and where :func:`kernel_takes` the leaf); other leaves
    dequantize to x.dtype and multiply (no kernel exists for them)."""
    route = _route[0]
    if "q4" not in leaf or leaf["q4"].dim() != 2 or (
            route == "auto" and not (_on_cuda(x)
                                     and kernel_takes(x, leaf["q4"]))):
        return x @ dequantize_array(leaf, x.dtype)
    N = leaf["q4"].shape[1]
    fn = int4_matmul_plain if route == "plain" else int4_matmul
    y = fn(x.reshape(-1, x.shape[-1]), leaf["q4"],
           leaf["scale"].reshape(1, N))
    return y.reshape(*x.shape[:-1], N)
