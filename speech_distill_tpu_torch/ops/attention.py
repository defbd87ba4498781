"""Attention dispatch (port of ``speech_distill_tpu/ops/attention.py``).

``sdpa`` picks a route by ``impl``, with the JAX names:

* ``"xla"``: :func:`sdpa_plain`, plain tensor code (as JAX leaves it to
  XLA);
* ``"pallas"``: the causal flash op (``flash_attention``: the hand-written
  CUDA kernels on CUDA tensors, which raise on what they cannot take; the
  plain versions on CPU tensors, as JAX interprets the Pallas kernel
  off the TPU);
* ``"auto"``: the flash op where :func:`use_flash` says the kernels apply
  — CUDA tensors, T >= 512, T == S, T % 256 == 0 (the JAX predicate) and
  what the kernels take (bf16, Dh in {64, 128}) — and the plain route
  otherwise. The JAX ``try/except`` fallback is not carried over: on the
  kernel route the kernel runs or raises;
* ``"ring"`` / ``"ring_zigzag"``: with no bias and T == S, ring attention
  over the sp axis of ``mesh`` (default: the active mesh;
  ``ops/ring_attention``) on this rank's sequence shard, the zig-zag ring
  where the global length splits into 2 sp chunks and the contiguous ring
  otherwise; with a bias (the forward found no ring to take) the plain
  route.
"""
from __future__ import annotations

from typing import Optional

import torch

from speech_distill_tpu_torch.ops.flash_attention import (flash_attention,
                                                          kernel_takes)

FLASH_MIN_SEQ = 512
FLASH_BLOCK = 256
IMPLS = ("auto", "xla", "pallas", "ring", "ring_zigzag")
RING_IMPLS = ("ring", "ring_zigzag")


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query SDPA (counterpart of ``sdpa_xla``).

    q: [B, T, H, Dh], k/v: [B, S, KV, Dh], mask_bias: [B, 1, T, S] fp32
    additive (0 keep / -inf drop). Returns [B, T, H, Dh] in q.dtype.
    Scores and softmax are fp32 (bf16 operands upcast: their products are
    exact in fp32, as with an fp32-accumulating bf16 product)."""
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, T, KV, G, Dh)
    logits = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * Dh ** -0.5
    if mask_bias is not None:
        logits = logits + mask_bias[:, :, None, :, :]
    # fully masked rows (padding queries) get uniform attention instead of
    # NaN; their outputs are masked downstream
    logits = logits.masked_fill(torch.isneginf(logits), -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), v)
    return out.reshape(B, T, H, Dh).to(q.dtype)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def use_flash(q: torch.Tensor, k: torch.Tensor, impl: str = "auto") -> bool:
    """Whether ``sdpa`` takes the flash route for these inputs."""
    if impl == "xla":
        return False
    if impl in ("pallas", *RING_IMPLS):
        return impl == "pallas"
    if impl != "auto":
        raise NotImplementedError(
            f"attn_impl={impl!r} is not ported (the port has {IMPLS})")
    T = q.shape[1]
    return (_on_cuda(q) and T >= FLASH_MIN_SEQ and T == k.shape[1]
            and T % FLASH_BLOCK == 0 and kernel_takes(q)
            and k.dtype == q.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask_bias: Optional[torch.Tensor], impl: str = "auto", mesh=None,
         zigzag: bool = False) -> torch.Tensor:
    """Attention output [B, T, H, Dh] by the route :func:`use_flash`
    picks, or a ring route. On the flash and ring routes the mask is
    implied (causal; right padding is exact) and gradients flow through
    the kernels' backward or the ring's. A ring route runs over ``mesh``'s
    sp axis (default the active mesh) on this rank's shard, the zig-zag
    chunk pair with ``zigzag``: the caller's layout of the sequence
    (``qwen3.sequence_layout``)."""
    if impl in RING_IMPLS:
        if mask_bias is None and q.shape[1] == k.shape[1]:
            from speech_distill_tpu_torch.ops import ring_attention as ra
            from speech_distill_tpu_torch.parallel.mesh import \
                get_active_mesh
            mesh = mesh if mesh is not None else get_active_mesh()
            ring = ra.zigzag_ring_attention if zigzag else ra.ring_attention
            return ring(q, k, v, mesh)
        return sdpa_plain(q, k, v, mask_bias)
    if use_flash(q, k, impl):
        return flash_attention(q, k, v)
    return sdpa_plain(q, k, v, mask_bias)
