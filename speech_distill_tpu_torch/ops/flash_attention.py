"""Causal GQA flash attention: forward, backward and the autograd op.

Port of ``speech_distill_tpu/ops/flash_attention.py``: the forward
(``_fwd_kernel`` via ``_flash_call``) and the two-kernel backward
(``_dq_kernel``, ``_dkv_kernel`` and the sum over query groups in
``_flash_bwd``), tied together by :class:`FlashAttention` as the JAX
custom VJP ties them.

Layout: q [B, T, H, Dh], k/v [B, T, KV, Dh] (GQA: H = KV * G), T == S.
The forward returns (o [B, T, H, Dh] in q.dtype, lse [B, H, T] fp32); the
backward reuses that lse. Causal masking only: exact for right-padded
batches, because padded keys sit beyond every valid query's causal window.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` launch the
hand-written CUDA kernels ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``
for CUDA tensors; for CPU tensors they run their plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from speech_distill_tpu_torch.ops import _cuda

NEG_INF = -1e30
# T granularity of the kernels: their 64-row warpgroup tiles (the
# 128-row tiles of flash_fwd.cu and flash_bwd.cu zero-fill past T)
KERNEL_BLOCK = 64


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain causal GQA attention in fp32 with its log-sum-exp."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, T, KV, G, Dh)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * Dh ** -0.5
    pos = torch.arange(T, device=q.device)
    s = torch.where(pos[None, :] <= pos[:, None], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                        # [B, KV, G, T]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return (o.reshape(B, T, H, Dh).to(q.dtype),
            lse.reshape(B, H, T))


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  what: str) -> None:
    """q [B, T, H, Dh] against k/v [B, T, KV, Dh] with KV dividing H."""
    B, T, H, Dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[1] != T or k.shape[3] != Dh:
        raise ValueError(f"{what} needs k/v [B, T, KV, Dh] matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of KV={k.shape[2]}")


def kernel_takes(q: torch.Tensor) -> bool:
    """Whether the CUDA kernels take q's dtype and shape (k/v alike): bf16,
    Dh in (64, 128), T a multiple of the 64-row tile."""
    return (q.dtype == torch.bfloat16 and q.shape[3] in (64, 128)
            and q.shape[1] % KERNEL_BLOCK == 0)


def _check_kernel_inputs(what: str, **tensors) -> None:
    """Each ``name=(tensor, dtype)`` has that dtype and is contiguous on
    q's device; q is one the kernels take."""
    q = tensors["q"][0]
    if not kernel_takes(q):
        raise ValueError(f"{what} needs bf16, T % {KERNEL_BLOCK} == 0 and "
                         f"Dh in (64, 128), got {q.dtype}, T={q.shape[1]}, "
                         f"Dh={q.shape[3]}")
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{what} takes {dtype} {name}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse). CPU tensors take :func:`flash_attention_fwd_plain`; CUDA
    tensors launch ``csrc/flash_fwd.cu`` or raise — no fallback."""
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v)
    _check_shapes(q, k, v, "flash_fwd")
    bf = torch.bfloat16
    _check_kernel_inputs("flash_fwd", q=(q, bf), k=(k, bf), v=(v, bf))
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = _cuda.function("flash_fwd")
    _cuda.launches["flash_fwd"] += 1
    _cuda.check(fn(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(o),
                   _cuda.ptr(lse), B, T, H, KV, Dh, Dh ** -0.5,
                   _cuda.stream_of(q)),
                "flash_fwd")
    return o, lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of causal GQA attention in fp32, with the algebra of the
    JAX backward (``_flash_bwd``): delta = rowsum(dO * O), p recomputed as
    exp(s * scale - lse), ds = p * (dp - delta); dq and dk scaled by
    Dh^-0.5; dk and dv summed over the G query heads of each KV head.
    Results in the dtypes of q, k and v."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = Dh ** -0.5
    qf = q.float().reshape(B, T, KV, G, Dh)
    dof = do.float().reshape(B, T, KV, G, Dh)
    kf, vf = k.float(), v.float()
    delta = (dof * o.float().reshape(B, T, KV, G, Dh)).sum(-1)   # [B,T,KV,G]
    delta = delta.permute(0, 2, 3, 1)[..., None]                # [B,KV,G,T,1]
    s = torch.einsum("btkgd,bskd->bkgts", qf, kf) * scale
    pos = torch.arange(T, device=q.device)
    causal = pos[None, :] <= pos[:, None]
    p = torch.where(causal, torch.exp(s - lse.reshape(B, KV, G, T, 1)), 0.0)
    dp = torch.einsum("btkgd,bskd->bkgts", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgts,bskd->btkgd", ds, kf) * scale
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgts,btkgd->bskd", p, dof)
    return (dq.reshape(B, T, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check_shapes(q, k, v, "flash_bwd")
    B, T, H, _ = q.shape
    if do.shape != q.shape or lse.shape != (B, H, T) \
            or delta.shape != (B, H, T):
        raise ValueError(f"flash_bwd needs dO {tuple(q.shape)} and lse / "
                         f"delta {(B, H, T)}, got {tuple(do.shape)} / "
                         f"{tuple(lse.shape)} / {tuple(delta.shape)}")
    bf, f32 = torch.bfloat16, torch.float32
    _check_kernel_inputs("flash_bwd", q=(q, bf), k=(k, bf), v=(v, bf),
                         do=(do, bf), lse=(lse, f32), delta=(delta, f32))


def _bwd_args(q, k, v, do, lse, delta):
    B, T, H, Dh = q.shape
    head = (_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(do),
            _cuda.ptr(lse), _cuda.ptr(delta))
    tail = (B, T, H, k.shape[2], Dh, Dh ** -0.5, _cuda.stream_of(q))
    return head, tail


def flash_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq [B, T, H, Dh] bf16 from ``csrc/flash_bwd.cu`` (CUDA tensors
    only): lse is the forward's, delta = rowsum(dO * O), both fp32
    [B, H, T]."""
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    head, tail = _bwd_args(q, k, v, do, lse, delta)
    fn = _cuda.function("flash_dq")
    _cuda.launches["flash_dq"] += 1
    _cuda.check(fn(*head, _cuda.ptr(dq), *tail), "flash_dq")
    return dq


def flash_dkv(q, k, v, do, lse, delta
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, T, KV, Dh] bf16, summed over each KV head's query
    group, from ``csrc/flash_bwd.cu`` (CUDA tensors only)."""
    _check_bwd(q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    head, tail = _bwd_args(q, k, v, do, lse, delta)
    fn = _cuda.function("flash_dkv")
    _cuda.launches["flash_dkv"] += 1
    _cuda.check(fn(*head, _cuda.ptr(dk), _cuda.ptr(dv), *tail), "flash_dkv")
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv). CPU tensors take :func:`flash_attention_bwd_plain`;
    CUDA tensors launch :func:`flash_dq` and :func:`flash_dkv` or raise —
    no fallback. ``lse`` must be the forward's own
    (``flash_attention_fwd``)."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_bwd needs o like q {tuple(q.shape)} "
                         f"{q.dtype}, got {tuple(o.shape)} {o.dtype}")
    # delta = rowsum(dO * O) in fp32, outside the kernels as in JAX
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (flash_dq(q, k, v, do, lse, delta),
            *flash_dkv(q, k, v, do, lse, delta))


class FlashAttention(torch.autograd.Function):
    """Causal GQA flash attention with the kernels' backward (the port of
    the JAX ``flash_attention`` custom VJP). The forward saves (q, k, v, o,
    lse); under activation checkpointing it runs again in the backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Differentiable causal GQA attention, o [B, T, H, Dh]: the kernels on
    CUDA tensors (which raise on what they cannot take), the plain versions
    on CPU tensors."""
    _check_shapes(q, k, v, "flash_attention")
    return FlashAttention.apply(q, k, v)
