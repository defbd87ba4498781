"""LoRA projection: merged forward, skinny backward.

Port of ``speech_distill_tpu/ops/lora_linear.py`` (a JAX custom VJP) as a
``torch.autograd.Function``. The forward merges the rank-r delta into the
frozen weight and runs ONE product, ``x @ (W + g * A @ B)``; the backward
never forms a dense [din, dout] weight gradient:

    dx = dy W_eff^T
    dA = g * x^T (dy B^T)        ([N, r] temp, then [din, r])
    dB = g * (x A)^T dy          ([N, r] temp, then [r, dout])

with dA and dB accumulated in fp32. The base weight W is frozen and gets
no gradient. These are plain products outside any TPU kernel, so they go
to ``torch.matmul`` (cuBLAS on the card).
"""
from __future__ import annotations

import torch

from speech_distill_tpu_torch.ops.matmul import matmul_f32


def _merge(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """W + (g * A @ B) with the delta computed in fp32 and cast to
    ``dtype`` before the add."""
    return w + (matmul_f32(a, b) * scale).to(dtype)


class LoraLinear(torch.autograd.Function):
    """x [..., din] @ (w [din, dout] + scale * a [din, r] @ b [r, dout])."""

    @staticmethod
    def forward(ctx, x, w, a, b, scale: float):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        return x @ _merge(w, a, b, scale, x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        scale = ctx.scale
        dx = dy @ _merge(w, a, b, scale, x.dtype).t()
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
        dyb = matmul_f32(dy2, b.to(dy2.dtype).t())            # [N, r]
        da = (x2.float().t() @ dyb) * scale
        xa = matmul_f32(x2, a.to(x2.dtype))                   # [N, r]
        db = (xa.t() @ dy2.float()) * scale
        return dx, None, da.to(a.dtype), db.to(b.dtype), None


def lora_linear(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float) -> torch.Tensor:
    return LoraLinear.apply(x, w, a, b, float(scale))
