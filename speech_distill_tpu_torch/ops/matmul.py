"""Matrix products with an fp32 result from operands of any float dtype.

The counterpart of JAX's ``dot_general(..., preferred_element_type=
float32)``: bf16 operands are multiplied at the tensor cores' bf16 rate
with fp32 accumulation, and the fp32 sum is returned unrounded. On CUDA
that is ``torch.mm(..., out_dtype=torch.float32)``; on the CPU the
operands are upcast first (products of bf16 values are exact in fp32).
A plain bf16 product would round its result to bf16, so it is not used
where JAX keeps fp32.
"""
from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] -> fp32 [..., N]."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda and a.dtype == b.dtype:
        lead = a.shape[:-1]
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*lead, b.shape[-1])
    return a.float() @ b.float()
