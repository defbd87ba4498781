"""lm-head product + sparse top-K KD loss as one op with an analytic
backward (port of ``head_sparse_kd_loss`` in
``speech_distill_tpu/ops/fused_lm_loss.py``).

The forward materialises the fp32 logits and computes exactly what
``losses.sparse_distill_loss(unembed(hidden), ...)`` computes. The
backward is the one-pass form of the JAX custom VJP:

  d task   / ds_j = inv_n * valid * (softmax(s)_j - 1[j = label])
  d distill/ds_j = inv_n * valid * T * (softmax(s/T)_j - scatter(p)_j)

built in bf16 from a bf16 logits residual (bf16 even when the model runs
in fp32, as the JAX op hard-codes), with -c_dist * p scattered onto the
top-K indices and then -c_task onto the label, followed by the two head
products with fp32 accumulation. It is not a TPU kernel: the products go
to ``torch.matmul`` (cuBLAS on the card). The chunked and Pallas fused
losses wait for a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from speech_distill_tpu_torch.distill.losses import (DistillLossOutput,
                                                     _shift_and_mask)
from speech_distill_tpu_torch.ops.matmul import matmul_f32


class _HeadKD(torch.autograd.Function):
    """(total, task, distill, teacher) of h [N, D] @ w [V, D]^T against
    fp32 teacher logprobs v [N, K] at int64 indices idx [N, K]; labels
    [N] (may be IGNORE_INDEX), valid fp32 [N]."""

    @staticmethod
    def forward(ctx, h, w, v, idx, shift_labels, valid, T, alpha):
        s = matmul_f32(h, w.t())                                # [N, V]
        log_p = torch.log_softmax(v / T, dim=-1)
        p = log_p.exp()
        lse1 = torch.logsumexp(s, dim=-1)
        lse_t = torch.logsumexp(s / T, dim=-1)
        safe = shift_labels.clamp_min(0)
        gold = s.gather(1, safe[:, None])[:, 0]
        topk = s.gather(1, idx)

        n = valid.sum()
        inv_n = torch.where(n > 0, 1.0 / n.clamp_min(1.0),
                            torch.zeros_like(n))
        task = ((lse1 - gold) * valid).sum() * inv_n
        log_q = topk / T - lse_t[:, None]
        distill = ((p * (log_p - log_q)).sum(-1) * valid).sum() * inv_n \
            * (T * T)
        hits = (idx == shift_labels[:, None]).float() * valid[:, None]
        n_hits = hits.sum()
        teacher = torch.where(n_hits > 0,
                              -(v * hits).sum() / n_hits.clamp_min(1.0),
                              torch.zeros_like(n_hits))
        total = alpha * task + (1.0 - alpha) * distill
        # the dominant residual, the logits, is kept in bf16
        ctx.save_for_backward(h, w, s.to(torch.bfloat16), lse1, lse_t, p,
                              idx, safe, valid, inv_n)
        ctx.T, ctx.alpha = T, alpha
        return total, task, distill, teacher

    @staticmethod
    def backward(ctx, g_total, g_task, g_distill, g_teacher):
        h, w, sb, lse1, lse_t, p, idx, safe, valid, inv_n = ctx.saved_tensors
        T, alpha = ctx.T, ctx.alpha
        a_task = (g_total * alpha + g_task) * inv_n
        a_dist = (g_total * (1.0 - alpha) + g_distill) * inv_n * T
        c_task = (a_task * valid)[:, None]                      # [N, 1]
        c_dist = (a_dist * valid)[:, None]
        s32 = sb.float()
        d = (c_task * torch.exp(s32 - lse1[:, None])
             + c_dist * torch.exp(s32 / T - lse_t[:, None])
             ).to(torch.bfloat16)
        del s32
        d.scatter_add_(1, idx, (-c_dist * p).to(torch.bfloat16))
        d.scatter_add_(1, safe[:, None], (-c_task).to(torch.bfloat16))
        bf = torch.bfloat16
        dh = matmul_f32(d, w.to(bf)).to(h.dtype)
        dw = matmul_f32(d.t(), h.to(bf)).to(w.dtype)
        return dh, dw, None, None, None, None, None, None


def head_sparse_kd_loss(hidden: torch.Tensor, lm_w: torch.Tensor,
                        labels: torch.Tensor,
                        teacher_top_k_v: torch.Tensor,
                        teacher_top_k_i: torch.Tensor,
                        speech_token_mask: Optional[torch.Tensor] = None,
                        temperature: float = 2.0,
                        alpha: float = 0.5) -> DistillLossOutput:
    """hidden [B, T, D] (before the shift), lm_w [V, D]. Forward values
    equal ``sparse_distill_loss(unembed(hidden), ...)``; the backward is
    the analytic one-pass form."""
    D = hidden.shape[-1]
    K = teacher_top_k_i.shape[-1]
    h = hidden[:, :-1, :].reshape(-1, D)
    shift_labels, valid = _shift_and_mask(labels, speech_token_mask)
    v = teacher_top_k_v[:, :-1, :].float().reshape(-1, K).detach()
    idx = teacher_top_k_i[:, :-1, :].long().reshape(-1, K)
    out = _HeadKD.apply(h, lm_w, v, idx, shift_labels.reshape(-1).long(),
                        valid.reshape(-1), float(temperature), float(alpha))
    return DistillLossOutput(*out)
