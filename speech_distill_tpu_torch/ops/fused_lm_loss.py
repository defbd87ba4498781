"""Fused lm-head losses (port of ``speech_distill_tpu/ops/fused_lm_loss.py``).

* :func:`head_sparse_kd_loss`: the lm-head product and the sparse top-K KD
  loss as one op with an analytic backward. The forward materialises the
  fp32 logits and computes exactly what ``losses.sparse_distill_loss(
  unembed(hidden), ...)`` computes. The backward is the one-pass form of
  the JAX custom VJP:

    d task   / ds_j = inv_n * valid * (softmax(s)_j - 1[j = label])
    d distill/ds_j = inv_n * valid * T * (softmax(s/T)_j - scatter(p)_j)

  built in bf16 from a bf16 logits residual (bf16 even when the model runs
  in fp32, as the JAX op hard-codes), with -c_dist * p scattered onto the
  top-K indices and then -c_task onto the label, followed by the two head
  products with fp32 accumulation (``torch.matmul``, cuBLAS on the card;
  not a TPU kernel).
* :func:`fused_sparse_kd_loss` and :func:`fused_cross_entropy`: the same
  losses from row statistics, never materialising the [N, V] logits.
  ``backend="xla"`` (the JAX name) is the chunked plain route: an online
  logsumexp over vocab chunks, each chunk's body checkpointed as
  ``jax.checkpoint`` is in the JAX scan; the chunk's logits are fp32 sums
  of the operands (the JAX scan rounds a bf16 product to bf16 first; the
  port keeps the fp32 sum, as the kernels do). ``backend="pallas"`` takes
  the statistics from ``ops/pallas_lm_loss.lm_head_stats`` (the K2 kernels
  on the card). Logits at the label and at the teacher's top-K columns come
  from W-row gathers (``gathered_logits``) in both routes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from speech_distill_tpu_torch.distill.losses import (DistillLossOutput,
                                                     IGNORE_INDEX,
                                                     _masked_mean,
                                                     _shift_and_mask)
from speech_distill_tpu_torch.ops.matmul import matmul_f32
from speech_distill_tpu_torch.ops.pallas_lm_loss import (chunked_stats,
                                                         gathered_logits,
                                                         lm_head_stats)

BACKENDS = ("xla", "pallas")


class _RowStats(NamedTuple):
    lse1: torch.Tensor          # [N] logsumexp at temperature 1
    lse_t: torch.Tensor         # [N] logsumexp at temperature T
    label_logit: torch.Tensor   # [N]
    topk_logit: torch.Tensor    # [N, K]


def _collect_lse(hidden: torch.Tensor, lm_w: torch.Tensor,
                 temperature: float, chunk_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online logsumexp of hidden [N, D] @ lm_w [V, D]^T at temperatures 1
    and T over vocab chunks of ``chunk_size``, each chunk checkpointed so
    its [N, chunk] logits are recomputed in the backward, not kept. The
    last chunk is short where JAX pads it with masked columns; the sums are
    the same."""
    lse1, lse_t, _ = chunked_stats(hidden, lm_w, None, temperature,
                                   chunk_size, checkpointed=True)
    return lse1, lse_t


def _collect_stats(hidden: torch.Tensor, lm_w: torch.Tensor,
                   labels: torch.Tensor, topk_i: torch.Tensor,
                   temperature: float, chunk_size: int) -> _RowStats:
    lse1, lse_t = _collect_lse(hidden, lm_w, temperature, chunk_size)
    label_logit = gathered_logits(hidden, lm_w, labels[:, None])[:, 0]
    return _RowStats(lse1, lse_t, label_logit,
                     gathered_logits(hidden, lm_w, topk_i))


def fused_sparse_kd_loss(hidden: torch.Tensor, lm_w: torch.Tensor,
                         labels: torch.Tensor,
                         teacher_top_k_v: torch.Tensor,
                         teacher_top_k_i: torch.Tensor,
                         speech_token_mask: Optional[torch.Tensor] = None,
                         temperature: float = 2.0, alpha: float = 0.5,
                         chunk_size: int = 8192,
                         backend: str = "xla") -> DistillLossOutput:
    """The sparse top-K KD loss from hidden [B, T, D] (before the shift)
    and the unembedding lm_w [V, D], with the values of
    ``sparse_distill_loss(unembed(hidden), ...)``, from row statistics:
    ``backend="xla"`` the chunked plain route, ``"pallas"`` the K2 op."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown fused backend {backend!r} ({BACKENDS})")
    T = temperature
    D = hidden.shape[-1]
    h = hidden[:, :-1, :].reshape(-1, D)
    shift_labels, valid = _shift_and_mask(labels, speech_token_mask)
    labels_flat = shift_labels.reshape(-1).long().clamp_min(0)
    K = teacher_top_k_i.shape[-1]
    idx = teacher_top_k_i[:, :-1, :].long().reshape(-1, K)
    if backend == "pallas":
        lse1, lse_t, label_logit = lm_head_stats(h, lm_w, labels_flat, T)
        stats = _RowStats(lse1, lse_t, label_logit,
                          gathered_logits(h, lm_w, idx))
    else:
        stats = _collect_stats(h, lm_w, labels_flat, idx, T, chunk_size)

    valid = valid.reshape(-1)
    task = _masked_mean(stats.lse1 - stats.label_logit, valid)
    v = teacher_top_k_v[:, :-1, :].float().reshape(-1, K).detach()
    log_p = torch.log_softmax(v / T, dim=-1)
    p = log_p.exp()
    log_q = stats.topk_logit / T - stats.lse_t[:, None]
    kl = (p * (log_p - log_q)).sum(-1)
    distill = _masked_mean(kl, valid) * (T * T)
    hits = (idx == labels_flat[:, None]).float() * valid[:, None] \
        * (shift_labels.reshape(-1) != IGNORE_INDEX).float()[:, None]
    n_hits = hits.sum()
    teacher = torch.where(n_hits > 0,
                          -(v * hits).sum() / n_hits.clamp_min(1.0),
                          torch.zeros_like(n_hits))
    total = alpha * task + (1.0 - alpha) * distill
    return DistillLossOutput(total, task, distill, teacher)


def fused_cross_entropy(hidden: torch.Tensor, lm_w: torch.Tensor,
                        labels: torch.Tensor, chunk_size: int = 8192,
                        backend: str = "xla") -> torch.Tensor:
    """Masked-mean next-token CE from hidden [B, T, D] and lm_w [V, D]
    over labels != -100 (the Liger FLCE equivalent of stage 1):
    ``backend="xla"`` the chunked plain route, ``"pallas"`` the K2 op at
    temperature 2, of which only lse1 and the label logit are used, as the
    JAX stage-1 step calls it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown fused backend {backend!r} ({BACKENDS})")
    D = hidden.shape[-1]
    h = hidden[:, :-1, :].reshape(-1, D)
    shift = labels[:, 1:].reshape(-1).long()
    valid = (shift != IGNORE_INDEX).float()
    if backend == "pallas":
        lse1, _, gold = lm_head_stats(h, lm_w, shift.clamp_min(0), 2.0)
    else:
        lse1, _ = _collect_lse(h, lm_w, 1.0, chunk_size)
        gold = gathered_logits(h, lm_w, shift.clamp_min(0)[:, None])[:, 0]
    return _masked_mean(lse1 - gold, valid)


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
