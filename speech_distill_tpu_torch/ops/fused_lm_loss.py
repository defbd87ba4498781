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
* :func:`head_dense_kd_loss`: the same for the dense (full-vocab) KD loss
  against the teacher's logits, the backward's d_logits

    d distill/ds_j = inv_n * valid * T * (softmax(s/T)_j - softmax(t/T)_j)

  built in bf16 from bf16 student and teacher logits residuals, one batch
  row at a time, so no fp32 [N, V] temporary outlives its row.
* :func:`fused_topk_lse` and :func:`fused_extract_top_k`: the teacher's
  exact top-K and logsumexp over vocab chunks of the head product, never
  holding [N, V] (the chunk products are ``torch.matmul``, as JAX leaves
  them to XLA).
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

from speech_distill_tpu_torch.core.metrics import span
from speech_distill_tpu_torch.distill.losses import (DistillLossOutput,
                                                     IGNORE_INDEX,
                                                     _masked_mean,
                                                     _shift_and_mask,
                                                     segmented_top_k)
from speech_distill_tpu_torch.ops.matmul import matmul_f32
from speech_distill_tpu_torch.ops.pallas_lm_loss import (chunked_stats,
                                                         gathered_logits,
                                                         lm_head_stats)
from speech_distill_tpu_torch.parallel.comm import global_count

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
    n_hits = global_count(hits.sum())
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

        n = global_count(valid.sum())
        inv_n = torch.where(n > 0, 1.0 / n.clamp_min(1.0),
                            torch.zeros_like(n))
        task = ((lse1 - gold) * valid).sum() * inv_n
        log_q = topk / T - lse_t[:, None]
        distill = ((p * (log_p - log_q)).sum(-1) * valid).sum() * inv_n \
            * (T * T)
        hits = (idx == shift_labels[:, None]).float() * valid[:, None]
        n_hits = global_count(hits.sum())
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
        with span("train.head"):
            return _HeadKD._backward(ctx, g_total, g_task, g_distill,
                                     g_teacher)

    @staticmethod
    def _backward(ctx, g_total, g_task, g_distill, g_teacher):
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


class _HeadDenseKD(torch.autograd.Function):
    """(total, task, distill, teacher) of h [B, T-1, D] @ w [V, D]^T
    against the teacher logits t [B, T, V] (row b's first T-1 positions);
    labels and valid [B, T-1]. Each batch row's [T-1, V] fp32 logits live
    only while that row is computed."""

    @staticmethod
    def forward(ctx, h, w, t, shift_labels, valid, T, alpha):
        B, Tm1, _ = h.shape
        V = w.shape[0]
        sb = torch.empty(B, Tm1, V, dtype=torch.bfloat16, device=h.device)
        tb = torch.empty_like(sb)
        rows = {k: torch.empty(B, Tm1, device=h.device)
                for k in ("lse1_s", "lse_t_s", "lse1_t", "lse_t_t", "kl",
                          "gold_s", "gold_t")}
        safe = shift_labels.clamp_min(0)
        for b in range(B):
            s = matmul_f32(h[b], w.t())                         # [T-1, V]
            tt = t[b, :-1].float()
            lse_t_s = torch.logsumexp(s / T, dim=-1)
            lse_t_t = torch.logsumexp(tt / T, dim=-1)
            log_p = tt / T - lse_t_t[:, None]
            log_q = s / T - lse_t_s[:, None]
            rows["kl"][b] = (log_p.exp() * (log_p - log_q)).sum(-1)
            del log_p, log_q
            rows["lse1_s"][b] = torch.logsumexp(s, dim=-1)
            rows["lse1_t"][b] = torch.logsumexp(tt, dim=-1)
            rows["lse_t_s"][b], rows["lse_t_t"][b] = lse_t_s, lse_t_t
            rows["gold_s"][b] = s.gather(1, safe[b][:, None])[:, 0]
            rows["gold_t"][b] = tt.gather(1, safe[b][:, None])[:, 0]
            sb[b], tb[b] = s, tt
            del s, tt
        n = global_count(valid.sum())
        inv_n = torch.where(n > 0, 1.0 / n.clamp_min(1.0),
                            torch.zeros_like(n))
        task = ((rows["lse1_s"] - rows["gold_s"]) * valid).sum() * inv_n
        distill = (rows["kl"] * valid).sum() * inv_n * (T * T)
        teacher = ((rows["lse1_t"] - rows["gold_t"]) * valid).sum() * inv_n
        total = alpha * task + (1.0 - alpha) * distill
        ctx.save_for_backward(h, w, sb, tb, rows["lse1_s"], rows["lse_t_s"],
                              rows["lse_t_t"], safe, valid, inv_n)
        ctx.T, ctx.alpha = T, alpha
        return total, task, distill, teacher

    @staticmethod
    def backward(ctx, g_total, g_task, g_distill, g_teacher):
        with span("train.head"):
            return _HeadDenseKD._backward(ctx, g_total, g_task, g_distill,
                                          g_teacher)

    @staticmethod
    def _backward(ctx, g_total, g_task, g_distill, g_teacher):
        (h, w, sb, tb, lse1_s, lse_t_s, lse_t_t, safe, valid,
         inv_n) = ctx.saved_tensors
        T, alpha = ctx.T, ctx.alpha
        a_task = (g_total * alpha + g_task) * inv_n
        a_dist = (g_total * (1.0 - alpha) + g_distill) * inv_n * T
        c_task = (a_task * valid)[..., None]                # [B, T-1, 1]
        c_dist = (a_dist * valid)[..., None]
        d = torch.empty_like(sb)
        for b in range(d.shape[0]):
            s32, t32 = sb[b].float(), tb[b].float()
            d[b] = (c_task[b] * torch.exp(s32 - lse1_s[b][:, None])
                    + c_dist[b] * (torch.exp(s32 / T - lse_t_s[b][:, None])
                                   - torch.exp(t32 / T
                                               - lse_t_t[b][:, None])))
            del s32, t32
        d.scatter_add_(2, safe[..., None], (-c_task).to(torch.bfloat16))
        bf = torch.bfloat16
        D, V = h.shape[-1], w.shape[0]
        dh = matmul_f32(d, w.to(bf)).to(h.dtype)
        dw = matmul_f32(d.reshape(-1, V).t(),
                        h.reshape(-1, D).to(bf)).to(w.dtype)
        return dh, dw, None, None, None, None, None


def head_dense_kd_loss(hidden: torch.Tensor, lm_w: torch.Tensor,
                       teacher_logits: torch.Tensor, labels: torch.Tensor,
                       speech_token_mask: Optional[torch.Tensor] = None,
                       temperature: float = 2.0,
                       alpha: float = 0.5) -> DistillLossOutput:
    """The dense KD head loss as one op (the quantized-teacher or
    top_k <= 0 mode): hidden [B, T, D] (before the shift), lm_w [V, D],
    teacher_logits [B, T, V] already truncated to the student vocab (no
    gradient). Forward values equal ``dense_distill_loss(unembed(hidden),
    teacher_logits, ...)``; the backward is the analytic one-pass form with
    bf16 d_logits, student and teacher logits kept in bf16."""
    shift_labels, valid = _shift_and_mask(labels, speech_token_mask)
    out = _HeadDenseKD.apply(hidden[:, :-1, :], lm_w, teacher_logits.detach(),
                             shift_labels.long(), valid, float(temperature),
                             float(alpha))
    return DistillLossOutput(*out)


def fused_topk_lse(h: torch.Tensor, lm_w: torch.Tensor, k: int,
                   vocab_limit: Optional[int] = None,
                   chunk_size: int = 16384,
                   bias: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The raw top-k logits and the logsumexp of ``h @ lm_w.T (+ bias)``
    over vocab chunks of ``chunk_size`` (the JAX ``fused_topk_lse``): one
    fp32 [N, chunk] product at a time, merged into a running top-k and an
    online logsumexp. h [N, D], lm_w [V, D], bias [V]. Returns (values
    fp32 [N, k], indices int32 [N, k], lse fp32 [N]); the set is exact.
    The last chunk is short where JAX pads it with masked columns."""
    N = h.shape[0]
    w = lm_w[:vocab_limit] if vocab_limit is not None else lm_w
    V = w.shape[0]
    kw = dict(dtype=torch.float32, device=h.device)
    m = torch.full((N,), -1e30, **kw)
    s = torch.zeros(N, **kw)
    tv = torch.full((N, k), -1e30, **kw)
    ti = torch.zeros(N, k, dtype=torch.int64, device=h.device)
    for off in range(0, V, chunk_size):
        logits = matmul_f32(h, w[off:off + chunk_size].t())
        if bias is not None:
            logits = logits + bias[off:off + logits.shape[1]].float()
        new_m = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - new_m) + torch.exp(
            logits - new_m[:, None]).sum(1)
        m = new_m
        cv, ci = segmented_top_k(logits, min(k, logits.shape[1]))
        tv, sel = torch.topk(torch.cat([tv, cv], 1), k, dim=1)
        ti = torch.cat([ti, ci + off], 1).gather(1, sel)
    return tv, ti.to(torch.int32), m + torch.log(s.clamp_min(1e-30))


def fused_extract_top_k(hidden: torch.Tensor, lm_w: torch.Tensor, k: int,
                        vocab_limit: Optional[int] = None,
                        chunk_size: int = 16384
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher top-k logprob extraction fused with the head product, never
    holding the [B, T, V] fp32 teacher logits: hidden [B, T, D] (the
    teacher's final hidden states), lm_w [V, D]. Returns (fp16 logprobs,
    int32 indices) [B, T, k], the set of ``extract_top_k(unembed(hidden),
    k, method="exact")``. No gradient flows (the teacher is frozen)."""
    B, S, D = hidden.shape
    with torch.no_grad():
        tv, ti, lse = fused_topk_lse(hidden.reshape(-1, D), lm_w, k,
                                     vocab_limit, chunk_size)
    v = (tv - lse[:, None]).to(torch.float16).reshape(B, S, k)
    return v, ti.reshape(B, S, k)
