"""Distillation losses (port of ``speech_distill_tpu/distill/losses.py``).

Every reduction is a masked mean over a fixed-shape row set:

  * causal shift: logits[t] predicts labels[t+1]
  * valid = speech_token_mask[1:] AND labels[1:] != -100
  * task_loss      = CE(student, labels), mean over valid rows
  * dense distill  = full-vocab KL at temperature T, x T^2
  * sparse distill = teacher top-K renormalised KL at temperature T, x T^2
  * teacher_loss   = dense: the teacher's CE; sparse: -mean top-K logprob
                     of the gold label over the valid rows where it
                     appears in the top-K
  * total = alpha * task + (1 - alpha) * distill

All math in fp32 whatever the input dtype. The online top-K extraction
(:func:`extract_top_k`) lives here too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from speech_distill_tpu_torch.parallel.comm import global_count

IGNORE_INDEX = -100


class DistillLossOutput(NamedTuple):
    total: torch.Tensor
    task: torch.Tensor
    distill: torch.Tensor
    teacher: torch.Tensor


def _shift_and_mask(labels: torch.Tensor,
                    speech_token_mask: Optional[torch.Tensor]):
    """(shifted labels [B, T-1], valid fp32 mask [B, T-1])."""
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    if speech_token_mask is not None:
        valid = valid & (speech_token_mask[:, 1:] != 0)
    return shift_labels, valid.float()


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / count; under ``comm.dp_denominators`` the
    count is the global batch's, so the dp ranks' results sum to it."""
    n = global_count(mask.sum())
    return torch.where(n > 0, (values * mask).sum() / n.clamp_min(1.0),
                       torch.zeros_like(n))


def _ce_per_pos(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy per position; at IGNORE_INDEX labels the value is
    arbitrary (the caller masks it)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return lse - gold


def dense_distill_loss(student_logits: torch.Tensor,
                       teacher_logits: torch.Tensor,
                       labels: torch.Tensor,
                       speech_token_mask: Optional[torch.Tensor] = None,
                       temperature: float = 2.0,
                       alpha: float = 0.5) -> DistillLossOutput:
    """Dense path: the KL of the student against the teacher's full
    softmax at temperature T. Both logits [B, T, V] (the teacher's already
    truncated to the student vocab); the teacher gets no gradient."""
    T = temperature
    s = student_logits[:, :-1, :].float()
    t = teacher_logits[:, :-1, :].float().detach()
    shift_labels, valid = _shift_and_mask(labels, speech_token_mask)

    log_q = torch.log_softmax(s / T, dim=-1)
    log_p = torch.log_softmax(t / T, dim=-1)
    kl_per_pos = (log_p.exp() * (log_p - log_q)).sum(-1)
    distill = _masked_mean(kl_per_pos, valid) * (T * T)

    task = _masked_mean(_ce_per_pos(s, shift_labels), valid)
    teacher = _masked_mean(_ce_per_pos(t, shift_labels), valid)
    total = alpha * task + (1.0 - alpha) * distill
    return DistillLossOutput(total, task, distill, teacher)


def sparse_distill_loss(student_logits: torch.Tensor,
                        teacher_top_k_v: torch.Tensor,
                        teacher_top_k_i: torch.Tensor,
                        labels: torch.Tensor,
                        speech_token_mask: Optional[torch.Tensor] = None,
                        temperature: float = 2.0,
                        alpha: float = 0.5) -> DistillLossOutput:
    """Sparse top-K path. teacher_top_k_v: [B, T, K] teacher logprobs (any
    float dtype); teacher_top_k_i: [B, T, K] indices into the student
    vocab; student_logits [B, T, V]. :func:`sparse_distill_sums` of the
    shifted inputs over the batch's own (global) counts."""
    shift_labels, valid, idx, denom, n_hits = sparse_targets(
        labels, speech_token_mask, teacher_top_k_i)
    return sparse_distill_sums(
        student_logits[:, :-1, :], shift_labels, valid,
        teacher_top_k_v[:, :-1, :], idx, denom, n_hits, temperature, alpha)


def sparse_targets(labels: torch.Tensor,
                   speech_token_mask: Optional[torch.Tensor],
                   teacher_top_k_i: torch.Tensor):
    """The shifted targets of :func:`sparse_distill_sums` for a batch:
    (labels [B, T-1], fp32 valid mask, top-K indices [B, T-1, K], denom,
    n_hits), the two counts global (``comm.global_count``) and at least 1
    (data only)."""
    shift_labels, valid = _shift_and_mask(labels.long(), speech_token_mask)
    idx = teacher_top_k_i[:, :-1, :].long()
    hits = (idx == shift_labels[..., None]).float() * valid[..., None]
    return (shift_labels, valid, idx,
            global_count(valid.sum()).clamp_min(1.0),
            global_count(hits.sum()).clamp_min(1.0))


def distillation_loss(student_logits: torch.Tensor,
                      labels: torch.Tensor,
                      teacher_logits: Optional[torch.Tensor] = None,
                      teacher_top_k_v: Optional[torch.Tensor] = None,
                      teacher_top_k_i: Optional[torch.Tensor] = None,
                      speech_token_mask: Optional[torch.Tensor] = None,
                      temperature: float = 2.0,
                      alpha: float = 0.5) -> DistillLossOutput:
    """The dispatching facade (the reference's ``DistillationLoss.
    forward``): :func:`dense_distill_loss` when the teacher's logits are
    given, else :func:`sparse_distill_loss` on its top-K values and
    indices; ``ValueError`` with neither."""
    if teacher_logits is not None:
        return dense_distill_loss(student_logits, teacher_logits, labels,
                                  speech_token_mask, temperature, alpha)
    if teacher_top_k_v is not None and teacher_top_k_i is not None:
        return sparse_distill_loss(student_logits, teacher_top_k_v,
                                   teacher_top_k_i, labels,
                                   speech_token_mask, temperature, alpha)
    raise ValueError("Either teacher_logits or top_k values must be provided")


def sparse_distill_sums(student_logits_shifted: torch.Tensor,
                        shift_labels: torch.Tensor, valid: torch.Tensor,
                        teacher_v_shifted: torch.Tensor,
                        teacher_i_shifted: torch.Tensor,
                        denom: torch.Tensor, n_hits: torch.Tensor,
                        temperature: float = 2.0,
                        alpha: float = 0.5) -> DistillLossOutput:
    """The sparse top-K losses in sum form over a slice of the batch,
    normalised by global denominators (the JAX ``sparse_distill_sums``):
    the outputs of disjoint row slices sum to the full batch's masked
    means. The per-microbatch head of the 1F1B schedule; over the whole
    batch, :func:`sparse_distill_loss`.

    Every input is pre-shifted ([B_mb, T-1, ...]); ``valid`` is the slice's
    fp32 validity mask; ``denom`` = max(global count of valid, 1) and
    ``n_hits`` = max(global count of top-K gold hits, 1) come from the
    whole batch (data only, no gradient)."""
    T = temperature
    s = student_logits_shifted.float()
    v = teacher_v_shifted.float().detach()
    idx = teacher_i_shifted.long()
    # teacher distribution renormalised over its top-K at temperature T
    log_p = torch.log_softmax(v / T, dim=-1)
    p = log_p.exp()
    # student log-probs at the teacher indices, gather-then-normalise
    lse_t = torch.logsumexp(s / T, dim=-1)
    log_q = s.gather(-1, idx) / T - lse_t[..., None]
    kl_per_pos = (p * (log_p - log_q)).sum(-1)
    distill = (kl_per_pos * valid).sum() / denom * (T * T)
    task = (_ce_per_pos(s, shift_labels) * valid).sum() / denom
    hits = (idx == shift_labels[..., None]).float() * valid[..., None]
    teacher = -(v * hits).sum() / n_hits
    total = alpha * task + (1.0 - alpha) * distill
    return DistillLossOutput(total, task, distill, teacher)


def segmented_top_k(x: torch.Tensor, k: int, group: int = 64):
    """Exact top-k over a large last dim by two-level segmented selection
    (the JAX ``segmented_top_k``): the maxima of ``group``-wide segments,
    the k winning segments among them (a segment holding a global top-k
    element ranks in the top-k of segment maxima), re-sorted ascending,
    then the exact top-k over their k * group candidates. Returns
    (values, indices) [..., k], descending.

    Values equal ``torch.topk``'s (and ``lax.top_k``'s) exactly; indices
    too where the values have no ties. Tie order follows ``torch.topk``,
    not ``lax.top_k``'s smallest-index-first."""
    V = x.shape[-1]
    S = -(-V // group)
    if S <= 2 * k or V <= 8 * k:
        return torch.topk(x, k, dim=-1)
    pad = S * group - V
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=-float("inf"))
    lead = x.shape[:-1]
    xg = x.reshape(*lead, S, group)
    seg = torch.topk(xg.amax(dim=-1), k, dim=-1).indices
    seg = torch.sort(seg, dim=-1).values          # ascending global order
    cand = torch.gather(xg, -2, seg[..., None].expand(*lead, k, group))
    v, p = torch.topk(cand.reshape(*lead, k * group), k, dim=-1)
    return v, seg.gather(-1, p // group) * group + p % group


def chunked_top_k(x: torch.Tensor, k: int, n_chunks: int = 16):
    """Exact top-k over a large last dim in two stages (the JAX
    ``chunked_top_k``): the top-k of each of ``n_chunks`` vocab chunks,
    then the top-k of the k * n_chunks candidates. Every global top-k
    element is in its chunk's top-k, so the set is exact. Tie order
    follows ``torch.topk``."""
    V = x.shape[-1]
    if V <= k * n_chunks * 2:
        return torch.topk(x, k, dim=-1)
    chunk = -(-V // n_chunks)
    pad = chunk * n_chunks - V
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=-float("inf"))
    lead = x.shape[:-1]
    cv, ci = torch.topk(x.reshape(*lead, n_chunks, chunk), k, dim=-1)
    ci = ci + torch.arange(n_chunks, device=x.device)[:, None] * chunk
    v, pos = torch.topk(cv.reshape(*lead, n_chunks * k), k, dim=-1)
    return v, ci.reshape(*lead, n_chunks * k).gather(-1, pos)


TOPK_METHODS = ("exact", "approx")


def extract_top_k(teacher_logits: torch.Tensor, k: int,
                  student_vocab_size: Optional[int] = None,
                  method: str = "exact", recall: float = 0.99):
    """On-the-fly sparse extraction (the JAX ``extract_top_k``): truncate
    to the student vocab, take the top-k of the fp32 logits
    (:func:`segmented_top_k`), and subtract the logsumexp from the k
    winners only. Returns (fp16 logprobs, int32 indices) [..., k], as the
    reference stores them.

    ``method`` "approx" (JAX: the TPU's ``lax.approx_max_k`` at
    ``recall``) takes the exact top-k as well: the port has no
    counterpart."""
    if method not in TOPK_METHODS:
        raise ValueError(f"unknown top-k method {method!r}")
    del recall
    if student_vocab_size is not None:
        teacher_logits = teacher_logits[..., :student_vocab_size]
    logits = teacher_logits.float()
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    v, i = segmented_top_k(logits, k)
    return (v - lse).to(torch.float16), i.to(torch.int32)
