"""Distillation losses (port of ``speech_distill_tpu/distill/losses.py``).

Every reduction is a masked mean over a fixed-shape row set:

  * causal shift: logits[t] predicts labels[t+1]
  * valid = speech_token_mask[1:] AND labels[1:] != -100
  * task_loss      = CE(student, labels), mean over valid rows
  * sparse distill = teacher top-K renormalised KL at temperature T, x T^2
  * teacher_loss   = -mean top-K logprob of the gold label over the valid
                     rows where it appears in the top-K
  * total = alpha * task + (1 - alpha) * distill

All math in fp32 whatever the input dtype. The dense path waits for the
online modes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
    n = mask.sum()
    return torch.where(n > 0, (values * mask).sum() / n.clamp_min(1.0),
                       torch.zeros_like(n))


def _ce_per_pos(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy per position; at IGNORE_INDEX labels the value is
    arbitrary (the caller masks it)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return lse - gold


def sparse_distill_loss(student_logits: torch.Tensor,
                        teacher_top_k_v: torch.Tensor,
                        teacher_top_k_i: torch.Tensor,
                        labels: torch.Tensor,
                        speech_token_mask: Optional[torch.Tensor] = None,
                        temperature: float = 2.0,
                        alpha: float = 0.5) -> DistillLossOutput:
    """Sparse top-K path. teacher_top_k_v: [B, T, K] teacher logprobs (any
    float dtype); teacher_top_k_i: [B, T, K] indices into the student
    vocab; student_logits [B, T, V]."""
    T = temperature
    s = student_logits[:, :-1, :].float()
    v = teacher_top_k_v[:, :-1, :].float().detach()
    idx = teacher_top_k_i[:, :-1, :].long()
    shift_labels, valid = _shift_and_mask(labels, speech_token_mask)

    # teacher distribution renormalised over its top-K at temperature T
    log_p = torch.log_softmax(v / T, dim=-1)
    p = log_p.exp()
    # student log-probs at the teacher indices, gather-then-normalise
    lse_t = torch.logsumexp(s / T, dim=-1)
    log_q = s.gather(-1, idx) / T - lse_t[..., None]

    kl_per_pos = (p * (log_p - log_q)).sum(-1)
    distill = _masked_mean(kl_per_pos, valid) * (T * T)
    task = _masked_mean(_ce_per_pos(s, shift_labels), valid)

    hits = (idx == shift_labels[..., None]).float() * valid[..., None]
    n_hits = hits.sum()
    teacher = torch.where(n_hits > 0,
                          -(v * hits).sum() / n_hits.clamp_min(1.0),
                          torch.zeros_like(n_hits))
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
