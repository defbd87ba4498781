"""Held-out teacher-student agreement of a distilled student (port of
``speech_distill_tpu/distill/evaluate.py``).

Metrics, each over two position slices (``all``: every attended
next-token position; ``speech``: targets inside the speech span):

  * top-1 agreement      argmax(student) == argmax(teacher)
  * top-k agreement      argmax(student) within the teacher's top-k set
  * KL(teacher||student) at T = 1
  * student CE / teacher CE on the gold labels

:func:`make_agreement_step` runs the teacher in the step and computes the
exact full-vocab metrics, streamed over ``chunk``-wide time slices so the
fp32 softmax temporaries never exceed [B, chunk, V];
:func:`make_sparse_agreement_step` scores against stored
``teacher_top_k_v/i`` (membership in the stored index set, KL
renormalised over the stored top-K). Steps return sums plus counts;
:func:`finalize_metrics` turns them into rates. Rank and argmax follow
``lax.top_k``'s tie order (the smallest index first), computed by rule,
not by ``torch.topk``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from speech_distill_tpu_torch.core.config import Qwen3Config
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.distill.train_step import check_width
from speech_distill_tpu_torch.models import qwen3

IGNORE_INDEX = -100
_SUM_KEYS = ("n", "kl", "agree1", "agreek", "n_label", "ce_s", "ce_t")


def _position_masks(batch: Dict[str, torch.Tensor]):
    """Shifted position masks, each [B, T-1] fp32: all_m (prediction and
    target attended), speech_m (all_m and the target in the speech span),
    label_m (all_m and the gold label kept)."""
    mask = batch["attention_mask"]
    all_m = (mask[:, 1:] * mask[:, :-1]).float()
    smask = batch.get("speech_token_mask")
    speech_m = (all_m * (smask[:, 1:] != 0) if smask is not None
                else torch.zeros_like(all_m))
    labels = batch.get("labels")
    label_m = (all_m * (labels[:, 1:] != IGNORE_INDEX) if labels is not None
               else torch.zeros_like(all_m))
    return all_m, speech_m, label_m


def _top1_rank_in(t_chunk: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
    """Rank of the student argmax ``s1`` inside the teacher logits with
    ``lax.top_k``'s tie order: #{j: t[j] > t[s1]} + #{j < s1: t[j] ==
    t[s1]}. O(V), no sort."""
    t_at = t_chunk.gather(-1, s1[..., None])
    above = (t_chunk > t_at).sum(-1)
    iota = torch.arange(t_chunk.shape[-1], device=t_chunk.device)
    ties = ((t_chunk == t_at) & (iota < s1[..., None])).sum(-1)
    return above + ties


def _chunk_dense_metrics(s: torch.Tensor, t: torch.Tensor,
                         target: torch.Tensor, k: int):
    """Per-position metric planes of one [B, C, V] fp32 chunk pair."""
    lsm_s = torch.log_softmax(s, dim=-1)
    lsm_t = torch.log_softmax(t, dim=-1)
    kl = (lsm_t.exp() * (lsm_t - lsm_s)).sum(-1)
    safe = target.clamp_min(0)[..., None]
    ce_s = -lsm_s.gather(-1, safe)[..., 0]
    ce_t = -lsm_t.gather(-1, safe)[..., 0]
    del lsm_s, lsm_t
    s1 = s.argmax(-1)             # the first maximum, as jnp.argmax
    t1 = t.argmax(-1)
    return {"kl": kl, "ce_s": ce_s, "ce_t": ce_t,
            "agree1": (s1 == t1).float(),
            "agreek": (_top1_rank_in(t, s1) < k).float()}


def _sum_slices(planes: Dict[str, torch.Tensor], all_m, speech_m, label_m):
    out = {}
    for name, m in (("all", all_m), ("speech", speech_m)):
        out[f"n_{name}"] = m.sum()
        for key in ("kl", "agree1", "agreek"):
            out[f"{key}_{name}"] = (planes[key] * m).sum()
        # CE also needs a kept gold label
        lm = m * label_m
        out[f"n_label_{name}"] = lm.sum()
        out[f"ce_s_{name}"] = (planes["ce_s"] * lm).sum()
        out[f"ce_t_{name}"] = (planes["ce_t"] * lm).sum()
    return out


def _to(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def make_agreement_step(student_cfg: Qwen3Config,
                        teacher_cfg: Optional[Qwen3Config] = None,
                        k: int = 10,
                        teacher_forward: Optional[Callable] = None,
                        chunk: int = 128, device="cuda"):
    """Exact agreement ``step(student, teacher, batch) -> sums`` with the
    teacher run in the step (``teacher_forward(teacher, ids, mask) ->
    logits``, default the port's ``qwen3.forward``; the teacher's config is
    the model's own). ``batch`` is a flat [B, T] dict (input_ids,
    attention_mask, optionally labels, speech_token_mask,
    teacher_input_ids, teacher_attention_mask), moved to ``device`` (CUDA
    by default; raises without it). Sums are fp32 0-dim tensors."""
    del teacher_cfg
    dev = resolve_device(device)
    if teacher_forward is None:
        def teacher_forward(teacher, ids, mask):
            return qwen3.forward(teacher, ids, attention_mask=mask)

    @torch.no_grad()
    def step(student: qwen3.Qwen3, teacher, batch: dict):
        batch = _to(batch, dev)
        s_logits = qwen3.forward(student, batch["input_ids"],
                                 attention_mask=batch["attention_mask"])
        t_logits = teacher_forward(
            teacher, batch.get("teacher_input_ids", batch["input_ids"]),
            batch.get("teacher_attention_mask", batch["attention_mask"]))
        check_width(t_logits.shape[-1], student_cfg.vocab_size)
        s_logits = s_logits[:, :-1]
        t_logits = t_logits[:, :-1, :student_cfg.vocab_size]
        target = batch["input_ids"][:, 1:].long()
        masks = _position_masks(batch)
        sums = {f"{m}_{sl}": torch.zeros((), device=dev)
                for sl in ("all", "speech") for m in _SUM_KEYS}
        for c0 in range(0, target.shape[1], chunk):
            c1 = c0 + chunk
            planes = _chunk_dense_metrics(s_logits[:, c0:c1].float(),
                                          t_logits[:, c0:c1].float(),
                                          target[:, c0:c1], k)
            part = _sum_slices(planes, *(m[:, c0:c1] for m in masks))
            for key in sums:
                sums[key] += part[key]
        return sums

    return step


def make_sparse_agreement_step(student_cfg: Qwen3Config, k: int = 10,
                               device="cuda"):
    """Agreement ``step(student, batch) -> sums`` against stored top-K
    artifacts (``teacher_top_k_v/i``, the extraction's output): the
    teacher is its renormalised top-K, so ``kl`` is the sparse objective at
    T = 1 and agreement is membership in the stored set. ``k`` <= the
    stored K; top-k agreement tests the student argmax against the first k
    stored indices (stored in descending order). The teacher CE counts
    only label positions whose gold label is in the stored set
    (``n_teacher_*``)."""
    del student_cfg
    dev = resolve_device(device)

    @torch.no_grad()
    def step(student: qwen3.Qwen3, batch: dict):
        batch = _to(batch, dev)
        s = qwen3.forward(student, batch["input_ids"],
                          attention_mask=batch["attention_mask"]
                          )[:, :-1].float()
        v = batch["teacher_top_k_v"][:, :-1].float()
        idx = batch["teacher_top_k_i"][:, :-1].long()
        target = batch["input_ids"][:, 1:].long()
        all_m, speech_m, label_m = _position_masks(batch)

        lse = torch.logsumexp(s, dim=-1)
        log_q = s.gather(-1, idx) - lse[..., None]
        log_p = torch.log_softmax(v, dim=-1)
        kl = (log_p.exp() * (log_p - log_q)).sum(-1)
        ce_s = lse - s.gather(-1, target.clamp_min(0)[..., None])[..., 0]
        hit = idx == target[..., None]
        ce_t = -torch.where(hit, v, torch.zeros_like(v)).sum(-1)
        has_hit = hit.any(-1).float()
        s1 = s.argmax(-1)
        planes = {"kl": kl, "ce_s": ce_s, "ce_t": ce_t,
                  "agree1": (s1 == idx[..., 0]).float(),
                  "agreek": (idx[..., :k] == s1[..., None]).any(-1).float()}
        sums = _sum_slices(planes, all_m, speech_m, label_m)
        for name, m in (("all", all_m), ("speech", speech_m)):
            lm = m * label_m * has_hit
            sums[f"ce_t_{name}"] = (ce_t * lm).sum()
            sums[f"n_teacher_{name}"] = lm.sum()
        return sums

    return step


def finalize_metrics(sums: Dict[str, float], k: int) -> Dict[str, object]:
    """Streamed metric sums as rates; a JSON-ready dict."""
    s = {kk: float(v) for kk, v in sums.items()}
    out: Dict[str, object] = {"agree_k": k}
    for name in ("all", "speech"):
        n = s.get(f"n_{name}", 0.0)
        nl = s.get(f"n_label_{name}", 0.0)
        nt = s.get(f"n_teacher_{name}", nl)
        out[name] = {
            "positions": int(n),
            "top1_agreement": s[f"agree1_{name}"] / n if n else None,
            f"top{k}_agreement": s[f"agreek_{name}"] / n if n else None,
            "kl_t1": s[f"kl_{name}"] / n if n else None,
            "student_ce": s[f"ce_s_{name}"] / nl if nl else None,
            "teacher_ce": s[f"ce_t_{name}"] / nt if nt else None,
        }
    return out
