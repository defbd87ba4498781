"""Decode-step sampling (port of ``speech_distill_tpu/ops/sampling.py``).

HF-generate processors in HF order — min-new-tokens EOS suppression,
repetition penalty over *generated* tokens only, temperature, top-k,
top-p — then multinomial sampling, with VALL-E 2 Repetition-Aware
Sampling: if the candidate appeared >= win*tau times in the last ``win``
tokens, resample from the RAW (pre-processor) distribution.

``temperature``, ``top_p``, ``repetition_penalty`` and ``min_tokens`` may
each be a Python scalar (one value for the batch) or a [B] tensor (the
per-request parameters of a serving engine). With ``return_logprob`` the
samplers also return the emitted token's log-probability under their
closed-form output distribution
p(x) = proc(x)·[not rep(x)] + P_rep·softmax(raw)(x)
(RAS mixture included; without RAS the processed distribution).

Randomness comes from an explicit ``torch.Generator`` on the logits'
device (Gumbel-max draws, the method ``jax.random.categorical`` uses).
The streams differ from JAX's, so the tests compare distributions, the
deterministic processors and the logprob at a given token, not drawn
tokens.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def _is_scalar(x) -> bool:
    """A Python sampling parameter vs a per-row [B] tensor."""
    return isinstance(x, (int, float))


def _rows(x, like: torch.Tensor) -> torch.Tensor:
    """Broadcastable [B, 1] fp32 view of a per-row parameter."""
    return torch.as_tensor(x, dtype=torch.float32,
                           device=like.device).reshape(-1, 1)


def _divide_temperature(x: torch.Tensor, temperature) -> torch.Tensor:
    if not _is_scalar(temperature):
        return x / _rows(temperature, x)
    return x / temperature if temperature != 1.0 else x


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: where a token is present in the
    penalized set: score > 0 ? score / p : score * p."""
    if _is_scalar(penalty):
        if penalty == 1.0:
            return logits
        pen = penalty
    else:
        pen = _rows(penalty, logits)
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(presence.bool(), penalized, logits)


def suppress_eos_before_min(logits: torch.Tensor, eos_ids: Sequence[int],
                            num_generated: torch.Tensor, min_tokens
                            ) -> torch.Tensor:
    """MinNewTokensLengthLogitsProcessor: EOS gets -1e30 until min_tokens
    (int, or per-row [B] integers). An EOS id past the vocabulary is
    skipped, as JAX drops an out-of-range update."""
    if _is_scalar(min_tokens) and min_tokens <= 0:
        return logits
    active = num_generated.reshape(-1) < torch.as_tensor(
        min_tokens, device=logits.device).reshape(-1)           # [B]
    out = logits.clone()
    for eos in eos_ids:
        if eos < out.shape[-1]:
            out[:, eos] = torch.where(active, NEG_INF, out[:, eos])
    return out


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_filter(logits: torch.Tensor, p) -> torch.Tensor:
    """HF TopPLogitsWarper: keep the smallest set whose cumulative prob > p
    (the token crossing p is kept)."""
    if _is_scalar(p):
        if p >= 1.0:
            return logits
    else:
        p = _rows(p, logits)
    sorted_logits = torch.sort(logits, dim=-1).values            # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # in ascending order, remove where cum <= 1 - p; the top token always
    # stays (a rounded cum of 1.0 must not index past the row)
    n_removed = torch.clamp((cum <= (1.0 - p)).sum(-1, keepdim=True),
                            max=logits.shape[-1] - 1)
    threshold = sorted_logits.gather(-1, n_removed)
    return torch.where(logits < threshold, NEG_INF, logits)


def process_logits(raw: torch.Tensor, presence: torch.Tensor,
                   num_generated: torch.Tensor, *, temperature, top_k: int,
                   top_p, repetition_penalty, min_tokens,
                   eos_ids: Sequence[int]) -> torch.Tensor:
    """Full processor chain (HF order) raw fp32 logits -> warped scores."""
    x = suppress_eos_before_min(raw, eos_ids, num_generated, min_tokens)
    x = apply_repetition_penalty(x, presence, repetition_penalty)
    x = _divide_temperature(x, temperature)
    return top_p_filter(top_k_filter(x, top_k), top_p)


TOPK_METHODS = ("exact", "approx")


def top_k_top_p(x: torch.Tensor, top_k: int, temperature, top_p,
                topk_method: str = "exact"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k candidates (descending), temperature, and the HF top-p
    set in k-space: removed candidates get NEG_INF. Returns (vals, idx).

    ``torch.topk`` orders ties differently from ``lax.top_k`` (which puts
    the smallest index first); with ties the two may keep a different
    member of a tied boundary group. ``topk_method`` "approx" (JAX:
    ``lax.approx_max_k``, a TPU primitive) takes the exact top-k too."""
    if topk_method not in TOPK_METHODS:
        raise ValueError(f"topk_method {topk_method!r}: one of "
                         f"{TOPK_METHODS}")
    vals, idx = torch.topk(x, top_k, dim=-1)
    vals = _divide_temperature(vals, temperature)
    if not _is_scalar(top_p) or top_p < 1.0:
        # remove tokens once the cumulative prob (shifted by one, so the
        # crossing token survives) exceeds p — HF TopPLogitsWarper's set
        tp = top_p if _is_scalar(top_p) else _rows(top_p, vals)
        probs = torch.softmax(vals, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < tp
        vals = torch.where(keep, vals, NEG_INF)
    return vals, idx


class RowDraws:
    """A generator standing for rows ``row0 .. row0 + n`` of a batch of
    ``total`` rows: each draw is made for the whole batch and sliced, so
    a dp rank's slots sample what they sample in a one-process run."""

    def __init__(self, generator: torch.Generator, total: int, row0: int):
        self.generator, self.total, self.row0 = generator, total, row0

    def rand(self, shape, device) -> torch.Tensor:
        full = torch.rand((self.total,) + tuple(shape[1:]),
                          generator=self.generator, device=device,
                          dtype=torch.float32)
        return full[self.row0:self.row0 + shape[0]]


def categorical(generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) by Gumbel-max;
    ``generator`` a ``torch.Generator`` or a :class:`RowDraws`."""
    if isinstance(generator, RowDraws):
        u = generator.rand(logits.shape, logits.device)
    else:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def _repeats(recent_ids: torch.Tensor, recent_valid: torch.Tensor,
             candidate: torch.Tensor, win_size: int, tau_r: float
             ) -> torch.Tensor:
    """The RAS predicate of each row's candidate [B]."""
    matches = (recent_ids == candidate[:, None]) & recent_valid.bool()
    return matches.sum(dim=-1) + 1 >= win_size * tau_r


def _raw_logprob(raw: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    return (raw.gather(1, token[:, None])[:, 0]
            - torch.logsumexp(raw, dim=-1)).float()


def _mixture(proc_t: torch.Tensor, p_rep: torch.Tensor,
             raw_lp: torch.Tensor) -> torch.Tensor:
    """log(proc_t + p_rep * exp(raw_lp)) in log space: log(0) = -inf is
    exact under logaddexp, so tiny probabilities keep their logprob."""
    return torch.logaddexp(torch.log(proc_t),
                           torch.log(p_rep) + raw_lp).float()


def topk_logprob(vals: torch.Tensor, idx: torch.Tensor, raw: torch.Tensor,
                 token: torch.Tensor, recent_ids: torch.Tensor,
                 recent_valid: torch.Tensor, *, use_ras: bool,
                 win_size: int, tau_r: float) -> torch.Tensor:
    """[B] logprob of ``token`` under the k-space sampler's closed-form
    output distribution, from its warped candidates (``vals``, ``idx``
    of :func:`top_k_top_p`) and the raw logits."""
    hit = idx == token[:, None]                                 # [B, k]
    if not use_ras:
        v_t = torch.where(hit, vals, NEG_INF).amax(dim=-1)
        return (v_t - torch.logsumexp(vals, dim=-1)).float()
    probs = torch.softmax(vals, dim=-1)
    # every candidate's RAS predicate: its processed mass goes to the raw
    # resample instead
    m_all = ((recent_ids[:, None, :] == idx[:, :, None])
             & recent_valid[:, None, :].bool()).sum(-1)
    rep_all = m_all + 1 >= win_size * tau_r                     # [B, k]
    p_rep = torch.where(rep_all, probs, 0.0).sum(-1)
    proc_t = torch.where(hit & ~rep_all, probs, 0.0).sum(-1)
    return _mixture(proc_t, p_rep, _raw_logprob(raw, token))


def sample_token_topk(generator: torch.Generator, raw: torch.Tensor,
                      presence: torch.Tensor, num_generated: torch.Tensor,
                      recent_ids: torch.Tensor, recent_valid: torch.Tensor,
                      *, temperature, top_k: int, top_p, repetition_penalty,
                      min_tokens, eos_ids: Sequence[int], use_ras: bool,
                      win_size: int, tau_r: float,
                      topk_method: str = "exact",
                      return_logprob: bool = False):
    """Fused decode-step sampler for top_k > 0: processors, k-space
    warping (``topk_method`` as :func:`top_k_top_p` takes it) and the
    draw, plus the RAS fallback to the raw full-vocab distribution.
    Returns [B] int64 tokens, or (tokens, logprobs) with
    ``return_logprob`` (:func:`topk_logprob`)."""
    x = suppress_eos_before_min(raw, eos_ids, num_generated, min_tokens)
    x = apply_repetition_penalty(x, presence, repetition_penalty)
    vals, idx = top_k_top_p(x, top_k, temperature, top_p, topk_method)
    choice = categorical(generator, vals)
    token = idx.gather(1, choice[:, None])[:, 0]
    if use_ras:
        use_raw = _repeats(recent_ids, recent_valid, token, win_size, tau_r)
        token = torch.where(use_raw, categorical(generator, raw), token)
    if not return_logprob:
        return token
    return token, topk_logprob(vals, idx, raw, token, recent_ids,
                               recent_valid, use_ras=use_ras,
                               win_size=win_size, tau_r=tau_r)


def ras_logprob(raw: torch.Tensor, processed: torch.Tensor,
                token: torch.Tensor, recent_ids: torch.Tensor,
                recent_valid: torch.Tensor, *, use_ras: bool, win_size: int,
                tau_r: float) -> torch.Tensor:
    """[B] logprob of ``token`` under :func:`ras_sample`'s closed-form
    output distribution, in full-vocab space."""
    proc_lp = torch.log_softmax(processed, dim=-1)
    if not use_ras:
        return proc_lp.gather(1, token[:, None])[:, 0].float()
    B, V = raw.shape
    # occurrence count of every vocab id in the recent window
    counts = torch.zeros((B, V), dtype=torch.int64, device=raw.device)
    counts.scatter_add_(1, recent_ids.long(), recent_valid.long())
    rep = counts + 1 >= win_size * tau_r                        # [B, V]
    proc_p = proc_lp.exp()
    p_rep = torch.where(rep, proc_p, 0.0).sum(-1)
    proc_t = torch.where(rep.gather(1, token[:, None])[:, 0], 0.0,
                         proc_p.gather(1, token[:, None])[:, 0])
    return _mixture(proc_t, p_rep, _raw_logprob(raw, token))


def ras_sample(generator: torch.Generator, raw: torch.Tensor,
               processed: torch.Tensor, recent_ids: torch.Tensor,
               recent_valid: torch.Tensor, *, use_ras: bool, win_size: int,
               tau_r: float, return_logprob: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Full-vocab sampling with Repetition-Aware Sampling: draw from
    ``processed``, and redraw from ``raw`` where the candidate repeats.
    Returns (token [B], used_raw [B] bool, logprob [B] or None)."""
    token = categorical(generator, processed)
    used_raw = torch.zeros_like(token, dtype=torch.bool)
    if use_ras:
        used_raw = _repeats(recent_ids, recent_valid, token, win_size, tau_r)
        token = torch.where(used_raw, categorical(generator, raw), token)
    logp = None
    if return_logprob:
        logp = ras_logprob(raw, processed, token, recent_ids, recent_valid,
                           use_ras=use_ras, win_size=win_size, tau_r=tau_r)
    return token, used_raw, logp
