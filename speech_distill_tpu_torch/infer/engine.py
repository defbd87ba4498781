"""Decode-step sampling shared by the serving engines (port of
``sample_next_token`` in ``speech_distill_tpu/infer/engine.py``; the
contiguous-cache ``DecodeEngine`` comes with a later slice)."""
from __future__ import annotations

import torch

from speech_distill_tpu_torch.core.config import SamplingParams
from speech_distill_tpu_torch.ops import sampling


def sample_next_token(sp: SamplingParams, st, win: int, eos_ids: tuple,
                      generator: torch.Generator,
                      want_logprob: bool = False):
    """Sample one token per row from ``st.last_logits`` (RAS + repetition
    penalty + top-k/p; ``top_k <= 0`` samples over the full vocabulary).
    ``st`` carries tokens [B, max_len], length [B], presence [B, V],
    num_generated [B] and last_logits [B, V]; a ``samp`` [B, 4] tensor
    (temperature, top_p, repetition penalty, min_tokens per row), when
    present, overrides the engine-global parameters per row. Returns
    tokens [B], or (tokens, logprobs [B]) with ``want_logprob`` (the
    emitted token's logprob under the sampler's closed-form output
    distribution, ops/sampling)."""
    samp = getattr(st, "samp", None)
    if samp is not None:
        temperature, top_p = samp[:, 0], samp[:, 1]
        rep_pen, min_tok = samp[:, 2], samp[:, 3].long()
    else:
        temperature, top_p = sp.temperature, sp.top_p
        rep_pen, min_tok = sp.repetition_penalty, sp.min_tokens
    # last `win` tokens of each row (prompt included), masked to length
    pos = (st.length[:, None] - win
           + torch.arange(win, device=st.length.device)[None, :])
    recent_valid = pos >= 0
    recent = st.tokens.gather(1, pos.clamp(min=0))
    raw = st.last_logits
    if sp.top_k > 0:
        return sampling.sample_token_topk(
            generator, raw, st.presence, st.num_generated, recent,
            recent_valid, temperature=temperature, top_k=sp.top_k,
            top_p=top_p, repetition_penalty=rep_pen, min_tokens=min_tok,
            eos_ids=eos_ids, use_ras=sp.use_ras, win_size=win,
            tau_r=sp.tau_r, return_logprob=want_logprob)
    processed = sampling.process_logits(
        raw, st.presence, st.num_generated, temperature=temperature,
        top_k=sp.top_k, top_p=top_p, repetition_penalty=rep_pen,
        min_tokens=min_tok, eos_ids=eos_ids)
    token, _, logp = sampling.ras_sample(
        generator, raw, processed, recent, recent_valid, use_ras=sp.use_ras,
        win_size=win, tau_r=sp.tau_r, return_logprob=want_logprob)
    return (token, logp) if want_logprob else token
