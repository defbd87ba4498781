"""Speculative decoding for the single-stream decode loop (port of
``speech_distill_tpu/infer/speculative.py``).

At B = 1 a decode step moves the whole model's weights for one token, so
producing more than one token a step is the lever. Two deterministic
drafts propose ``gamma`` tokens:

* ``"ngram"`` (vLLM's prompt lookup): the last n-gram of the sequence is
  matched against the whole buffer, and the continuation of its most
  recent earlier occurrence is copied, wrapping periodically past the
  end (speech-token streams repeat themselves);
* ``"layer_skip"`` (LayerSkip self-speculation): ``gamma`` greedy steps
  through the first ``draft_layers`` layers and the real head, on the
  penalty-warped logits. They write their layer < K K/V into the main
  cache: the verify pass rewrites those columns with the same values
  (same weights, inputs and dtype), so there is no draft cache.

One forward over [pending, d_0 .. d_{gamma-1}] verifies every draft at
once. Acceptance is exact leftover rejection sampling against the
closed-form target of the production sampler
(``ops/sampling.sample_token_topk``), RAS included:

    p(x) = proc(x) * [not rep(x)] + P_rep * softmax(raw)(x)

A draft d is accepted with probability p(d); on rejection the token comes
from p with d removed. So the committed stream is distributed exactly
like the plain decode loop's, however bad the draft. A rejection rewinds
the cache length: the stale columns are masked by ``valid`` and
overwritten by the next pass. B = 1 only (rows would commit different
counts, which one shared write column cannot express).

The JAX loop is one ``lax.while_loop``; here an iteration is Python over
device tensors with one host read (the committed count, the kept drafts
and the finished flag) for the loop test and the cache length. The random
draws come from the state's generator, so the streams differ from JAX's.
"""
from __future__ import annotations

from typing import Optional

import torch

from speech_distill_tpu_torch.core.config import Qwen3Config, SamplingParams
from speech_distill_tpu_torch.distill.losses import segmented_top_k
from speech_distill_tpu_torch.infer.engine import (DecodeState, is_eos,
                                                   sample_next_token)
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.ops import sampling

NEG_INF = sampling.NEG_INF


def ngram_draft(tokens: torch.Tensor, length: int, gamma: int,
                n_max: int = 3, n_min: int = 1) -> torch.Tensor:
    """Propose ``gamma`` draft tokens by prompt lookup.

    tokens: [L] buffer, tokens[:length] real. The last n-gram (the largest
    matching n in [n_min, n_max]) is searched over all earlier windows;
    the most recent match wins and its continuation is copied, wrapping
    periodically when it runs past ``length``. Returns [gamma] (zeros
    when nothing matches: the verifier rejects them)."""
    L = tokens.shape[0]
    dev = tokens.device
    best_found = torch.zeros((), dtype=torch.bool, device=dev)
    best_start = torch.zeros((), dtype=torch.int64, device=dev)
    for n in range(n_min, n_max + 1):      # ascending: larger n overwrites
        g = tokens[(length - n + torch.arange(n, device=dev)).clamp(min=0)]
        M = L - n + 1
        eq = torch.ones((M,), dtype=torch.bool, device=dev)
        for k in range(n):
            eq &= tokens[k:k + M] == g[k]
        ii = torch.arange(M, device=dev)
        # the continuation must exist (i + n < length), the gram be real
        ok = eq & (ii + n < length) & (length >= n)
        idx = torch.where(ok, ii, -1).max()
        found = idx >= 0
        best_start = torch.where(found, idx + n, best_start)
        best_found |= found
    period = (length - best_start).clamp(min=1)
    pos = best_start + torch.arange(gamma, device=dev) % period
    drafts = tokens[pos.clamp(0, L - 1)]
    return torch.where(best_found, drafts, 0)


def _warp_topk(raw, presence, num_gen, recent, recent_valid,
               sp: SamplingParams, eos_ids, win: int):
    """The production sampler's processed distribution in k-space: EOS
    suppression and repetition penalty on raw, exact top-k, temperature,
    top-p keep mask. Returns (vals [N, k] warped logits, idx [N, k],
    probs [N, k], rep [N, k] RAS predicate of each candidate,
    P_rep [N])."""
    x = sampling.suppress_eos_before_min(raw, eos_ids, num_gen,
                                         sp.min_tokens)
    x = sampling.apply_repetition_penalty(x, presence,
                                          sp.repetition_penalty)
    vals, idx = segmented_top_k(x, sp.top_k)
    if sp.temperature != 1.0:
        vals = vals / sp.temperature
    if sp.top_p < 1.0:
        probs = torch.softmax(vals, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < sp.top_p
        vals = torch.where(keep, vals, NEG_INF)
    probs = torch.softmax(vals, dim=-1)
    if sp.use_ras:
        matches = ((recent[:, None, :] == idx[:, :, None])
                   & recent_valid[:, None, :].bool()).sum(-1)
        rep = matches + 1 >= win * sp.tau_r
    else:
        rep = torch.zeros_like(idx, dtype=torch.bool)
    p_rep = (probs * rep).sum(-1)
    return vals, idx, probs, rep, p_rep


def target_probs(raw, presence, num_gen, recent, recent_valid,
                 sp: SamplingParams, eos_ids, win: int) -> torch.Tensor:
    """Full-vocab output distribution of ``sample_token_topk`` [N, V]:
    proc(x) * [not rep(x)] + P_rep * softmax(raw)(x). A test oracle; the
    decode loop never builds it."""
    vals, idx, probs, rep, p_rep = _warp_topk(
        raw, presence, num_gen, recent, recent_valid, sp, eos_ids, win)
    proc = torch.zeros(raw.shape, dtype=torch.float32, device=raw.device)
    proc.scatter_add_(1, idx, torch.where(rep, 0.0, probs))
    return proc + p_rep[:, None] * torch.softmax(raw.float(), dim=-1)


def make_spec_decode_fn(cfg: Qwen3Config, sp: SamplingParams, gamma: int,
                        ngram_max: int = 3, ngram_min: int = 1,
                        win_size: Optional[int] = None,
                        with_stats: bool = False, draft: str = "ngram",
                        draft_layers: Optional[int] = None):
    """``spec_decode(model, state, max_new) -> state`` at B = 1, in place:
    the plain decode loop's contract (every committed token cached but
    the last, which ``finalize`` caches; ``last_logits`` after it).

    ``with_stats``: return ``(state, iterations)``: tokens committed per
    verify iteration is the acceptance."""
    if sp.top_k <= 0:
        raise ValueError("speculative decode requires top_k > 0 "
                         "(the k-space verifier)")
    if draft not in ("ngram", "layer_skip"):
        raise ValueError(f"unknown draft method {draft!r}")
    if draft == "layer_skip" and not (
            draft_layers and 0 < draft_layers < cfg.num_hidden_layers):
        raise ValueError(f"layer_skip needs 0 < draft_layers < "
                         f"{cfg.num_hidden_layers}, got {draft_layers}")
    win = win_size or sp.win_size
    eos_ids = tuple(sp.stop_token_ids)
    G = gamma

    def layer_skip_drafts(model, s: DecodeState, Lb: int, cols, real):
        """G greedy early-exit steps. Step j feeds the previous token at
        column Lb - 1 + j (position real - 1 + j) and writes its layer < K
        K/V there; returns (drafts [G], the cache with its length back at
        the pending column)."""
        tok, dc = s.tokens[0, Lb - 1], s.cache
        pres = s.presence[0].clone()
        out = []
        for j in range(G):
            am = s.valid[0] | ((cols >= Lb) & (cols < Lb + j))
            lg, dc = qwen3.forward(model, tok.reshape(1, 1),
                                   attention_mask=am[None],
                                   positions=(real - 1 + j).reshape(1, 1),
                                   cache=dc, num_layers=draft_layers)
            xd = sampling.suppress_eos_before_min(
                lg[:, -1].float(), eos_ids, s.num_generated + j,
                sp.min_tokens)
            xd = sampling.apply_repetition_penalty(xd, pres[None],
                                                   sp.repetition_penalty)
            tok = torch.argmax(xd[0])
            pres[tok] = True
            out.append(tok)
        return torch.stack(out), qwen3.KVCache(dc.k, dc.v, s.cache.length)

    def body(model, s: DecodeState, Lb: int, max_new: int) -> list:
        """One draft-verify-commit iteration; returns the host values
        [kept drafts, committed tokens, finished]."""
        max_len, V = s.tokens.shape[1], s.presence.shape[1]
        dev = s.tokens.device
        row = s.tokens[0]
        cols = torch.arange(max_len, device=dev)
        ar_g = torch.arange(G, device=dev)
        ar_g1 = torch.arange(G + 1, device=dev)
        # RoPE positions count real tokens, not buffer slots (left-padded
        # states): the pending token sits at position (#real) - 1
        real = s.valid[0].sum()
        if draft == "ngram":
            drafts, cache_in = ngram_draft(row, Lb, G, ngram_max,
                                           ngram_min), s.cache
        else:
            drafts, cache_in = layer_skip_drafts(model, s, Lb, cols, real)
        chunk = torch.cat([row[Lb - 1:Lb], drafts])              # [G+1]
        # the buffer with the drafts visible (RAS windows only)
        tview = row.clone()
        tview[Lb + ar_g] = drafts
        amask = s.valid[0] | ((cols >= Lb) & (cols < Lb + G))
        logits, cache = qwen3.forward(
            model, chunk[None], attention_mask=amask[None],
            positions=(real - 1 + ar_g1)[None], cache=cache_in)
        raw_all = logits[0].float()                              # [G+1, V]

        # every position verified in ONE batched pass: only the presence
        # set is sequential (each accepted draft joins it)
        hit = torch.zeros((G, V), dtype=torch.int32, device=dev)
        hit[ar_g, drafts] = 1
        presence_all = s.presence[0][None] | torch.cat(
            [torch.zeros_like(hit[:1]), hit.cumsum(0)]).bool()  # [G+1, V]
        pos = (Lb + ar_g1[:, None]) - win + torch.arange(win,
                                                         device=dev)[None]
        vals_all, idx_all, probs_all, rep_all, prep_all = _warp_topk(
            raw_all, presence_all, s.num_generated[0] + ar_g1,
            tview[pos.clamp(0, max_len - 1)], pos >= 0, sp, eos_ids, win)
        raw_lse_all = torch.logsumexp(raw_all, dim=-1)            # [G+1]

        eqd = idx_all[:G] == drafts[:, None]                     # [G, k]
        proc_d = torch.where(eqd & ~rep_all[:G], probs_all[:G],
                             0.0).sum(-1)
        raw_d = torch.exp(raw_all[ar_g, drafts] - raw_lse_all[:G])
        acc_p = proc_d + prep_all[:G] * raw_d                    # [G]
        u = torch.rand((G,), generator=s.generator, device=dev)
        acc = u < acc_p
        a0 = torch.where(acc.all(), G, torch.argmin(acc.int()))  # accepted

        # resample (rejection leftover, a0 < G) or bonus (a0 == G): p
        # without the rejected draft is a two-component mixture: pick the
        # component by its leftover mass, then a categorical within it
        vals_r, idx_r = vals_all[a0], idx_all[a0]
        probs_r, rep_r, raw_r = probs_all[a0], rep_all[a0], raw_all[a0]
        has_excl = a0 < G
        d_excl = torch.where(has_excl, drafts[a0.clamp(max=G - 1)], -1)
        proc_ok = ~rep_r & (idx_r != d_excl)
        w_proc = torch.where(proc_ok, probs_r, 0.0).sum()
        d_safe = d_excl.clamp(min=0)
        raw_excl_p = torch.where(
            has_excl, torch.exp(raw_r[d_safe] - raw_lse_all[a0]), 0.0)
        w_raw = prep_all[a0] * (1.0 - raw_excl_p)
        p_proc = w_proc / (w_proc + w_raw).clamp(min=1e-30)
        use_proc = torch.rand((), generator=s.generator,
                              device=dev) < p_proc
        proc_tok = idx_r[sampling.categorical(
            s.generator, torch.where(proc_ok, vals_r, NEG_INF))]
        raw_masked = raw_r.clone()
        raw_masked[d_safe] = torch.where(has_excl, NEG_INF, raw_r[d_safe])
        raw_tok = sampling.categorical(s.generator, raw_masked)
        t = torch.where(use_proc, proc_tok, raw_tok)

        # commit: a0 kept drafts + the fresh token t, clamped to the
        # remaining budget, truncated at the first EOS
        total = torch.clamp(a0 + 1, max=max_new - s.num_generated[0])
        keep_d = torch.minimum(a0, total)
        pend = total - keep_d                                    # 0 or 1
        eos_kept = is_eos(drafts, eos_ids) & (ar_g < keep_d)
        any_eos = eos_kept.any()
        keep_d = torch.where(any_eos, torch.argmax(eos_kept.int()) + 1,
                             keep_d)
        pend = torch.where(any_eos, 0, pend)
        t_eos = (pend == 1) & is_eos(t, eos_ids)
        s.finished |= any_eos | t_eos
        n_c = keep_d + pend
        cvals = torch.where(ar_g1 < keep_d,
                            torch.cat([drafts, drafts[-1:]]), t)
        idxs = Lb + ar_g1                    # <= Lb + G <= max_len - 1
        maskq = ar_g1 < n_c
        s.tokens[0, idxs] = torch.where(maskq, cvals, row[idxs])
        s.valid[0, idxs] |= maskq
        hits = torch.zeros((V,), dtype=torch.int64, device=dev)
        hits.scatter_add_(0, cvals, maskq.long())
        s.presence |= (hits > 0)[None]
        s.length += n_c
        s.num_generated += n_c
        kept, n_c, fin = torch.stack([keep_d, n_c,
                                      s.finished[0].long()]).tolist()
        s.cache = qwen3.KVCache(cache.k, cache.v, Lb + kept)
        return [kept, n_c, fin]

    def spec_decode(model, s: DecodeState, max_new: int):
        max_len = s.tokens.shape[1]
        fin, n_gen, Lb = torch.stack([s.finished[0].long(),
                                      s.num_generated[0],
                                      s.length[0]]).tolist()
        iters = 0
        if not fin and n_gen < max_new and Lb < max_len:
            # the first token comes from the held logits, as in the plain
            # loop; it becomes the pending (uncached) token
            tok = sample_next_token(sp, s, win, eos_ids, s.generator)
            s.tokens[0, Lb] = tok[0]
            s.valid[0, Lb] = True
            s.presence[0, tok[0]] = True
            s.finished |= is_eos(tok, eos_ids)
            s.length += 1
            s.num_generated += 1
            Lb, n_gen = Lb + 1, n_gen + 1
            fin = bool(s.finished[0])
            while not fin and n_gen < max_new and Lb + G + 1 <= max_len:
                _, n_c, fin = body(model, s, Lb, max_new)
                Lb, n_gen, iters = Lb + n_c, n_gen + n_c, iters + 1
        if Lb > s.cache.length:
            # cache the pending token and refresh last_logits, so the
            # state meets the engine's contract (prefill appends at
            # cache.length; the plain loop samples from last_logits)
            logits, s.cache = qwen3.forward(
                model, s.tokens[0, Lb - 1].reshape(1, 1),
                attention_mask=s.valid,
                positions=(s.valid[0].sum() - 1).reshape(1, 1),
                cache=s.cache)
            s.last_logits = logits[:, -1].float()
        return (s, iters) if with_stats else s

    return spec_decode
