"""Contiguous-cache decode engine (port of
``speech_distill_tpu/infer/engine.py``): a bucketed prefill, then a
sampling decode loop over a preallocated KV cache [L, B, max_len, KV, Dh]
and a token buffer [B, max_len].

* The decode loop samples from the held logits, appends the token and
  runs the model over it; the repetition-penalty presence set is an
  incremental [B, V] mask.
* Multi-turn reuse: the cache and buffer survive across calls, so a
  long-form session pays prefill only for each new turn's text.
* ``generate_batch`` left-pads a batch of prompts to one bucket (pads are
  masked keys; RoPE positions count real tokens) and prefills a shared
  prompt prefix once, from an LRU of prefix K/V slabs.
* ``generate_stream`` yields the new tokens every ``chunk`` steps.

Differences from the JAX engine, by design:

* State is updated in place (JAX's is immutable and returned anew). A
  turn's ``prefill`` gives a new :class:`DecodeState` whose small tensors
  and generator are copies, sharing only the cache's tensors, and writes
  K/V only at columns past the old length: a state retained across turns
  (an orchestrator's rollback point) stays valid, as in JAX.
* Randomness is an explicit ``torch.Generator`` a state, on the engine's
  device; ``new_state`` seeds it from the engine's seeded generator, as
  JAX splits the engine key. The streams differ from JAX's.
* The decode loop is a Python loop; its exit test (every row finished)
  is one host read a step. The windowed decode runs it over views of the
  first ``window`` columns, so JAX's merge-back has no counterpart.
* A prefill that would run past ``max_len`` is narrowed to the columns
  left (JAX's ``dynamic_update_slice`` shifts the write instead); a
  prompt that does not fit raises.
* ``generate_batch`` refuses a bucketed prompt that fills the cache
  before its prefill (JAX after it).

Only the rows' last positions go through the lm head at prefill.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import Qwen3Config, SamplingParams
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.ops import sampling


@dataclass
class DecodeState:
    tokens: torch.Tensor         # [B, max_len] int64 (prompt + generated)
    length: torch.Tensor         # [B] int64 — buffer slots used per row
    valid: torch.Tensor          # [B, max_len] bool — real (non-pad) slots
    cache: qwen3.KVCache         # cache.length: columns written (host int)
    last_logits: torch.Tensor    # [B, V] fp32 — logits at the last token
    presence: torch.Tensor       # [B, V] bool — generated-token set
    num_generated: torch.Tensor  # [B] int64
    cap: torch.Tensor            # [B] int64 — per-row token budget (the
    #                              continuous engine retires rows at it;
    #                              the static engine leaves it huge)
    finished: torch.Tensor       # [B] bool
    generator: torch.Generator

    def fork(self) -> "DecodeState":
        """A state to continue from this one: copies of the small tensors
        and the generator, the cache's tensors shared."""
        generator = torch.Generator(device=self.generator.device)
        generator.set_state(self.generator.get_state())
        return DecodeState(
            tokens=self.tokens.clone(), length=self.length.clone(),
            valid=self.valid.clone(),
            cache=qwen3.KVCache(self.cache.k, self.cache.v,
                                self.cache.length),
            last_logits=self.last_logits, presence=self.presence.clone(),
            num_generated=self.num_generated.clone(), cap=self.cap.clone(),
            finished=self.finished.clone(),
            generator=generator)

    def window(self, w: int) -> "DecodeState":
        """The state over the first ``w`` columns: views of the buffer and
        the cache, every other field shared."""
        c = self.cache
        return replace(self, tokens=self.tokens[:, :w],
                       valid=self.valid[:, :w],
                       cache=qwen3.KVCache(c.k[:, :, :w], c.v[:, :, :w],
                                           c.length))

    def absorb(self, w: "DecodeState") -> None:
        """Take back what a decode over :meth:`window` reassigned (the
        buffer and cache views were written in place)."""
        for f in fields(self):
            if f.name not in ("tokens", "valid", "cache"):
                setattr(self, f.name, getattr(w, f.name))
        self.cache = qwen3.KVCache(self.cache.k, self.cache.v,
                                   w.cache.length)


def new_decode_state(cfg: Qwen3Config, batch: int, max_len: int,
                     cache_dtype, device, seeds: torch.Generator,
                     idle: bool = False) -> DecodeState:
    """A fresh state of ``batch`` rows; its generator's seed is drawn from
    ``seeds`` (as JAX splits the engine key). Rows start live with no
    token budget of their own, or with ``idle`` finished with cap 0 (the
    continuous engine's free slots)."""
    V = cfg.vocab_size
    i64 = dict(dtype=torch.int64, device=device)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=seeds))
    return DecodeState(
        tokens=torch.zeros((batch, max_len), **i64),
        length=torch.zeros((batch,), **i64),
        valid=torch.zeros((batch, max_len), dtype=torch.bool,
                          device=device),
        cache=qwen3.KVCache.create(cfg, batch, max_len, cache_dtype,
                                   device),
        last_logits=torch.zeros((batch, V), dtype=torch.float32,
                                device=device),
        presence=torch.zeros((batch, V), dtype=torch.bool, device=device),
        num_generated=torch.zeros((batch,), **i64),
        cap=torch.full((batch,), 0 if idle else 1 << 30, **i64),
        finished=torch.full((batch,), idle, dtype=torch.bool,
                            device=device),
        generator=torch.Generator(device=device).manual_seed(seed))


def is_eos(token: torch.Tensor, eos_ids) -> torch.Tensor:
    hit = torch.zeros_like(token, dtype=torch.bool)
    for e in eos_ids:
        hit |= token == e
    return hit


def write_live(buf: torch.Tensor, col: torch.Tensor, live: torch.Tensor,
               value: torch.Tensor) -> None:
    """buf[b, col[b]] = value[b] for live rows; dead rows write their
    current value back (JAX scatters them with ``mode="drop"``)."""
    buf.scatter_(1, col, torch.where(live[:, None], value[:, None],
                                     buf.gather(1, col)))


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
            tau_r=sp.tau_r, topk_method=sp.topk_method,
            return_logprob=want_logprob)
    processed = sampling.process_logits(
        raw, st.presence, st.num_generated, temperature=temperature,
        top_k=sp.top_k, top_p=top_p, repetition_penalty=rep_pen,
        min_tokens=min_tok, eos_ids=eos_ids)
    token, _, logp = sampling.ras_sample(
        generator, raw, processed, recent, recent_valid, use_ras=sp.use_ras,
        win_size=win, tau_r=sp.tau_r, return_logprob=want_logprob)
    return (token, logp) if want_logprob else token


def make_decode_fn(sp: SamplingParams, win_size: Optional[int] = None):
    """``decode(model, state, max_new) -> state``: decode steps, in place,
    until every row finished, ``min(num_generated)`` reaches ``max_new``
    or ``max(length)`` the buffer's width. Every row appends a token each
    step (a finished row the pad id), so the two bounds are counted on
    the host; the all-finished test is one host read a step."""
    win = win_size or sp.win_size
    eos_ids = tuple(sp.stop_token_ids)
    pad_id = eos_ids[0]

    def step(model, st: DecodeState) -> None:
        tok = sample_next_token(sp, st, win, eos_ids, st.generator)
        token = torch.where(st.finished, pad_id, tok)
        col = st.length[:, None]
        # per-row RoPE position = count of real tokens before this one
        # (left-padded batches: pads are masked keys, not positions)
        pos = st.valid.sum(dim=1, keepdim=True)
        st.tokens.scatter_(1, col, token[:, None])
        st.valid.scatter_(1, col, True)
        st.presence.scatter_(1, token[:, None], True)
        st.finished |= is_eos(token, eos_ids)
        logits, st.cache = qwen3.forward(model, token[:, None],
                                         attention_mask=st.valid,
                                         positions=pos, cache=st.cache)
        st.last_logits = logits[:, -1].float()
        st.length += 1
        st.num_generated += 1

    def decode(model, st: DecodeState, max_new: int) -> DecodeState:
        max_len = st.tokens.shape[1]
        n0, l0 = torch.stack([st.num_generated.min(),
                              st.length.max()]).tolist()
        steps = 0
        while n0 + steps < max_new and l0 + steps < max_len:
            if bool(st.finished.all()):
                break
            step(model, st)
            steps += 1
        return st

    return decode


class DecodeEngine:
    """Host-facing engine on id lists (tokenizer-free).

    ``generate(prompt_ids)`` mirrors the reference HF engine's generate:
    the repetition penalty excludes the prompt, RAS sampling, EOS
    stopping, the state passed through for multi-turn reuse.
    ``spec_gamma`` > 0 decodes B = 1 speculatively
    (``infer/speculative.py``; draft "ngram" with n-grams up to
    ``spec_ngram``, or "layer_skip" over the first ``spec_layers``
    layers; ``n_spec_iterations`` counts its verify passes). ``device``
    defaults to CUDA and raises without it; the cache is ``cache_dtype``
    (bf16 by default)."""

    stateful = True   # multi-turn reuse via caller-held DecodeState

    def __init__(self, model: qwen3.Qwen3, cfg: Qwen3Config,
                 sp: SamplingParams, max_len: int = 8192,
                 prefill_bucket: int = 128, seed: int = 0,
                 cache_dtype=torch.bfloat16, prefix_cache_size: int = 4,
                 prefix_cache_min: int = 32, spec_gamma: int = 0,
                 spec_ngram: int = 3, spec_draft: str = "ngram",
                 spec_layers: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg
        self.sp = sp
        self.max_len = max_len
        self.bucket = prefill_bucket
        self.cache_dtype = cache_dtype
        self._decode = make_decode_fn(sp)
        self._spec_gamma = spec_gamma
        self._spec = None
        self.n_spec_iterations = 0
        if spec_gamma > 0:
            from speech_distill_tpu_torch.infer import speculative
            self._spec = speculative.make_spec_decode_fn(
                cfg, sp, spec_gamma, ngram_max=spec_ngram,
                draft=spec_draft, draft_layers=spec_layers,
                with_stats=True)
        # the seed of each new state's generator
        self._generator = torch.Generator().manual_seed(seed)
        # prompt-prefix KV cache (vLLM enable_prefix_caching): prefix
        # token tuple -> (k, v) [L, 1, n, KV, Dh], LRU-evicted
        self.prefix_cache_size = prefix_cache_size
        self.prefix_cache_min = prefix_cache_min
        self._prefix_cache: "dict[tuple, tuple]" = {}
        self.last_stream_state: Optional[DecodeState] = None

    def _bucketed(self, n: int) -> int:
        return min(self.max_len, -(-n // self.bucket) * self.bucket)

    def _window_for(self, n: int) -> int:
        """Smallest power-of-two cache window >= n (min 512)."""
        w = 512
        while w < n:
            w *= 2
        return min(w, self.max_len)

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=self.device)

    def _last_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """fp32 logits [B, V] of hidden states [B, 1, D]."""
        return qwen3.unembed(self.model, hidden)[:, 0].float()

    def _run_decode(self, state: DecodeState, max_new: int) -> DecodeState:
        """Windowed decode: the loop runs over a power-of-two window of the
        cache that grows with the sequence, so a step attends over
        O(length) keys instead of max_len. The window is a view: what the
        loop writes lands in the state's own tensors."""
        spec = self._spec if (self._spec is not None
                              and state.tokens.shape[0] == 1) else None
        # spec decode needs gamma + 1 free slots in its window to run one
        # iteration; without the margin the loop could pick a window the
        # spec loop rejects at once and spin forever
        margin = self._spec_gamma + 1 if spec is not None else 0
        done = 0
        while done < max_new:
            window = self._window_for(int(state.length.max()) + 1 + margin)
            if window >= self.max_len:
                if spec is not None:
                    self.n_spec_iterations += spec(self.model, state,
                                                   max_new)[1]
                # the plain loop decodes the <= gamma-token tail the spec
                # loop cannot fit near max_len (nothing if already done)
                self._decode(self.model, state, max_new)
                break
            st_w = state.window(window)
            if spec is not None:
                self.n_spec_iterations += spec(self.model, st_w, max_new)[1]
            else:
                self._decode(self.model, st_w, max_new)
            state.absorb(st_w)
            done, fin = torch.stack([state.num_generated.min(),
                                     state.finished.all().long()]).tolist()
            if fin:
                break
        return state

    def new_state(self, batch: int = 1) -> DecodeState:
        return new_decode_state(self.cfg, batch, self.max_len,
                                self.cache_dtype, self.device,
                                self._generator)

    def prefill(self, state: DecodeState, new_ids: list) -> DecodeState:
        """Append prompt ids (one row) and run the model over them; returns
        a new state (:meth:`DecodeState.fork`).

        The chunk is padded to a bucket; the padded columns are written to
        the cache but never read: the cache length is rewound to the real
        end, and every later step writes its own column before attending.
        A fresh turn (cache empty) attends over its own bucket, a view of
        the cache's first ``width`` columns, instead of all ``max_len``
        (the other keys are masked either way): T == S there, so a
        flash-width prefill takes K1-fwd on the card, as
        :meth:`_prefill_prefix` does.
        """
        n = len(new_ids)
        start = state.cache.length
        width = min(self._bucketed(n), self.max_len - start)
        if width < n:
            raise ValueError(f"{n} prompt tokens at column {start} overflow "
                             f"max_len={self.max_len}")
        ids = np.zeros((1, width), np.int64)
        ids[0, :n] = new_ids
        ids = self._ids(ids)
        c = state.cache
        cache = (qwen3.KVCache(c.k[:, :, :width], c.v[:, :, :width], 0)
                 if start == 0 else c)
        S = cache.k.shape[2]
        mask = (torch.arange(S, device=self.device) < start + n)[None]
        hidden, _ = qwen3.forward(self.model, ids, attention_mask=mask,
                                  cache=cache, return_hidden=True)
        st = state.fork()
        st.cache = qwen3.KVCache(c.k, c.v, start + n)
        st.tokens[0, start:start + n] = ids[0, :n]
        st.length.fill_(start + n)
        st.valid[0, start:start + n] = True
        st.last_logits = self._last_logits(hidden[:, n - 1:n])
        return st

    # -- prompt-prefix KV caching ------------------------------------------

    @staticmethod
    def _common_prefix_len(prompts: list) -> int:
        n = min(len(p) for p in prompts)
        first = prompts[0]
        for i in range(n):
            t = first[i]
            for p in prompts[1:]:
                if p[i] != t:
                    return i
        return n

    def _prefill_prefix(self, prefix: tuple):
        """Prefill ``prefix`` alone (B = 1) and cache its K/V slabs.

        Reuses the longest cached entry that is a prefix of ``prefix`` and
        extends it with one more prefill, so a growing system prompt pays
        only for its new tokens. A fresh prefix of a flash width (>= 512,
        a multiple of 256) prefills through K1-fwd: its cache is exactly
        one bucket wide and right-padded."""
        if prefix in self._prefix_cache:
            kv = self._prefix_cache.pop(prefix)
            self._prefix_cache[prefix] = kv          # LRU bump
            return kv
        best = ()
        for key in self._prefix_cache:
            if len(best) < len(key) < len(prefix) \
                    and prefix[:len(key)] == key:
                best = key
        start = len(best)
        new_ids = list(prefix[start:])
        n = len(prefix)
        width = self._bucketed(len(new_ids))
        S = start + width
        cache = qwen3.KVCache.create(self.cfg, 1, S, self.cache_dtype,
                                     self.device)
        if start:
            pk, pv = self._prefix_cache[best]
            cache.k[:, :, :start] = pk
            cache.v[:, :, :start] = pv
            cache.length = start
        ids = np.zeros((1, width), np.int64)
        ids[0, :len(new_ids)] = new_ids
        mask = (torch.arange(S, device=self.device) < n)[None]
        _, cache = qwen3.forward(self.model, self._ids(ids),
                                 attention_mask=mask, cache=cache,
                                 return_hidden=True)
        kv = (cache.k[:, :, :n], cache.v[:, :, :n])
        self._prefix_cache[prefix] = kv
        while len(self._prefix_cache) > self.prefix_cache_size:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))
        return kv

    def generate_batch(self, prompts: list, max_new: Optional[int] = None,
                       use_prefix_cache: bool = True) -> list:
        """Batched single-turn decode. Prompts are LEFT-padded to one
        bucket width so every row shares the write column; pads are
        masked keys with per-row RoPE positions, so results match
        unpadded decoding.

        ``use_prefix_cache``: when the prompts share a common token prefix
        (>= ``prefix_cache_min``), it is prefilled once (B = 1), its K/V
        broadcast across rows, and kept in an LRU for later calls (vLLM's
        ``enable_prefix_caching``)."""
        B = len(prompts)
        longest = max(len(p) for p in prompts)
        if longest >= self.max_len:
            raise ValueError(
                f"prompt length {longest} leaves no room to generate "
                f"(max_len={self.max_len})")
        pre = 0
        if use_prefix_cache:
            # every row keeps >= 1 remainder token for its last logits
            pre = min(self._common_prefix_len(prompts),
                      min(len(p) for p in prompts) - 1)
            if pre < self.prefix_cache_min:
                pre = 0
        rems = [p[pre:] for p in prompts]
        if pre and pre + self._bucketed(max(len(r) for r in rems)) \
                > self.max_len:
            # the bucketed remainder after the shared prefix would
            # overflow the cache: prefill the full prompts in-row
            pre = 0
            rems = prompts
        width = self._bucketed(max(len(r) for r in rems))
        total = pre + width
        cap = min(max_new or self.sp.max_tokens, self.max_len - total)
        if cap <= 0:
            raise ValueError(
                f"bucketed prompt width {total} fills the cache "
                f"(max_len={self.max_len}); raise max_len or shrink "
                f"prefill_bucket")
        ids = np.zeros((B, width), np.int64)
        valid = np.zeros((B, self.max_len), bool)
        pos = np.zeros((B, width), np.int64)
        for b, r in enumerate(rems):
            n = len(r)
            ids[b, width - n:] = r
            valid[b, pre + width - n:total] = True
            pos[b, width - n:] = pre + np.arange(n)
        valid[:, :pre] = True

        state = self.new_state(B)
        if pre:
            pk, pv = self._prefill_prefix(tuple(prompts[0][:pre]))
            state.tokens[:, :pre] = self._ids(prompts[0][:pre])
            state.cache.k[:, :, :pre] = pk
            state.cache.v[:, :, :pre] = pv
            state.cache.length = pre
        ids = self._ids(ids)
        state.valid = torch.as_tensor(valid, device=self.device)
        hidden, cache = qwen3.forward(self.model, ids,
                                      attention_mask=state.valid,
                                      positions=self._ids(pos),
                                      cache=state.cache, return_hidden=True)
        state.cache = qwen3.KVCache(cache.k, cache.v, total)
        state.tokens[:, pre:total] = ids
        state.length.fill_(total)
        state.last_logits = self._last_logits(hidden[:, -1:])
        state = self._run_decode(state, int(cap))
        toks = state.tokens.cpu().numpy()
        lens = state.length.tolist()
        return [toks[b, total:lens[b]].tolist() for b in range(B)]

    def _start_turn(self, state: Optional[DecodeState], prompt_ids: list):
        """(state after the turn's prefill with per-turn sampling state
        reset (the penalty set excludes the prompt), prompt end)."""
        state = state if state is not None else self.new_state(1)
        prompt_end = int(state.length[0]) + len(prompt_ids)
        state = self.prefill(state, prompt_ids)
        state.presence = torch.zeros_like(state.presence)
        state.num_generated = torch.zeros_like(state.num_generated)
        state.finished = torch.zeros_like(state.finished)
        return state, prompt_end

    def generate(self, prompt_ids: list,
                 state: Optional[DecodeState] = None) -> dict:
        """One turn: prefill the prompt continuation, sample until EOS."""
        state, prompt_end = self._start_turn(state, prompt_ids)
        max_new = min(self.sp.max_tokens, self.max_len - prompt_end)
        state = self._run_decode(state, int(max_new))
        end = int(state.length[0])
        return {"token_ids": state.tokens[0, prompt_end:end].tolist(),
                "state": state}

    def generate_stream(self, prompt_ids: list, chunk: int = 25,
                        state: Optional[DecodeState] = None,
                        max_new: Optional[int] = None):
        """Token streaming: one turn as a generator yielding the newly
        generated ids every ``chunk`` decode steps (sooner at EOS).

        The yields concatenate to ``generate()``'s token_ids for the same
        generator state (the same decode, stopped and resumed). After
        exhaustion ``self.last_stream_state`` holds the final state (a
        generator cannot return one), so multi-turn sessions continue the
        cache."""
        self.last_stream_state = None
        state, prompt_end = self._start_turn(state, prompt_ids)
        cap = min(max_new or self.sp.max_tokens, self.max_len - prompt_end)
        emitted = prompt_end
        done = 0
        while done < cap:
            state = self._run_decode(state, min(done + chunk, cap))
            # ONE host read a chunk, the token row included
            head = torch.stack([state.num_generated[0], state.length[0],
                                state.finished.all().long()])
            got = torch.cat([head, state.tokens[0]]).tolist()
            done, end, fin = got[:3]
            new = got[3 + emitted:3 + end]
            emitted = end
            if new:
                yield new
            if fin:
                break
        self.last_stream_state = state
