"""Paged-KV serving: block-table cache pool + on-demand pages + preemption.

Port of ``speech_distill_tpu/infer/paged.py``. The KV cache is a pool of
fixed-size pages [L, P, KV, page_size, Dh] handed out on demand by a
host-side ref-counted allocator; each slot's pages are named by a row of
the block table. When the pool runs dry the youngest stream is preempted
(recompute mode: its pages are freed and it re-queues with its generated
tokens appended to the prompt). Full page-aligned prompt prefixes are
shared through a prefix registry. Decode attention is the hand-written
CUDA kernel ``csrc/paged_decode.cu`` (``ops/paged_attention.py``); long
fresh prompts prefill through ``csrc/flash_fwd.cu`` (``ops/attention.py``).

Differences from the JAX engine, by design:
  * State is mutated in place (JAX donates and rebuilds it).
  * JAX scatters with ``mode="drop"`` at out-of-range indices to discard
    dead rows; torch's ``index_put_`` would raise or corrupt memory there.
    The pool holds one extra page, index P, that no block table names:
    dead rows write their KV there. Token, presence and logprob writes of
    dead rows write the current value back.
  * The decode chunk is a Python loop; its exit test (every slot
    finished, or ``exit_free`` slots retired in the chunk) is one host
    read per step, counted in ``n_exit_syncs``. CUDA graphs come later.
  * The pool holds the model's dtype (bf16 or fp32), or int8 with one
    fp32 scale per (token, KV head) (``cache_dtype=torch.int8``, the
    vLLM quantized KV cache; decode through ``paged_decode_int8``).
  * Pending batched prefills are flushed before a prefix hit gathers
    their pages (the JAX engine gathers first and reads unwritten pages).
  * With ``prefill_chunk``, a prompt longer than the chunk that becomes
    the head of the queue during admission waits a pass and prefills in
    pieces (the JAX engine prefills it whole there, past the chunk
    bound). Tokens are the same; the scheduling and
    ``n_prefill_chunks`` may differ.
  * ``attn_impl`` and ``attn_win_pages`` have no counterpart: the decode
    attention wrapper launches K4 on CUDA tensors and runs its plain
    version on CPU ones, and K4 sizes its stages from the shapes
    (``k4_plan``).
  * ``mesh`` (``parallel/mesh.Mesh``): one rank of an SPMD serve (JAX:
    one controller over a ``NamedSharding``-placed state). Slots shard
    over dp: the rank's device state holds its slots' rows. The pool's KV
    heads shard over tp ([L, P + 1, KV / tp, ps, Dh]) and every dp rank
    keeps every page, as JAX replicates the pool over dp: prefills run on
    every rank and each decode step's new KV rows are all-gathered over
    dp. K4 and the prefill's K1-fwd run on the rank's heads. The ranks
    of a pp or sp axis serve replicas (JAX's engine shards only over dp
    and tp and replicates the rest); a pipelined model raises. Every rank
    makes the same admission, preemption, prefix and finish decisions
    from the same dp-gathered lengths, tokens and flags, and from rank
    0's clock; the draws are made for the global slot batch and sliced
    (``ops/sampling.RowDraws``), so tokens equal a one-process serve's.
Every other option and ``serve`` argument is the JAX engine's: chunked
prefill, the early chunk exit, the four admission policies with TTFT
deadlines and shedding, open-loop arrivals, per-request sampling,
logprobs (``on_logprobs``), ``on_chunk``, and the native C++ allocator
and prefix trie (``native/serving.py``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import Qwen3Config, SamplingParams
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.infer.engine import (is_eos,
                                                   sample_next_token,
                                                   write_live)
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_plain, quantize_kv)
from speech_distill_tpu_torch.ops.sampling import RowDraws
from speech_distill_tpu_torch.parallel import comm


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class PagedKVCache:
    """Page pools [L, P + 1, KV, page_size, Dh]; page P is the drop target
    of dead rows' writes and is never read. An int8 pool carries one fp32
    scale per (token, KV head) in ``ks``/``vs`` [L, P + 1, KV, page_size]
    (ones at creation)."""

    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None

    @property
    def drop_page(self) -> int:
        return self.k.shape[1] - 1

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @classmethod
    def create(cls, cfg: Qwen3Config, num_pages: int, page_size: int,
               dtype=torch.bfloat16, device="cuda") -> "PagedKVCache":
        if dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise ValueError(f"pool dtype {dtype}: bf16, fp32 or int8")
        shape = (cfg.num_hidden_layers, num_pages + 1,
                 cfg.num_key_value_heads, page_size, cfg.head_dim)
        device = resolve_device(device)

        def zeros():
            return torch.zeros(shape, dtype=dtype, device=device)
        if dtype != torch.int8:
            return cls(zeros(), zeros())
        return cls(zeros(), zeros(),
                   torch.ones(shape[:-1], dtype=torch.float32, device=device),
                   torch.ones(shape[:-1], dtype=torch.float32, device=device))


@dataclass
class PagedState:
    tokens: torch.Tensor         # [B, max_len] int64 (prompt + generated)
    length: torch.Tensor         # [B] int64 — tokens resident per row
    pool: PagedKVCache
    block_tables: torch.Tensor   # [B, max_pages] int32 pool page ids
    last_logits: torch.Tensor    # [B, V] fp32
    presence: torch.Tensor       # [B, V] bool — generated-token set
    num_generated: torch.Tensor  # [B] int64 (request total across preemption)
    cap: torch.Tensor            # [B] int64 — request token budget
    finished: torch.Tensor       # [B] bool
    samp: Optional[torch.Tensor] = None   # [B, 4] fp32 per-request
    #  (temperature, top_p, repetition penalty, min_tokens); None unless
    #  the engine was built with per_request_sampling
    logps: Optional[torch.Tensor] = None  # [B, max_len] fp32: each
    #  generated token's logprob at its column; None unless the engine was
    #  built with return_logprobs


@torch.no_grad()
def paged_forward(model: qwen3.Qwen3, token: torch.Tensor,
                  pool: PagedKVCache, block_tables: torch.Tensor,
                  lengths: torch.Tensor, live: torch.Tensor,
                  attn_impl: str = "kernel", dp=None) -> torch.Tensor:
    """One decode step over the page pool.

    token [B]; the new token's KV is written at page
    block_tables[b, lengths[b] // ps], offset lengths[b] % ps (to the drop
    page for dead rows), then each row attends over its lengths[b] + 1
    resident keys. Updates ``pool`` in place; returns logits [B, V] fp32.
    ``attn_impl``: "kernel" (``paged_attention``: the CUDA kernel on CUDA
    tensors) or "plain" (``paged_attention_plain``). A tensor-parallel
    model attends over its KV heads of the pool; with a ``dp`` group the
    step's new KV rows of every dp rank are written into this rank's
    pool after the layers (no row reads another rank's fresh rows within
    a step)."""
    cfg = model.cfg
    B = token.shape[0]
    Dh, KV = cfg.head_dim, pool.k.shape[2]
    G = cfg.num_attention_heads // cfg.num_key_value_heads
    ps = pool.k.shape[3]
    tp = qwen3.tp_group(model)
    attend = {"kernel": paged_attention,
              "plain": paged_attention_plain}[attn_impl]
    dev = token.device

    x = qwen3.embed_tokens(model, token[:, None])              # [B, 1, D]
    cos, sin = qwen3.rope_angles(lengths[:, None], Dh, cfg.rope_theta)
    rows = torch.arange(B, device=dev)
    # clamp: a row at length == max_len is dead but must not index past
    # the table
    col = torch.clamp(lengths // ps, max=block_tables.shape[1] - 1)
    pages = torch.where(live, block_tables[rows, col].long(),
                        pool.drop_page)[:, None]               # [B, 1]
    offs = (lengths % ps)[:, None]
    heads = torch.arange(KV, device=dev)[None, :]              # [1, KV]
    klen = torch.where(live, lengths + 1, 0).to(torch.int32)
    fresh = []                       # this step's KV rows, for dp
    for li, layer in enumerate(model.layers):
        y = qwen3.rms_norm(x, layer.input_ln, cfg.rms_norm_eps)
        q, k, v = qwen3.qkv_proj(layer.attn, y, cos, sin, cfg)
        k1, v1 = k[:, 0], v[:, 0]                          # [B, KV, Dh]
        if pool.quantized:
            # per (token, head) int8 before the scatter; K and V in one
            # call (the scales are per slice, so stacking changes nothing)
            (k1, v1), (ksc, vsc) = quantize_kv(torch.stack([k1, v1]))
            pool.ks[li, pages, heads, offs] = ksc
            pool.vs[li, pages, heads, offs] = vsc
        pool.k[li, pages, heads, offs] = k1.to(pool.k.dtype)
        pool.v[li, pages, heads, offs] = v1.to(pool.v.dtype)
        if dp is not None:
            fresh.append((k1, v1) + ((ksc, vsc) if pool.quantized else ()))
        o = attend(q.reshape(B, KV, G, Dh), pool.k, pool.v,
                   block_tables, klen, layer=li, k_scale=pool.ks,
                   v_scale=pool.vs)
        x = qwen3.o_proj_and_mlp(layer, x, o, cfg, tp=tp)
    if dp is not None:
        _write_fresh(pool, fresh, pages, heads, offs, dp)
    x = qwen3.rms_norm(x, model.final_ln, cfg.rms_norm_eps)
    return qwen3.unembed(model, x)[:, 0].float()


def _write_fresh(pool: PagedKVCache, fresh, pages, heads, offs, dp) -> None:
    """Write every dp rank's new KV rows of a step (``fresh``: per layer
    (k, v[, k scale, v scale]) of this rank's rows) into this rank's
    pool: the pool stays the same on every dp rank."""
    pages = comm.all_gather(pages, dp)
    offs = comm.all_gather(offs, dp)
    names = ("k", "v", "ks", "vs")
    for j in range(len(fresh[0])):
        rows = comm.all_gather(torch.stack([f[j] for f in fresh]), dp,
                               dim=1)               # [L, B_all, KV(, Dh)]
        dst = getattr(pool, names[j])
        dst[:, pages, heads, offs] = rows.to(dst.dtype)


def make_paged_decode_fn(sp: SamplingParams, dp=None):
    """``decode_chunk(model, state, n_steps, generator, exit_free) ->
    (steps_run, exit_tests)``: up to ``n_steps`` decode steps over the page
    pool, updating ``state`` in place. The chunk exits early once every
    slot is finished, or once ``exit_free`` slots retired inside it (the
    scheduler passes ``slots + 1`` to run to the boundary). The host
    allocator guarantees every live row has pages for ``n_steps`` more
    tokens. With a ``dp`` group the state holds this rank's slots: the
    exit test reads the finished flags of every dp rank."""
    win = sp.win_size
    eos_ids = tuple(sp.stop_token_ids)
    pad_id = eos_ids[0]

    @torch.no_grad()
    def step(model, st: PagedState, generator) -> None:
        max_len = st.tokens.shape[1]
        if st.logps is not None:
            tok, logp = sample_next_token(sp, st, win, eos_ids, generator,
                                          want_logprob=True)
        else:
            tok = sample_next_token(sp, st, win, eos_ids, generator)
        live = ~st.finished & (st.length < max_len)
        token = torch.where(live, tok, pad_id)
        col = torch.clamp(st.length, max=max_len - 1)[:, None]
        write_live(st.tokens, col, live, token)
        if st.logps is not None:
            write_live(st.logps, col, live, logp)
        write_live(st.presence, token[:, None], live, torch.ones_like(live))
        capped = live & (st.num_generated + 1 >= st.cap)
        st.finished |= ((live & is_eos(token, eos_ids)) | capped
                        | (st.length + 1 >= max_len))
        st.last_logits = paged_forward(model, token, st.pool,
                                       st.block_tables, st.length, live,
                                       dp=dp)
        st.length += live
        st.num_generated += live

    def decode_chunk(model, st: PagedState, n_steps: int, generator,
                     exit_free: int):
        fin0 = comm.all_gather(st.finished, dp).clone()
        steps = tests = 0
        while steps < n_steps:
            # the JAX while_loop tests this on the device; here it is one
            # host read per step
            tests += 1
            fin = comm.all_gather(st.finished, dp)
            retired = (fin & ~fin0).sum()
            if bool(fin.all() | (retired >= exit_free)):
                break
            step(model, st, generator)
            steps += 1
        return steps, tests

    return decode_chunk


class _AdmissionQueue:
    """Admission-ordered request queue (``PagedEngine.admission_policy``).

    fifo keeps deque semantics exactly (appendleft = front of the queue,
    where a preempted request goes). The priority policies keep the queue
    sorted by key with a stable arrival tiebreak; preempted requests
    re-insert by their CURRENT key (a shortest_job request's remaining
    budget shrinks while resident, so it re-queues ahead of equal-length
    fresh work)."""

    def __init__(self, policy: str):
        self.policy = policy
        self._items = deque()
        self._seq = 0

    def _key(self, r):
        if self.policy == "shortest_job":
            return r["cap"] - len(r["gen"])
        if self.policy == "deadline":
            dl = r.get("dl")
            return dl if dl is not None else float("inf")
        return len(r["ids"])

    def append(self, r) -> None:
        if "_seq" not in r:
            r["_seq"] = self._seq
            self._seq += 1
        if self.policy == "fifo":
            self._items.append(r)
            return
        k = (self._key(r), r["_seq"])
        for i, q in enumerate(self._items):
            if (self._key(q), q["_seq"]) > k:
                self._items.insert(i, r)
                return
        self._items.append(r)

    def appendleft(self, r) -> None:
        if self.policy == "fifo":
            self._items.appendleft(r)
        else:
            self.append(r)

    def popleft(self):
        return self._items.popleft()

    def shed_expired(self, t_now: float):
        """Remove and return queued requests whose TTFT deadline passed
        before they produced ANY token (load shedding under overload).
        Requests already holding generated tokens (preempted residents)
        met their first-token deadline and are never shed."""
        def past_due(r):
            return (r.get("dl") is not None and t_now > r["dl"]
                    and not r["gen"] and "t_first" not in r)
        expired = [r for r in self._items if past_due(r)]
        if expired:
            self._items = deque(r for r in self._items if not past_due(r))
        return expired

    def __getitem__(self, i):
        return self._items[i]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)


class PagePool:
    """Host-side ref-counted page allocator (the vLLM block manager,
    minus GPU swap: preemption here is recompute-mode)."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def share(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)

    def refcount(self, p: int) -> int:
        return self._ref.get(p, 0)


class PrefixRegistry:
    """Automatic prefix caching: full, page-aligned prompt prefixes are
    keyed by their token tuple and mapped to resident pool pages. A
    registered page carries one registry reference, so it outlives the
    stream that computed it; under pool pressure, entries whose page is
    held ONLY by the registry are evicted LRU-first (before any live
    stream is preempted). Keys are exact token tuples, so no collision can
    alias two different prefixes onto one KV page."""

    def __init__(self):
        self._map = {}          # tuple(ids[:i*ps]) -> {"page", "last"}
        self._clock = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, ids: Sequence[int], ps: int,
              max_pages: int) -> List[int]:
        """Longest registered page-aligned prefix of ``ids`` (capped at
        ``max_pages`` so the caller keeps at least one suffix token to
        prefill). Returns the matched page ids, root-first."""
        pages = []
        for i in range(min(len(ids) // ps, max_pages)):
            e = self._map.get(tuple(ids[:(i + 1) * ps]))
            if e is None:
                break
            e["last"] = self._tick()
            pages.append(e["page"])
        return pages

    def register(self, ids: Sequence[int], stream_pages: Sequence[int],
                 ps: int, pool: PagePool) -> None:
        """Record every full page of ``ids`` (pages beyond the last full
        one are mutable — never registered). Each new entry takes its own
        pool reference."""
        for i in range(len(ids) // ps):
            key = tuple(ids[:(i + 1) * ps])
            if key not in self._map:
                pool.share([stream_pages[i]])
                self._map[key] = {"page": stream_pages[i],
                                  "last": self._tick()}

    def evict_one(self, pool: PagePool) -> bool:
        """Free the LRU entry whose page no live stream holds."""
        best = None
        for key, e in self._map.items():
            if pool.refcount(e["page"]) == 1 and \
                    (best is None or e["last"] < self._map[best]["last"]):
                best = key
        if best is None:
            return False
        pool.free([self._map.pop(best)["page"]])
        return True

    def alloc(self, pool: PagePool, n: int) -> Optional[List[int]]:
        """pool.alloc with LRU cache eviction under pressure."""
        while True:
            got = pool.alloc(n)
            if got is not None or not self.evict_one(pool):
                return got


class PagedEngine:
    """Slot scheduler over the paged decode step.

    ``serve()`` runs every prompt to completion (order-preserving outputs,
    per-request caps) with KV memory bounded by ``num_pages`` and
    recompute preemption when the pool runs dry. ``num_pages >=
    ceil(max_len / page_size)`` is required so a lone stream can always
    run to max_len. ``cache_dtype``: the pool's dtype, the model's when
    None, or ``torch.int8`` (prefill then runs over a bf16 cache that is
    quantized at the page scatter). ``device`` defaults to CUDA and
    raises without it.

    ``prefill_chunk``: chunked prefill — a longer prompt prefills in
    pieces of at most this many (page-aligned) tokens, one piece a
    scheduler pass while it heads the queue, so live slots get a decode
    chunk between the pieces (None: whole prompts). ``chunk_exit_free``: a decode chunk returns once this many
    slots retired inside it while requests queue (None/0: chunks run to
    the boundary). ``admit_batch_max_width``: fresh prompts up to this
    page-aligned width prefill in batches, longer ones one by one.
    ``per_request_sampling``: the state carries a [B, 4] row of
    (temperature, top_p, repetition penalty, min_tokens) per slot, filled
    from ``serve(sampling_per_request=...)``; top_k and RAS stay global.
    ``return_logprobs``: each generated token's logprob under the
    sampler's closed-form output distribution is kept
    (``request_logprobs``, ``on_logprobs``). ``admission_policy``: who is
    seated first under contention — "fifo" (arrival order),
    "shortest_job" (remaining budget), "shortest_prompt" (prompt length)
    or "deadline" (earliest TTFT deadline first); ties keep arrival
    order. ``native_runtime``: the allocator and prefix registry — None:
    the C++ runtime if it builds (``SDT_NATIVE=0`` turns it off), True:
    the C++ runtime or raise, False: the Python twins."""

    stateful = False   # generate() takes the full context; no caller state

    def __init__(self, model: qwen3.Qwen3, cfg: Qwen3Config,
                 sp: SamplingParams, slots: int = 8, max_len: int = 4096,
                 num_pages: Optional[int] = None, page_size: int = 128,
                 chunk_steps: int = 32, seed: int = 0,
                 prefix_sharing: bool = True, device="cuda",
                 prefill_chunk: Optional[int] = None, mesh=None,
                 native_runtime: Optional[bool] = None,
                 per_request_sampling: bool = False,
                 return_logprobs: bool = False,
                 admission_policy: str = "fifo",
                 chunk_exit_free: Optional[int] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 admit_batch_max_width: int = 1024):
        if admission_policy not in ("fifo", "shortest_job",
                                    "shortest_prompt", "deadline"):
            raise ValueError(f"unknown admission_policy "
                             f"{admission_policy!r}")
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        self._tp, self._dp_group = 1, None
        self.local_slots, self.row0 = slots, 0
        if mesh is not None:
            dp, tp = mesh.dp, mesh.tp
            if qwen3.pipelined(model):
                raise ValueError("PagedEngine runs every layer on each "
                                 "rank: pass a model without "
                                 "pp_microbatches (its pp and sp ranks "
                                 "serve replicas, as JAX's engine "
                                 "replicates over pp and sp)")
            if slots % dp != 0:
                raise ValueError(f"slots={slots} not divisible by dp={dp}")
            if cfg.num_key_value_heads % tp != 0:
                raise ValueError(
                    f"KV heads {cfg.num_key_value_heads} not divisible "
                    f"by tp={tp}")
            # a quantized model replicates whole (sharding.shard_params):
            # its pool keeps every head
            if getattr(model, "mesh", None) is not None:
                self._tp = model.mesh.tp
            self._dp_group = mesh.group("dp")
            self.local_slots = slots // dp
            self.row0 = mesh.index("dp") * self.local_slots
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        # the shapes of this rank's KV heads (pool, prefill caches)
        self._kv_cfg = dataclasses.replace(
            cfg, num_key_value_heads=cfg.num_key_value_heads // self._tp)
        self.model = model
        self.cfg = cfg
        self.sp = sp
        self.slots = slots
        self.max_len = max_len
        self.ps = page_size
        self.max_pages = _ceil_div(max_len, page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else slots * self.max_pages)
        if self.num_pages < self.max_pages:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold one max_len stream "
                f"({self.max_pages} pages)")
        self.chunk_steps = chunk_steps
        self.chunk_exit_free = chunk_exit_free
        self.admit_batch_max_width = admit_batch_max_width
        self.per_request_sampling = per_request_sampling
        self.return_logprobs = return_logprobs
        self.request_logprobs: List[Optional[List[float]]] = []
        self.admission_policy = admission_policy
        # the pool holds the model dtype (the bf16/fp32 decode kernel takes
        # one dtype for q and pool) or int8; the contiguous prefill cache
        # of an int8 pool is bf16 (quantized at the page scatter)
        self.cache_dtype = (cfg.torch_dtype if cache_dtype is None
                            else cache_dtype)
        self._tmp_cache_dtype = (torch.bfloat16
                                 if self.cache_dtype == torch.int8
                                 else self.cache_dtype)
        self.prefix_sharing = prefix_sharing
        # page-aligned, so partial pages never exist
        if prefill_chunk is not None:
            prefill_chunk = max(page_size,
                                (prefill_chunk // page_size) * page_size)
        self.prefill_chunk = prefill_chunk
        if native_runtime is None and os.environ.get("SDT_NATIVE",
                                                     "1") == "0":
            native_runtime = False
        self.native_runtime = native_runtime
        self.runtime: Optional[str] = None   # "native" or "python", at serve
        self._decode = make_paged_decode_fn(sp, self._dp_group)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._draws = (self._generator if self._dp_group is None else
                       RowDraws(self._generator, slots, self.row0))
        # persistent serving state (created lazily on first serve())
        self._state: Optional[PagedState] = None
        self._pool: Optional[PagePool] = None
        self._registry: Optional[PrefixRegistry] = None

    def _make_runtime(self):
        """(page pool, prefix registry): the native C++ runtime
        (``native/serving.py``) when it builds, else the Python twins.
        Both behave identically (tested); the trie walks O(n) tokens per
        match/register where the Python map hashes every full prefix
        (O(n^2/ps) per admission). Sets ``self.runtime``."""
        if self.native_runtime is not False:
            from speech_distill_tpu_torch.native import serving
            if serving.available():
                self.runtime = "native"
                return (serving.NativePagePool(self.num_pages),
                        serving.NativePrefixRegistry())
            if self.native_runtime is True:     # explicitly requested
                raise RuntimeError(f"native serving runtime unavailable: "
                                   f"{serving.unavailable_reason()}")
        self.runtime = "python"
        return PagePool(self.num_pages), PrefixRegistry()

    def _default_samp(self) -> List[float]:
        """Engine-global sampling params as a [4] row (the per-request
        default when a request specifies nothing)."""
        return [float(self.sp.temperature), float(self.sp.top_p),
                float(self.sp.repetition_penalty), float(self.sp.min_tokens)]

    def _local(self, b: int) -> Optional[int]:
        """Slot ``b``'s row in this rank's state, None on another dp
        rank's."""
        lb = b - self.row0
        return lb if 0 <= lb < self.local_slots else None

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of a state tensor (dp ranks in order)."""
        return comm.all_gather(t, self._dp_group)

    def new_state(self) -> PagedState:
        B, V, dev = self.local_slots, self.cfg.vocab_size, self.device
        i64 = dict(dtype=torch.int64, device=dev)
        return PagedState(
            tokens=torch.zeros((B, self.max_len), **i64),
            length=torch.zeros((B,), **i64),
            pool=PagedKVCache.create(self._kv_cfg, self.num_pages, self.ps,
                                     self.cache_dtype, dev),
            block_tables=torch.zeros((B, self.max_pages), dtype=torch.int32,
                                     device=dev),
            last_logits=torch.zeros((B, V), dtype=torch.float32, device=dev),
            presence=torch.zeros((B, V), dtype=torch.bool, device=dev),
            num_generated=torch.zeros((B,), **i64),
            cap=torch.zeros((B,), **i64),
            finished=torch.ones((B,), dtype=torch.bool, device=dev),
            samp=(torch.tensor(self._default_samp(), dtype=torch.float32,
                               device=dev).repeat(B, 1)
                  if self.per_request_sampling else None),
            logps=(torch.zeros((B, self.max_len), dtype=torch.float32,
                               device=dev)
                   if self.return_logprobs else None))

    @staticmethod
    def _scatter_impl(pool: PagedKVCache, tmp_k, tmp_v, page_ids) -> None:
        """Install a contiguous prefill cache [L, B, W, KV, Dh] into
        ``len(page_ids)`` pool pages (len(page_ids) == B * W/page_size;
        rows flatten page-major, so batched admission scatters every row's
        pages in ONE update). An int8 pool quantizes here, per token per
        head, so the result does not depend on how prefill was batched."""
        L, B, W, KV, Dh = tmp_k.shape
        n = page_ids.shape[0]
        ps = (B * W) // n
        kk = tmp_k.reshape(L, n, ps, KV, Dh).transpose(2, 3)
        vv = tmp_v.reshape(L, n, ps, KV, Dh).transpose(2, 3)
        if pool.quantized:
            kk, ksc = quantize_kv(kk)
            vv, vsc = quantize_kv(vv)
            pool.ks[:, page_ids] = ksc
            pool.vs[:, page_ids] = vsc
        pool.k[:, page_ids] = kk.to(pool.k.dtype)
        pool.v[:, page_ids] = vv.to(pool.v.dtype)

    @staticmethod
    def _gather_impl(pool: PagedKVCache, page_ids,
                     total_w: int) -> qwen3.KVCache:
        """Assemble a contiguous B=1 prefill cache [L, 1, total_w, KV, Dh]
        from ``len(page_ids)`` shared pool pages (the prefix-cache hit
        path: the suffix then prefills on top of it). An int8 pool
        dequantizes here to bf16: the suffix attends over what decode
        attends over."""
        L, _, KV, ps, Dh = pool.k.shape
        m = page_ids.shape[0]

        def gx(a, scl):
            g = a[:, page_ids]                         # [L, m, KV, ps, Dh]
            if scl is not None:
                g = (g.float() * scl[:, page_ids][..., None]).to(
                    torch.bfloat16)
            g = g.transpose(2, 3).reshape(L, 1, m * ps, KV, Dh)
            out = torch.zeros((L, 1, total_w, KV, Dh), dtype=g.dtype,
                              device=a.device)
            out[:, :, :m * ps] = g
            return out
        return qwen3.KVCache(gx(pool.k, pool.ks), gx(pool.v, pool.vs),
                             m * ps)

    def _prefill_pages(self, state: PagedState, arr, mask, pages, *,
                       m: int, width: int) -> torch.Tensor:
        """Gather-or-create -> forward of the fresh tokens ``arr`` ->
        scatter of the fresh pages. The first ``m`` of ``pages`` already
        hold this prompt's KV (a prefix hit or earlier prefill pieces): the
        fresh tokens attend over them, and only ``pages[m:]`` are written.
        Returns the fresh tokens' hidden states [1, width - m*ps, D]."""
        pre = m * self.ps
        if m > 0:
            tmp = self._gather_impl(state.pool, pages[:m], width)
        else:
            tmp = qwen3.KVCache.create(self._kv_cfg, 1, width,
                                       self._tmp_cache_dtype, self.device)
        self.n_prefill_forwards += 1
        hidden, tmp = qwen3.forward(self.model, arr, attention_mask=mask,
                                    cache=tmp, return_hidden=True)
        self._scatter_impl(state.pool, tmp.k[:, :, pre:], tmp.v[:, :, pre:],
                           pages[m:])
        return hidden

    def _admit(self, state: PagedState, b: int, arr, mask, pages, n: int,
               token_row, presence_row, n_gen0: int, cap: int, samp_row, *,
               m: int, width: int) -> None:
        """Prefill (:meth:`_prefill_pages`) and slot insert, for one
        slot. On a mesh every rank prefills (the pages live on every dp
        rank) and the slot's dp rank inserts."""
        hidden = self._prefill_pages(state, arr, mask, pages, m=m,
                                     width=width)
        # unembed ONLY the last prompt position
        pre = m * self.ps
        h_row = hidden[:, n - pre - 1:n - pre]                 # [1, 1, D]
        logits = qwen3.unembed(self.model, h_row)[0, 0].float()
        b = self._local(b)
        if b is None:
            return
        state.tokens[b] = token_row
        state.length[b] = n
        state.last_logits[b] = logits
        state.presence[b] = presence_row
        state.num_generated[b] = n_gen0
        state.cap[b] = cap
        state.finished[b] = False
        if state.samp is not None:
            state.samp[b] = torch.as_tensor(samp_row, dtype=torch.float32)
        if state.logps is not None:
            # prompt columns carry no logprobs; a resumed request's earlier
            # logprobs were harvested at preemption
            state.logps[b] = 0.0

    def _prefill_part(self, state: PagedState, ids: Sequence[int],
                      pages: List[int], m: int) -> None:
        """Chunked-prefill piece: prefill ``ids[m*ps : len(pages)*ps]``
        over the ``m`` pages already holding the prompt's first tokens and
        write the fresh pages, with no slot insert. The final piece goes
        through the normal admission with these pages as its shared
        prefix, so chunked and whole-prompt prefill compute the same KV
        (int8 pools quantize per token, so the STORED pages do not depend
        on the chunking, but a later piece attends over the dequantized
        earlier pages)."""
        width = len(pages) * self.ps
        arr = self._dev(np.asarray(ids[m * self.ps:width])[None])
        self._prefill_pages(state, arr, None, self._dev(pages), m=m,
                            width=width)

    def _admit_batch(self, state: PagedState, bs, arrs, pages_flat, ns,
                     caps, samps, *, width: int) -> None:
        """Batched admission: ``n`` FRESH (no shared prefix, no resumed
        generation) requests of one width bucket prefill as a single
        [n, width] forward + ONE page scatter + vectorized slot inserts.
        Rows are independent (per-row masks), so batched == sequential.
        On a mesh every rank prefills and inserts the rows of its slots."""
        n = arrs.shape[0]
        masks = (torch.arange(width, device=self.device)[None]
                 < ns[:, None]).to(torch.int32)
        tmp = qwen3.KVCache.create(self._kv_cfg, n, width,
                                   self._tmp_cache_dtype, self.device)
        self.n_prefill_forwards += 1
        hidden, tmp = qwen3.forward(self.model, arrs, attention_mask=masks,
                                    cache=tmp, return_hidden=True)
        self._scatter_impl(state.pool, tmp.k, tmp.v, pages_flat)
        rows = torch.arange(n, device=self.device)
        h_rows = hidden[rows, ns - 1][:, None]                 # [n, 1, D]
        logits = qwen3.unembed(self.model, h_rows)[:, 0].float()
        if self._dp_group is not None:
            mine = (bs >= self.row0) & (bs < self.row0 + self.local_slots)
            bs, logits, arrs, ns = (bs[mine] - self.row0, logits[mine],
                                    arrs[mine], ns[mine])
            caps, samps = caps[mine], samps[mine]
        state.last_logits[bs] = logits
        state.tokens[bs] = 0
        state.tokens[bs, :width] = arrs
        state.length[bs] = ns
        state.presence[bs] = False
        state.num_generated[bs] = 0
        state.cap[bs] = caps
        state.finished[bs] = False
        if state.samp is not None:
            state.samp[bs] = samps
        if state.logps is not None:
            state.logps[bs] = 0.0

    def _dev(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _prefill_slot(self, state: PagedState, b: int, ids: Sequence[int],
                      pages: List[int], prev_gen: Sequence[int],
                      shared: int = 0, cap: int = 1 << 30,
                      samp=None) -> None:
        """Prefill slot ``b``. The first ``shared`` entries of ``pages``
        are prefix-cache hits (or chunked-prefill pieces) already holding
        this prompt's KV: only the suffix runs through the model (attending
        over the gathered shared pages), and only the fresh pages are
        scattered back."""
        n = len(ids)
        if n >= self.max_len:
            raise ValueError(f"prompt length {n} leaves no room to "
                             f"generate (max_len={self.max_len})")
        width = _ceil_div(n, self.ps) * self.ps
        pre = shared * self.ps
        arr = np.zeros((1, width - pre), np.int64)
        arr[0, :n - pre] = ids[pre:]
        mask = (np.arange(width) < n).astype(np.int32)[None]
        token_row = np.zeros((self.max_len,), np.int64)
        token_row[:n] = ids
        # resume parity after preemption: previously generated tokens stay
        # in the repetition-penalty set and in the request-total counter
        presence_row = np.zeros((self.cfg.vocab_size,), bool)
        presence_row[list(prev_gen)] = True
        self._admit(state, b, self._dev(arr), self._dev(mask, torch.int32),
                    self._dev(pages[:width // self.ps]), n,
                    self._dev(token_row), self._dev(presence_row, torch.bool),
                    len(prev_gen), min(cap, 1 << 30),
                    samp or self._default_samp(), m=shared, width=width)

    def _flush_admissions(self, state: PagedState, pending,
                          slot_pages) -> None:
        """Run the deferred zero-shared-prefix prefills: group by width
        bucket, flush each group in batch sizes {8, 4, 2} (greedy),
        singles through the per-slot path."""
        groups: dict = {}
        for b, r in pending:
            width = _ceil_div(len(r["ids"]), self.ps) * self.ps
            if r["gen"] or width > self.admit_batch_max_width:
                # single-row path for resumed-after-preemption rows (they
                # carry a presence set + generation count) and LONG prompts
                self._prefill_slot(state, b, r["ids"], slot_pages[b],
                                   r["gen"], 0, cap=r["cap"],
                                   samp=r.get("samp"))
                continue
            groups.setdefault(width, []).append((b, r))
        for width, jobs in groups.items():
            i = 0
            while i < len(jobs):
                sz = next(s for s in (8, 4, 2, 1) if len(jobs) - i >= s)
                chunk = jobs[i:i + sz]
                i += sz
                if sz == 1:
                    b, r = chunk[0]
                    self._prefill_slot(state, b, r["ids"], slot_pages[b],
                                       r["gen"], 0, cap=r["cap"],
                                       samp=r.get("samp"))
                    continue
                self.n_batched_prefills += sz
                self._prefill_batch(state, chunk, slot_pages, width)

    def _prefill_batch(self, state: PagedState, jobs, slot_pages,
                       width: int) -> None:
        """Pack ``jobs`` (list of (slot, request), all fresh) into one
        batched admission (see _admit_batch)."""
        n = len(jobs)
        npg = width // self.ps
        arrs = np.zeros((n, width), np.int64)
        bs = np.empty(n, np.int64)
        ns = np.empty(n, np.int64)
        caps = np.empty(n, np.int64)
        samps = np.empty((n, 4), np.float32)
        pages_flat = np.empty(n * npg, np.int64)
        for i, (b, r) in enumerate(jobs):
            ids = r["ids"]
            ln = len(ids)
            if ln >= self.max_len:
                raise ValueError(f"prompt length {ln} leaves no room to "
                                 f"generate (max_len={self.max_len})")
            arrs[i, :ln] = ids
            bs[i] = b
            ns[i] = ln
            caps[i] = min(r["cap"], 1 << 30)
            samps[i] = r.get("samp") or self._default_samp()
            pages_flat[i * npg:(i + 1) * npg] = slot_pages[b][:npg]
        self._admit_batch(state, self._dev(bs), self._dev(arrs),
                          self._dev(pages_flat), self._dev(ns),
                          self._dev(caps), self._dev(samps, torch.float32),
                          width=width)

    # ------------------------------------------------------------------
    # Scheduler
    # ------------------------------------------------------------------

    def _pages_needed(self, resident: int) -> int:
        """Pages to cover ``resident`` tokens plus one decode chunk."""
        horizon = min(resident + self.chunk_steps + 1, self.max_len)
        return _ceil_div(horizon, self.ps)

    def generate(self, ids: Sequence[int], max_new: Optional[int] = None
                 ) -> dict:
        """Single-request API, STATELESS: pass the full context each call.
        Multi-turn sessions stay incremental through the persistent prefix
        cache (a finished request registers its full prompt+generated
        pages). Returns "logprobs" too when the engine keeps them."""
        gen = self.serve([list(ids)], max_new=max_new)[0]
        out = {"token_ids": gen, "state": None}
        if self.return_logprobs:
            out["logprobs"] = self.request_logprobs[0]
        return out

    def _request_samp(self, overrides: Optional[dict]
                      ) -> Optional[List[float]]:
        """A request's [4] sampling row from its overrides (None: the
        engine's)."""
        if not overrides:
            return None
        o = dict(overrides)
        d = self._default_samp()
        samp = [float(o.pop("temperature", d[0])),
                float(o.pop("top_p", d[1])),
                float(o.pop("repetition_penalty", d[2])),
                float(o.pop("min_tokens", d[3]))]
        if o:
            raise ValueError(f"unknown sampling overrides: {sorted(o)} "
                             f"(top_k/RAS are engine-global)")
        return samp

    @torch.no_grad()
    def serve(self, prompts: Sequence[Sequence[int]],
              max_new: Optional[int] = None,
              max_new_per_request: Optional[Sequence[int]] = None,
              on_tokens=None, on_logprobs=None, on_chunk=None,
              sampling_per_request: Optional[Sequence[Optional[dict]]]
              = None,
              ttft_deadline_s: Optional[float] = None,
              deadline_per_request: Optional[Sequence[Optional[float]]]
              = None,
              arrival_per_request: Optional[Sequence[float]] = None
              ) -> List[List[int]]:
        """Run every prompt to completion through the slot pool; returns
        generated token ids per prompt (order-preserving).

        ``on_tokens(rid, new_token_ids, done)``: optional streaming
        callback invoked at decode-chunk granularity with each request's
        newly generated ids, in order, exactly once per token (preemption
        and resume included). The concatenation of a request's callbacks
        equals its entry in the returned outputs.

        With ``return_logprobs`` the engine keeps each generated token's
        logprob: ``self.request_logprobs[rid]`` holds one float per token
        of ``outputs[rid]`` (exact across preemption). ``on_logprobs(rid,
        new_logprobs, done)`` streams them, aligned one to one with the
        ``on_tokens`` call of the same chunk (it needs ``on_tokens``).

        ``on_chunk()``: called once a scheduler pass, after every
        per-request callback of the chunk (the hook for one batched
        downstream tick); its host time goes to
        ``phase_seconds["downstream"]``.

        ``sampling_per_request``: per-request overrides of temperature,
        top_p, repetition_penalty and min_tokens (needs
        ``per_request_sampling``).

        ``ttft_deadline_s`` / ``deadline_per_request``: TTFT deadlines
        (seconds from arrival). A queued request whose deadline passes
        before it produced any token is shed: ``outputs[rid] == []``,
        ``request_metrics[rid]["shed"]``, ``on_tokens(rid, [], True)``
        closes its stream, and its chunked-prefill pages return to the
        pool. ``self.shed_requests`` counts them.

        ``arrival_per_request``: open-loop arrivals, seconds from the
        start of the serve at which each request becomes visible to the
        scheduler; its TTFT/e2e clocks and deadline start then. With
        nothing queued and nothing resident the scheduler sleeps until
        the next arrival."""
        cap_default = max_new or self.sp.max_tokens
        if on_logprobs is not None and not self.return_logprobs:
            raise ValueError("on_logprobs needs "
                             "PagedEngine(return_logprobs=True)")
        if on_logprobs is not None and on_tokens is None:
            raise ValueError("on_logprobs is a companion callback: pass "
                             "on_tokens too (emission is aligned to it)")
        if sampling_per_request is not None \
                and not self.per_request_sampling:
            raise ValueError("sampling_per_request needs "
                             "PagedEngine(per_request_sampling=True)")
        t_serve0 = time.perf_counter()
        queue = _AdmissionQueue(self.admission_policy)
        pending_arrivals: List[dict] = []      # future arrivals, by t_arr
        for rid, p in enumerate(prompts):
            dl = (deadline_per_request[rid]
                  if deadline_per_request is not None else ttft_deadline_s)
            arr = (float(arrival_per_request[rid] or 0.0)
                   if arrival_per_request is not None else 0.0)
            t_arr = t_serve0 + arr
            r = {"rid": rid, "ids": list(p), "plen0": len(p),
                 "cap": (max_new_per_request[rid]
                         if max_new_per_request is not None
                         else cap_default),
                 "samp": self._request_samp(
                     sampling_per_request[rid]
                     if sampling_per_request is not None else None),
                 "gen": [], "lps": [], "n_emitted": 0,
                 "t_enq": t_arr, "t_arr": t_arr,
                 "dl": (t_arr + dl if dl is not None else None)}
            if arr <= 0.0:
                queue.append(r)
            else:
                pending_arrivals.append(r)
        pending_arrivals.sort(key=lambda r: (r["t_arr"], r["rid"]))
        any_deadlines = (ttft_deadline_s is not None
                         or (deadline_per_request is not None
                             and any(d is not None
                                     for d in deadline_per_request)))
        outputs: List[Optional[List[int]]] = [None] * len(prompts)
        self.request_logprobs = [None] * len(prompts)
        self.preemptions = 0               # serve-level metrics
        self.shed_requests = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        # wall-time anatomy of the scheduler loop (decode_sync includes the
        # device chunk; everything else is host time)
        self.phase_seconds = {"grow": 0.0, "admit": 0.0,
                              "decode_sync": 0.0, "retire": 0.0,
                              "downstream": 0.0}
        self.n_chunks = 0
        self.n_decode_steps = 0
        self.n_exit_syncs = 0
        self.n_prefills = 0
        self.n_prefill_chunks = 0
        self.n_batched_prefills = 0
        self.n_prefill_forwards = 0        # model forwards of admission
        # per-request latency records, chunk-granularity: ttft = arrival ->
        # end of the first chunk that produced this request's token(s);
        # e2e = arrival -> retire
        self.request_metrics: List[Optional[dict]] = [None] * len(prompts)
        # pool, registry and device state PERSIST across serve() calls
        if self._state is None:
            self._pool, self._registry = self._make_runtime()
            self._state = self.new_state()
        registry = self._registry
        pool = self._pool
        state = self._state
        # if serve raises mid-loop, leaving _state None makes the next call
        # rebuild pool + registry + state as a consistent trio
        self._state = None
        meta: List[Optional[dict]] = [None] * self.slots
        slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        join_seq = 0
        bt = np.zeros((self.slots, self.max_pages), np.int32)

        def release(b):
            pool.free(slot_pages[b])
            slot_pages[b] = []
            bt[b, :] = 0
            meta[b] = None

        # host mirrors of state.length / tokens / logps, refreshed once per
        # chunk
        lengths_h = np.zeros((self.slots,), np.int64)
        tokens_h = np.zeros((self.slots, self.max_len), np.int64)
        lps_h = np.zeros((self.slots, self.max_len), np.float32)

        def emit(r, new, new_lps, done):
            if on_tokens is not None:
                if on_logprobs is not None:
                    on_logprobs(r["rid"], new_lps, done)
                on_tokens(r["rid"], new, done)

        def finish(r, t_done):
            outputs[r["rid"]] = r["gen"]
            if self.return_logprobs:
                self.request_logprobs[r["rid"]] = r["lps"]
            lo = r["n_emitted"]
            emit(r, r["gen"][lo:], r["lps"][lo:], True)
            r["n_emitted"] = len(r["gen"])
            self.request_metrics[r["rid"]] = {
                "ttft_s": r.get("t_first", t_done) - r["t_enq"],
                "e2e_s": t_done - r["t_enq"],
                "n_prompt": r["plen0"], "n_gen": len(r["gen"])}

        def harvest(r, b, n):
            """Append the first ``n`` tokens (and logprobs) this residency
            generated in slot ``b`` to the request."""
            s0 = r["plen"]
            r["gen"] += tokens_h[b, s0:s0 + n].tolist()
            if self.return_logprobs:
                r["lps"] += lps_h[b, s0:s0 + n].tolist()

        def preempt(b):
            """Recompute preemption: fold generated tokens back into the
            request and re-queue it at the front."""
            self.preemptions += 1
            r = meta[b]
            made = int(lengths_h[b]) - r["plen"]
            keep = min(len(r["gen"]) + made, r["cap"]) - len(r["gen"])
            harvest(r, b, keep)
            if len(r["gen"]) >= r["cap"]:
                finish(r, time.perf_counter())   # cap reached mid-chunk
            else:
                r["ids"] = r["ids"] + r["gen"][len(r["gen"]) - keep:]
                queue.appendleft(r)
            release(b)
            lb = self._local(b)
            if lb is not None:
                state.finished[lb] = True

        world = self.mesh.group() if self.mesh is not None else None

        def clock() -> float:
            """The clock of the time-driven decisions (arrivals,
            shedding): on a mesh rank 0's time since its serve began, on
            each rank's own start, so every rank decides alike."""
            t = time.perf_counter()
            if world is None:
                return t
            dt = comm.broadcast(torch.tensor([t - t_serve0],
                                             dtype=torch.float64,
                                             device=self.device), world)
            return t_serve0 + float(dt)

        while queue or pending_arrivals or any(m is not None for m in meta):
            t_phase = time.perf_counter()
            # 0. open-loop arrivals join the queue; with nothing queued
            # and nothing resident, sleep to the next one
            if pending_arrivals:
                t_dec = clock()
                if (not queue and all(m is None for m in meta)
                        and pending_arrivals[0]["t_arr"] > t_dec):
                    time.sleep(pending_arrivals[0]["t_arr"] - t_dec)
                    t_dec = clock()
                    t_phase = time.perf_counter()
                while (pending_arrivals
                       and pending_arrivals[0]["t_arr"] <= t_dec):
                    queue.append(pending_arrivals.pop(0))
            # 1. grow live slots (oldest joins first — they keep latency)
            order = sorted((b for b in range(self.slots)
                            if meta[b] is not None),
                           key=lambda b: meta[b]["join"])
            for b in order:
                if meta[b] is None:
                    continue
                need = self._pages_needed(int(lengths_h[b])) \
                    - len(slot_pages[b])
                while need > 0:
                    got = registry.alloc(pool, need)
                    if got is not None:
                        start = len(slot_pages[b])
                        slot_pages[b].extend(got)
                        bt[b, start:start + len(got)] = got
                        break
                    victims = [j for j in range(self.slots)
                               if j != b and meta[j] is not None]
                    if not victims:
                        # last resort: reclaim the pages of half-prefilled
                        # queued requests (they prefill again later)
                        if any(rq.get("pf") for rq in queue):
                            for rq in queue:
                                if rq.get("pf"):
                                    pool.free(rq.pop("pf"))
                            continue
                        raise RuntimeError(
                            "page pool exhausted by a single stream — "
                            "increase num_pages")
                    preempt(max(victims, key=lambda j: meta[j]["join"]))

            t_now = time.perf_counter()
            self.phase_seconds["grow"] += t_now - t_phase
            t_phase = t_now

            # 1b. load shedding, BEFORE any prefill is spent on doomed work
            if any_deadlines:
                for r in queue.shed_expired(clock()):
                    if r.get("pf"):
                        pool.free(r.pop("pf"))
                    self.shed_requests += 1
                    outputs[r["rid"]] = []
                    if self.return_logprobs:
                        self.request_logprobs[r["rid"]] = []
                    self.request_metrics[r["rid"]] = {
                        "shed": True, "wait_s": t_now - r["t_enq"],
                        "n_prompt": r["plen0"], "n_gen": 0}
                    emit(r, [], [], True)

            # 2a. chunked prefill: advance the head-of-queue request by at
            # most one prefill_chunk of page-aligned prompt tokens a pass.
            # The pieces accumulate in r["pf"]; the final piece goes
            # through the admission below with r["pf"] as shared prefix.
            if self.prefill_chunk is not None and queue:
                r = queue[0]
                n = len(r["ids"])
                pf = r.setdefault("pf", [])
                if not pf and self.prefix_sharing:
                    hits = registry.match(r["ids"], self.ps,
                                          (n - 1) // self.ps)
                    pool.share(hits)           # the request's own reference
                    pf.extend(hits)
                    if hits:
                        self.prefix_hits += 1
                        self.prefix_hit_tokens += len(hits) * self.ps
                if n - len(pf) * self.ps > self.prefill_chunk:
                    # fresh pages this piece; >= 1 token stays for admission
                    cp = min(self.prefill_chunk // self.ps,
                             (n - 1) // self.ps - len(pf))
                    got = registry.alloc(pool, cp) if cp > 0 else None
                    if got is not None:
                        self._prefill_part(state, r["ids"], pf + got,
                                           len(pf))
                        pf.extend(got)
                        self.n_prefill_chunks += 1
                        if self.prefix_sharing:
                            registry.register(r["ids"][:len(pf) * self.ps],
                                              pf, self.ps, pool)

            # 2. admit queued requests into free slots. Allocation and
            # bookkeeping stay sequential (pool state feeds each next
            # decision); the prefill of zero-shared-prefix admissions is
            # deferred and flushed in same-width batches. Prefix-hit rows
            # take the single-row gather + suffix path.
            pending = []                       # (slot, request), shared==0
            for b in range(self.slots):
                if meta[b] is not None or not queue:
                    continue
                r = queue[0]
                n = len(r["ids"])
                if "pf" in r:                  # chunked-prefill pages
                    if n - len(r["pf"]) * self.ps > (self.prefill_chunk
                                                     or n):
                        break                  # still mid-prefill
                    shared = r["pf"]
                elif self.prefill_chunk is not None and n > self.prefill_chunk:
                    # it became the head in this loop: 2a prefills it in
                    # pieces from the next pass (the JAX engine prefills
                    # it whole here, unbounded by prefill_chunk)
                    break
                else:
                    shared = []
                    if self.prefix_sharing:
                        # cap so >= 1 suffix token remains to prefill
                        shared = registry.match(r["ids"], self.ps,
                                                (n - 1) // self.ps)
                        pool.share(shared)     # the stream's own reference
                got = registry.alloc(pool, self._pages_needed(n)
                                     - len(shared))
                if got is None:
                    if "pf" not in r:
                        pool.free(shared)
                    break                      # pool full; retry next chunk
                queue.popleft()
                if "pf" not in r and shared:
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += len(shared) * self.ps
                r.pop("pf", None)
                slot_pages[b] = shared + got
                bt[b, :len(slot_pages[b])] = slot_pages[b]
                bt[b, len(slot_pages[b]):] = 0
                if shared:
                    # the matched pages may have been registered earlier in
                    # this pass by a request whose prefill is still pending:
                    # write them before gathering them. (The JAX engine
                    # gathers first and reads unwritten pages there.)
                    self._flush_admissions(state, pending, slot_pages)
                    pending = []
                    self._prefill_slot(state, b, r["ids"], slot_pages[b],
                                       r["gen"], len(shared), cap=r["cap"],
                                       samp=r.get("samp"))
                else:
                    pending.append((b, r))
                self.n_prefills += 1
                if self.prefix_sharing:
                    registry.register(r["ids"], slot_pages[b], self.ps, pool)
                meta[b] = {**r, "plen": n, "join": join_seq,
                           "ngen0": len(r["gen"])}
                join_seq += 1
                lengths_h[b] = n
            self._flush_admissions(state, pending, slot_pages)

            t_now = time.perf_counter()
            self.phase_seconds["admit"] += t_now - t_phase
            t_phase = t_now

            # 3. one decode chunk. With requests still queued it exits once
            # enough slots retire to seat them (capped by chunk_exit_free);
            # with an empty queue it runs to the boundary (slots + 1 can
            # never be reached)
            state.block_tables.copy_(torch.from_numpy(
                bt[self.row0:self.row0 + self.local_slots]))
            if self.chunk_exit_free and queue:
                exit_free = max(1, min(self.chunk_exit_free, len(queue)))
            else:
                exit_free = self.slots + 1
            steps, tests = self._decode(self.model, state, self.chunk_steps,
                                        self._draws, exit_free)
            self.n_chunks += 1
            self.n_decode_steps += steps
            self.n_exit_syncs += tests

            # 4. retire finished slots (host mirrors carry into the next
            # grow pass). Caps are enforced on the device, so `finished`
            # is exact.
            lengths_h = self._gather(state.length).cpu().numpy()
            ngen = self._gather(state.num_generated).cpu().numpy()
            fin = self._gather(state.finished).cpu().numpy()
            tokens_h = self._gather(state.tokens).cpu().numpy()
            if self.return_logprobs:
                lps_h = self._gather(state.logps).cpu().numpy()
            t_now = time.perf_counter()
            self.phase_seconds["decode_sync"] += t_now - t_phase
            t_phase = t_now
            for b in range(self.slots):
                r = meta[b]
                if r is None:
                    continue
                # first-token stamp (chunk granularity)
                if "t_first" not in r and int(ngen[b]) > r["ngen0"]:
                    r["t_first"] = t_now
                if on_tokens is not None:
                    # request-total ngen counts across preemptions; tokens
                    # before len(gen) came from a previous residency
                    total_now = min(int(ngen[b]), r["cap"])
                    if total_now > r["n_emitted"]:
                        lo, g = r["n_emitted"], len(r["gen"])
                        new = list(r["gen"][lo:min(total_now, g)])
                        new_lps = list(r["lps"][lo:min(total_now, g)])
                        if total_now > g:
                            s0 = r["plen"] + max(lo, g) - g
                            s1 = r["plen"] + total_now - g
                            new += tokens_h[b, s0:s1].tolist()
                            new_lps += lps_h[b, s0:s1].tolist()
                        r["n_emitted"] = total_now
                        emit(r, new, new_lps, False)
            for b in [b for b in range(self.slots)
                      if meta[b] is not None and fin[b]]:
                r = meta[b]
                harvest(r, b, min(int(ngen[b]), r["cap"]) - len(r["gen"]))
                finish(r, t_now)
                if self.prefix_sharing:
                    # register the full pages of prompt + GENERATED tokens,
                    # so a later context extending this one prefills only
                    # its new suffix
                    L = int(lengths_h[b])
                    registry.register(tokens_h[b, :L].tolist(),
                                      slot_pages[b], self.ps, pool)
                release(b)
            self.phase_seconds["retire"] += time.perf_counter() - t_phase
            if on_chunk is not None:
                t_phase = time.perf_counter()
                on_chunk()
                self.phase_seconds["downstream"] += (time.perf_counter()
                                                     - t_phase)
        self._state = state
        return outputs  # type: ignore[return-value]
