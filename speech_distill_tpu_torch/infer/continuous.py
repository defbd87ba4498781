"""Continuous batching: slot-based serving with mid-flight join and leave
(port of ``speech_distill_tpu/infer/continuous.py``).

A fixed number of decode slots share one decode step and one contiguous
KV cache [L, slots, max_len, KV, Dh]. When a stream finishes (EOS or its
own cap) its slot retires at once and the next queued prompt prefills
into it while the other slots keep decoding; finished rows do not burn
steps the way ``DecodeEngine.generate_batch``'s run-until-slowest batch
does.

* Slot b's tokens occupy cache columns [0, length_b) of row b: a retiring
  slot is recycled whole (no block table).
* Each row writes its K/V at its own column
  (``qwen3.forward(cache_positions=...)``).
* The decode runs in chunks of ``chunk_steps``, exiting early when every
  slot is finished; the host scheduler runs between chunks: retire
  finished slots, prefill queued prompts into free ones.
* Join and leave do not perturb other slots: the presence set, RAS
  window and K/V are per row (the generator is the state's, so the draws
  a row sees depend on its neighbours, as JAX's per-state key does).

An admission prefills into a fresh cache exactly one bucket wide, right
padded: at a flash width (>= 512, a multiple of 256) on CUDA it runs
K1-fwd. The chunk's exit test is one host read a step (JAX: a device
``while_loop``); dead rows write their token, presence and valid entries
back unchanged (JAX: ``mode="drop"``).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import Qwen3Config, SamplingParams
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.infer.engine import (DecodeState, is_eos,
                                                   new_decode_state,
                                                   sample_next_token,
                                                   write_live)
from speech_distill_tpu_torch.models import qwen3


def make_chunk_decode_fn(sp: SamplingParams,
                         win_size: Optional[int] = None):
    """``decode_chunk(model, state, n_steps) -> steps run``: up to
    ``n_steps`` continuous-batching steps on ``state``, in place (early
    exit when every slot is finished). Rows write their K/V at their own
    columns (``length``)."""
    win = win_size or sp.win_size
    eos_ids = tuple(sp.stop_token_ids)
    pad_id = eos_ids[0]

    def step(model, st: DecodeState) -> None:
        max_len = st.tokens.shape[1]
        tok = sample_next_token(sp, st, win, eos_ids, st.generator)
        live = ~st.finished & (st.length < max_len)
        token = torch.where(live, tok, pad_id)
        # contiguous per-slot rows: RoPE position == cache column == length
        col = st.length.clamp(max=max_len - 1)
        write_live(st.tokens, col[:, None], live, token)
        write_live(st.valid, col[:, None], live, torch.ones_like(live))
        write_live(st.presence, token[:, None], live, torch.ones_like(live))
        capped = live & (st.num_generated + 1 >= st.cap)
        st.finished |= ((live & is_eos(token, eos_ids)) | capped
                        | (st.length + 1 >= max_len))
        logits, st.cache = qwen3.forward(model, token[:, None],
                                         attention_mask=st.valid,
                                         cache=st.cache,
                                         cache_positions=col)
        st.last_logits = logits[:, -1].float()
        st.length += live
        st.num_generated += live

    def decode_chunk(model, st: DecodeState, n_steps: int) -> int:
        for i in range(n_steps):
            if bool(st.finished.all()):
                return i
            step(model, st)
        return n_steps

    return decode_chunk


class ContinuousEngine:
    """Slot scheduler over the chunked decode.

    ``serve(prompts)`` runs a workload through ``slots`` concurrent decode
    lanes: prompts queue, join a lane the moment one frees, and retire on
    EOS or their per-request cap. ``device`` defaults to CUDA and raises
    without it; the cache is ``cache_dtype`` (bf16 by default)."""

    def __init__(self, model: qwen3.Qwen3, cfg: Qwen3Config,
                 sp: SamplingParams, slots: int = 8, max_len: int = 4096,
                 prefill_bucket: int = 128, chunk_steps: int = 32,
                 seed: int = 0, cache_dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg
        self.sp = sp
        self.slots = slots
        self.max_len = max_len
        self.bucket = prefill_bucket
        self.chunk_steps = chunk_steps
        self.cache_dtype = cache_dtype
        self._decode = make_chunk_decode_fn(sp)
        self._generator = torch.Generator().manual_seed(seed)
        self.n_decode_steps = 0     # decode steps (each over every slot)

    def _bucketed(self, n: int) -> int:
        return min(self.max_len, -(-n // self.bucket) * self.bucket)

    def new_state(self) -> DecodeState:
        """Every slot idle (finished)."""
        return new_decode_state(self.cfg, self.slots, self.max_len,
                                self.cache_dtype, self.device,
                                self._generator, idle=True)

    def _admit(self, state: DecodeState, b: int, prompt: Sequence[int],
               cap: int) -> None:
        """Prefill ``prompt`` into a fresh cache one bucket wide (right
        padded), then install it in slot ``b``. The columns past the
        prompt are masked by ``valid`` until decode overwrites them."""
        n = len(prompt)
        width = self._bucketed(n)
        ids = np.zeros((1, width), np.int64)
        ids[0, :n] = prompt
        ids = torch.as_tensor(ids, device=self.device)
        tmp = qwen3.KVCache.create(self.cfg, 1, width, self.cache_dtype,
                                   self.device)
        mask = (torch.arange(width, device=self.device) < n)[None]
        hidden, tmp = qwen3.forward(self.model, ids, attention_mask=mask,
                                    cache=tmp, return_hidden=True)
        state.cache.k[:, b, :width] = tmp.k[:, 0]
        state.cache.v[:, b, :width] = tmp.v[:, 0]
        state.tokens[b] = 0
        state.tokens[b, :n] = ids[0, :n]
        state.valid[b] = False
        state.valid[b, :n] = True
        state.length[b] = n
        state.last_logits[b] = qwen3.unembed(
            self.model, hidden[:, n - 1:n])[0, 0].float()
        state.presence[b] = False
        state.num_generated[b] = 0
        state.cap[b] = cap
        state.finished[b] = False

    def _prefill_slot(self, state: DecodeState, b: int,
                      prompt: Sequence[int],
                      cap: int = 1 << 30) -> DecodeState:
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt length {len(prompt)} leaves no room "
                             f"to generate (max_len={self.max_len})")
        self._admit(state, b, prompt, min(cap, 1 << 30))
        return state

    def serve(self, prompts: Sequence[Sequence[int]],
              max_new: Optional[int] = None,
              max_new_per_request: Optional[Sequence[int]] = None
              ) -> List[List[int]]:
        """Run every prompt to completion through the slot pool; returns
        the generated ids per prompt, in the prompts' order."""
        cap_default = max_new or self.sp.max_tokens
        queue = deque(range(len(prompts)))
        outputs: List[Optional[List[int]]] = [None] * len(prompts)
        slot_req = [-1] * self.slots           # request id per slot
        slot_plen = [0] * self.slots
        slot_cap = [0] * self.slots
        state = self.new_state()

        while queue or any(r >= 0 for r in slot_req):
            for b in range(self.slots):        # fill free slots
                if slot_req[b] < 0 and queue:
                    rid = queue.popleft()
                    cap = (max_new_per_request[rid]
                           if max_new_per_request is not None
                           else cap_default)
                    state = self._prefill_slot(state, b, prompts[rid],
                                               cap=cap)
                    slot_req[b] = rid
                    slot_plen[b] = len(prompts[rid])
                    slot_cap[b] = cap

            self.n_decode_steps += self._decode(self.model, state,
                                                self.chunk_steps)

            # one host transfer for every slot's state (the caps are
            # enforced on the device, so `finished` is exact)
            B = self.slots
            host = torch.cat([state.num_generated, state.finished.long(),
                              state.tokens.reshape(-1)]).cpu().numpy()
            ngen, fin = host[:B], host[B:2 * B]
            toks = host[2 * B:].reshape(B, self.max_len)
            for b in range(self.slots):
                if slot_req[b] < 0 or not fin[b]:
                    continue
                n_keep = min(int(ngen[b]), slot_cap[b])
                start = slot_plen[b]
                outputs[slot_req[b]] = toks[b, start:start + n_keep].tolist()
                slot_req[b] = -1
        return outputs  # type: ignore[return-value]
