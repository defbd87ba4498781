"""Concurrent multi-session streaming TTS serving (port of
``speech_distill_tpu/infer/tts_serve.py``).

N sessions are served end to end at once: the paged LLM engine decodes
every session in one slot pool (``infer/paged.py``), and at every
decode-chunk boundary (the engine's ``on_chunk`` hook) the coordinator
runs one batched flow call and one batched vocoder call over the sessions
with fresh chunk-aligned tokens. The synthesis runs on the engine's
stream and reads mel and wav back to the host, so decode waits for it
during a tick.

Exactness: each session's synthesis is the computation of its
single-session :class:`StreamingTokenToWav` run on the same token stream
at the same tick cadence (the plan/apply stages are shared code). Batched
HiFT rows take each row's own NSF draws, so they match the B = 1 call;
batched flow rows match to float32 rounding (the matmul libraries pick
kernels by shape).

Shape groups: flow rows group by the padded token width W (every
session's prompt mel is padded to one frame bucket); vocoder rows by
(mel frames, source-cache length); each group runs in power-of-two row
sub-batches (:meth:`MultiSessionTTS._pow2_batches`). These keys decide
which rows batch together.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.infer.streaming_tts import (
    StreamingTokenToWav, make_stream_programs)


class TTSSession:
    """One podcast turn: the LLM prompt plus the acoustic context the
    flow and vocoder condition on. ``rng``: an int seed, a CPU
    ``torch.Generator`` or a draw source (``infer/streaming_tts``); it
    draws the utterance's noise buffer and seeds one NSF generator a
    vocode job."""

    def __init__(self, llm_ids: Sequence[int],
                 flow_prompt_tokens: Sequence[int],
                 prompt_mel: np.ndarray, prompt_mel_len: int,
                 spk_emb: np.ndarray, rng):
        self.llm_ids = [int(t) for t in llm_ids]
        self.flow_prompt_tokens = [int(t) for t in flow_prompt_tokens]
        self.prompt_mel = np.asarray(prompt_mel, np.float32)
        self.prompt_mel_len = int(prompt_mel_len)
        self.spk_emb = np.asarray(spk_emb, np.float32)
        self.rng = rng


class MultiSessionTTS:
    """Serve N TTS sessions through one PagedEngine with batched
    downstream synthesis ticks.

    ``engine``: a PagedEngine, or anything with its ``serve(prompts,
    max_new=, on_tokens=, on_chunk=, on_logprobs=)`` contract.
    ``confidence_gate`` (nats, e.g. -3.0): a tick whose fresh tokens have
    a mean logprob below it is deferred, so an uncertain run reaches the
    vocoder with more right-context; at most ``gate_max_defer`` deferrals
    in a row, and the final tick always synthesizes. It needs an engine
    that streams logprobs (``PagedEngine(return_logprobs=True)``).
    ``device`` defaults to CUDA and raises without it.

    After ``serve``: ``tick_ms`` holds the host ms of every batched call,
    {"flow": {rows: [ms]}, "vocode": {rows: [ms]}} (each ends with its
    results read back to the host), and ``cadence[sid]`` the (tokens,
    final) of every tick that synthesized session ``sid``, which replays
    the session alone through :class:`StreamingTokenToWav`."""

    def __init__(self, engine, flow_model, flow_cfg, hift_model, hift_cfg,
                 speech_token_offset: int, programs: Optional[dict] = None,
                 token_bucket: int = 64, mel_pad_to: Optional[int] = None,
                 chunk_tokens: Optional[int] = None, max_tokens: int = 4096,
                 confidence_gate: Optional[float] = None,
                 gate_max_defer: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.engine = engine
        self.fp, self.fc = flow_model, flow_cfg
        self.hp, self.hc = hift_model, hift_cfg
        self.offset = int(speech_token_offset)
        self.programs = programs or make_stream_programs(flow_cfg, hift_cfg)
        self.token_bucket = token_bucket
        self.mel_pad_to = mel_pad_to
        self.chunk_tokens = chunk_tokens
        self.max_tokens = max_tokens
        self.confidence_gate = confidence_gate
        self.gate_max_defer = int(gate_max_defer)
        self.tick_ms: Dict[str, Dict[int, List[float]]] = {}
        self.cadence: List[List[Tuple[int, bool]]] = []

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _timed(self, what: str, rows: int, t0: float) -> None:
        self.tick_ms[what].setdefault(rows, []).append(
            (time.perf_counter() - t0) * 1e3)

    # -- batched executors ----------------------------------------------------

    def _run_flow_rows(self, rows: List[tuple]) -> None:
        """One batched flow call over same-shape rows [(synth, job)]."""
        t0 = time.perf_counter()
        args = [s.flow_args(j) for s, j in rows]
        cat = [np.concatenate([a[i] for a in args]) for i in (0, 1, 2, 3, 4,
                                                                6)]
        noise = torch.cat([a[5] for a in args])
        mels, _ = self.programs["flow"](
            self.fp, self._t(cat[0]), self._t(cat[1]), self._t(cat[2]),
            self._t(cat[3]), self._t(cat[4]), noise=noise,
            enc_len=self._t(cat[5]))
        mels = mels.cpu().numpy()
        ratio = self.fc.token_mel_ratio
        for b, (s, j) in enumerate(rows):
            s.apply_flow(mels[b:b + 1, :ratio * j["n_enc"]], j)
        self._timed("flow", len(rows), t0)

    def _run_vocode_rows(self, rows: List[tuple]) -> List[np.ndarray]:
        """One batched HiFT call over same-shape rows [(synth, job)];
        returns the emitted wav chunk a row (each row takes its own NSF
        draws, so it equals its single-session call)."""
        t0 = time.perf_counter()
        mel_in = np.concatenate([j["mel_in"] for _, j in rows])
        src = torch.cat([j["source"] for _, j in rows])
        draws = (torch.cat([j["draws"][0] for _, j in rows]),
                 torch.cat([j["draws"][1] for _, j in rows]))
        wav, source = self.programs["hift"](self.hp, self._t(mel_in),
                                            cache_source=src, draws=draws)
        wav = wav.cpu().numpy()
        out = [s.apply_vocode(wav[b:b + 1], source[b:b + 1], j)
               for b, (s, j) in enumerate(rows)]
        self._timed("vocode", len(rows), t0)
        return out

    @staticmethod
    def _pow2_batches(rows: List[tuple]):
        """Split a shape group into power-of-two row sub-batches."""
        i = 0
        while i < len(rows):
            take = 1 << ((len(rows) - i).bit_length() - 1)
            yield rows[i:i + take]
            i += take

    # -- serving ---------------------------------------------------------------

    def serve(self, sessions: Sequence[TTSSession],
              max_new: Optional[int] = None, on_wav=None) -> List[dict]:
        """Run every session's turn to completion; returns per session
        {"wav": [T] float32, "tokens": generated llm ids, "ttfa_s",
        "n_chunks", "gate_deferrals"}. ``on_wav(sid, wav_chunk)``
        streams chunks as they are synthesized.

        TTFA is serve entry -> the session's first wav chunk, so it
        includes the wait for an LLM slot: what a client sees under
        concurrent load."""
        if self.mel_pad_to is None:
            tp = max((s.prompt_mel.shape[0] if s.prompt_mel.ndim == 2
                      else s.prompt_mel.shape[1]) for s in sessions)
            mel_pad_to = max(-(-max(tp, 1) // 16) * 16, 16)
        else:
            mel_pad_to = self.mel_pad_to
        self.tick_ms = {"flow": {}, "vocode": {}}
        self.cadence = [[] for _ in sessions]
        synths = [StreamingTokenToWav(
            self.fp, self.fc, self.hp, self.hc, s.flow_prompt_tokens,
            s.prompt_mel, s.prompt_mel_len, s.spk_emb, s.rng,
            chunk_tokens=self.chunk_tokens, token_bucket=self.token_bucket,
            max_tokens=self.max_tokens, programs=self.programs,
            mel_pad_to=mel_pad_to, device=self.device) for s in sessions]
        st: List[Dict] = [{"gen": [], "lps": [], "dirty": False,
                           "done": False, "finalized": False, "wavs": [],
                           "n_seen": 0, "defers": 0, "total_defers": 0,
                           "t_first": None} for _ in sessions]
        t0 = time.perf_counter()

        def on_tokens(rid, new, done):
            r = st[rid]
            r["gen"].extend(new)
            r["dirty"] = True
            r["done"] = r["done"] or done

        def on_logprobs(rid, new, done):
            st[rid]["lps"].extend(new)

        def on_chunk():
            # 1. plan + run flow, grouped by token width W
            flow_groups = defaultdict(list)
            ticked = []
            for sid, r in enumerate(st):
                if not r["dirty"] or r["finalized"]:
                    continue
                final = r["done"]
                # the trailing generated token is withheld until final: it
                # may be the EOS the reference grammar drops before flow
                toks = [t - self.offset for t in r["gen"][:-1]]
                if self.confidence_gate is not None and not final:
                    # defer (stay dirty) while the fresh tokens are
                    # low-confidence, so they meet more right-context
                    fresh = r["lps"][r["n_seen"]:len(toks)]
                    if (fresh and sum(fresh) / len(fresh)
                            < self.confidence_gate
                            and r["defers"] < self.gate_max_defer):
                        r["defers"] += 1
                        r["total_defers"] += 1
                        continue
                r["defers"] = 0
                r["n_seen"] = len(toks)
                r["dirty"] = False
                if final:
                    r["finalized"] = True
                self.cadence[sid].append((len(toks), final))
                job = synths[sid].flow_job(toks, final=final)
                ticked.append(sid)
                if job is not None:
                    flow_groups[job["W"]].append((synths[sid], job))
            for rows in flow_groups.values():
                for sub in self._pow2_batches(rows):
                    self._run_flow_rows(sub)
            # 2. plan + run vocode, grouped by (mel frames, source len)
            voc_groups = defaultdict(list)
            order = []
            for sid in ticked:
                job = synths[sid].vocode_job(final=st[sid]["finalized"])
                if job is not None:
                    key = (job["mel_in"].shape[1], job["source"].shape[1])
                    voc_groups[key].append((sid, (synths[sid], job)))
            for rows in voc_groups.values():
                for sub in self._pow2_batches(rows):
                    wavs = self._run_vocode_rows([rj for _, rj in sub])
                    order.extend((sid, w)
                                 for (sid, _), w in zip(sub, wavs))
            for sid, wav in order:
                r = st[sid]
                r["wavs"].append(wav)
                if r["t_first"] is None:
                    r["t_first"] = time.perf_counter()
                if on_wav is not None:
                    on_wav(sid, wav)

        kw = ({"on_logprobs": on_logprobs}
              if self.confidence_gate is not None else {})
        outputs = self.engine.serve([s.llm_ids for s in sessions],
                                    max_new=max_new, on_tokens=on_tokens,
                                    on_chunk=on_chunk, **kw)
        # engines without on_chunk pipelining (or zero-chunk tails) still
        # need the final flush
        for sid, r in enumerate(st):
            r["gen"] = outputs[sid]
            r["done"] = True
            if not r["finalized"]:
                r["dirty"] = True
        on_chunk()
        return [{
            "wav": (np.concatenate(r["wavs"]) if r["wavs"]
                    else np.zeros((0,), np.float32)),
            "tokens": r["gen"],
            "n_chunks": len(r["wavs"]),
            "gate_deferrals": r["total_defers"],
            "ttfa_s": (None if r["t_first"] is None
                       else r["t_first"] - t0),
        } for r in st]
