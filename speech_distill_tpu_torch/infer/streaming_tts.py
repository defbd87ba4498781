"""Streaming TTS synthesis: incremental token -> mel -> wav (port of
``speech_distill_tpu/infer/streaming_tts.py``).

The reference ships the streaming machinery (chunk-causal attention
masks, causal convs, the 3-frame pre-lookahead, the vocoder's NSF source
cache) but invokes it only with ``streaming=False``; this module runs it,
so wav chunks are emitted while the LLM is still generating:

* **Token chunking.** Emission boundaries are multiples of the encoder's
  ``static_chunk_size`` tokens. In streaming mode every attention mask is
  chunk-causal and every conv causal, so the mel of a completed block
  never changes as tokens append: each flow call recomputes the prefix
  over a bucketed width and the freshly completed blocks are emitted
  once.
* **Lookahead.** A block is final once ``la`` tokens beyond its boundary
  exist; the final flush encodes everything (``finalize=True``).
* **Fixed noise.** The CFM solves from one noise buffer drawn per
  utterance and sliced per call.
* **Vocoder windowing.** HiFT convs are not causal: the last
  ``mel_cache_frames`` mel frames are re-synthesized with the next chunk,
  the NSF source is spliced through ``cache_source``, and the overlap is
  Hamming cross-faded.

:func:`stream_tts` drives one turn end to end: an engine's
``generate_stream`` token chunks into a :class:`StreamingTokenToWav`.

The stream state between calls (pending and cached mel, the emitted wav
tail) lives on the host as numpy, as in JAX; the noise buffer and the
source tail stay on the device. The programs of
:func:`make_stream_programs` are plain functions (no jit; a CUDA graph of
the Euler step is later work).

Randomness. JAX splits the utterance key into a noise key and a vocoder
key, and splits the vocoder key once a vocode job. Here an utterance's
draws come from a *draw source*: an int seed or a CPU ``torch.Generator``
(wrapped in :class:`GeneratorDraws`: the noise buffer from a child
generator, and a fresh child generator a vocode job for its NSF draws),
or any object with the same two methods, ``flow_noise(shape)`` and
``source(T, H)``. The tests pass one that reproduces JAX's key splits.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.models import flow as flow_lib
from speech_distill_tpu_torch.models import hift as hift_lib


def make_stream_programs(flow_cfg: flow_lib.FlowConfig,
                         hift_cfg: hift_lib.HiFTConfig) -> dict:
    """The flow and vocoder programs every :class:`StreamingTokenToWav` of
    these configs calls: the recompute flow (``streaming=True``), the
    incremental encoder and solver, and HiFT."""
    return {
        "flow": partial(flow_lib.forward_flow, cfg=flow_cfg,
                        streaming=True),
        "flow_enc_inc": partial(flow_lib.encode_flow_tokens, cfg=flow_cfg),
        "flow_solve_inc": partial(flow_lib.solve_flow_incremental,
                                  cfg=flow_cfg),
        "hift": partial(hift_lib.forward, cfg=hift_cfg),
    }


def fade_in_out(new: np.ndarray, old_tail: np.ndarray,
                window: np.ndarray) -> np.ndarray:
    """Cross-fade the first ``len(old_tail)`` samples of ``new`` against
    ``old_tail`` with the two halves of ``window`` (rising half on the new
    audio, falling half on the old)."""
    n = old_tail.shape[-1]
    out = new.copy()
    out[..., :n] = new[..., :n] * window[:n] + old_tail * window[n:]
    return out


class GeneratorDraws:
    """An utterance's draws from an int seed or a CPU ``torch.Generator``:
    each call takes a 62-bit seed from it for a child generator on
    ``device`` (where JAX splits its key)."""

    def __init__(self, rng, device):
        if isinstance(rng, torch.Generator):
            if rng.device.type != "cpu":
                raise ValueError("the session generator must be a CPU "
                                 "torch.Generator (it only seeds children)")
            self._g = rng
        else:
            self._g = torch.Generator()
            self._g.manual_seed(int(rng))
        self.device = device

    def _child(self) -> torch.Generator:
        seed = int(torch.randint(0, 1 << 62, (1,), generator=self._g))
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def flow_noise(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._child(),
                           device=self.device)

    def source(self, T: int, H: int):
        return hift_lib.nsf_draws(self._child(), 1, T, H, self.device)


def draw_source(rng, device):
    """``rng`` as a draw source (see the module docstring)."""
    if hasattr(rng, "flow_noise") and hasattr(rng, "source"):
        return rng
    return GeneratorDraws(rng, device)


class StreamingTokenToWav:
    """Incremental speech-token -> waveform synthesizer for ONE utterance.

    ``push(gen_tokens, final)`` takes the FULL list of generated flow
    tokens so far (prompt tokens are fixed at construction) and returns
    the wav chunks newly available at chunk-aligned boundaries; the
    ``final=True`` call flushes everything remaining. Flow-vocabulary ids
    at or past ``flow_cfg.vocab_size`` raise ``ValueError`` (JAX's
    embedding reads NaN rows there). ``device`` defaults to CUDA and
    raises without it; the models must be on it."""

    def __init__(self, flow_model: flow_lib.Flow,
                 flow_cfg: flow_lib.FlowConfig,
                 hift_model: hift_lib.HiFTGenerator,
                 hift_cfg: hift_lib.HiFTConfig,
                 prompt_tokens: Sequence[int], prompt_mel: np.ndarray,
                 prompt_mel_len: int, spk_emb: np.ndarray, rng,
                 chunk_tokens: Optional[int] = None,
                 token_bucket: int = 64,
                 mel_cache_frames: Optional[int] = None,
                 max_tokens: int = 4096, programs: Optional[dict] = None,
                 mel_pad_to: Optional[int] = None,
                 incremental: bool = False, inc_max_frames: int = 2048,
                 inc_kv_dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        for name, m in (("flow", flow_model), ("hift", hift_model)):
            if m.device != self.device:
                raise ValueError(f"{name} model is on {m.device}, the "
                                 f"synthesizer on {self.device}")
        self.fp, self.fc = flow_model, flow_cfg
        self.hp, self.hc = hift_model, hift_cfg
        self.prompt_tokens = [int(t) for t in prompt_tokens]
        self._check_ids(self.prompt_tokens)
        pm = np.asarray(prompt_mel, np.float32)
        self.prompt_mel = pm[None] if pm.ndim == 2 else pm
        self.prompt_mel_len = int(prompt_mel_len)
        # pad the (length-masked) prompt mel to a fixed frame bucket so
        # sessions with different prompt lengths share one flow shape and
        # stack into batched multi-session calls (infer/tts_serve.py)
        if mel_pad_to is not None:
            if mel_pad_to < self.prompt_mel.shape[1]:
                raise ValueError(f"mel_pad_to={mel_pad_to} < prompt mel "
                                 f"frames {self.prompt_mel.shape[1]}")
            self.prompt_mel = np.pad(
                self.prompt_mel,
                [(0, 0), (0, mel_pad_to - self.prompt_mel.shape[1]),
                 (0, 0)])
        self.spk_emb = np.asarray(spk_emb, np.float32)
        if self.spk_emb.ndim == 1:
            self.spk_emb = self.spk_emb[None]
        self.la = flow_cfg.pre_lookahead_len
        self.ratio = flow_cfg.token_mel_ratio
        # emission boundaries must complete BOTH chunk masks: a multiple of
        # the encoder's (token) chunk whose mel length is a multiple of the
        # estimator's (mel) chunk, i.e. of est / gcd(est, ratio) tokens
        enc_c = flow_cfg.encoder.static_chunk_size
        est = flow_cfg.static_chunk_size
        base = math.lcm(enc_c, est // math.gcd(est, self.ratio))
        self.chunk = chunk_tokens or base
        if self.chunk % base != 0:
            raise ValueError(
                f"chunk_tokens={self.chunk} must be a multiple of "
                f"lcm(encoder chunk {enc_c}, estimator chunk {est} / "
                f"gcd(est, ratio {self.ratio})) = {base}")
        self.bucket = token_bucket
        if mel_cache_frames is None:
            mel_cache_frames = 8          # the CosyVoice2 overlap window
        if mel_cache_frames < 1:
            raise ValueError("mel_cache_frames must be >= 1 (the -0: "
                             "slices would invert the hold semantics)")
        self.cache_frames = mel_cache_frames
        self.scale = hift_cfg.upsample_scale
        fade = mel_cache_frames * self.scale
        self._window = np.hamming(2 * fade).astype(np.float32)
        self._draws = draw_source(rng, self.device)
        # one noise buffer per utterance, sliced per call
        self._noise = self._draws.flow_noise(
            (1, self.ratio * max_tokens, flow_cfg.output_size))
        # vocoder streaming caches
        self._mel_cache = np.zeros((1, 0, flow_cfg.output_size), np.float32)
        self._source_cache = torch.zeros((1, 0), device=self.device)
        self._speech_tail: Optional[np.ndarray] = None
        # mel emitted by the flow but not yet vocoded: after a prompt that
        # is not chunk-aligned the first region can be smaller than the
        # hold window, so it waits until a window can both refill the
        # cache and emit >= 1 frame
        self._pending_mel = np.zeros((1, 0, flow_cfg.output_size),
                                     np.float32)
        self._mel_done = self.prompt_mel_len   # mel frames already vocoded
        self._enc_done = len(self.prompt_tokens)  # tokens already encoded
        programs = programs or make_stream_programs(flow_cfg, hift_cfg)
        self._flow = programs["flow"]
        self._hift = programs["hift"]
        # incremental flow (models/flow.py per-Euler-step caches): O(n)
        # flow work instead of the prefix recompute, single-stream (the
        # batched tts_serve path keeps the recompute form)
        self.incremental = incremental
        if incremental:
            self._inc_max_frames = inc_max_frames
            self._t_past = 0
            self._inc_caches = flow_lib.init_incremental_cache(
                flow_cfg, 1, inc_max_frames, kv_dtype=inc_kv_dtype,
                device=self.device)
            self._flow_enc_inc = programs["flow_enc_inc"]
            self._flow_solve_inc = programs["flow_solve_inc"]
        self._finished = False

    def _check_ids(self, ids: Sequence[int]) -> None:
        if ids and max(ids) >= self.fc.vocab_size:
            raise ValueError(
                f"flow token id {max(ids)} >= flow vocab_size "
                f"{self.fc.vocab_size} (speech ids must be offset into "
                f"the flow vocabulary)")

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    # -- flow (plan / execute / apply) ---------------------------------------
    #
    # The staged form lets a multi-session coordinator (infer/tts_serve.py)
    # collect every session's job for one tick and run ONE batched call per
    # shape group; push() composes the same stages for one session.

    def flow_job(self, gen_tokens: Sequence[int],
                 final: bool = False) -> Optional[dict]:
        """Plan the flow call advancing the stream to ``gen_tokens`` (the
        full generated-token list so far). Returns None when no new chunk
        boundary completed (the final flush may still need vocoding: call
        ``vocode_job`` regardless)."""
        if self._finished:
            raise RuntimeError("push() after final=True")
        gen = [int(t) for t in gen_tokens]
        self._check_ids(gen)
        total = self.prompt_tokens + gen
        n = len(total)
        if final:
            self._finished = True
            n_enc = n
        else:
            # encode up to the last chunk boundary with `la` lookahead
            # tokens beyond it
            n_enc = ((n - self.la) // self.chunk) * self.chunk
        if n_enc <= self._enc_done:
            return None
        tokens = total[:min(n, n_enc + self.la)]
        W = -(-max(len(tokens), 1) // self.bucket) * self.bucket
        return {"tokens": tokens, "n_enc": n_enc, "W": W}

    def flow_args(self, job: dict):
        """The per-row arguments of ``job`` for the shared flow program:
        (tokens [1, W], n [1], prompt_mel, prompt_mel_len [1], spk_emb,
        noise [1, ratio*W, D] on the device, enc_len [1]). Rows of one
        shape group stack along axis 0 into a batched call."""
        n, W = len(job["tokens"]), job["W"]
        arr = np.zeros((1, W), np.int64)
        arr[0, :n] = job["tokens"]
        return (arr, np.asarray([n], np.int64), self.prompt_mel,
                np.asarray([self.prompt_mel_len], np.int64), self.spk_emb,
                self._noise[:, :self.ratio * W],
                np.asarray([job["n_enc"]], np.int64))

    def apply_flow(self, mel: np.ndarray, job: dict) -> None:
        """Fold the flow result (mel [1, ratio*n_enc, 80]; slice a batched
        call's row to the job's encoded region first) into the stream."""
        self._pending_mel = np.concatenate(
            [self._pending_mel, mel[:, self._mel_done:]], axis=1)
        self._enc_done = job["n_enc"]
        self._mel_done = mel.shape[1]

    def _flow_call_inc(self, job: dict) -> None:
        """Incremental execution of a flow job: encode the (bucketed)
        token prefix, then Euler-solve only the new frames against the
        per-step caches, and fold the new mel into the stream (it starts
        at the old write front, not at frame 0)."""
        n, W = len(job["tokens"]), job["W"]
        arr = np.zeros((1, W), np.int64)
        arr[0, :n] = job["tokens"]
        f_new = self.ratio * job["n_enc"] - self._t_past
        F = self.ratio * self.chunk
        while F < f_new:
            F *= 2
        if self._t_past + F > self._inc_max_frames:
            raise ValueError(
                f"incremental stream over {self._inc_max_frames} frames "
                f"(need {self._t_past + F}); raise inc_max_frames")
        need = self._t_past + F
        enc_len = self._t([job["n_enc"]])
        h = self._flow_enc_inc(self.fp, self._t(arr), self._t([n]),
                               enc_len=enc_len)
        if h.shape[1] < need:     # final partial chunk: padded rows
            h = torch.nn.functional.pad(h, (0, 0, 0, need - h.shape[1]))
        mel_new = self._flow_solve_inc(
            self.fp, h[:, self._t_past:need], self._t(self.prompt_mel),
            self._t([self.prompt_mel_len]), self._t(self.spk_emb),
            caches=self._inc_caches, t_past=self._t_past,
            noise_new=self._noise[:, self._t_past:need],
            enc_len=job["n_enc"])
        mel_new = mel_new[:, :f_new].cpu().numpy()
        start = max(self._mel_done - self._t_past, 0)
        self._t_past += f_new
        self._pending_mel = np.concatenate(
            [self._pending_mel, mel_new[:, start:]], axis=1)
        self._enc_done = job["n_enc"]
        self._mel_done = self._t_past

    def _flow_call(self, job: dict) -> np.ndarray:
        """Single-session execution of a flow job."""
        a = self.flow_args(job)
        mels, _ = self._flow(self.fp, self._t(a[0]), self._t(a[1]),
                             self._t(a[2]), self._t(a[3]), self._t(a[4]),
                             noise=a[5], enc_len=self._t(a[6]))
        return mels[:, :self.ratio * job["n_enc"]].cpu().numpy()

    # -- vocoder (plan / execute / apply) -------------------------------------

    def vocode_job(self, final: bool = False) -> Optional[dict]:
        """Plan the windowed HiFT call over the pending mel: vocode when
        the window can refill the hold cache AND emit >= 1 frame (always
        on final). Consumes the pending mel and this job's NSF draws;
        ``apply_vocode`` folds the result back."""
        have = self._pending_mel.shape[1] + self._mel_cache.shape[1]
        if final:
            if have == 0:
                return None
        elif have <= self.cache_frames or self._pending_mel.shape[1] == 0:
            return None
        mel_in = np.concatenate([self._mel_cache, self._pending_mel],
                                axis=1)
        self._pending_mel = self._pending_mel[:, :0]
        draws = self._draws.source(mel_in.shape[1] * self.scale,
                                   self.hc.nb_harmonics + 1)
        return {"mel_in": mel_in, "source": self._source_cache,
                "draws": draws, "final": final}

    def apply_vocode(self, wav: np.ndarray, source: torch.Tensor,
                     job: dict) -> np.ndarray:
        """Cross-fade + cache update for one executed vocode job; returns
        the emitted wav chunk [T]."""
        wav = np.asarray(wav)
        mel_in, final = job["mel_in"], job["final"]
        if self._speech_tail is not None:
            wav = fade_in_out(wav, self._speech_tail, self._window)
        hold = self.cache_frames * self.scale
        if final:
            self._mel_cache = mel_in[:, mel_in.shape[1]:]
            self._speech_tail = None
            return wav[0]
        self._mel_cache = mel_in[:, -self.cache_frames:]
        self._source_cache = source[:, -hold:].clone()
        self._speech_tail = wav[:, -hold:]
        return wav[0, :-hold]

    # -- public -------------------------------------------------------------

    def run_flow(self, job: dict) -> np.ndarray:
        """Execute a flow job alone, in this stream's form (incremental or
        recompute); returns the mel frames it added to the pending mel
        [1, F, 80]."""
        before = self._pending_mel.shape[1]
        if self.incremental:
            self._flow_call_inc(job)
        else:
            self.apply_flow(self._flow_call(job), job)
        return self._pending_mel[:, before:]

    def run_vocode(self, job: dict) -> np.ndarray:
        """Execute a vocode job alone; returns the emitted wav chunk."""
        wav, source = self._hift(self.hp, self._t(job["mel_in"]),
                                 cache_source=job["source"],
                                 draws=job["draws"])
        return self.apply_vocode(wav.cpu().numpy(), source, job)

    def push(self, gen_tokens: Sequence[int],
             final: bool = False) -> List[np.ndarray]:
        """Advance the stream to ``gen_tokens`` (the full generated-token
        list so far, flow-vocabulary ids). Returns 0+ wav chunks [T]."""
        fj = self.flow_job(gen_tokens, final)
        if fj is not None:
            self.run_flow(fj)
        vj = self.vocode_job(final)
        return [] if vj is None else [self.run_vocode(vj)]


def stream_tts(llm_engine, flow_model: flow_lib.Flow,
               flow_cfg: flow_lib.FlowConfig,
               hift_model: hift_lib.HiFTGenerator,
               hift_cfg: hift_lib.HiFTConfig, llm_inputs: Sequence[int],
               speech_token_offset: int, prompt_tokens: Sequence[int],
               prompt_mel: np.ndarray, prompt_mel_len: int,
               spk_emb: np.ndarray, rng, llm_chunk: Optional[int] = None,
               programs: Optional[dict] = None,
               **kw) -> Iterator[np.ndarray]:
    """End-to-end streaming TTS for one turn: the token chunks of
    ``llm_engine.generate_stream`` (any engine with one, such as
    ``infer/engine.DecodeEngine``) feed a :class:`StreamingTokenToWav`;
    yields wav chunks as they complete. ``kw`` goes to the synthesizer
    (``device`` defaults to CUDA there).

    The trailing token of the generated stream is withheld from the flow
    until the end: it is the EOS in the reference grammar, which drops it
    before the flow."""
    synth = StreamingTokenToWav(flow_model, flow_cfg, hift_model, hift_cfg,
                                prompt_tokens, prompt_mel, prompt_mel_len,
                                spk_emb, rng, programs=programs, **kw)
    # la + 1 tokens must exist past a boundary before it flushes (the
    # withheld possible EOS + la lookahead); poll the LLM in chunk-sized
    # pieces so wav chunks come at a steady cadence
    chunk = llm_chunk or synth.chunk
    gen: List[int] = []
    for new in llm_engine.generate_stream(list(llm_inputs), chunk=chunk):
        gen.extend(new)
        yield from synth.push([t - speech_token_offset for t in gen[:-1]])
    yield from synth.push([t - speech_token_offset for t in gen[:-1]],
                          final=True)
