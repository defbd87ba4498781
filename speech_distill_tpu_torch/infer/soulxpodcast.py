"""SoulXPodcast TTS orchestrator: LLM decode -> flow -> vocoder (port of
``speech_distill_tpu/infer/soulxpodcast.py``; reference ``SoulXPodcast``,
soulxpodcast/models/soulxpodcast.py:19-432).

Single-shot TTS (``forward_tts`` / ``forward_tts2`` and the streaming
``forward_tts_streaming``) and multi-turn long-form synthesis
(``forward_longform`` and ``forward_longform_streaming``) with the
KV-cache history-eviction policy (soulxpodcast.py:345-374).

The components are injected (the S3 quantize function, a decode engine,
the flow and HiFT modules): ``DecodeEngine`` (stateful: the caller holds
the cache state between turns) or ``PagedEngine`` (stateless: the full
context goes in every turn and its prefix cache makes that incremental).

Randomness: each utterance's flow noise and NSF draws come from a draw
source (``infer/streaming_tts.GeneratorDraws``) whose seed is taken from
one CPU ``torch.Generator`` seeded with ``seed``, where JAX splits its
key; :meth:`SoulXPodcast._next_draws` is the one place a test replaces to
replay JAX's draws.
"""
from __future__ import annotations

from itertools import chain
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from speech_distill_tpu_torch.core.config import EngineConfig, SamplingParams
from speech_distill_tpu_torch.core.device import resolve_device
from speech_distill_tpu_torch.infer import streaming_tts
from speech_distill_tpu_torch.models import flow as flow_lib
from speech_distill_tpu_torch.models import hift as hift_lib


def _flatten(lst):
    if lst and isinstance(lst[0], list):
        return list(chain.from_iterable(lst))
    return list(lst)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


class SoulXPodcast:
    def __init__(self, config: EngineConfig, llm_engine, s3_quantize,
                 flow_model: flow_lib.Flow, flow_cfg: flow_lib.FlowConfig,
                 hift_model: hift_lib.HiFTGenerator,
                 hift_cfg: hift_lib.HiFTConfig, seed: int = 0,
                 device="cuda"):
        """``s3_quantize(mels [B, n_mels, T], lens [B]) -> (codes,
        code_lens)``; ``llm_engine`` is any engine with ``generate(ids) ->
        {"token_ids": ...}`` and a ``stateful`` flag. ``device`` (CUDA by
        default; raises without it) must hold the flow and HiFT."""
        self.device = resolve_device(device)
        for name, m in (("flow", flow_model), ("hift", hift_model)):
            if m.device != self.device:
                raise ValueError(f"{name} model is on {m.device}, the "
                                 f"orchestrator on {self.device}")
        self.config = config
        self.llm = llm_engine
        self.s3_quantize = s3_quantize
        self.flow = flow_model
        self.flow_cfg = flow_cfg
        self.hift = hift_model
        self.hift_cfg = hift_cfg
        self._generator = torch.Generator().manual_seed(seed)
        self._stream_programs = streaming_tts.make_stream_programs(
            flow_cfg, hift_cfg)

    # -- helpers ------------------------------------------------------------

    def _next_draws(self):
        """The next utterance's draw source (flow noise and NSF draws)."""
        seed = int(torch.randint(0, 1 << 62, (1,), generator=self._generator))
        return streaming_tts.GeneratorDraws(seed, self.device)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    @staticmethod
    def _align_prompt(speech_tokens: np.ndarray, token_len: int,
                      prompt_mel: np.ndarray):
        """Align the prompt speech-token count with the flow prompt mel
        (2 mel frames a token; soulxpodcast.py:283-300)."""
        mel_len = prompt_mel.shape[0]
        if token_len * 2 > mel_len:
            return speech_tokens[: mel_len // 2], prompt_mel, mel_len
        return (speech_tokens[:token_len], prompt_mel[:token_len * 2],
                token_len * 2)

    def _token_to_wav(self, speech_tokens: List[int],
                      prompt_speech_token: Sequence[int],
                      prompt_mel: np.ndarray, prompt_mel_len: int,
                      spk_emb: np.ndarray, bucket: int = 64) -> np.ndarray:
        """Flow + vocoder for one turn, over a token width bucketed to
        ``bucket`` (JAX's compile buckets; the noise is drawn at that
        width, so the wav follows it). Flow ids at or past the flow
        vocabulary raise (JAX's embedding reads NaN rows there)."""
        toks = [int(t) for t in prompt_speech_token] + \
            [int(t) for t in speech_tokens]
        if toks and max(toks) >= self.flow_cfg.vocab_size:
            raise ValueError(f"flow token id {max(toks)} >= flow vocab_size "
                             f"{self.flow_cfg.vocab_size}")
        n = len(toks)
        width = -(-n // bucket) * bucket
        flow_input = np.zeros((1, width), np.int64)
        flow_input[0, :n] = toks
        emb = np.asarray(spk_emb, np.float32)
        emb = emb[None] if emb.ndim == 1 else emb
        draws = self._next_draws()
        noise = draws.flow_noise((1, self.flow_cfg.token_mel_ratio * width,
                                  self.flow_cfg.output_size))
        mels, mel_lens = flow_lib.forward_flow(
            self.flow, self._t(flow_input), self._t([n]),
            self._t(np.asarray(prompt_mel, np.float32)[None]),
            self._t([prompt_mel_len]), self._t(emb), self.flow_cfg,
            noise=noise.to(self.device))
        # keep the mel bucket-shaped for the vocoder; trim the wav instead
        mel = mels[:, prompt_mel_len:]                       # [1, T_b, 80]
        scale = self.hift_cfg.upsample_scale
        src = draws.source(mel.shape[1] * scale, self.hift_cfg.nb_harmonics
                           + 1)
        wav, _ = hift_lib.forward(self.hift, mel, self.hift_cfg,
                                  draws=tuple(d.to(self.device) for d in src))
        true_mel = int(mel_lens[0]) - prompt_mel_len
        return wav[0].cpu().numpy()[: true_mel * scale]

    def _generated_to_flow_tokens(self, token_ids: List[int]) -> List[int]:
        off = self.config.llm.speech_token_offset
        return [t - off for t in token_ids[:-1]]             # drop final eos

    def _speech_inputs(self, prompt_tokens) -> List[int]:
        off = self.config.llm.speech_token_offset
        return [int(t) + off for t in prompt_tokens] + \
            [self.config.llm.eos_token_id]

    # -- single-shot TTS ----------------------------------------------------

    def _tts_prepare(self, prompt_mels_for_llm, prompt_mels_lens_for_llm,
                     prompt_mels_for_flow_ori):
        """The single-shot preamble: tokenize the prompt audio and align
        the prompt speech tokens with the flow prompt mel."""
        mels = np.asarray(prompt_mels_for_llm, np.float32)
        if mels.ndim == 2:
            mels = mels[None]
        lens = np.atleast_1d(np.asarray(prompt_mels_lens_for_llm, np.int64))
        codes, code_lens = self.s3_quantize(mels, lens)
        pmel = np.asarray(prompt_mels_for_flow_ori, np.float32)
        if pmel.ndim == 3:
            pmel = pmel[0]
        return self._align_prompt(_np(codes)[0], int(_np(code_lens)[0]),
                                  pmel)

    def forward_tts(self, prompt_mels_for_llm, prompt_mels_lens_for_llm,
                    prompt_text_tokens_for_llm, text_tokens_for_llm,
                    prompt_mels_for_flow_ori, spk_emb_for_flow,
                    sampling_params: Optional[SamplingParams] = None,
                    **kwargs) -> Dict[str, Any]:
        """Reference forward_tts (soulxpodcast.py:145-250)."""
        prompt_tokens, prompt_mel, prompt_mel_len = self._tts_prepare(
            prompt_mels_for_llm, prompt_mels_lens_for_llm,
            prompt_mels_for_flow_ori)
        inputs = (_flatten(prompt_text_tokens_for_llm)
                  + self._speech_inputs(prompt_tokens)
                  + _flatten(text_tokens_for_llm))
        gen = self._generated_to_flow_tokens(
            self.llm.generate(inputs)["token_ids"])
        wav = self._token_to_wav(gen, prompt_tokens, prompt_mel,
                                 prompt_mel_len, spk_emb_for_flow)
        return {"generated_wavs": [wav]}

    def forward_tts_streaming(self, prompt_mels_for_llm,
                              prompt_mels_lens_for_llm,
                              prompt_text_tokens_for_llm,
                              text_tokens_for_llm,
                              prompt_mels_for_flow_ori, spk_emb_for_flow,
                              llm_chunk: Optional[int] = None, **kwargs):
        """Streaming forward_tts: a generator of wav chunks while the LLM
        is still generating (``infer/streaming_tts.stream_tts``; the
        chunk-causal path the reference ships with streaming=False).
        Needs a token-streaming engine (``DecodeEngine.generate_stream``)."""
        if not hasattr(self.llm, "generate_stream"):
            raise ValueError("streaming TTS needs a token-streaming engine "
                             "(DecodeEngine.generate_stream)")
        prompt_tokens, prompt_mel, prompt_mel_len = self._tts_prepare(
            prompt_mels_for_llm, prompt_mels_lens_for_llm,
            prompt_mels_for_flow_ori)
        inputs = (_flatten(prompt_text_tokens_for_llm)
                  + self._speech_inputs(prompt_tokens)
                  + _flatten(text_tokens_for_llm))
        yield from streaming_tts.stream_tts(
            self.llm, self.flow, self.flow_cfg, self.hift, self.hift_cfg,
            inputs, self.config.llm.speech_token_offset,
            [int(t) for t in prompt_tokens], prompt_mel, prompt_mel_len,
            np.asarray(spk_emb_for_flow, np.float32), self._next_draws(),
            llm_chunk=llm_chunk, programs=self._stream_programs,
            device=self.device)

    def forward_tts2(self, prompt_mels_for_llm, prompt_mels_lens_for_llm,
                     inputs, prompt_mels_for_flow_ori, spk_emb_for_flow,
                     sampling_params: Optional[SamplingParams] = None,
                     **kwargs) -> Dict[str, Any]:
        """Reference forward_tts2 (soulxpodcast.py:59-143): the caller
        gives the assembled LLM input ids."""
        prompt_tokens, prompt_mel, prompt_mel_len = self._tts_prepare(
            prompt_mels_for_llm, prompt_mels_lens_for_llm,
            prompt_mels_for_flow_ori)
        gen = self._generated_to_flow_tokens(
            self.llm.generate(list(inputs))["token_ids"])
        wav = self._token_to_wav(gen, prompt_tokens, prompt_mel,
                                 prompt_mel_len, spk_emb_for_flow)
        return {"generated_wavs": [wav]}

    # -- long-form multi-turn -----------------------------------------------

    def _longform_prepare(self, prompt_mels_for_llm,
                          prompt_mels_lens_for_llm,
                          prompt_text_tokens_for_llm,
                          prompt_mels_for_flow_ori,
                          use_dialect_prompt=False,
                          dialect_prompt_text_tokens_for_llm=None,
                          dialect_prefix=None):
        """The long-form setup (soulxpodcast.py:272-335): tokenize the
        prompt audio, align the prompt mels, assemble each speaker's
        prompt and history token lists (with the dialect-prompt
        pre-generation)."""
        prompt_size = len(prompt_text_tokens_for_llm)
        codes, code_lens = self.s3_quantize(
            np.asarray(prompt_mels_for_llm, np.float32),
            np.asarray(prompt_mels_lens_for_llm, np.int64))
        codes, code_lens = _np(codes), _np(code_lens)

        prompt_speech_tokens, prompt_mels_flow, prompt_mels_lens_flow = \
            [], [], []
        for i in range(prompt_size):
            pmel = np.asarray(prompt_mels_for_flow_ori[i], np.float32)
            toks, mel_i, mel_len = self._align_prompt(
                codes[i], int(code_lens[i]), pmel)
            prompt_speech_tokens.append([int(t) for t in toks])
            prompt_mels_flow.append(mel_i)
            prompt_mels_lens_flow.append(mel_len)

        prompt_inputs: List[List[int]] = []
        history_inputs: List[List[int]] = []
        for i in range(prompt_size):
            speech_tokens_i = self._speech_inputs(prompt_speech_tokens[i])
            if use_dialect_prompt and dialect_prompt_text_tokens_for_llm \
                    and len(dialect_prompt_text_tokens_for_llm[i]) > 0:
                dialect_input = (prompt_text_tokens_for_llm[i]
                                 + speech_tokens_i
                                 + dialect_prompt_text_tokens_for_llm[i])
                if i > 0:
                    dialect_input = dialect_prefix[0] + dialect_input
                gen = self.llm.generate(dialect_input)["token_ids"]
                item = (dialect_prefix[i + 1]
                        + dialect_prompt_text_tokens_for_llm[i] + gen)
            else:
                item = prompt_text_tokens_for_llm[i] + speech_tokens_i
            prompt_inputs.append(list(item))
            history_inputs.append(list(item))
        return (prompt_speech_tokens, prompt_mels_flow,
                prompt_mels_lens_flow, prompt_inputs, history_inputs)

    def _evict(self, history_inputs, prompt_inputs):
        """The eviction rebuild (soulxpodcast.py:345-374): the first
        ``prompt_context`` prompts, a window of text-only history and the
        last ``history_context`` full turns. Returns (inputs, valid turn
        count)."""
        cfg = self.config
        bound = max(cfg.prompt_context, len(history_inputs)
                    - cfg.history_text_context - cfg.history_context)
        inputs = _flatten(history_inputs[:cfg.prompt_context]
                          + history_inputs[bound:-cfg.history_context]
                          + prompt_inputs[-cfg.history_context:])
        return inputs, cfg.prompt_context + len(history_inputs) - bound

    def _turns(self, prompt_inputs, history_inputs, text_tokens_for_llm,
               turn):
        """Drive the multi-turn context for ``turn(i, pending, inputs,
        state) -> (token_ids, state)``: the eviction policy, the pending
        (not yet cached) ids and the history bookkeeping. Yields what
        ``turn`` yields; returns nothing."""
        cfg = self.config
        inputs = _flatten(prompt_inputs)
        state = None            # a fresh prefill on the first turn
        pending = list(inputs)  # ids not yet prefilled into the cache
        valid_turn_size = len(prompt_inputs)
        for i, text in enumerate(text_tokens_for_llm):
            if (valid_turn_size > cfg.max_turn_size
                    or len(inputs) > cfg.turn_tokens_threshold):
                inputs, valid_turn_size = self._evict(history_inputs,
                                                      prompt_inputs)
                state = None
                pending = list(inputs)
            valid_turn_size += 1
            inputs = inputs + list(text)
            pending = pending + list(text)
            token_ids, state = yield from turn(i, pending, inputs, state)
            pending = []
            inputs = inputs + token_ids
            prompt_inputs.append(list(text) + token_ids)
            history_inputs.append(list(text)[:-1])

    def forward_longform(self, prompt_mels_for_llm, prompt_mels_lens_for_llm,
                         prompt_text_tokens_for_llm: List[List[int]],
                         text_tokens_for_llm: List[List[int]],
                         prompt_mels_for_flow_ori, spk_emb_for_flow,
                         sampling_params: Optional[SamplingParams] = None,
                         spk_ids: Optional[List[int]] = None,
                         use_dialect_prompt: bool = False,
                         dialect_prompt_text_tokens_for_llm=None,
                         dialect_prefix=None,
                         **kwargs) -> Dict[str, Any]:
        """Reference forward_longform (soulxpodcast.py:252-432): a
        multi-turn dialogue with KV reuse and the eviction policy — past
        ``max_turn_size`` turns or ``turn_tokens_threshold`` tokens the
        context is rebuilt (:meth:`_evict`) over a fresh cache. A
        stateless engine takes the full context every turn."""
        off = self.config.llm.speech_token_offset
        spk_ids = spk_ids or [0] * len(text_tokens_for_llm)
        (prompt_speech_tokens, prompt_mels_flow, prompt_mels_lens_flow,
         prompt_inputs, history_inputs) = self._longform_prepare(
            prompt_mels_for_llm, prompt_mels_lens_for_llm,
            prompt_text_tokens_for_llm, prompt_mels_for_flow_ori,
            use_dialect_prompt, dialect_prompt_text_tokens_for_llm,
            dialect_prefix)
        stateful = getattr(self.llm, "stateful", True)
        wavs = []

        def turn(i, pending, inputs, state):
            yield from ()       # a generator for _turns, yielding nothing
            if stateful:
                if state is None:
                    state = self.llm.new_state(1)
                out = self.llm.generate(pending, state=state)
                token_ids, state = out["token_ids"], out["state"]
            else:
                token_ids = self.llm.generate(inputs)["token_ids"]
            spk = spk_ids[i]
            wavs.append(self._token_to_wav(
                [t - off for t in token_ids[:-1]], prompt_speech_tokens[spk],
                prompt_mels_flow[spk], prompt_mels_lens_flow[spk],
                np.asarray(spk_emb_for_flow[spk:spk + 1], np.float32)))
            return token_ids, state

        for _ in self._turns(prompt_inputs, history_inputs,
                             text_tokens_for_llm, turn):
            pass
        return {"generated_wavs": wavs}

    def forward_longform_streaming(self, prompt_mels_for_llm,
                                   prompt_mels_lens_for_llm,
                                   prompt_text_tokens_for_llm,
                                   text_tokens_for_llm,
                                   prompt_mels_for_flow_ori,
                                   spk_emb_for_flow,
                                   spk_ids: Optional[List[int]] = None,
                                   use_dialect_prompt: bool = False,
                                   dialect_prompt_text_tokens_for_llm=None,
                                   dialect_prefix=None,
                                   llm_chunk: Optional[int] = None,
                                   **kwargs):
        """Streaming forward_longform: a generator of ``(turn_index,
        wav_chunk)`` while each turn's decode runs. The context (KV reuse
        and the eviction policy) is forward_longform's; each turn's
        synthesis runs the chunk-causal path
        (``infer/streaming_tts.StreamingTokenToWav``). Needs the stateful
        DecodeEngine (token streaming and caller-held cache state)."""
        if not getattr(self.llm, "stateful", True):
            raise ValueError("streaming longform needs the stateful "
                             "DecodeEngine (generate_stream)")
        off = self.config.llm.speech_token_offset
        spk_ids = spk_ids or [0] * len(text_tokens_for_llm)
        (prompt_speech_tokens, prompt_mels_flow, prompt_mels_lens_flow,
         prompt_inputs, history_inputs) = self._longform_prepare(
            prompt_mels_for_llm, prompt_mels_lens_for_llm,
            prompt_text_tokens_for_llm, prompt_mels_for_flow_ori,
            use_dialect_prompt, dialect_prompt_text_tokens_for_llm,
            dialect_prefix)

        def turn(i, pending, inputs, state):
            if state is None:
                state = self.llm.new_state(1)
            spk = spk_ids[i]
            synth = streaming_tts.StreamingTokenToWav(
                self.flow, self.flow_cfg, self.hift, self.hift_cfg,
                prompt_speech_tokens[spk], prompt_mels_flow[spk],
                prompt_mels_lens_flow[spk],
                np.asarray(spk_emb_for_flow[spk:spk + 1], np.float32),
                self._next_draws(), programs=self._stream_programs,
                device=self.device)
            token_ids: List[int] = []
            for new in self.llm.generate_stream(
                    pending, chunk=llm_chunk or synth.chunk, state=state):
                token_ids.extend(new)
                for wav in synth.push([t - off for t in token_ids[:-1]]):
                    yield i, wav
            for wav in synth.push([t - off for t in token_ids[:-1]],
                                  final=True):
                yield i, wav
            return token_ids, self.llm.last_stream_state

        yield from self._turns(prompt_inputs, history_inputs,
                               text_tokens_for_llm, turn)
