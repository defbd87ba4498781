"""PyTorch port, the SoulXPodcast orchestrator (``infer/soulxpodcast.py``)
against the JAX one on the same tiny components as
``tests/test_soulxpodcast.py`` (a vocab-64 LLM with speech at 40, the tiny
flow, HiFT and S3 encoder), fp32 with greedy sampling: every turn's
tokens equal JAX's on both engines, with and without the eviction
rebuild, and the wavs within 1e-4 with JAX's flow noise and NSF draws
replayed (:class:`JaxReplay`); single-shot TTS likewise; the streaming
long form and streaming single-shot TTS give JAX's tokens and, turn by
turn, JAX's concatenated chunks within 1e-4 (:class:`JaxStreamReplay`),
and the streaming long form gives the offline turns' tokens. CPU.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import EngineConfig as JaxEC
from speech_distill_tpu.core.config import SamplingParams as JaxSP
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.infer.engine import DecodeEngine as JaxDecode
from speech_distill_tpu.infer.paged import PagedEngine as JaxPaged
from speech_distill_tpu.infer.soulxpodcast import SoulXPodcast as JaxSXP
from speech_distill_tpu.models import flow as jflow
from speech_distill_tpu.models import flow_encoder as jfe
from speech_distill_tpu.models import hift as jhift
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.tokenizer import s3 as js3
from speech_distill_tpu_torch.core.config import (EngineConfig,
                                                  SamplingParams, qwen3_tiny)
from speech_distill_tpu_torch.infer.engine import DecodeEngine
from speech_distill_tpu_torch.infer.paged import PagedEngine
from speech_distill_tpu_torch.infer.soulxpodcast import SoulXPodcast
from speech_distill_tpu_torch.models.convert import (params_from_jax,
                                                     s3_params_from_jax)
from speech_distill_tpu_torch.tokenizer import s3 as ts3
from tests.test_torch_flow import port_flow
from tests.test_torch_hift import jax_nsf_draws, port_hift
from tests.test_torch_streaming_tts import JaxDraws

# With the fixture's weights x10 the wavs peak near 3e-2 and the fp32
# error against JAX stays under 3e-5; a wrong speaker moves them by 4e-3.
# Each comparison asserts a peak of 10x the bound, so it cannot pass on a
# silent wav.
WAV_ATOL = 1e-4
GREEDY = dict(temperature=1.0, repetition_penalty=1.0, top_k=1, top_p=1.0,
              min_tokens=2, max_tokens=8, stop_token_ids=(63,),
              use_ras=False, win_size=5)
ENGINE = dict(max_model_len=256, max_turn_size=3, turn_tokens_threshold=120)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxReplay:
    """The JAX orchestrator's key splits as the port's draw sources: each
    ``_next_draws`` takes what the JAX ``_token_to_wav`` takes, one key
    for the flow noise and one for the NSF draws."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def __call__(self):
        kf, kh = self._next(), self._next()

        class Draws:
            def flow_noise(self, shape):
                return torch.from_numpy(np.array(
                    jax.random.normal(kf, shape, jnp.float32)))

            def source(self, T, H):
                return jax_nsf_draws(kh, 1, T, H)
        return Draws()


class JaxStreamReplay(JaxReplay):
    """The same key splits for the streaming paths: each utterance takes
    one key, which JAX's ``StreamingTokenToWav`` splits into the noise
    buffer's key and the vocoder key (:class:`JaxDraws`)."""

    def __call__(self):
        return JaxDraws(self._next())


@pytest.fixture(scope="module")
def parts():
    """(JAX parts, port parts) on the same weights."""
    jcfg = dataclasses.replace(jax_tiny(64), dtype="float32", remat=False,
                               attn_impl="xla", speech_token_offset=40,
                               eos_token_id=63)
    llm = jq.init_params(jax.random.PRNGKey(0), jcfg)
    enc = jfe.FlowEncoderConfig(
        input_size=16, output_size=16, attention_heads=2, linear_units=32,
        num_blocks=1, num_up_blocks=1)
    fcfg = jflow.FlowConfig(
        input_size=16, output_size=8, spk_embed_dim=6, vocab_size=23,
        n_timesteps=2, est_in_channels=32, est_channels=16, est_n_blocks=1,
        est_num_mid_blocks=1, est_num_heads=2, est_head_dim=8, encoder=enc)
    fp = jflow.init_params(jax.random.PRNGKey(1), fcfg)
    hcfg = jhift.HiFTConfig(
        in_channels=8, base_channels=16, nb_harmonics=2,
        resblock_kernel_sizes=(3,), resblock_dilations=((1,),),
        source_resblock_kernel_sizes=(3, 3, 3),
        source_resblock_dilations=((1,), (1,), (1,)), f0_cond_channels=8)
    hp = jhift.init_params(jax.random.PRNGKey(2), hcfg)
    # x10 the init's 0.01-0.02 draws so the wav follows the mel, the
    # speaker and the draws: at init scale HiFT's head stays near exp(0)
    # and every wav is the same ripple of ~2e-5
    fp, hp = (jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) * np.float32(10)) if a.ndim >= 2 else a, p)
        for p in (fp, hp))
    s3cfg = js3.S3Config(n_mels=16, n_state=16, n_head=2, n_layer=1,
                         fsq_dim=3, fsq_level=3)
    s3p = js3.init_params(jax.random.PRNGKey(3), s3cfg)

    @jax.jit
    def jquant(mels, lens):
        codes, code_lens = js3.quantize(s3p, mels, lens, s3cfg)
        return jnp.minimum(codes, fcfg.vocab_size - 1), code_lens

    cfg = qwen3_tiny(64, dtype="float32", speech_token_offset=40,
                     eos_token_id=63)
    model = params_from_jax(jax.tree.map(np.asarray, llm), cfg, "cpu")
    flow, tfcfg = port_flow(fp, fcfg)
    hift, thcfg = port_hift(hp, hcfg)
    tcfg3 = ts3.S3Config(**dataclasses.asdict(s3cfg))
    s3m = s3_params_from_jax(jax.tree.map(np.asarray, s3p), tcfg3, "cpu")

    def tquant(mels, lens):
        codes, code_lens = ts3.quantize(s3m, mels, lens)
        return codes.clamp(max=tfcfg.vocab_size - 1), code_lens

    return ((jcfg, llm, jquant, fp, fcfg, hp, hcfg),
            (cfg, model, tquant, flow, tfcfg, hift, thcfg))


@pytest.fixture(scope="module")
def pairs(parts):
    """``pair(engine, seed)``: (JAX SoulXPodcast, port SoulXPodcast) over
    ``engine`` ("decode" or "paged"), greedy, the port replaying JAX's
    draws. The JAX orchestrator and the engines are built once an engine
    (their compiled programs reused) and reseeded a call."""
    (jcfg, llm, jquant, fp, fcfg, hp, hcfg), \
        (cfg, model, tquant, flow, tfcfg, hift, thcfg) = parts
    jsp, sp = JaxSP(**GREEDY), SamplingParams(**GREEDY)
    built = {}

    def engines(engine):
        if engine == "decode":
            return (JaxDecode(llm, jcfg, jsp, max_len=256, prefill_bucket=16,
                              cache_dtype=jnp.float32),
                    DecodeEngine(model, cfg, sp, max_len=256,
                                 prefill_bucket=16,
                                 cache_dtype=torch.float32, device="cpu"))
        return (JaxPaged(llm, jcfg, jsp, slots=2, max_len=256, page_size=16,
                         chunk_steps=4, cache_dtype=jnp.float32,
                         attn_impl="xla"),
                PagedEngine(model, cfg, sp, slots=2, max_len=256,
                            page_size=16, chunk_steps=4,
                            cache_dtype=torch.float32, device="cpu"))

    def pair(engine, seed=0):
        if engine not in built:
            jeng, teng = engines(engine)
            built[engine] = (
                JaxSXP(JaxEC(model="", llm=jcfg, sampling=jsp, **ENGINE),
                       jeng, jquant, fp, fcfg, hp, hcfg),
                SoulXPodcast(EngineConfig(model="", llm=cfg, sampling=sp,
                                          **ENGINE), teng, tquant, flow,
                             tfcfg, hift, thcfg, device="cpu"))
            # one compile of the JAX flow and HiFT for both orchestrators
            first = next(iter(built.values()))[0]
            built[engine][0]._flow_fn = first._flow_fn
            built[engine][0]._hift_fn = first._hift_fn
        jm, tm = built[engine]
        jm._rng = jax.random.PRNGKey(seed)
        tm._next_draws = JaxReplay(seed)
        for m in (jm, tm):              # undo an earlier test's recording
            m.llm.__dict__.pop("generate", None)
            m.llm.__dict__.pop("generate_stream", None)
        return jm, tm
    return pair


def assert_wav_close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 10 * WAV_ATOL
    np.testing.assert_allclose(got, ref, atol=WAV_ATOL, rtol=0)


def _record(engine, method="generate"):
    """Wrap ``engine.<method>`` to keep every turn's generated ids."""
    seen = []
    real = getattr(engine, method)
    if method == "generate":
        def wrapped(*a, **kw):
            out = real(*a, **kw)
            seen.append(list(out["token_ids"]))
            return out
    else:
        def wrapped(*a, **kw):
            toks = []
            for new in real(*a, **kw):
                toks.extend(new)
                yield new
            seen.append(toks)
    setattr(engine, method, wrapped)
    return seen


def _features(n_prompts, seed, mel_T=32):
    rng = np.random.default_rng(seed)
    mels = rng.normal(size=(n_prompts, 16, mel_T)).astype(np.float32)
    lens = np.full((n_prompts,), mel_T, np.int32)
    flow_mel = [rng.normal(size=(mel_T // 2, 8)).astype(np.float32)
                for _ in range(n_prompts)]
    spk = rng.normal(size=(n_prompts, 6)).astype(np.float32)
    return mels, lens, flow_mel, spk


def _longform_kw(turns, seed):
    mels, lens, flow_mel, spk = _features(2, seed)
    return dict(prompt_mels_for_llm=mels, prompt_mels_lens_for_llm=lens,
                prompt_text_tokens_for_llm=[[1, 2], [3, 4]],
                text_tokens_for_llm=[[5, 6 + i] for i in range(turns)],
                prompt_mels_for_flow_ori=flow_mel, spk_emb_for_flow=spk,
                spk_ids=[i % 2 for i in range(turns)])


@pytest.mark.parametrize("engine", ["decode", "paged"])
@pytest.mark.parametrize("turns", [2, 5])
def test_longform_matches_jax(pairs, engine, turns):
    """Two turns (no eviction) and five (max_turn_size 3 forces the
    rebuild): the same tokens every turn, the wavs within 1e-4."""
    jm, tm = pairs(engine)
    jseen, tseen = _record(jm.llm), _record(tm.llm)
    kw = _longform_kw(turns, seed=turns)
    jw = jm.forward_longform(**kw)["generated_wavs"]
    tw = tm.forward_longform(**kw)["generated_wavs"]
    assert tseen == jseen and len(tseen) == turns
    assert len(tw) == turns
    for a, b in zip(tw, jw):
        assert_wav_close(a, b)


def test_single_shot_tts_matches_jax(pairs):
    """forward_tts and forward_tts2 over the decode engine."""
    jm, tm = pairs("decode", seed=1)
    mels, lens, flow_mel, spk = _features(1, seed=4)
    kw = dict(prompt_mels_for_llm=mels[0], prompt_mels_lens_for_llm=lens[0],
              prompt_mels_for_flow_ori=flow_mel[0], spk_emb_for_flow=spk[0])
    outs = []
    for m in (jm, tm):
        a = m.forward_tts(prompt_text_tokens_for_llm=[1, 2, 3],
                          text_tokens_for_llm=[4, 5], **kw)
        b = m.forward_tts2(inputs=[1, 2, 3, 4], **kw)
        outs.append(a["generated_wavs"] + b["generated_wavs"])
    for a, b in zip(outs[1], outs[0]):
        assert_wav_close(a, b)


def _turn_wavs(chunks):
    """``(turn, chunk)`` pairs -> one concatenated wav a turn."""
    per_turn = {}
    for turn, chunk in chunks:
        per_turn.setdefault(turn, []).append(np.asarray(chunk))
    return [np.concatenate(per_turn[i]) for i in sorted(per_turn)]


def test_longform_streaming_gives_the_offline_turns(pairs):
    """forward_longform_streaming over five turns (max_turn_size 3 forces
    an eviction rebuild) with JAX's draws replayed: each turn's streamed
    tokens equal JAX's streamed turn and the port's offline turn, and
    each turn's chunks, concatenated, make (2 n_gen) x 480 samples equal
    to JAX's within 1e-4 (the speaker's prompt, the draws and the dropped
    EOS all show there)."""
    kw = _longform_kw(5, seed=7)
    _, tm = pairs("decode")
    offline = _record(tm.llm)
    tm.forward_longform(**kw)
    jm, tm = pairs("decode", seed=3)
    tm._next_draws = JaxStreamReplay(3)
    jseen = _record(jm.llm, "generate_stream")
    tseen = _record(tm.llm, "generate_stream")
    jw = _turn_wavs(jm.forward_longform_streaming(**kw))
    tw = _turn_wavs(tm.forward_longform_streaming(**kw))
    assert tseen == jseen == offline and len(tseen) == 5
    assert len(tw) == len(jw) == 5
    scale = tm.hift_cfg.upsample_scale
    for a, b, toks in zip(tw, jw, offline):
        assert a.shape == (2 * (len(toks) - 1) * scale,)
        assert_wav_close(a, b)


def test_tts_streaming_matches_jax(pairs):
    """forward_tts_streaming with JAX's draws replayed: the same tokens
    and the same concatenated chunks within 1e-4."""
    jm, tm = pairs("decode", seed=5)
    tm._next_draws = JaxStreamReplay(5)
    jseen = _record(jm.llm, "generate_stream")
    tseen = _record(tm.llm, "generate_stream")
    mels, lens, flow_mel, spk = _features(1, seed=6)
    kw = dict(prompt_mels_for_llm=mels[0], prompt_mels_lens_for_llm=lens[0],
              prompt_text_tokens_for_llm=[1, 2, 3],
              text_tokens_for_llm=[4, 5], prompt_mels_for_flow_ori=flow_mel[0],
              spk_emb_for_flow=spk[0])
    jw = [np.asarray(c) for c in jm.forward_tts_streaming(**kw)]
    tw = list(tm.forward_tts_streaming(**kw))
    assert tseen == jseen and len(tseen) == 1
    assert len(tw) == len(jw) >= 1
    assert_wav_close(np.concatenate(tw), np.concatenate(jw))


def test_paged_engine_is_stateless_and_refuses_streaming(pairs):
    _, tm = pairs("paged")
    assert tm.llm.stateful is False
    with pytest.raises(ValueError, match="stateful"):
        next(tm.forward_longform_streaming(**_longform_kw(1, seed=0)))
