"""PyTorch port, concurrent multi-session TTS serving
(``infer/tts_serve.py``): the batched coordinator against the port's
single-session synthesis at the same tick cadence, against the JAX
coordinator on the same streams and draws, the confidence gate, and an
end-to-end run over the port's ``PagedEngine`` on the CPU.

Tolerances: N = 1 is bit-equal to the single session (every group is one
row, so the calls are the same); batched rows and the JAX coordinator
agree to 2e-4 / rtol 1e-4 (the JAX test's bound: batched flow rows round
differently, HiFT rows take their own draws)."""
import numpy as np
import jax
import jax.numpy as jnp

from speech_distill_tpu.core.config import SamplingParams as JaxSP
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.infer import paged as jpaged
from speech_distill_tpu.infer import tts_serve as jts
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.core.config import SamplingParams, qwen3_tiny
from speech_distill_tpu_torch.infer import paged as tpaged
from speech_distill_tpu_torch.infer import tts_serve as tts
from speech_distill_tpu_torch.infer.streaming_tts import StreamingTokenToWav
from speech_distill_tpu_torch.models.convert import params_from_jax
from tests.test_torch_streaming_tts import JaxDraws, tiny_models
from tests.test_tts_serve import FakeEngine

WAV_ATOL, WAV_RTOL = 2e-4, 1e-4
_MODELS = {}


def _models(enc_chunk=4):
    if enc_chunk not in _MODELS:
        _MODELS[enc_chunk] = tiny_models(enc_chunk)
    return _MODELS[enc_chunk]


def _inputs(n, seed):
    """Session acoustic contexts (JAX keys as rngs) and token streams
    ending in a stand-in EOS."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pml = int(rng.integers(2, 7))
        out.append(dict(
            flow_prompt_tokens=rng.integers(0, 50, int(rng.integers(1, 4)))
            .tolist(),
            prompt_mel=rng.normal(size=(pml, 8)).astype(np.float32),
            prompt_mel_len=pml,
            spk_emb=rng.normal(size=(6,)).astype(np.float32),
            rng=jax.random.PRNGKey(100 + i)))
    streams = [rng.integers(0, 49, int(rng.integers(9, 19))).tolist() + [49]
               for _ in range(n)]
    return out, streams


def _port(inp):
    return dict(inp, rng=JaxDraws(inp["rng"]))


def _mel_pad(inputs):
    return max(-(-max(i["prompt_mel"].shape[0] for i in inputs) // 16) * 16,
               16)


def _single(inp, pushes, mel_pad_to):
    """The port's single-session synthesis at an explicit cadence
    [(tokens, final), ...]."""
    (_, _, _, _), (tf, tfc, th, thc) = _models()
    synth = StreamingTokenToWav(
        tf, tfc, th, thc, inp["flow_prompt_tokens"], inp["prompt_mel"],
        inp["prompt_mel_len"], inp["spk_emb"], _port(inp)["rng"],
        token_bucket=64, max_tokens=4096, mel_pad_to=mel_pad_to,
        device="cpu")
    chunks = []
    for toks, final in pushes:
        chunks += synth.push(toks, final=final)
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)


def _cadence(stream, chunk):
    """The pushes a FakeEngine tick cadence makes (the withheld last
    token included)."""
    out = []
    for i0 in range(chunk, len(stream) + chunk, chunk):
        gen = stream[:min(i0, len(stream))]
        out.append((gen[:-1], len(gen) == len(stream)))
    return out


def _coordinator(inputs, streams, chunk=3, lps=None, **kw):
    (_, _, _, _), (tf, tfc, th, thc) = _models()
    coord = tts.MultiSessionTTS(FakeEngine(streams, chunk=chunk, lps=lps),
                                tf, tfc, th, thc, speech_token_offset=0,
                                device="cpu", **kw)
    res = coord.serve([tts.TTSSession(llm_ids=[1, 2, 3], **_port(i))
                       for i in inputs])
    return res, coord


def test_single_session_is_bit_equal():
    inputs, streams = _inputs(1, seed=3)
    res, _ = _coordinator(inputs, streams)
    ref = _single(inputs[0], _cadence(streams[0], 3), _mel_pad(inputs))
    assert res[0]["tokens"] == streams[0]
    np.testing.assert_array_equal(res[0]["wav"], ref)


def test_multi_session_matches_single_session():
    """N = 5 staggered sessions: batched rows match each session's own
    synthesis; the tick times are recorded by row count."""
    inputs, streams = _inputs(5, seed=0)
    res, coord = _coordinator(inputs, streams)
    for r, inp, s in zip(res, inputs, streams):
        ref = _single(inp, _cadence(s, 3), _mel_pad(inputs))
        assert r["tokens"] == s
        assert r["wav"].shape == ref.shape
        np.testing.assert_allclose(r["wav"], ref, atol=WAV_ATOL,
                                   rtol=WAV_RTOL)
        assert r["n_chunks"] >= 1 and r["ttfa_s"] >= 0
    assert max(r["n_chunks"] for r in res) >= 2
    assert max(coord.tick_ms["flow"]) >= 2        # rows did batch
    assert all(ms >= 0 for v in coord.tick_ms["vocode"].values() for ms in v)


def test_coordinator_matches_jax():
    """The port's coordinator and JAX's on the same streams, weights and
    draws give the same wav per session."""
    (fp, fc, hp, hc), _ = _models()
    inputs, streams = _inputs(3, seed=5)
    res, _ = _coordinator(inputs, streams)
    jcoord = jts.MultiSessionTTS(FakeEngine(streams, chunk=3), fp, fc, hp,
                                 hc, speech_token_offset=0)
    ref = jcoord.serve([jts.TTSSession(llm_ids=[1, 2, 3], **i)
                        for i in inputs])
    for r, j in zip(res, ref):
        assert r["tokens"] == j["tokens"]
        assert r["n_chunks"] == j["n_chunks"]
        np.testing.assert_allclose(r["wav"], j["wav"], atol=WAV_ATOL,
                                   rtol=WAV_RTOL)


def _gated(seed=3, n_tokens=12):
    inputs, _ = _inputs(1, seed)
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 49, n_tokens - 1).tolist() + [49]
    return inputs, stream


def test_confidence_gate_passthrough_when_confident():
    inputs, stream = _gated()
    lps = [[-0.1] * len(stream)]
    gated, _ = _coordinator(inputs, [stream], lps=lps, confidence_gate=-1e9)
    plain, _ = _coordinator(inputs, [stream], lps=lps)
    assert gated[0]["gate_deferrals"] == plain[0]["gate_deferrals"] == 0
    np.testing.assert_array_equal(gated[0]["wav"], plain[0]["wav"])


def test_confidence_gate_defers_low_confidence_run():
    """Fresh spans per tick [0:2], [2:5] (mean -10 < -6: deferred), then
    [2:8] (mean -5.05: synthesized), then final: bit-equal to the single
    session at the merged cadence."""
    inputs, stream = _gated()
    lps = [-0.1] * len(stream)
    lps[2:5] = [-10.0] * 3
    res, _ = _coordinator(inputs, [stream], lps=[lps], confidence_gate=-6.0,
                          gate_max_defer=2)
    assert res[0]["gate_deferrals"] == 1
    ref = _single(inputs[0], [(stream[:2], False), (stream[:8], False),
                              (stream[:11], True)], _mel_pad(inputs))
    np.testing.assert_array_equal(res[0]["wav"], ref)


def test_confidence_gate_deferral_is_bounded():
    inputs, stream = _gated()
    res, _ = _coordinator(inputs, [stream], lps=[[-10.0] * len(stream)],
                          confidence_gate=-3.0, gate_max_defer=1)
    # tick 1 defers, tick 2 forced (5 tokens), tick 3 defers, tick 4 final
    assert res[0]["gate_deferrals"] == 2
    ref = _single(inputs[0], [(stream[:5], False), (stream[:11], True)],
                  _mel_pad(inputs))
    np.testing.assert_array_equal(res[0]["wav"], ref)


def test_pow2_batches():
    rows = list(range(7))
    assert [len(b) for b in tts.MultiSessionTTS._pow2_batches(rows)] \
        == [4, 2, 1]
    assert [x for b in tts.MultiSessionTTS._pow2_batches(rows)
            for x in b] == rows


def test_multisession_over_paged_engine():
    """Four sessions through the port's PagedEngine (2 slots, greedy):
    tokens equal the JAX engine's; wavs finite and sized by their token
    counts; every session streamed."""
    jcfg = jax_tiny(48, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(3), jcfg)
    cfg = qwen3_tiny(48, dtype="float32")
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    greedy = dict(stop_token_ids=(47,), max_tokens=12, min_tokens=12,
                  top_k=1, temperature=1.0, use_ras=False,
                  repetition_penalty=1.0)
    kw = dict(slots=2, max_len=64, page_size=8, chunk_steps=3)
    eng = tpaged.PagedEngine(model, cfg, SamplingParams(**greedy),
                             device="cpu", **kw)
    (_, _, _, _), (tf, tfc, th, thc) = _models(enc_chunk=2)
    rng = np.random.default_rng(8)
    pml = 4
    sessions = [tts.TTSSession(
        llm_ids=rng.integers(1, 46, 8).tolist(),
        flow_prompt_tokens=rng.integers(0, 50, 2).tolist(),
        prompt_mel=rng.normal(size=(pml, 8)).astype(np.float32),
        prompt_mel_len=pml, spk_emb=rng.normal(size=(6,)).astype(np.float32),
        rng=i) for i in range(4)]
    coord = tts.MultiSessionTTS(eng, tf, tfc, th, thc, speech_token_offset=0,
                                device="cpu")
    streamed = []
    res = coord.serve(sessions, max_new=12,
                      on_wav=lambda sid, w: streamed.append(sid))
    jeng = jpaged.PagedEngine(params, jcfg, JaxSP(**greedy),
                              cache_dtype=jnp.float32, attn_impl="xla", **kw)
    ref = jeng.serve([s.llm_ids for s in sessions], max_new=12)
    assert [r["tokens"] for r in res] == ref
    for r in res:
        n_tok = 2 + len(r["tokens"]) - 1
        assert r["wav"].shape[0] == (2 * n_tok - pml) * thc.upsample_scale
        assert np.isfinite(r["wav"]).all() and r["ttfa_s"] is not None
    assert len(set(streamed)) == 4
