"""PyTorch port, contiguous-cache decoding (``infer/engine.py``):
``qwen3.forward`` with per-row ``positions``, per-row ``cache_positions``
and ``num_layers`` against the JAX forward (logits 1e-4 / rtol 1e-4);
``segmented_top_k`` against JAX (values exact, indices exact on tie-free
inputs); greedy ``DecodeEngine`` token lists equal to the JAX engine's on
the same weights (``generate`` over two turns, left-padded
``generate_batch`` with and without a shared prefix, ``generate_stream``
chunked and multi-turn, a decode that crosses cache windows); a retained
state rolled back to; and ``stream_tts`` over the port's engine. fp32,
qwen3_tiny, CPU; JAX attention through "xla"."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import SamplingParams as JaxSP
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.distill.losses import segmented_top_k as j_segtopk
from speech_distill_tpu.infer.engine import DecodeEngine as JaxEngine
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.core.config import SamplingParams, qwen3_tiny
from speech_distill_tpu_torch.distill.losses import segmented_top_k
from speech_distill_tpu_torch.infer import streaming_tts as tst
from speech_distill_tpu_torch.infer.engine import DecodeEngine
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.models.convert import params_from_jax

LOGITS_ATOL = 1e-4


def setup(vocab=48, seed=3, layers=2, **sp):
    """(JAX cfg, JAX params, JAX sampler, port cfg, port model, port
    sampler) on the same weights. The sampler defaults to greedy argmax
    (deterministic, robust to fp noise) with EOS vocab - 1."""
    jcfg = jax_tiny(vocab, dtype="float32", remat=False, attn_impl="xla",
                    num_hidden_layers=layers)
    params = jq.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = qwen3_tiny(vocab, dtype="float32", num_hidden_layers=layers)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    kw = dict(stop_token_ids=(vocab - 1,), max_tokens=6, min_tokens=6,
              top_k=1, temperature=1.0, use_ras=False,
              repetition_penalty=1.0)
    kw.update(sp)
    return jcfg, params, JaxSP(**kw), cfg, model, SamplingParams(**kw)


def engines(setup_, **kw):
    """The JAX and the port DecodeEngine with the same options (fp32
    caches)."""
    jcfg, params, jsp, cfg, model, sp = setup_
    return (JaxEngine(params, jcfg, jsp, cache_dtype=jnp.float32, **kw),
            DecodeEngine(model, cfg, sp, cache_dtype=torch.float32,
                         device="cpu", **kw))


def _prompts(rng, n, lo, hi, vocab):
    return [rng.integers(1, vocab - 2, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def test_forward_cache_options_match_jax():
    """A left-padded prefill with per-row positions, two per-row-column
    decode steps (cache_positions) and a 1-layer step (num_layers):
    logits and the whole cache agree with JAX after each call."""
    jcfg, params, _, cfg, model, _ = setup(vocab=64, seed=1)
    rng = np.random.default_rng(0)
    B, T, S = 2, 6, 16
    ids = rng.integers(1, 60, (B, T))
    n = np.asarray([6, 3])                   # row 1 left-padded by 3
    mask = np.zeros((B, S), np.int32)
    pos = np.zeros((B, T), np.int64)
    for b in range(B):
        mask[b, T - n[b]:T] = 1
        pos[b, T - n[b]:] = np.arange(n[b])
    jc = jq.KVCache.create(jcfg, B, S, jnp.float32)
    tc = tq.KVCache.create(cfg, B, S, torch.float32, "cpu")

    def both(tok, m, **kw):
        nonlocal jc, tc
        ref, jc = jq.forward(params, jnp.asarray(tok, jnp.int32), jcfg,
                             attention_mask=jnp.asarray(m), cache=jc,
                             **{k: jnp.asarray(v, jnp.int32)
                                if isinstance(v, np.ndarray) else v
                                for k, v in kw.items()})
        got, tc = tq.forward(model, torch.from_numpy(tok).long(),
                             attention_mask=torch.from_numpy(m), cache=tc,
                             **{k: torch.from_numpy(v)
                                if isinstance(v, np.ndarray) else v
                                for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOGITS_ATOL, rtol=1e-4)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v),
                                   atol=1e-5, rtol=1e-5)

    both(ids, mask, positions=pos)
    cols = np.asarray([T, T + 2])            # rows at different columns
    for step in range(2):
        mask[np.arange(B), cols + step] = 1
        both(rng.integers(1, 60, (B, 1)), mask,
             cache_positions=cols + step)
    mask[:, T + 4] = 1
    both(rng.integers(1, 60, (B, 1)), mask, num_layers=1,
         positions=np.asarray([[7], [5]]))
    assert tc.length == int(jc.length)


@pytest.mark.parametrize("shape,k,ties", [
    ((3, 159488), 100, False), ((2, 5, 4096), 32, False),
    ((2, 40), 5, False), ((2, 8192), 16, True)])
def test_segmented_top_k_matches_jax(shape, k, ties):
    """Values equal JAX's exactly; indices too on tie-free rows (a
    permutation of distinct values); on rows of few distinct values the
    values still agree."""
    rng = np.random.default_rng(k)
    if ties:
        x = rng.integers(0, 7, shape).astype(np.float32)
    else:
        x = np.stack([rng.permutation(shape[-1]) for _ in
                      range(int(np.prod(shape[:-1])))]).reshape(shape)
        x = (x * 0.01 - 3.0).astype(np.float32)
    jv, ji = j_segtopk(jnp.asarray(x), k)
    tv, ti = segmented_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if not ties:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the indices name the values either way
    np.testing.assert_array_equal(
        np.take_along_axis(x, ti.numpy(), -1), tv.numpy())


def test_generate_two_turns_matches_jax():
    """Two turns on one caller-held state (the second prefills on top of
    the first's cache), greedy: equal to JAX token for token."""
    s = setup(seed=3, max_tokens=7, min_tokens=7)
    jeng, teng = engines(s, max_len=64, prefill_bucket=8)
    t1, t2 = [1, 2, 3, 4, 5, 6, 7, 8, 9], [10, 11, 12]
    j1 = jeng.generate(t1)
    j2 = jeng.generate(t2, state=j1["state"])
    p1 = teng.generate(t1)
    p2 = teng.generate(t2, state=p1["state"])
    assert p1["token_ids"] == j1["token_ids"]
    assert p2["token_ids"] == j2["token_ids"]
    assert p2["state"].cache.length == int(p2["state"].length[0]) \
        == int(j2["state"].cache.length)


@pytest.mark.parametrize("shared", [False, True])
def test_generate_batch_matches_jax(shared):
    """Left-padded rows of different lengths, with and without a shared
    prefix (>= prefix_cache_min) prefilled once and broadcast; then the
    prefix hit of a second call."""
    s = setup(seed=4)
    jeng, teng = engines(s, max_len=96, prefill_bucket=8,
                         prefix_cache_min=8)
    rng = np.random.default_rng(1)
    prompts = _prompts(rng, 3, 2, 9, 48)
    if shared:
        prefix = rng.integers(1, 46, 11).tolist()
        prompts = [prefix + p for p in prompts]
    ref = jeng.generate_batch(prompts, max_new=5)
    got = teng.generate_batch(prompts, max_new=5)
    assert got == ref
    assert len(teng._prefix_cache) == int(shared)
    if shared:
        assert teng.generate_batch(prompts[::-1], max_new=5) == ref[::-1]


def test_generate_stream_matches_generate_and_jax():
    """Chunks of 5 concatenate to generate()'s tokens, which equal JAX's;
    a second turn continues from last_stream_state like generate()."""
    s = setup(seed=3, max_tokens=17, min_tokens=17)
    jeng, teng = engines(s, max_len=64, prefill_bucket=8)
    t1, t2 = list(range(1, 9)), [7, 8, 9]
    j1 = jeng.generate(t1)
    j2 = jeng.generate(t2, state=j1["state"])
    chunks = list(teng.generate_stream(t1, chunk=5))
    assert len(chunks) >= 3 and all(0 < len(c) <= 5 for c in chunks)
    assert [t for c in chunks for t in c] == j1["token_ids"]
    g2 = [t for c in teng.generate_stream(
        t2, chunk=4, state=teng.last_stream_state) for t in c]
    assert g2 == j2["token_ids"]


def test_windowed_decode_crosses_windows_like_jax():
    """A 500-token prompt with max_len 1100: the decode runs in the
    512-column window, then the 1024 one, then the whole cache."""
    s = setup(vocab=64, seed=5, max_tokens=700, min_tokens=700)
    jeng, teng = engines(s, max_len=1100, prefill_bucket=128)
    prompt = np.random.default_rng(2).integers(1, 62, 500).tolist()
    ref = jeng.generate(prompt)["token_ids"]
    got = teng.generate(prompt)["token_ids"]
    assert len(got) == 1100 - 500 and got == ref


def test_a_retained_state_rolls_back():
    """Two turns taken from the same retained state give the same tokens
    (sampling on: the generator is part of the state), and the retained
    state's own tensors are untouched by either."""
    s = setup(seed=6, top_k=8, temperature=0.9, use_ras=True, win_size=4,
              repetition_penalty=1.2, min_tokens=2, max_tokens=12)
    _, teng = engines(s, max_len=96, prefill_bucket=8)
    base = teng.generate([1, 2, 3, 4, 5])["state"]
    snap = [base.tokens.clone(), base.valid.clone(), base.length.clone(),
            base.presence.clone(), base.cache.length]
    a = teng.generate([9, 8, 7], state=base)["token_ids"]
    b = teng.generate([9, 8, 7], state=base)["token_ids"]
    assert a == b and len(a) > 0
    for before, now in zip(snap, [base.tokens, base.valid, base.length,
                                  base.presence, base.cache.length]):
        assert (torch.equal(before, now) if torch.is_tensor(now)
                else before == now)


def test_approx_topk_method_is_the_exact_top_k():
    """topk_method="approx" samples exactly as "exact" (same seed)."""
    outs = []
    for method in ("exact", "approx"):
        s = setup(seed=7, top_k=6, temperature=0.8, use_ras=True,
                  repetition_penalty=1.1, min_tokens=0, max_tokens=12,
                  topk_method=method)
        _, teng = engines(s, max_len=64, prefill_bucket=8, seed=3)
        outs.append(teng.generate([3, 1, 4, 1, 5])["token_ids"])
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="topk_method"):
        s = setup(top_k=6, topk_method="sorted")
        engines(s, max_len=64)[1].generate([1, 2])


def test_stream_tts_over_the_decode_engine():
    """stream_tts over the port's DecodeEngine on the tiny flow and HiFT:
    the wav is finite, as long as the tokens it read say, comes in more
    than one chunk, and equals the synthesizer fed generate()'s tokens
    (the trailing one withheld) at the same cadence."""
    from tests.test_torch_streaming_tts import _utterance, tiny_models
    _, (flow, fc, hift, hc) = tiny_models()
    # every id of a 52-token LLM minus the offset is a flow id (< 50)
    offset, n_gen = 2, 30
    s = setup(vocab=52, seed=8, max_tokens=n_gen, min_tokens=n_gen)
    jcfg, params, jsp, cfg, model, sp = s
    cfg = dataclasses.replace(cfg, speech_token_offset=offset)
    ptoks, pmel, pml, spk, _ = _utterance(9, 0)
    llm_in = [1, 2, 3, 4]

    def eng():
        return DecodeEngine(model, cfg, sp, max_len=64, prefill_bucket=8,
                            cache_dtype=torch.float32, device="cpu")
    wavs = list(tst.stream_tts(eng(), flow, fc, hift, hc, llm_in, offset,
                               ptoks, pmel, pml, spk, 11, llm_chunk=4,
                               token_bucket=8, mel_cache_frames=2,
                               max_tokens=64, device="cpu"))
    gen = eng().generate(llm_in)["token_ids"]
    assert len(gen) == n_gen
    flow_ids = [t - offset for t in gen]
    assert max(flow_ids) < fc.vocab_size
    synth = tst.StreamingTokenToWav(flow, fc, hift, hc, ptoks, pmel, pml,
                                    spk, 11, token_bucket=8,
                                    mel_cache_frames=2, max_tokens=64,
                                    device="cpu")
    ref = []
    for n in list(range(4, n_gen, 4)) + [n_gen]:    # the stream's yields
        ref += synth.push(flow_ids[:n - 1])
    ref += synth.push(flow_ids[:n_gen - 1], final=True)
    wav = np.concatenate(wavs)
    assert len(wavs) >= 2 and np.isfinite(wav).all()
    n_tok = len(ptoks) + n_gen - 1
    assert wav.shape == ((n_tok * fc.token_mel_ratio - pml)
                         * hc.upsample_scale,)
    np.testing.assert_array_equal(wav, np.concatenate(ref))


def test_prefill_near_max_len_is_narrowed():
    """A turn whose bucketed prefill would run past max_len (52 + 16 >
    64) is narrowed to the 12 columns left: its logits equal one prefill
    of the whole history. JAX's dynamic_update_slice moves that write
    back onto columns 48-51 of the history instead, and its logits
    differ (a standing divergence, ROADMAP §3)."""
    s = setup(seed=9)
    jeng, teng = engines(s, max_len=64, prefill_bucket=16)
    t1 = list(range(1, 47))
    j1, p1 = jeng.generate(t1), teng.generate(t1)
    assert p1["token_ids"] == j1["token_ids"] and len(p1["token_ids"]) == 6
    t2 = [7, 8, 9, 10]
    got = teng.prefill(p1["state"], t2)
    ref = teng.prefill(teng.new_state(1), t1 + p1["token_ids"] + t2)
    np.testing.assert_allclose(got.last_logits.numpy(),
                               ref.last_logits.numpy(), atol=1e-4,
                               rtol=1e-4)
    jgot = jeng.prefill(j1["state"], t2)
    assert np.abs(np.asarray(jgot.last_logits)
                  - ref.last_logits.numpy()).max() > 1e-2
    with pytest.raises(ValueError, match="overflow"):
        teng.prefill(got, list(range(1, 10)))


def test_fresh_prefill_attends_over_its_bucket(monkeypatch):
    """A fresh turn's prefill runs over its own bucket (T == S: the shape
    K1-fwd takes on the card), a later turn's over the whole cache; the
    tokens stay JAX's on both turns."""
    s = setup(vocab=48, seed=5)
    seen = []
    real = tq.use_flash

    def spy(q, k, impl="auto"):
        seen.append((q.shape[1], k.shape[1]))
        return real(q, k, impl)
    monkeypatch.setattr(tq, "use_flash", spy)
    jeng, teng = engines(s, max_len=64, prefill_bucket=16)
    p1, p2 = list(range(1, 21)), [3, 4, 5]
    j1, t1 = jeng.generate(p1), teng.generate(p1)
    assert t1["token_ids"] == j1["token_ids"]
    assert seen[0] == (32, 32)
    seen.clear()
    j2 = jeng.generate(p2, state=j1["state"])
    t2 = teng.generate(p2, state=t1["state"])
    assert t2["token_ids"] == j2["token_ids"]
    assert seen[0] == (16, 64)
