"""PyTorch port, speculative decoding (``infer/speculative.py``):
``ngram_draft`` exact against JAX; ``target_probs`` against JAX within
1e-5 and against the port's sampler's draw frequencies; greedy streams of
the "ngram" and "layer_skip" drafts equal to the JAX engine's plain
decode (prompts with repeats, left-padded, a stop id inside the stream,
the budget); the layer-skip draft's partial cache write; and the cache
after rejections equal to a one-pass prefill. fp32, qwen3_tiny, CPU."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.infer import speculative as jspec
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.infer import speculative as tspec
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.ops import sampling as ts
from tests.test_torch_decode_engine import engines, setup

SPEC = {"ngram": {}, "layer_skip": {"spec_draft": "layer_skip",
                                    "spec_layers": 2}}
PROMPTS = ([1, 2, 3, 1, 2, 3, 1, 2], [5, 9, 11], list(range(20)))


def test_ngram_draft_matches_jax():
    """The JAX test's cases (a match without continuation skipped,
    periodic extension, no match) and 40 random 24-token buffers of four
    symbols at every length."""
    cases = [([7, 1, 2, 3, 9, 1, 2, 0, 0, 0], 7, 3, 2, 1),
             ([2, 3, 2, 3, 0, 0], 4, 4, 2, 1),
             ([5, 6, 7, 8, 0, 0], 4, 2, 3, 2)]
    for toks, length, gamma, n_max, n_min in cases:
        ref = jspec.ngram_draft(jnp.asarray(toks, jnp.int32),
                                jnp.asarray(length), gamma, n_max, n_min)
        got = tspec.ngram_draft(torch.tensor(toks), length, gamma, n_max,
                                n_min)
        assert got.tolist() == np.asarray(ref).tolist(), (toks, length)
    jdraft = jax.jit(lambda t, n: jspec.ngram_draft(t, n, 5, 3, 1))
    rng = np.random.default_rng(0)
    for i in range(40):
        toks = rng.integers(0, 4, 24)
        ref = jdraft(jnp.asarray(toks, jnp.int32), jnp.asarray(i % 25))
        got = tspec.ngram_draft(torch.from_numpy(toks), i % 25, 5)
        assert got.tolist() == np.asarray(ref).tolist(), (toks, i % 25)
    assert tspec.ngram_draft(torch.tensor(cases[0][0]), 7, 3, 2,
                             1).tolist() == [3, 9, 1]


def _target_inputs(V=48, win=8, B=3, seed=3):
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=(B, V)) * 2.0).astype(np.float32)
    presence = rng.random((B, V)) < 0.15
    recent = rng.integers(0, 6, (B, win))
    recent_valid = np.ones((B, win), bool)
    recent_valid[0, :3] = False
    num_gen = np.asarray([4, 9, 0])[:B]
    return raw, presence, num_gen, recent, recent_valid


@pytest.mark.parametrize("use_ras,top_p", [(True, 0.85), (False, 1.0)])
def test_target_probs_matches_jax(use_ras, top_p):
    from tests.test_torch_decode_engine import JaxSP, SamplingParams
    V, win = 48, 8
    kw = dict(temperature=0.8, repetition_penalty=1.2, top_k=10,
              top_p=top_p, min_tokens=6, stop_token_ids=(47,),
              use_ras=use_ras, win_size=win, tau_r=0.2)
    args = _target_inputs(V, win)
    ref = jspec.target_probs(*map(jnp.asarray, args), JaxSP(**kw), (47,),
                             win)
    got = tspec.target_probs(*map(torch.from_numpy, args),
                             SamplingParams(**kw), (47,), win)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_target_probs_matches_the_sampler_empirically():
    """The closed form is the port's sample_token_topk's output
    distribution, RAS included: 40,000 draws within total variation
    0.02; EOS suppressed below min_tokens in both."""
    from tests.test_torch_decode_engine import SamplingParams
    V, win, n = 48, 8, 40000
    raw, presence, num_gen, recent, recent_valid = (
        torch.from_numpy(a[:1]) for a in _target_inputs(V, win))
    sp = SamplingParams(temperature=0.8, repetition_penalty=1.2, top_k=10,
                        top_p=0.85, min_tokens=6, stop_token_ids=(47,),
                        use_ras=True, win_size=win, tau_r=0.2)
    target = tspec.target_probs(raw, presence, num_gen, recent,
                                recent_valid, sp, (47,), win)[0].numpy()
    g = torch.Generator().manual_seed(0)
    toks = ts.sample_token_topk(
        g, raw.expand(n, V), presence.expand(n, V), num_gen.expand(n),
        recent.expand(n, win), recent_valid.expand(n, win),
        temperature=0.8, top_k=10, top_p=0.85, repetition_penalty=1.2,
        min_tokens=6, eos_ids=(47,), use_ras=True, win_size=win,
        tau_r=0.2)
    emp = np.bincount(toks.numpy(), minlength=V) / n
    assert 0.5 * np.abs(emp - target).sum() < 0.02
    assert target[47] == 0 and emp[47] == 0


@pytest.mark.parametrize("draft", ["ngram", "layer_skip"])
@pytest.mark.parametrize("penalty", [1.15, 1.5])
def test_spec_greedy_matches_jax(draft, penalty):
    """top_k 1 makes every step deterministic: the speculative stream
    equals the JAX engine's plain decode token for token."""
    s = setup(vocab=64, seed=0, layers=4, temperature=0.7,
              repetition_penalty=penalty, min_tokens=3, max_tokens=30)
    kw = dict(max_len=128, prefill_bucket=16)
    jeng, _ = engines(s, **kw)
    _, teng = engines(s, spec_gamma=3, **SPEC[draft], **kw)
    for prompt in PROMPTS:
        out = teng.generate(prompt)
        assert out["token_ids"] == jeng.generate(prompt)["token_ids"], \
            (draft, prompt)
        assert out["state"].cache.length == int(out["state"].length[0])


@pytest.mark.parametrize("draft", ["ngram", "layer_skip"])
def test_spec_greedy_left_padded_stop_id_and_budget_match_jax(draft):
    """generate_batch of one row left-pads it (RoPE positions count real
    tokens); a stop id taken from inside the plain stream ends the
    speculative stream there, as in JAX; every stream keeps to its
    budget."""
    s = setup(vocab=64, seed=4, layers=4, temperature=0.7,
              repetition_penalty=3.0, min_tokens=2, max_tokens=16)
    kw = dict(max_len=96, prefill_bucket=16)
    jeng, _ = engines(s, **kw)
    _, teng = engines(s, spec_gamma=3, **SPEC[draft], **kw)
    prompt = [1, 2, 3, 1, 2, 3, 9, 4, 5]            # 9 tokens, 7 pads
    ref = jeng.generate_batch([prompt], max_new=16,
                              use_prefix_cache=False)
    assert teng.generate_batch([prompt], max_new=16,
                               use_prefix_cache=False) == ref
    assert len(ref[0]) == 16
    for budget in (1, 5):
        assert teng.generate_batch([prompt], max_new=budget,
                                   use_prefix_cache=False) \
            == [ref[0][:budget]]
    # a second stop id: the first token of the plain stream new at
    # position >= 4 ends it there
    i, stop = next((i, t) for i, t in enumerate(ref[0])
                   if i >= 4 and t not in ref[0][:i])
    s = setup(vocab=64, seed=4, layers=4, temperature=0.7,
              repetition_penalty=3.0, min_tokens=2, max_tokens=16,
              stop_token_ids=(63, stop))
    jeng, _ = engines(s, **kw)
    _, teng = engines(s, spec_gamma=3, **SPEC[draft], **kw)
    ref = jeng.generate_batch([prompt], use_prefix_cache=False)
    got = teng.generate_batch([prompt], use_prefix_cache=False)
    assert got == ref and got[0][-1] == stop and len(got[0]) == i + 1


def test_spec_sampling_eos_and_budget_semantics():
    """Sampling with top-k 8: a stream stops at EOS (its last token) or
    at max_tokens, and a second turn continues from the returned state."""
    s = setup(vocab=64, seed=3, top_k=8, temperature=1.0, min_tokens=1,
              max_tokens=11)
    _, teng = engines(s, max_len=96, prefill_bucket=16, spec_gamma=4)
    for seed in range(6):
        teng._generator.manual_seed(seed)
        out = teng.generate([1, 2, 3, 4, 5])
        toks = out["token_ids"]
        assert 1 <= len(toks) <= 11
        if 63 in toks:
            assert toks[-1] == 63 and toks.count(63) == 1
        else:
            assert len(toks) == 11
        out2 = teng.generate([7, 8], state=out["state"])
        assert len(out2["token_ids"]) <= 11


def test_spec_cache_after_rejections_equals_one_prefill():
    """After a sampled speculative decode (rejections rewind the cache),
    the cache and last_logits equal a fresh prefill over the committed
    tokens (1e-4); with_stats counts the verify iterations."""
    s = setup(vocab=64, seed=2, top_k=16, temperature=1.0,
              repetition_penalty=1.1, top_p=0.9, min_tokens=0,
              max_tokens=20, use_ras=True, win_size=5)
    _, teng = engines(s, max_len=128, prefill_bucket=16, spec_gamma=3,
                      seed=11)
    prompt = [1, 2, 3, 1, 2, 3, 9]
    out = teng.generate(prompt)
    st = out["state"]
    L = int(st.length[0])
    assert st.cache.length == L
    _, plain = engines(s, max_len=128, prefill_bucket=16)
    ref = plain.prefill(plain.new_state(1), prompt + out["token_ids"])
    np.testing.assert_allclose(st.last_logits.numpy(),
                               ref.last_logits.numpy(), atol=1e-4,
                               rtol=1e-4)
    for a, b in ((st.cache.k, ref.cache.k), (st.cache.v, ref.cache.v)):
        np.testing.assert_allclose(a[:, :, :L].numpy(), b[:, :, :L].numpy(),
                                   atol=1e-4, rtol=1e-4)
    # with_stats, EOS suppressed throughout (RAS off: its raw resample
    # keeps EOS): 9 tokens, the first from the held logits, then 1 to 4
    # a verify iteration
    sp = dataclasses.replace(s[5], min_tokens=9, use_ras=False)
    fn = tspec.make_spec_decode_fn(s[3], sp, 3, with_stats=True)
    st = teng.prefill(teng.new_state(1), prompt)
    st, iters = fn(s[4], st, 9)
    assert int(st.num_generated[0]) == 9 and 1 <= iters <= 8


def test_layer_skip_partial_cache_matches_full_prefix_and_jax():
    """forward(num_layers=2) of 4 writes cache layers < 2 bit-identically
    to the full forward and leaves layers >= 2 untouched; its logits
    match JAX's partial forward."""
    jcfg, params, _, cfg, model, _ = setup(vocab=64, seed=0, layers=4)
    ids = np.random.default_rng(0).integers(1, 60, (1, 6))
    mask = torch.ones((1, 16), dtype=torch.int32)
    full = tq.KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    tq.forward(model, torch.from_numpy(ids), attention_mask=mask,
               cache=full)
    part = tq.KVCache.create(cfg, 1, 16, torch.float32, "cpu")
    part.k += 7.0
    part.v += 7.0
    lg, part = tq.forward(model, torch.from_numpy(ids), attention_mask=mask,
                          cache=part, num_layers=2)
    assert torch.equal(part.k[:2, :, :6], full.k[:2, :, :6])
    assert torch.equal(part.v[:2, :, :6], full.v[:2, :, :6])
    assert (part.k[2:] == 7.0).all() and (part.v[2:] == 7.0).all()
    ref, _ = jq.forward(params, jnp.asarray(ids, jnp.int32), jcfg,
                        attention_mask=jnp.ones((1, 16), jnp.int32),
                        cache=jq.KVCache.create(jcfg, 1, 16, jnp.float32),
                        num_layers=2)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
