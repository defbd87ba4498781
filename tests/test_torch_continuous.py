"""PyTorch port, continuous batching (``infer/continuous.py``): greedy
``ContinuousEngine.serve`` token lists equal to the JAX engine's and to
the port's ``DecodeEngine`` run prompt by prompt (5 prompts through 2
slots, mid-flight join and leave), per-request caps, one slot draining a
queue, and the chunk decode's per-row cache columns against the JAX
step. fp32, qwen3_tiny, CPU."""
import numpy as np
import jax.numpy as jnp
import torch

from speech_distill_tpu.infer import continuous as jcont
from speech_distill_tpu_torch.infer import continuous as tcont
from tests.test_torch_decode_engine import _prompts, engines, setup


def _continuous(setup_, **kw):
    jcfg, params, jsp, cfg, model, sp = setup_
    return (jcont.ContinuousEngine(params, jcfg, jsp,
                                   cache_dtype=jnp.float32, **kw),
            tcont.ContinuousEngine(model, cfg, sp, cache_dtype=torch.float32,
                                   device="cpu", **kw))


def test_serve_matches_jax_and_per_stream_decode():
    """5 prompts through 2 slots equal the JAX engine's outputs and the
    port's DecodeEngine decoding each prompt alone."""
    s = setup(seed=3)
    prompts = _prompts(np.random.default_rng(0), 5, 3, 11, 48)
    jeng, teng = _continuous(s, slots=2, max_len=64, prefill_bucket=8,
                             chunk_steps=3)
    got = teng.serve(prompts, max_new=6)
    assert got == jeng.serve(prompts, max_new=6)
    for p, o in zip(prompts, got):
        assert o == engines(s, max_len=64, prefill_bucket=8)[1].generate(
            p)["token_ids"]
    assert teng.n_decode_steps > 0


def test_per_request_caps_match_jax():
    """Each stream retires at its own cap; its tokens are the uncapped
    stream's prefix, as in JAX."""
    s = setup(seed=4, max_tokens=8, min_tokens=8)
    prompts = _prompts(np.random.default_rng(1), 4, 6, 7, 48)
    caps = [2, 5, 3, 7]
    jeng, teng = _continuous(s, slots=4, max_len=64, prefill_bucket=8,
                             chunk_steps=2)
    full = teng.serve(prompts, max_new=8)
    capped = teng.serve(prompts, max_new_per_request=caps)
    assert capped == jeng.serve(prompts, max_new_per_request=caps)
    assert capped == [f[:c] for f, c in zip(full, caps)]


def test_one_slot_drains_the_queue():
    """One slot, three prompts: strict sequential reuse of the slot, each
    equal to the single-stream engine."""
    s = setup(seed=5)
    prompts = _prompts(np.random.default_rng(2), 3, 5, 6, 48)
    _, teng = _continuous(s, slots=1, max_len=64, prefill_bucket=8,
                          chunk_steps=4)
    got = teng.serve(prompts, max_new=4)
    for p, o in zip(prompts, got):
        ref = engines(s, max_len=64, prefill_bucket=8)[1].generate(p)
        assert o == ref["token_ids"][:4]


def test_chunk_step_matches_jax():
    """Three slots at different lengths (one idle) after one admission
    each: two chunk steps leave the same tokens, lengths, finished flags,
    logits (1e-4) and cache rows (1e-5) as the JAX step."""
    s = setup(seed=6)
    prompts = [[3, 4, 5], [6, 7, 8, 9, 10, 11, 12]]
    jeng, teng = _continuous(s, slots=3, max_len=32, prefill_bucket=8,
                             chunk_steps=2)
    jst, tst = jeng.new_state(), teng.new_state()
    for b, p in enumerate(prompts):
        jst = jeng._prefill_slot(jst, b, p, cap=5)
        tst = teng._prefill_slot(tst, b, p, cap=5)
    jst = jeng._decode(jeng.params, jst, jnp.asarray(2, jnp.int32))
    assert teng._decode(teng.model, tst, 2) == 2
    for f in ("tokens", "length", "num_generated", "finished", "valid"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), f)
    live = [0, 1]
    np.testing.assert_allclose(tst.last_logits[live].numpy(),
                               np.asarray(jst.last_logits)[live],
                               atol=1e-4, rtol=1e-4)
    for a, b in ((tst.cache.k, jst.cache.k), (tst.cache.v, jst.cache.v)):
        np.testing.assert_allclose(a[:, live, :10].numpy(),
                                   np.asarray(b)[:, live, :10], atol=1e-5)
