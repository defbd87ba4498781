"""PyTorch port, paged serving: ``paged_forward`` step by step and greedy
``PagedEngine.serve`` token lists held against the JAX engine on the same
weights (fp32, qwen3_tiny, CPU), including forced preemption and
prefix-cache hits."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import SamplingParams as JaxSP
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.infer import paged as jpaged
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu_torch.core.config import SamplingParams, qwen3_tiny
from speech_distill_tpu_torch.infer import paged as tpaged
from speech_distill_tpu_torch.models.convert import params_from_jax


def _setup(vocab=48, seed=3, max_tokens=6):
    jcfg = jax_tiny(vocab, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = qwen3_tiny(vocab, dtype="float32")
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    # greedy argmax decode: deterministic, robust to fp noise
    greedy = dict(stop_token_ids=(vocab - 1,), max_tokens=max_tokens,
                  min_tokens=max_tokens, top_k=1, temperature=1.0,
                  use_ras=False, repetition_penalty=1.0)
    return jcfg, params, JaxSP(**greedy), cfg, model, SamplingParams(**greedy)


def _serve_both(jcfg, params, jsp, cfg, model, sp, prompts, max_new, **kw):
    jeng = jpaged.PagedEngine(params, jcfg, jsp, cache_dtype=jnp.float32,
                              attn_impl="xla", **kw)
    teng = tpaged.PagedEngine(model, cfg, sp, device="cpu", **kw)
    return (jeng, jeng.serve(prompts, max_new=max_new),
            teng, teng.serve(prompts, max_new=max_new))


def test_paged_forward_matches_jax_step_by_step():
    """Two rows (one dead) through 6 decode steps: logits agree with the
    JAX paged_forward (XLA attention) at every step."""
    jcfg, params, _, cfg, model, _ = _setup()
    rng = np.random.default_rng(0)
    ps, n_pages, B = 4, 8, 2
    bt = np.asarray([[3, 0, 5, 7], [1, 2, 4, 6]], np.int32)
    jpool = jpaged.PagedKVCache.create(jcfg, n_pages, ps, jnp.float32)
    tpool = tpaged.PagedKVCache.create(cfg, n_pages, ps, torch.float32,
                                       "cpu")
    live = np.asarray([True, False])
    for t in range(6):
        tok = rng.integers(1, cfg.vocab_size - 2, B).astype(np.int32)
        lengths = np.full(B, t, np.int32)
        ref, jpool = jpaged.paged_forward(
            params, jnp.asarray(tok), jcfg, jpool, jnp.asarray(bt),
            jnp.asarray(lengths), jnp.asarray(live), attn_impl="xla")
        got = tpaged.paged_forward(
            model, torch.from_numpy(tok).long(), tpool,
            torch.from_numpy(bt), torch.from_numpy(lengths).long(),
            torch.from_numpy(live))
        np.testing.assert_allclose(got[live].numpy(),
                                   np.asarray(ref)[live],
                                   atol=1e-4, rtol=1e-4)
        # live row's pages agree; the dead row wrote only the drop page
        np.testing.assert_allclose(tpool.k[:, :n_pages].numpy(),
                                   np.asarray(jpool.k), atol=1e-5)


def test_serve_matches_jax_engine():
    """5 prompts through 2 slots (mid-flight join/leave)."""
    setup = _setup()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 46, int(rng.integers(3, 11))).tolist()
               for _ in range(5)]
    _, ref, teng, got = _serve_both(*setup, prompts, 6, slots=2, max_len=64,
                                    page_size=8, chunk_steps=3)
    assert got == ref
    assert teng.n_decode_steps > 0 and teng.n_exit_syncs >= teng.n_chunks


def test_serve_matches_jax_under_preemption():
    """A pool too small for all slots forces recompute preemption in both
    engines; token lists stay identical."""
    setup = _setup(seed=5, max_tokens=8)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 46, 9).tolist() for _ in range(4)]
    jeng, ref, teng, got = _serve_both(*setup, prompts, 8, slots=3,
                                       max_len=48, page_size=8, num_pages=7,
                                       chunk_steps=4)
    assert teng.preemptions > 0, "config failed to force preemption"
    assert teng.preemptions == jeng.preemptions
    assert got == ref


def test_serve_matches_jax_with_prefix_hits():
    """Prompts sharing a page-aligned prefix registered by an earlier
    serve() reuse its pages (suffix-only prefill); a multi-turn context
    extension hits the pages of prompt + generated tokens."""
    jcfg, params, jsp, cfg, model, sp = _setup(seed=7)
    rng = np.random.default_rng(3)
    common = rng.integers(1, 46, 16).tolist()
    prompts = [common + rng.integers(1, 46, k).tolist() for k in (3, 5, 7)]
    prompts.append(list(common))      # full match: prompt == prefix
    kw = dict(slots=2, max_len=64, page_size=8, chunk_steps=3)
    jeng = jpaged.PagedEngine(params, jcfg, jsp, cache_dtype=jnp.float32,
                              attn_impl="xla", **kw)
    teng = tpaged.PagedEngine(model, cfg, sp, device="cpu", **kw)
    first = teng.serve(prompts[:1], max_new=6)
    assert first == jeng.serve(prompts[:1], max_new=6)
    got = teng.serve(prompts[1:], max_new=6)
    assert got == jeng.serve(prompts[1:], max_new=6)
    assert teng.prefix_hits == jeng.prefix_hits == 3
    assert teng.prefix_hit_tokens == jeng.prefix_hit_tokens
    turn2 = [prompts[0] + first[0] + [5, 6]]
    assert teng.serve(turn2, max_new=4) == jeng.serve(turn2, max_new=4)
    assert teng.prefix_hits == 1


def test_same_pass_prefix_hit_reads_written_pages():
    """Two prompts with a common prefix admitted in ONE scheduler pass:
    the second one's prefix pages are written (by the first one's pending
    prefill) before it gathers them, so logits equal the no-sharing run.
    The JAX engine gathers first here; the port does not follow it."""
    _, _, _, cfg, model, sp = _setup(seed=7)
    rng = np.random.default_rng(3)
    common = rng.integers(1, 46, 16).tolist()
    prompts = [common + rng.integers(1, 46, k).tolist() for k in (3, 5)]
    kw = dict(slots=2, max_len=64, page_size=8, chunk_steps=1,
              device="cpu")
    on = tpaged.PagedEngine(model, cfg, sp, **kw)
    off = tpaged.PagedEngine(model, cfg, sp, prefix_sharing=False, **kw)
    assert on.serve(prompts, max_new=2) == off.serve(prompts, max_new=2)
    assert on.prefix_hits == 1
    torch.testing.assert_close(on._state.last_logits,
                               off._state.last_logits, atol=1e-5, rtol=0)


def test_per_request_caps_and_streaming():
    jcfg, params, jsp, cfg, model, sp = _setup(seed=4)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 46, 6).tolist() for _ in range(4)]
    caps = [2, 5, 3, 7]
    kw = dict(slots=4, max_len=64, page_size=8, chunk_steps=2)
    teng = tpaged.PagedEngine(model, cfg, sp, device="cpu", **kw)
    streamed = {i: [] for i in range(4)}
    done = set()

    def on_tokens(rid, toks, fin):
        streamed[rid] += toks
        if fin:
            done.add(rid)

    got = teng.serve(prompts, max_new_per_request=caps, on_tokens=on_tokens)
    jeng = jpaged.PagedEngine(params, jcfg, jsp, cache_dtype=jnp.float32,
                              attn_impl="xla", **kw)
    assert got == jeng.serve(prompts, max_new_per_request=caps)
    assert [len(g) for g in got] == caps
    assert streamed == dict(enumerate(got)) and done == set(range(4))
    assert all(m["n_gen"] == c for m, c in zip(teng.request_metrics, caps))
    assert set(teng.phase_seconds) == {"grow", "admit", "decode_sync",
                                       "retire", "downstream"}
    # single-request API: a stateless serve of one prompt
    assert teng.generate(prompts[1], max_new=5)["token_ids"] == got[1]


def test_allocator_refcounts():
    pool = tpaged.PagePool(4)
    a = pool.alloc(2)
    b = pool.alloc(2)
    assert pool.alloc(1) is None
    pool.share(a)
    pool.free(a)
    assert pool.free_pages == 0          # still referenced once
    pool.free(a)
    pool.free(b)
    assert pool.free_pages == 4


def _pp_mesh():
    """A rank's view of a dp 1 x pp 2 mesh (no process group: the serve
    calls no collective on it); the dp x tp mesh runs on gloo ranks in
    ``tests/test_torch_paged_tp.py``."""
    from speech_distill_tpu_torch.parallel.mesh import Mesh
    shape = {"dp": 1, "pp": 2, "sp": 1, "tp": 1}
    return Mesh(shape, {a: 0 for a in shape}, torch.device("cpu"))


@pytest.mark.parametrize("kw", [{"mesh": _pp_mesh()}],
                         ids=lambda kw: next(iter(kw)))
def test_deferred_features_raise(kw):
    """A mesh with pp serves a replica on each pp rank, as JAX's engine
    shards only over dp and tp: the greedy tokens equal JAX's engine on a
    dp 4 x pp 2 mesh of its 8 devices. A pipelined model (each rank
    holding a stage's layers) raises ``ValueError``."""
    import copy
    import dataclasses
    from speech_distill_tpu.core.config import MeshConfig as JMesh
    from speech_distill_tpu.parallel import mesh as jmesh
    jcfg, params, jsp, cfg, model, sp = _setup()
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8], [9, 10]]
    jeng = jpaged.PagedEngine(params, jcfg, jsp, cache_dtype=jnp.float32,
                              attn_impl="xla", slots=4, max_len=32,
                              page_size=8, mesh=jmesh.make_mesh(JMesh(pp=2)))
    teng = tpaged.PagedEngine(model, cfg, sp, device="cpu", slots=4,
                              max_len=32, page_size=8, **kw)
    assert teng.serve(prompts, max_new=6) == jeng.serve(prompts, max_new=6)
    piped = copy.copy(model)
    piped.cfg = dataclasses.replace(cfg, pp_microbatches=2)
    piped.mesh = kw["mesh"]
    with pytest.raises(ValueError, match="pp_microbatches"):
        tpaged.PagedEngine(piped, piped.cfg, sp, device="cpu", **kw)


def _noop(*_):
    pass


@pytest.mark.parametrize("engine_kw,serve_kw,match", [
    ({"admission_policy": "lottery"}, None, "admission_policy"),
    ({}, {"on_tokens": _noop, "on_logprobs": _noop}, "return_logprobs"),
    ({"return_logprobs": True}, {"on_logprobs": _noop}, "companion"),
    ({}, {"sampling_per_request": [{"temperature": 0.5}]},
     "per_request_sampling"),
    ({"per_request_sampling": True},
     {"sampling_per_request": [{"top_k": 3}]}, "unknown sampling")],
    ids=["unknown_policy", "logprobs_without_flag",
         "logprobs_without_on_tokens", "overrides_without_flag",
         "unknown_override"])
def test_misuse_raises_value_error(engine_kw, serve_kw, match):
    """The JAX engine's ValueErrors: at construction, or at serve()."""
    _, _, _, cfg, model, sp = _setup()
    with pytest.raises(ValueError, match=match):
        eng = tpaged.PagedEngine(model, cfg, sp, slots=2, max_len=32,
                                 page_size=8, device="cpu", **engine_kw)
        eng.serve([[1, 2, 3]], max_new=2, **serve_kw)
