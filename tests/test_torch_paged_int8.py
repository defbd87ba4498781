"""PyTorch port, the int8 KV pool: ``quantize_kv``, the plain int8 paged
attention (the function of the K4-int8 kernel), ``paged_forward`` and
greedy ``PagedEngine.serve`` over an int8 pool on the quantized tiny model
(int4 layers, int8 embed), held against the JAX package on the CPU."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import SamplingParams as JaxSP
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.infer import paged as jpaged
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.ops import quant as jquant
from speech_distill_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention, paged_attention_xla,
    quantize_kv as jax_quantize_kv)
from speech_distill_tpu_torch.core.config import SamplingParams, qwen3_tiny
from speech_distill_tpu_torch.infer import paged as tpaged
from speech_distill_tpu_torch.models.convert import params_from_jax
from speech_distill_tpu_torch.ops import _cuda
from speech_distill_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_plain, quantize_kv)

ATOL, RTOL = 3e-5, 1e-3      # as tests/test_paged_attention.py (int8)


@pytest.mark.parametrize("shape", [(5, 3, 16, 64), (2, 4, 8, 16)])
def test_quantize_kv_codes_equal_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x[0, 0] = 0.0                             # all-zero slices: scale 1
    x[1, 0, 0, :4] = [1.27, -1.27, 0.5, 0.0]  # a slice with exact ties
    x[1, 0, 0, 4:] = 0.0
    rq, rs = jax_quantize_kv(jnp.asarray(x))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert np.all(s.numpy()[0, 0] == 1.0)


def _int8_inputs(L=3, B=4, KV=2, G=3, Dh=32, P=16, ps=16, mp=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, Dh)).astype(np.float32)
    kp = rng.normal(size=(L, P, KV, ps, Dh)).astype(np.float32)
    vp = rng.normal(size=(L, P, KV, ps, Dh)).astype(np.float32)
    kq, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(kp)))
    vq, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(vp)))
    bt = rng.permutation(P)[:B * mp].reshape(B, mp).astype(np.int32)
    lengths = np.asarray([0, ps // 2 + 3, ps, 2 * ps + 5][:B], np.int32)
    return q, kq, vq, bt, lengths, ks, vs


@pytest.mark.parametrize("layer", [None, 0, 2])
def test_int8_plain_matches_jax_kernel_and_oracle(layer):
    """With a layer index into the full [L, P, KV, ps, Dh] pool, and
    without one over a one-layer pool [P, KV, ps, Dh]."""
    q, kq, vq, bt, lengths, ks, vs = _int8_inputs(seed=3 + (layer or 0))
    if layer is None:
        kq, vq, ks, vs = (np.ascontiguousarray(a[1])
                          for a in (kq, vq, ks, vs))
    args = (q, kq, vq, bt, lengths)
    kw = {} if layer is None else {"layer": layer}
    got = paged_attention_plain(*map(torch.from_numpy, args), **kw,
                                k_scale=torch.from_numpy(ks),
                                v_scale=torch.from_numpy(vs))
    jargs = [jnp.asarray(a) for a in args]
    jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    if layer is not None:
        jkw["layer"] = jnp.asarray(layer, jnp.int32)
    for ref in (jax_paged_attention(*jargs, **jkw, interpret=True),
                paged_attention_xla(*jargs, **jkw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=RTOL)
    assert np.all(got.numpy()[0] == 0.0)        # idle row: exact zeros
    # the CPU wrapper is the plain version and launches nothing
    before = _cuda.launches["paged_decode_int8"]
    same = paged_attention(*map(torch.from_numpy, args), **kw,
                           k_scale=torch.from_numpy(ks),
                           v_scale=torch.from_numpy(vs))
    assert _cuda.launches["paged_decode_int8"] == before
    torch.testing.assert_close(same, got, atol=0, rtol=0)


def test_int8_plain_dequantizes_in_q_dtype():
    """bf16 queries: the gathered rows dequantize in bf16, as
    ``paged_attention_xla`` does; the result is bf16."""
    q, kq, vq, bt, lengths, ks, vs = _int8_inputs(seed=9)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    got = paged_attention_plain(qb, *map(torch.from_numpy,
                                         (kq, vq, bt, lengths)), layer=1,
                                k_scale=torch.from_numpy(ks),
                                v_scale=torch.from_numpy(vs))
    ref = paged_attention_xla(jnp.asarray(qb.float().numpy(), jnp.bfloat16),
                              *map(jnp.asarray, (kq, vq, bt, lengths)),
                              layer=jnp.asarray(1, jnp.int32),
                              k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2)
    with pytest.raises(ValueError, match="k_scale"):
        paged_attention_plain(qb, *map(torch.from_numpy,
                                       (kq, vq, bt, lengths)), layer=1)


def _setup(vocab=48, seed=3, max_tokens=6):
    """fp32 qwen3_tiny with int4 layers and an int8 embed/tied head."""
    jcfg = jax_tiny(vocab, dtype="float32", remat=False)
    params = jquant.quantize_params(
        jq.init_params(jax.random.PRNGKey(seed), jcfg), bits=4,
        method="int4", quantize_embed=True)
    cfg = qwen3_tiny(vocab, dtype="float32")
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    greedy = dict(stop_token_ids=(vocab - 1,), max_tokens=max_tokens,
                  min_tokens=max_tokens, top_k=1, temperature=1.0,
                  use_ras=False, repetition_penalty=1.0)
    return jcfg, params, JaxSP(**greedy), cfg, model, SamplingParams(**greedy)


def test_int8_paged_forward_matches_jax_step_by_step():
    """Two rows (one dead) through 6 decode steps over an int8 pool: logits
    agree with the JAX paged_forward (XLA attention) at every step, and so
    do the scales and codes written to the live row's pages. The K/V that
    are quantized come out of fp32 products summed in another order, so a
    scale may differ in its last bits and a code by one step at a tie;
    ``quantize_kv`` itself is held bit-exact above."""
    jcfg, params, _, cfg, model, _ = _setup()
    rng = np.random.default_rng(0)
    ps, n_pages, B = 4, 8, 2
    bt = np.asarray([[3, 0, 5, 7], [1, 2, 4, 6]], np.int32)
    jpool = jpaged.PagedKVCache.create(jcfg, n_pages, ps, jnp.int8)
    tpool = tpaged.PagedKVCache.create(cfg, n_pages, ps, torch.int8, "cpu")
    assert tpool.quantized and tpool.ks.shape == (2, n_pages + 1, 2, ps)
    assert tpool.ks.data_ptr() != tpool.vs.data_ptr()
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
                                   np.asarray(ref)[live], atol=1e-4,
                                   rtol=1e-4)
        pages = bt[0, :t // ps + 1]
        for name in ("k", "v"):
            code = getattr(tpool, name)[:, pages].numpy().astype(int)
            ref_code = np.asarray(getattr(jpool, name))[:, pages]
            assert np.abs(code - ref_code).max() <= 1, name
            assert (code != ref_code).mean() < 0.01, name
        for name in ("ks", "vs"):
            np.testing.assert_allclose(
                getattr(tpool, name)[:, pages].numpy(),
                np.asarray(getattr(jpool, name))[:, pages], rtol=1e-5,
                err_msg=name)


def test_int8_serve_matches_jax_engine():
    """Greedy serve of 5 prompts through 2 slots with an int8 pool,
    token for token against the JAX engine; a prefix hit comes from an
    earlier serve() call (both gather dequantized pages)."""
    jcfg, params, jsp, cfg, model, sp = _setup()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 46, int(rng.integers(3, 11))).tolist()
               for _ in range(5)]
    kw = dict(slots=2, max_len=64, page_size=8, chunk_steps=3)
    jeng = jpaged.PagedEngine(params, jcfg, jsp, cache_dtype=jnp.int8,
                              attn_impl="xla", **kw)
    teng = tpaged.PagedEngine(model, cfg, sp, device="cpu",
                              cache_dtype=torch.int8, **kw)
    assert teng.serve(prompts, max_new=6) == jeng.serve(prompts, max_new=6)
    assert teng._state.pool.k.dtype == torch.int8
    again = [prompts[0] + [5, 6, 7, 8, 9, 10, 11, 12] + prompts[1]]
    assert teng.serve(again, max_new=5) == jeng.serve(again, max_new=5)
    assert teng.prefix_hits == jeng.prefix_hits == 1
    # one model forward a prefill, batched or not
    assert teng.n_prefill_forwards == 1


def test_int8_serve_slot_invariant_and_prefix_modes():
    """Quantization is per token, so a stream's KV never depends on its
    slot: int8 serve is exactly slot-count invariant with prefix sharing
    off; with it on (hits attend over dequantized pages) the caps
    contract holds."""
    _, _, _, cfg, model, sp = _setup()
    rng = np.random.default_rng(2)
    common = rng.integers(1, cfg.vocab_size - 2, 8).tolist()
    prompts = [common + rng.integers(1, cfg.vocab_size - 2,
                                     int(rng.integers(3, 9))).tolist()
               for _ in range(5)]
    kw = dict(max_len=64, page_size=8, chunk_steps=3, device="cpu",
              cache_dtype=torch.int8, prefix_sharing=False)
    got2 = tpaged.PagedEngine(model, cfg, sp, slots=2, **kw).serve(
        prompts, max_new=6)
    got1 = tpaged.PagedEngine(model, cfg, sp, slots=1, **kw).serve(
        prompts, max_new=6)
    assert got2 == got1
    assert all(len(o) == 6 for o in got2)
    eng = tpaged.PagedEngine(model, cfg, sp, slots=2,
                             **{**kw, "prefix_sharing": True})
    caps = [3, 6, 2, 5, 4]
    outs = eng.serve(prompts, max_new_per_request=caps)
    assert [len(o) for o in outs] == caps
    assert eng.prefix_hits > 0
