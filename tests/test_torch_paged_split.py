"""PyTorch port, K4's split plan and its merge algebra on the CPU.

``ops/paged_attention.k4_plan`` splits each row's pages over the blocks
of one thread-block cluster. The kernel (``csrc/paged_decode.cu``) keeps
an online softmax state (m, l, acc) for each split over only the tokens
below the row's length, in fp32 and in the log2 domain, then merges the
splits in split order:
M = max m_i, out = sum 2^(m_i - M) acc_i / max(sum 2^(m_i - M) l_i, 1e-30).
This file repeats that algorithm in plain torch and holds it against the
JAX ``paged_attention`` (Pallas interpret mode) and ``paged_attention_xla``
on the same numpy-seeded inputs, for bf16, fp32 and int8 pools.

Tolerances: fp32 at 1e-5 (only summation order and association differ);
bf16 at 2e-2, the kernel tests' BF16_ATOL: the TPU kernel rounds p to bf16
before P.V (``speech_distill_tpu/ops/paged_attention.py:171-175``) while
the redesign keeps p in fp32, and both outputs are rounded to bf16.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_distill_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention, paged_attention_xla,
    quantize_kv as jax_quantize_kv)
from speech_distill_tpu_torch.ops.paged_attention import (
    MAX_SPLITS, K4Plan, k4_plan)

FP32_ATOL = 1e-5
BF16_ATOL = 2e-2
LOG2E = 1.4426950408889634
H100_SMS = 132


def _ranges(plan: K4Plan, max_pages: int):
    pps = plan.pages_per_split
    return [(r * pps, min((r + 1) * pps, max_pages))
            for r in range(plan.splits)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
@pytest.mark.parametrize("page_size", [16, 64, 128])
@pytest.mark.parametrize("max_pages", [1, 2, 16, 64])
def test_plan_covers_each_page_once(max_pages, page_size, dtype):
    """Over the plan's splits, pages [0, max_pages) each once, no split
    empty or past the last page, at most MAX_SPLITS (a portable cluster);
    stages tile a page (int8: 4-row multiples, 16-byte scale runs)."""
    for B, KV in ((16, 8), (1, 8), (64, 8), (256, 8)):
        plan = k4_plan(B, KV, max_pages, page_size, 128, dtype, H100_SMS)
        assert 1 <= plan.splits <= MAX_SPLITS
        pages = [p for lo, hi in _ranges(plan, max_pages)
                 for p in range(lo, hi)]
        assert pages == list(range(max_pages))
        assert all(hi > lo for lo, hi in _ranges(plan, max_pages))
        assert page_size % plan.stage_tokens == 0
        assert dtype != torch.int8 or plan.stage_tokens % 4 == 0
        assert 1 <= plan.stages <= 4


def test_plan_is_a_function_of_static_shapes():
    """No argument carries lengths: the launch stays free of host syncs
    and capturable in a CUDA graph; equal shapes give equal plans."""
    assert list(inspect.signature(k4_plan).parameters) == [
        "B", "KV", "max_pages", "page_size", "Dh", "dtype", "sms"]
    args = (16, 8, 16, 128, 128, torch.bfloat16, H100_SMS)
    assert k4_plan(*args) == k4_plan(*args)


def test_plan_at_the_serve_shape():
    """The smoke's engine (16 rows, KV 8, max_len 2,048 at page size 128,
    max_pages 16): a 2,048-token row over 8 splits of 2 pages, 8 x 16 x 8
    = 1,024 blocks on 132 SMs."""
    bf16 = k4_plan(16, 8, 16, 128, 128, torch.bfloat16, H100_SMS)
    assert (bf16.splits, bf16.pages_per_split) == (8, 2)
    int8 = k4_plan(16, 8, 16, 128, 128, torch.int8, H100_SMS)
    assert (int8.splits, int8.pages_per_split) == (8, 2)
    # large batches need fewer splits to fill the card
    assert k4_plan(256, 8, 16, 128, 128, torch.bfloat16,
                   H100_SMS).splits < 8


def split_merge(q, k_pool, v_pool, bt, lengths, layer, plan,
                k_scale=None, v_scale=None):
    """The kernel's algorithm in plain torch (fp32): each split's online
    softmax state over its tokens below the length (the rows past it and
    the table entries past ceil(len / ps) are never read), then the
    cluster merge in split order. q [B, KV, G, Dh] and the full pools
    [L, P, KV, ps, Dh] (int8 with scales [L, P, KV, ps]) -> fp32."""
    B, KV, G, Dh = q.shape
    ps = k_pool.shape[3]
    c = Dh ** -0.5 * LOG2E
    out = torch.zeros(B, KV, G, Dh)
    for b in range(B):
        n = int(lengths[b])
        states = []
        for r in range(plan.splits):
            t0 = r * plan.pages_per_split * ps
            t1 = min(n, t0 + plan.pages_per_split * ps)
            m = torch.full((KV, G), -1e30)
            l = torch.zeros(KV, G)
            acc = torch.zeros(KV, G, Dh)
            if t1 > t0:
                toks = torch.arange(t0, t1)
                pages = bt[b, toks // ps].long()
                slots = toks % ps
                k = k_pool[layer][pages, :, slots].float()   # [T, KV, Dh]
                v = v_pool[layer][pages, :, slots].float()
                s = torch.einsum("kgd,tkd->kgt", q[b].float(), k)
                if k_scale is not None:
                    ks = k_scale[layer][pages, :, slots].T     # [KV, T]
                    s = s * ks[:, None, :]
                s = s * c
                m = s.amax(-1)
                p = torch.exp2(s - m[..., None])
                l = p.sum(-1)
                if v_scale is not None:
                    p = p * v_scale[layer][pages, :, slots].T[:, None, :]
                acc = torch.einsum("kgt,tkd->kgd", p, v)
            states.append((m, l, acc))
        if n == 0:
            continue
        M = states[0][0]
        for m, _, _ in states[1:]:
            M = torch.maximum(M, m)
        num = torch.zeros(KV, G, Dh)
        den = torch.zeros(KV, G)
        for m, l, acc in states:
            w = torch.exp2(m - M)
            num = num + w[..., None] * acc
            den = den + w * l
        out[b] = num / den.clamp_min(1e-30)[..., None]
    return out


def _inputs(ps=16, mp=16, B=7, KV=2, G=2, Dh=32, L=2, seed=0):
    """Rows of lengths 0, 1, ps, ps + 1, 5 ps + 3 (the plan's last splits
    empty), one token in the last split, and the whole table."""
    rng = np.random.default_rng(seed)
    P = B * mp + 1
    q = rng.normal(size=(B, KV, G, Dh)).astype(np.float32)
    kp = rng.normal(size=(L, P, KV, ps, Dh)).astype(np.float32)
    vp = rng.normal(size=(L, P, KV, ps, Dh)).astype(np.float32)
    bt = rng.permutation(P)[:B * mp].reshape(B, mp).astype(np.int32)
    plan = k4_plan(B, KV, mp, ps, Dh, torch.float32, H100_SMS)
    last = (plan.splits - 1) * plan.pages_per_split * ps + 1
    lengths = np.asarray([0, 1, ps, ps + 1, 5 * ps + 3, last, mp * ps],
                         np.int32)
    assert plan.splits == 8 and plan.pages_per_split == 2
    return q, kp, vp, bt, lengths


def _plan(q, bt, kp, dtype):
    return k4_plan(q.shape[0], q.shape[1], bt.shape[1], kp.shape[3],
                   q.shape[3], dtype, H100_SMS)


def _check(got, refs, atol):
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   atol=atol, rtol=0)
    assert np.all(got[0] == 0.0)                 # idle row: exact zeros


@pytest.mark.parametrize("layer", [0, 1])
def test_split_merge_matches_jax_fp32(layer):
    q, kp, vp, bt, lengths = _inputs(seed=layer)
    plan = _plan(q, bt, kp, torch.float32)
    got = split_merge(*map(torch.from_numpy, (q, kp, vp, bt, lengths)),
                      layer, plan)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths)]
    lay = jnp.asarray(layer, jnp.int32)
    _check(got.numpy(), (jax_paged_attention(*jargs, layer=lay,
                                             interpret=True),
                         paged_attention_xla(*jargs, layer=lay)), FP32_ATOL)


def test_split_merge_matches_jax_bf16():
    q, kp, vp, bt, lengths = _inputs(seed=3)
    q16, kp16, vp16 = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, kp, vp))
    plan = _plan(q, bt, kp, torch.bfloat16)
    got = split_merge(q16, kp16, vp16, torch.from_numpy(bt),
                      torch.from_numpy(lengths), 1, plan)
    # the kernel writes bf16
    got = got.to(torch.bfloat16).float().numpy()
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
             for a in (q16, kp16, vp16)] + [jnp.asarray(bt),
                                            jnp.asarray(lengths)]
    lay = jnp.asarray(1, jnp.int32)
    refs = [np.asarray(r.astype(jnp.float32)) for r in (
        jax_paged_attention(*jargs, layer=lay, interpret=True),
        paged_attention_xla(*jargs, layer=lay))]
    _check(got, refs, BF16_ATOL)


@pytest.mark.parametrize("q_dtype,atol", [(torch.float32, FP32_ATOL),
                                          (torch.bfloat16, BF16_ATOL)])
def test_split_merge_matches_jax_int8(q_dtype, atol):
    """The int8 fold: score (q . k_t) ks[t], then the softmax scale;
    p_t vs[t] into P.V; l takes p_t alone."""
    q, kp, vp, bt, lengths = _inputs(seed=4)
    kq, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(kp)))
    vq, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(vp)))
    tq = torch.from_numpy(q).to(q_dtype)
    plan = _plan(q, bt, kp, torch.int8)
    got = split_merge(tq, *map(torch.from_numpy, (kq, vq, bt, lengths)), 1,
                      plan, k_scale=torch.from_numpy(ks),
                      v_scale=torch.from_numpy(vs))
    got = got.to(q_dtype).float().numpy()
    jq = jnp.asarray(tq.float().numpy()).astype(
        jnp.bfloat16 if q_dtype == torch.bfloat16 else jnp.float32)
    jargs = [jq] + [jnp.asarray(a) for a in (kq, vq, bt, lengths)]
    jkw = dict(layer=jnp.asarray(1, jnp.int32), k_scale=jnp.asarray(ks),
               v_scale=jnp.asarray(vs))
    refs = [np.asarray(r.astype(jnp.float32)) for r in (
        jax_paged_attention(*jargs, **jkw, interpret=True),
        paged_attention_xla(*jargs, **jkw))]
    _check(got, refs, atol)


@pytest.mark.parametrize("quantized", [False, True])
def test_split_merge_never_reads_past_the_length(quantized):
    """Rows past each length, pages no table names, and table entries past
    ceil(len / ps) hold NaN (int8: NaN scales) or junk indices: the result
    is finite and bitwise the result with that junk zeroed."""
    q, kp, vp, bt, lengths = _inputs(seed=6)
    B, mp = bt.shape
    L, P, KV, ps, _ = kp.shape
    real = np.zeros((L, P, KV, ps), bool)
    junk_bt = bt.copy()
    for b, n in enumerate(lengths):
        pages = -(-int(n) // ps)
        for j in range(pages):
            real[:, bt[b, j], :, :min(ps, n - j * ps)] = True
        junk_bt[b, pages:] = 10 ** 9
    plan = _plan(q, bt, kp, torch.int8 if quantized else torch.float32)
    kw_nan, kw_zero = {}, {}
    if quantized:
        (kq, ks), (vq, vs) = (jax_quantize_kv(jnp.asarray(a))
                              for a in (kp, vp))
        kp_nan = kp_zero = torch.from_numpy(np.array(kq))
        vp_nan = vp_zero = torch.from_numpy(np.array(vq))
        for name, s in (("k_scale", ks), ("v_scale", vs)):
            s = np.array(s)
            kw_nan[name] = torch.from_numpy(np.where(real, s, np.nan))
            kw_zero[name] = torch.from_numpy(np.where(real, s, 0.0))
    else:
        kp_nan, vp_nan = (torch.from_numpy(np.where(real[..., None], a,
                                                    np.nan))
                          for a in (kp, vp))
        kp_zero, vp_zero = (torch.from_numpy(np.where(real[..., None], a,
                                                      0.0))
                            for a in (kp, vp))
    tq, tl = torch.from_numpy(q), torch.from_numpy(lengths)
    got = split_merge(tq, kp_nan, vp_nan, torch.from_numpy(junk_bt), tl, 1,
                      plan, **kw_nan)
    ref = split_merge(tq, kp_zero, vp_zero, torch.from_numpy(bt), tl, 1,
                      plan, **kw_zero)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, ref)
