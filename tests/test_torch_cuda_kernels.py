"""PyTorch port on the GPU: each hand-written CUDA kernel against its plain
version on the card, in bf16 against the plain version computed in fp32
from the same bf16 inputs. Marked ``cuda``; skips where there is no GPU.
Run on a GPU machine with ``python -m pytest tests/test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

from speech_distill_tpu_torch.ops import _cuda
from speech_distill_tpu_torch.ops import fused_norm
from speech_distill_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain)
from speech_distill_tpu_torch.ops.paged_attention import (
    k4_plan, paged_attention, paged_attention_plain, quantize_kv)
from speech_distill_tpu_torch.ops import pallas_lm_loss
from speech_distill_tpu_torch.ops.pallas_lm_loss import (
    lm_head_stats, lm_head_stats_bwd_plain, lm_head_stats_plain)
from speech_distill_tpu_torch.ops.quant import quantize_array_int4
from speech_distill_tpu_torch.ops.quant_matmul import (int4_matmul,
                                                       int4_matmul_plain)

pytestmark = pytest.mark.cuda

# bf16 outputs: one rounding of a value |o| <= max|v| ~ 4 (2^-8 relative)
BF16_ATOL = 2e-2
FP32_ATOL = 1e-5
# lm-head statistics, max |kernel - plain(fp32)| / max |plain|: fp32 sums
# of bf16 products in another order and tiling (lse, label logit); dh and
# dW round dlogits to bf16 (2^-9 relative) before the products and are
# written in bf16
LSE_REL_TOL = 1e-3
HEAD_GRAD_REL_TOL = 2e-2
# flash backward, max |kernel - plain(fp32)| / max |plain|: the kernels
# round p and ds to bf16 (2^-9 relative) before products over up to T * G
# terms and write bf16 results (2^-9), against an fp32 plain version
BWD_REL_TOL = 2e-2
# int4 dequant-matmul, max |kernel - plain| / max |plain| on the same bf16
# x and codes: fp32 sums in another order (and split over blocks) for an
# fp32 output; for a bf16 output one rounding of each element (at most
# 2^-8 of it) of sums that may differ in their last fp32 bits
INT4_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# the 8-bit AdamW's block scales on the card against the CPU's after a
# step over the clip norm, each device clipping its own gradients (see
# the test); fed the CPU's clipped gradients, the card's are equal
SCALE_MAX_ULP = 4
# a model prefill through K1-fwd against the plain route, max |diff| /
# max |plain|: bf16 attention outputs rounded at different points (the
# kernel's bf16 P, the plain route's fp32 softmax), through 2 layers
PREFILL_REL_TOL = 2e-2
# the one-pass elementwise kernels (ops/fused_norm) against their plain
# versions on the same bf16 inputs (the module's own bound; its comment
# gives the source)
FUSED_REL_TOL = fused_norm.PLAIN_REL_TOL
# a 2-layer training forward and backward through those kernels against
# the plain route on the same weights: values one bf16 step apart at some
# positions, carried through 2 layers of bf16 products (as PREFILL_REL_TOL)
FUSED_MODEL_REL_TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _paged_case(dev, pool, G, Dh, ps, mp, seed, q_dtype=None):
    """Inputs of one K4 call over a pool whose every row past a length,
    and every page no table names, holds NaN (int8: NaN scales), and
    whose table entries past ceil(len / ps) name such a page; and the
    same call's inputs with that junk set to zero, which the plain
    version (it gathers whole pages) takes. Six rows of 2 KV heads on
    layer 1 of 2: lengths 0, 1, ps + 1, one token in the plan's last
    split, half the table plus 3, the whole table. Returns (kernel
    arguments, plain arguments, keyword arguments of each)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, KV, L = 6, 2, 2
    P = B * mp + 2
    q_dtype = q_dtype or pool
    plan = k4_plan(B, KV, mp, ps, Dh, pool, 132)
    last = (plan.splits - 1) * plan.pages_per_split * ps + 1
    lens = [0, 1, ps + 1, last, mp * ps // 2 + 3, mp * ps]
    perm = torch.randperm(B * mp, generator=gen, device=dev)
    bt = perm.reshape(B, mp).to(torch.int32)
    real = torch.zeros(L, P, KV, ps, dtype=torch.bool, device=dev)
    bt_junk = bt.clone()
    for row, n in enumerate(lens):
        pages = -(-n // ps)
        for j in range(pages):
            real[:, bt[row, j], :, :min(ps, n - j * ps)] = True
        bt_junk[row, pages:] = P - 1          # an all-NaN page
    q = torch.randn(B, KV, G, Dh, generator=gen, device=dev).to(q_dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    shape = (L, P, KV, ps, Dh)
    vals = [torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
    if pool == torch.int8:
        codes, scales = zip(*(quantize_kv(v) for v in vals))
        junk = [s.masked_fill(~real, float("nan")) for s in scales]
        zero = [s.masked_fill(~real, 0.0) for s in scales]
        kern = (q, *codes, bt_junk, lengths)
        plain = (q.float(), *codes, bt_junk, lengths)
        return (kern, plain, dict(layer=1, k_scale=junk[0], v_scale=junk[1]),
                dict(layer=1, k_scale=zero[0], v_scale=zero[1]))
    kern = [v.masked_fill(~real[..., None], float("nan")).to(pool)
            for v in vals]
    plain = [v.masked_fill(~real[..., None], 0.0).to(pool).float()
             for v in vals]
    return ((q, *kern, bt_junk, lengths), (q.float(), *plain, bt_junk,
                                           lengths),
            dict(layer=1), dict(layer=1))


# page sizes 16-128, tables of 16 (the serve's) and 64 pages, G 1, 2
# (the 0.6B) and 8, Dh 64 and 128; bf16 and fp32 pools, and int8 pools
# under bf16 and fp32 queries
K4_GRID = [pytest.mark.parametrize("ps", [16, 64, 128]),
           pytest.mark.parametrize("mp", [16, 64]),
           pytest.mark.parametrize("G", [1, 2, 8]),
           pytest.mark.parametrize("Dh", [64, 128])]


def _k4_grid(fn):
    for mark in K4_GRID:
        fn = mark(fn)
    return fn


@_k4_grid
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, BF16_ATOL),
                                        (torch.float32, FP32_ATOL)])
def test_paged_decode_kernel_matches_plain(dev, dtype, atol, ps, mp, G, Dh):
    """Finite over a pool whose slack is NaN, equal to the plain version
    on the same pool with the slack zeroed; the idle row exact zeros; one
    launch a call."""
    kern, plain, kw, plain_kw = _paged_case(dev, dtype, G, Dh, ps, mp,
                                            seed=ps + mp + G + Dh)
    before = dict(_cuda.launches)
    got = paged_attention(*kern, **kw)
    torch.cuda.synchronize()
    assert {n: _cuda.launches[n] - before[n] for n in (
        "paged_decode", "paged_decode_int8")} == {
        "paged_decode": 1, "paged_decode_int8": 0}
    ref = paged_attention_plain(*plain, **plain_kw)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("pool,q_dtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.float32, torch.float32),
                                          (torch.int8, torch.bfloat16)])
def test_paged_decode_kernels_are_deterministic(dev, pool, q_dtype):
    """Two calls on the same inputs are bitwise equal: the lane groups,
    the warps and the cluster's splits merge in a fixed order."""
    kern, _, kw, _ = _paged_case(dev, pool, 2, 128, 128, 16, seed=9,
                                 q_dtype=q_dtype)
    first, second = (paged_attention(*kern, **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_paged_decode_refuses_unaligned_int8_pages(dev):
    """An int8 page of ps scales must start 16-byte aligned (ps % 4)."""
    kern, _, kw, _ = _paged_case(dev, torch.int8, 2, 64, 16, 2, seed=2,
                                 q_dtype=torch.bfloat16)
    q, kq, vq, bt, lengths = kern
    cut = [t[..., :6, :].contiguous() for t in (kq, vq)]
    ks, vs = (kw[n][..., :6].contiguous() for n in ("k_scale", "v_scale"))
    with pytest.raises(ValueError, match="page_size % 4"):
        paged_attention(q, *cut, bt, lengths, layer=1, k_scale=ks,
                        v_scale=vs)


def _flash_qkv(dev, B, T, H, KV, Dh, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, T, n, Dh))).to(
        dev, torch.bfloat16) for n in (H, KV, KV)]


# T 64: one key tile, half of it past T; T 320: a half last 128-row query
# tile; (16, 8) and (16, 4): two query heads of a KV group a block; (4, 4):
# 128 rows of one head a block; (14, 2): CosyVoice2's Qwen2 backbone, an
# odd group of 7 (the unpaired one-head path)
@pytest.mark.parametrize("H,KV", [(16, 8), (4, 4), (16, 4), (14, 2)])
@pytest.mark.parametrize("T", [64, 320, 1024])
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_fwd_kernel_matches_plain(dev, H, KV, T, Dh):
    q, k, v = _flash_qkv(dev, 2, T, H, KV, Dh, seed=1)
    before = _cuda.launches["flash_fwd"]
    o, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert _cuda.launches["flash_fwd"] == before + 1
    ref_o, ref_lse = flash_attention_fwd_plain(q.float(), k.float(),
                                               v.float())
    torch.testing.assert_close(o.float(), ref_o, atol=BF16_ATOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


def test_flash_fwd_kernel_is_deterministic(dev):
    """Two calls on the same inputs give bitwise the same o and lse."""
    q, k, v = _flash_qkv(dev, 2, 320, 16, 8, 128, seed=4)
    o1, lse1 = flash_attention_fwd(q, k, v)
    o2, lse2 = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def _rel_err(got, ref):
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def test_continuous_admission_prefills_through_flash(dev):
    """ContinuousEngine's admission of a 700-token prompt prefills a fresh
    cache one bucket (768) wide: K1-fwd once a layer; the plain route
    (attn_impl "xla") on the same model launches none. The slot's K/V
    and last logits agree within bf16 rounding of the attention
    outputs (layer 0's K/V are the same computation)."""
    import dataclasses
    from speech_distill_tpu_torch.core.config import (SamplingParams,
                                                      qwen3_tiny)
    from speech_distill_tpu_torch.infer.continuous import ContinuousEngine
    from speech_distill_tpu_torch.models import qwen3
    cfg = qwen3_tiny(1024, hidden_size=256, head_dim=128,
                     num_attention_heads=4, num_key_value_heads=2)
    model = qwen3.init_params(cfg, seed=0, device=dev)
    prompt = np.random.default_rng(0).integers(1, 1000, 700).tolist()
    states, launches = {}, {}
    for impl in ("auto", "xla"):
        model.cfg = dataclasses.replace(cfg, attn_impl=impl)
        eng = ContinuousEngine(model, model.cfg, SamplingParams(),
                               slots=2, max_len=1024, device=dev)
        st = eng.new_state()
        before = _cuda.launches["flash_fwd"]
        eng._prefill_slot(st, 1, prompt)
        torch.cuda.synchronize()
        launches[impl] = _cuda.launches["flash_fwd"] - before
        states[impl] = st
    assert launches == {"auto": cfg.num_hidden_layers, "xla": 0}
    got, ref = states["auto"], states["xla"]
    assert torch.equal(got.cache.k[0, 1, :700], ref.cache.k[0, 1, :700])
    for a, b in ((got.cache.k, ref.cache.k), (got.cache.v, ref.cache.v)):
        assert _rel_err(a[:, 1, :700], b[:, 1, :700].float()) \
            <= PREFILL_REL_TOL
    assert _rel_err(got.last_logits[1], ref.last_logits[1]) \
        <= PREFILL_REL_TOL
    assert torch.equal(got.valid, ref.valid) and int(got.length[1]) == 700


# an online KD step through the flash kernels against the plain route,
# both in bf16, held to the plain route in fp32: the kernel route's grads
# (the first Adam moments of the adapters and the embed) no further from
# fp32 than ONLINE_ERR_RATIO x the plain route's (bf16 attention outputs
# rounded at other points; the kernel's bf16 P), and its metrics within
# bf16 rounding of a mean over ~800 positions
ONLINE_ERR_RATIO, ONLINE_LOSS_RTOL = 2.0, 1e-2
ROUTES = {"kernel": ("bfloat16", "auto"), "plain": ("bfloat16", "xla"),
          "fp32": ("float32", "xla")}


def online_step_routes(dev, mode, routes=ROUTES):
    """One ``make_kd_step`` of ``mode`` at reduced depth (student 2 layers,
    teacher 3, Dh 128, B 2, T 512; the second row right-padded after 300
    tokens) through each (dtype, attention route) of ``routes`` from the
    same weights and LoRA (gaussian A, B drawn nonzero), at a rate of 0.
    Returns {route: (metrics, first Adam moments, flash launches)}."""
    import dataclasses
    from speech_distill_tpu_torch.core.config import (DistillConfig,
                                                      LoraConfig, qwen3_tiny)
    from speech_distill_tpu_torch.core.tree import tree_leaves
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.distill.lora import init_lora
    from speech_distill_tpu_torch.models import qwen3
    V = 1024
    heads = dict(head_dim=128, num_attention_heads=4, num_key_value_heads=2)
    cfg = qwen3_tiny(V, hidden_size=256, **heads)
    tcfg = qwen3_tiny(V + 128, hidden_size=384, intermediate_size=768,
                      num_hidden_layers=3, **heads)
    rng = np.random.default_rng(0)
    B, T = 2, 512
    ids = rng.integers(0, V, (1, B, T)).astype(np.int32)
    mask = np.ones((1, B, T), np.int32)
    mask[0, 1, 300:] = 0
    labels = ids.astype(np.int64)
    labels[mask == 0] = -100
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels}
    dcfg = DistillConfig(top_k=16, lora=LoraConfig(
        r=8, alpha=16, init_weights="gaussian"))
    out = {}
    for name, (dtype, impl) in routes.items():
        c = dataclasses.replace(cfg, attn_impl=impl, dtype=dtype)
        student = qwen3.init_params(c, seed=0, device=dev)
        teacher = qwen3.init_params(
            dataclasses.replace(tcfg, attn_impl=impl, dtype=dtype), seed=1,
            device=dev)
        lora, student = init_lora(student, c, dcfg.lora,
                                  generator=torch.Generator().manual_seed(2),
                                  device=dev)
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for mods in lora["layers"].values():
                for ab in mods.values():
                    ab["b"].copy_(torch.randn(ab["b"].shape,
                                              generator=gen) * 0.05)
        opt = train_step.make_optimizer(0.0, 1, 10)
        step = train_step.make_kd_step(c, dcfg, opt, mode=mode, device=dev)
        before = dict(_cuda.launches)
        state, m = step(train_step.init_state(lora, opt), student, teacher,
                        batch)
        torch.cuda.synchronize()
        out[name] = ({k: float(v) for k, v in m.items()},
                     [x.float() for x in tree_leaves(state.opt_state["mu"])],
                     {n: _cuda.launches[n] - before[n]
                      for n in ("flash_fwd", "flash_dq", "flash_dkv")})
    return out


@pytest.mark.parametrize("mode", ["online_sparse", "online_dense"])
def test_online_kd_step_kernel_route_matches_plain(dev, mode):
    """The teacher's forward and the student's forward, recompute and
    backward take the flash kernels (7 forwards, 2 of each backward); the
    kernels ignore the mask, which is exact for right padding: a padded
    row's queries carry no loss. Against the fp32 plain route, which
    applies the mask, the kernel route is as accurate as the bf16 plain
    route."""
    out = online_step_routes(dev, mode)
    assert out["kernel"][2] == {"flash_fwd": 3 + 2 * 2, "flash_dq": 2,
                                "flash_dkv": 2}
    assert out["plain"][2] == {"flash_fwd": 0, "flash_dq": 0,
                               "flash_dkv": 0}
    ref_m, ref_mu, _ = out["fp32"]
    for k in ("loss", "student_loss", "distill_loss", "grad_norm"):
        assert abs(out["kernel"][0][k] - ref_m[k]) \
            <= ONLINE_LOSS_RTOL * abs(ref_m[k]), k
    for i, (a, b, r) in enumerate(zip(out["kernel"][1], out["plain"][1],
                                      ref_mu)):
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a, r) <= ONLINE_ERR_RATIO * _rel_err(b, r), i


def _flash_bwd_inputs(dev, B, T, H, KV, Dh, seed):
    """q, k, v, dO in bf16 and the forward kernel's o and lse."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, T, n, Dh))
                                    ).to(dev, torch.bfloat16)
                   for n in (H, KV, KV, H))
    o, lse = flash_attention_fwd(q, k, v)
    return q, k, v, do, o, lse


# the forward's grid: T 64, one key tile half past T (dk/dv: the second
# warpgroup's keys all past T); T 320, a half last 128-row tile in both
# kernels; G 2 and 4 pair two query heads a dq block, G 1 takes 128 rows
# of one head; Dh 64, one swizzle box a row
@pytest.mark.parametrize("H,KV", [(16, 8), (4, 4), (16, 4)])
@pytest.mark.parametrize("T", [64, 320, 1024])
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_bwd_kernels_match_plain(dev, H, KV, T, Dh):
    q, k, v, do, o, lse = _flash_bwd_inputs(dev, 2, T, H, KV, Dh, seed=2)
    before = {n: _cuda.launches[n] for n in ("flash_dq", "flash_dkv")}
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert {n: _cuda.launches[n] - before[n] for n in before} == {
        "flash_dq": 1, "flash_dkv": 1}
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    ref_o, ref_lse = flash_attention_fwd_plain(qf, kf, vf)
    refs = flash_attention_bwd_plain(qf, kf, vf, ref_o, ref_lse, dof)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _rel_err(got, ref) <= BWD_REL_TOL, name


def test_flash_bwd_kernels_are_deterministic(dev):
    """Two backward calls on the same inputs give bitwise the same dq, dk
    and dv (no atomics, a fixed order of every sum)."""
    q, k, v, do, o, lse = _flash_bwd_inputs(dev, 2, 320, 16, 4, 128, seed=5)
    first = flash_attention_bwd(q, k, v, o, lse, do)
    second = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("T", [512, 320])
def test_flash_autograd_runs_the_kernels(dev, T):
    """Gradients through ``flash_attention`` on the card are the kernels'
    backward, launched once each per backward, reading the forward kernel's
    lse (T 320: a half last query tile of the forward)."""
    rng = np.random.default_rng(3)
    B, H, KV, Dh = 1, 4, 2, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, n, Dh))).to(
        dev, torch.bfloat16).requires_grad_() for n in (H, KV, KV))
    w = torch.from_numpy(rng.normal(size=(B, T, H, Dh))).to(dev,
                                                            torch.bfloat16)
    before = dict(_cuda.launches)
    (flash_attention(q, k, v).float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert {n: _cuda.launches[n] - before[n]
            for n in ("flash_fwd", "flash_dq", "flash_dkv")} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    ref_o, ref_lse = flash_attention_fwd_plain(qf, kf, vf)
    refs = flash_attention_bwd_plain(qf, kf, vf, ref_o, ref_lse, w.float())
    for name, got, ref in zip("qkv", (q.grad, k.grad, v.grad), refs):
        assert _rel_err(got, ref) <= BWD_REL_TOL, name


def _lm_head_inputs(dev, N, V, D, seed):
    """bf16 h ~ N(0, 1) and W ~ N(0, 0.1) (logits of std ~3 at D 1024),
    labels with a hit in the last, ragged vocab tile, a label past V
    (never hits) and a clamped -100 (0); fp32 cotangents."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(N, D))).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.1, (V, D))).to(dev, torch.bfloat16)
    lab = rng.integers(0, V, N)
    lab[:3] = [V - 1, V + 7, 0]
    labels = torch.from_numpy(lab).to(dev, torch.int32)
    cot = [torch.from_numpy(rng.normal(size=N)).to(dev, torch.float32)
           for _ in range(3)]
    return h, w, labels, cot


# chunk: the backward's vocab chunk (None: the module's 8,192, one chunk
# here), lowered for three or more chunks with a ragged last one (1000 =
# 3 x 256 + 232; 4099 = 4 x 1024 + 3; 1100 = 4 x 256 + 76; 2000 = 3 x 512
# + 464); N ragged against the 128-row tiles and the 64-row halves (129,
# 70, 257, 300); D 64 (BN 64), 128, 512 and 1024 (BN 256); labels V - 1 in
# the last chunk and V + 7 past V
@pytest.mark.parametrize("N,V,D,chunk", [
    (300, 1000, 128, None), (129, 4099, 1024, None), (70, 300, 64, None),
    (300, 1000, 128, 256), (129, 4099, 1024, 1024), (70, 1100, 64, 256),
    (257, 2000, 512, 512)])
def test_lm_head_kernels_match_plain(dev, monkeypatch, N, V, D, chunk):
    if chunk is not None:
        monkeypatch.setattr(pallas_lm_loss, "BWD_CHUNK", chunk)
        assert -(-V // pallas_lm_loss._bwd_plan(N, V, D).chunk) >= 3
    h, w, labels, cot = _lm_head_inputs(dev, N, V, D, seed=4)
    T = 2.0
    hr, wr = h.detach().requires_grad_(), w.detach().requires_grad_()
    before = dict(_cuda.launches)
    out = lm_head_stats(hr, wr, labels, T)
    sum((o * c).sum() for o, c in zip(out, cot)).backward()
    torch.cuda.synchronize()
    assert {n: _cuda.launches[n] - before[n] for n in (
        "lm_head_stats", "lm_head_dh", "lm_head_dw")} == {
        "lm_head_stats": 1, "lm_head_dh": 1, "lm_head_dw": 1}
    ref = lm_head_stats_plain(h.float(), w.float(), labels, T)
    assert out[2][1].item() == float(np.float32(-1e30))   # label past V
    hits = ref[2] > -1e29
    for name, got, r in zip(("lse1", "lseT", "label"),
                            (out[0], out[1], out[2][hits]),
                            (ref[0], ref[1], ref[2][hits])):
        assert _rel_err(got, r) <= LSE_REL_TOL, name
    ref_dh, ref_dw = lm_head_stats_bwd_plain(h.float(), w.float(), labels,
                                             ref[0], ref[1], *cot, T)
    assert hr.grad.dtype == torch.bfloat16 and wr.grad.shape == w.shape
    assert _rel_err(hr.grad, ref_dh) <= HEAD_GRAD_REL_TOL
    assert _rel_err(wr.grad, ref_dw) <= HEAD_GRAD_REL_TOL


def test_lm_head_bwd_kernels_are_deterministic(dev, monkeypatch):
    """Two calls of K2-dh and of K2-dW on the same inputs give bitwise the
    same result: dh sums its chunks in order in an fp32 partial, dW writes
    each row once, no atomics (five chunks, the last ragged)."""
    monkeypatch.setattr(pallas_lm_loss, "BWD_CHUNK", 256)
    N, V, D = 300, 1100, 256
    h, w, labels, cot = _lm_head_inputs(dev, N, V, D, seed=6)
    stats = lm_head_stats_plain(h.float(), w.float(), labels, 2.0)
    args = (h, w, labels, stats[0], stats[1], *cot, 2.0)
    for fn in (pallas_lm_loss.lm_head_dh, pallas_lm_loss.lm_head_dw):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second), fn.__name__


@pytest.mark.parametrize("N,V", [(300, 1000), (16380, 159488)])
def test_lm_head_stats_kernel_matches_plain_and_repeats(dev, N, V):
    """K2-stats alone at a ragged shape and at the stage-1 microbatch's
    N 16,380 over the full vocabulary (33 vocab splits): against the plain
    version, and two calls bitwise equal (each split sums its tiles in
    order, the combine adds the splits in order)."""
    h, w, labels, _ = _lm_head_inputs(dev, N, V, 1024, seed=7)
    before = _cuda.launches["lm_head_stats"]
    first = pallas_lm_loss.lm_head_stats_kernel(h, w, labels, 2.0)
    second = pallas_lm_loss.lm_head_stats_kernel(h, w, labels, 2.0)
    torch.cuda.synchronize()
    assert _cuda.launches["lm_head_stats"] == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    ref = lm_head_stats_plain(h.float(), w.float(), labels, 2.0)
    hits = ref[2] > -1e29
    assert first[2][1].item() == float(np.float32(-1e30))  # label past V
    for name, got, r in zip(("lse1", "lseT", "label"),
                            (first[0], first[1], first[2][hits]),
                            (ref[0], ref[1], ref[2][hits])):
        assert _rel_err(got, r) <= LSE_REL_TOL, name


# the 0.6B's projections (K, N): q, k/v, o, gate/up, down
PROJ_06B = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
            (3072, 1024)]


def _int4_inputs(dev, M, K, N, dtype, seed):
    """A quantized N(0, 0.02) weight with an all-zero column (7) and
    nibble 0 (-8) in packed row 0's first 64 columns, and x [M, K]."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.02, (K, N))).float()
    w[:, 7] = 0.0
    leaf = quantize_array_int4(w.to(dev))
    packed = leaf["q4"].clone()
    packed[0, :64] = 0x08
    x = torch.from_numpy(rng.normal(size=(M, K))).to(dev, dtype)
    return x, packed, leaf["scale"]


# M: a decode row, a decode step, the prefill tile's edges (17, 64, 65),
# a ragged prefill and a 1,024-token batched prefill
@pytest.mark.parametrize("M", [1, 16, 17, 64, 65, 300, 1024])
@pytest.mark.parametrize("K,N", PROJ_06B)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_matmul_kernel_matches_plain(dev, M, K, N, dtype):
    """Decode (M <= 16, contraction splits in one cluster) and prefill
    (wgmma) at every 0.6B projection, nibble 0 (-8) and an all-zero
    column."""
    x, packed, scale = _int4_inputs(dev, M, K, N, dtype, seed=M + K)
    before = _cuda.launches["int4_matmul"]
    got = int4_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert _cuda.launches["int4_matmul"] == before + 1
    ref = int4_matmul_plain(x.float(), packed, scale)
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.all(got[:, 7] == 0)
    assert _rel_err(got, ref) <= INT4_REL_TOL[dtype]


@pytest.mark.parametrize("M", [16, 1024])
@pytest.mark.parametrize("K,N", [(1024, 3072), (3072, 1024)])
def test_int4_matmul_kernel_is_deterministic(dev, M, K, N):
    """Two calls on the same inputs are bitwise equal: the decode splits
    are added in split order in the cluster, the prefill sums in one
    order."""
    x, packed, scale = _int4_inputs(dev, M, K, N, torch.bfloat16, seed=3)
    first, second = (int4_matmul(x, packed, scale) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int4_matmul_refuses_what_the_kernel_cannot_take(dev):
    leaf = quantize_array_int4(torch.ones(128, 64, device=dev))
    with pytest.raises(ValueError, match="N % 128"):
        int4_matmul(torch.ones(2, 128, device=dev), leaf["q4"],
                    leaf["scale"])


@_k4_grid
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, BF16_ATOL),
                                        (torch.float32, FP32_ATOL)])
def test_paged_decode_int8_kernel_matches_plain(dev, dtype, atol, ps, mp, G,
                                                Dh):
    """int8 codes with NaN scales past each length and on unnamed pages:
    finite, equal to the plain version with those scales zeroed."""
    kern, plain, kw, plain_kw = _paged_case(dev, torch.int8, G, Dh, ps, mp,
                                            seed=5 + ps + mp + G + Dh,
                                            q_dtype=dtype)
    before = dict(_cuda.launches)
    got = paged_attention(*kern, **kw)
    torch.cuda.synchronize()
    assert {n: _cuda.launches[n] - before[n] for n in (
        "paged_decode", "paged_decode_int8")} == {
        "paged_decode": 0, "paged_decode_int8": 1}
    ref = paged_attention_plain(*plain, **plain_kw)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("clip", ["each device", "the CPU's"])
def test_adamw_8bit_on_the_card_gives_the_cpu_codes(dev, clip,
                                                    monkeypatch):
    """Three steps of ``make_optimizer(eight_bit=True)`` on the same bf16
    and fp32 leaves and gradients (under, over and under the clip norm)
    on the card and on the CPU: the int8 / uint8 codes are equal at every
    step; the updates within rtol 1e-6. Each device clipping its own
    gradients, the block scales are equal after the first step and
    within SCALE_MAX_ULP after the step over the clip norm (the clip's
    global norm sums in another order on each device, so the fp32 leaf's
    clipped gradient may sit an ulp apart: two in the second moment's
    g^2, plus the roundings of the moments it carries on). Fed the CPU's
    clipped gradients, the card's block scales are equal at every step:
    the norm is where the ulps arise."""
    from speech_distill_tpu_torch.core.tree import tree_leaves, tree_map
    from speech_distill_tpu_torch.distill import optim8bit, train_step
    rng = np.random.default_rng(0)
    real_clip, cpu_clipped = optim8bit.clip_by_global_norm, []

    def clip_fn(grads, max_norm):    # the CPU's run comes first
        on_cpu = tree_leaves(grads)[0].device.type == "cpu"
        if on_cpu or clip == "each device":
            out = real_clip(grads, max_norm)
            if on_cpu:
                cpu_clipped.append(out)
            return out
        return tree_map(lambda t: t.to(dev), cpu_clipped.pop(0))
    monkeypatch.setattr(optim8bit, "clip_by_global_norm", clip_fn)

    def draw(scale):
        return {"a": torch.from_numpy((rng.normal(size=(37, 19)) * scale)
                                      .astype(np.float32)),
                "b": torch.from_numpy((rng.normal(size=(300,)) * scale)
                                      .astype(np.float32)).bfloat16()}
    params = draw(1.0)
    grads = [draw(scale) for scale in (0.01, 10.0, 0.01)]
    runs = {}
    for where in ("cpu", dev):
        opt = train_step.make_optimizer(1e-2, 1, 6, weight_decay=0.01,
                                        eight_bit=True)
        p = tree_map(lambda t: t.to(where), params)
        st = opt.init(p)
        runs[str(where)] = []
        for g in grads:
            ups, st = opt.update(tree_map(lambda t: t.to(where), g), st, p)
            p = train_step.apply_updates(p, ups, in_place=False)
            runs[str(where)].append((ups, st))
    for step, ((u1, s1), (u2, s2)) in enumerate(zip(runs["cpu"],
                                                    runs[str(dev)])):
        for a, b in zip(tree_leaves(u1), tree_leaves(u2)):
            torch.testing.assert_close(b.cpu().float(), a.float(),
                                       rtol=1e-6, atol=1e-9)
        for name in ("mu_q", "nu_q"):
            for a, b in zip(tree_leaves(getattr(s1, name)),
                            tree_leaves(getattr(s2, name))):
                assert torch.equal(b.cpu(), a), (step, name)
        for name in ("mu_scale", "nu_scale"):
            for a, b in zip(tree_leaves(getattr(s1, name)),
                            tree_leaves(getattr(s2, name))):
                np.testing.assert_array_max_ulp(
                    b.cpu().numpy(), a.numpy(),
                    maxulp=0 if step == 0 or clip == "the CPU's"
                    else SCALE_MAX_ULP)


# the one-pass elementwise kernels at the shapes the main path runs: KD
# (B 32 x T 512 = 16,384 rows), stage 1 (16 x 4,096 = 65,536), the 1.7B's
# hidden 2,048 / FFN 6,144, CosyVoice2's hidden 896 / FFN 4,864 / 14 + 2
# heads of 64, a tp-2 rank's 8 + 4 heads, a paged decode step (T 1), and
# ragged row and head counts
def _bf16(dev, shape, seed, scale=1.0, shift=0.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale + shift).to(
        dev, torch.bfloat16)


@pytest.mark.parametrize("need_dscale", [False, True])
@pytest.mark.parametrize("N,D", [(16384, 1024), (65536, 1024), (16384, 2048),
                                 (300, 896), (37, 128), (37, 64)])
def test_rms_norm_kernels_match_plain(dev, N, D, need_dscale):
    x, scale = _bf16(dev, (N, D), 1, 2.0), _bf16(dev, (D,), 2, 0.5, 1.0)
    dy = _bf16(dev, (N, D), 3)
    before = dict(_cuda.launches)
    y = fused_norm.rms_norm_fwd(x, scale, 1e-6)
    dx, ds = fused_norm.rms_norm_bwd(x, scale, 1e-6, dy, need_dscale)
    torch.cuda.synchronize()
    assert (_cuda.launches["rms_norm_fwd"] - before["rms_norm_fwd"],
            _cuda.launches["rms_norm_bwd"] - before["rms_norm_bwd"]) == (1, 1)
    assert _rel_err(y, fused_norm.rms_norm_plain(x, scale, 1e-6).float()) \
        <= FUSED_REL_TOL
    ref_dx, ref_ds = fused_norm.rms_norm_bwd_plain(x, scale, 1e-6, dy)
    assert _rel_err(dx, ref_dx.float()) <= FUSED_REL_TOL
    if need_dscale:
        assert ds.dtype == scale.dtype
        assert _rel_err(ds, ref_ds.float()) <= FUSED_REL_TOL
    else:
        assert ds is None


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("tables", ["T", "BT"])
@pytest.mark.parametrize("B,T,H,KV,Dh", [
    (32, 512, 16, 8, 128), (16, 4096, 16, 8, 128), (8, 512, 14, 2, 64),
    (8, 512, 8, 4, 128), (64, 1, 16, 8, 128), (3, 7, 7, 1, 64)])
def test_qk_norm_rope_kernels_match_plain(dev, B, T, H, KV, Dh, tables,
                                          qk_norm):
    from speech_distill_tpu_torch.models.qwen3 import rope_angles
    q, k = _bf16(dev, (B, T, H, Dh), 1, 3.0), _bf16(dev, (B, T, KV, Dh), 2)
    pos = torch.arange(T, device=dev) + 100
    if tables == "BT":
        pos = pos[None] + 37 * torch.arange(B, device=dev)[:, None]
    cos, sin = rope_angles(pos, Dh, 1e6)
    scales = ((_bf16(dev, (Dh,), 3, 0.5, 1.0), _bf16(dev, (Dh,), 4, 0.5, 1.0))
              if qk_norm else (None, None))
    dqo, dko = _bf16(dev, q.shape, 5), _bf16(dev, k.shape, 6)
    before = dict(_cuda.launches)
    got = fused_norm.qk_norm_rope_fwd(q, k, cos, sin, *scales, 1e-6)
    grads = fused_norm.qk_norm_rope_bwd(q, k, cos, sin, *scales, 1e-6, dqo,
                                        dko, qk_norm)
    torch.cuda.synchronize()
    assert (_cuda.launches["qk_norm_rope_fwd"] - before["qk_norm_rope_fwd"],
            _cuda.launches["qk_norm_rope_bwd"]
            - before["qk_norm_rope_bwd"]) == (1, 1)
    ref = fused_norm.qk_norm_rope_plain(q, k, cos, sin, *scales, 1e-6)
    ref_grads = fused_norm.qk_norm_rope_bwd_plain(q, k, cos, sin, *scales,
                                                  1e-6, dqo, dko)
    for name, a, b in zip(("q", "k", "dq", "dk", "dq_scale", "dk_scale"),
                          (*got, *grads), (*ref, *ref_grads)):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and _rel_err(a, b.float()) \
            <= FUSED_REL_TOL, name


@pytest.mark.parametrize("N,F", [(16384, 3072), (65536, 3072), (16384, 6144),
                                 (300, 4864), (1, 8)])
def test_swiglu_kernels_match_plain(dev, N, F):
    gate, up, dh = (_bf16(dev, (N, F), 1, 3.0), _bf16(dev, (N, F), 2),
                    _bf16(dev, (N, F), 3))
    before = dict(_cuda.launches)
    h = fused_norm.swiglu_fwd(gate, up)
    dgate, dup = fused_norm.swiglu_bwd(gate, up, dh)
    torch.cuda.synchronize()
    assert (_cuda.launches["swiglu_fwd"] - before["swiglu_fwd"],
            _cuda.launches["swiglu_bwd"] - before["swiglu_bwd"]) == (1, 1)
    assert _rel_err(h, fused_norm.swiglu_plain(gate, up).float()) \
        <= FUSED_REL_TOL
    for a, b in zip((dgate, dup),
                    fused_norm.swiglu_bwd_plain(gate, up, dh)):
        assert _rel_err(a, b.float()) <= FUSED_REL_TOL


def test_fused_norm_kernels_are_deterministic(dev):
    """Two calls on the same inputs give bitwise the same results, the
    scales' gradients (per-block partials summed) included."""
    from speech_distill_tpu_torch.models.qwen3 import rope_angles
    x, scale, dy = (_bf16(dev, (16384, 1024), 1), _bf16(dev, (1024,), 2),
                    _bf16(dev, (16384, 1024), 3))
    q, k = _bf16(dev, (32, 512, 16, 128), 4), _bf16(dev, (32, 512, 8, 128), 5)
    qs, ks = _bf16(dev, (128,), 6), _bf16(dev, (128,), 7)
    cos, sin = rope_angles(torch.arange(512, device=dev), 128, 1e6)
    gate, up = _bf16(dev, (16384, 3072), 8), _bf16(dev, (16384, 3072), 9)

    def run():
        return (fused_norm.rms_norm_fwd(x, scale, 1e-6),
                *fused_norm.rms_norm_bwd(x, scale, 1e-6, dy, True),
                *fused_norm.qk_norm_rope_fwd(q, k, cos, sin, qs, ks, 1e-6),
                *fused_norm.qk_norm_rope_bwd(q, k, cos, sin, qs, ks, 1e-6,
                                             q, k, True),
                fused_norm.swiglu_fwd(gate, up),
                *fused_norm.swiglu_bwd(gate, up, gate))
    first, second = run(), run()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


def test_fused_norm_kernels_refuse_what_they_cannot_take(dev):
    bf = torch.bfloat16
    x, scale = torch.zeros(8, 1024, device=dev), torch.ones(1024, device=dev)
    cos = sin = torch.zeros(4, 96, device=dev)
    q96 = torch.zeros(1, 4, 2, 96, device=dev, dtype=bf)
    wide = torch.zeros(2, 8200, device=dev, dtype=bf)
    odd = torch.zeros(2, 1028, device=dev, dtype=bf)[:, 2:]   # 4-byte offset
    before = dict(_cuda.launches)
    cases = {
        "fp32 rows": lambda: fused_norm.rms_norm_fwd(x, scale, 1e-6),
        "too wide": lambda: fused_norm.rms_norm_fwd(
            wide, torch.ones(8200, device=dev, dtype=bf), 1e-6),
        "Dh 96": lambda: fused_norm.qk_norm_rope_fwd(q96, q96, cos, sin),
        "fp32 gate": lambda: fused_norm.swiglu_fwd(x, x),
        "unaligned": lambda: fused_norm.swiglu_fwd(odd, odd),
        "shapes differ": lambda: fused_norm.swiglu_bwd(
            x.to(bf), x.to(bf), x[:4].to(bf)),
    }
    for name, call in cases.items():
        with pytest.raises(ValueError, match="does not take"):
            call()
    assert _cuda.launches == before
    # the routed functions send fp32 to the plain versions, the kernels'
    # widths to the kernels
    assert torch.equal(fused_norm.rms_norm(x, scale, 1e-6),
                       fused_norm.rms_norm_plain(x, scale, 1e-6))
    assert _cuda.launches == before
    fused_norm.rms_norm(x.to(bf), scale.to(bf), 1e-6)
    assert _cuda.launches["rms_norm_fwd"] == before["rms_norm_fwd"] + 1


def test_fused_norm_routes_on_device_dtype_and_width_alone(dev):
    """On CUDA bf16 tensors of the kernels' widths the routed functions
    launch the kernels or raise: a view at an odd offset is copied and
    launched, a scale, table or up that the kernel cannot take raises;
    nothing falls back to the plain chain."""
    from speech_distill_tpu_torch.models.qwen3 import rope_angles
    bf = torch.bfloat16
    flat = _bf16(dev, (4 * 1024 + 8,), 1)
    x = flat[8:].view(4, 1024)                  # 16 bytes off the grid + 16
    odd = flat[4:4 + 4 * 1024].view(4, 1024)    # 8 bytes off the grid
    assert x.data_ptr() % 16 == 0 and odd.data_ptr() % 16 == 8
    scale = _bf16(dev, (1024,), 2, 0.5, 1.0)
    before = dict(_cuda.launches)
    y = fused_norm.rms_norm(odd, scale, 1e-6)
    assert _cuda.launches["rms_norm_fwd"] == before["rms_norm_fwd"] + 1
    assert _rel_err(y, fused_norm.rms_norm_plain(odd, scale, 1e-6).float()
                    ) <= FUSED_REL_TOL
    h = fused_norm.swiglu(odd, odd)
    assert _cuda.launches["swiglu_fwd"] == before["swiglu_fwd"] + 1
    assert torch.equal(h, fused_norm.swiglu_plain(odd, odd))
    q, k = _bf16(dev, (1, 4, 2, 128), 3), _bf16(dev, (1, 4, 1, 128), 4)
    cos, sin = rope_angles(torch.arange(4, device=dev), 128, 1e6)
    qs = _bf16(dev, (128,), 5)
    refused = {
        "fp32 scale": lambda: fused_norm.rms_norm(x, scale.float(), 1e-6),
        "scale of another width": lambda: fused_norm.rms_norm(
            x, scale[:512], 1e-6),
        "bf16 tables": lambda: fused_norm.qk_norm_rope(
            q, k, cos.to(bf), sin.to(bf)),
        "fp32 q scale": lambda: fused_norm.qk_norm_rope(
            q, k, cos, sin, qs.float(), qs.float()),
        "one scale": lambda: fused_norm.qk_norm_rope(q, k, cos, sin, qs),
        "fp32 up": lambda: fused_norm.swiglu(x, x.float()),
    }
    mid = dict(_cuda.launches)
    for name, call in refused.items():
        with pytest.raises(ValueError, match="does not take"):
            call()
    assert _cuda.launches == mid


@pytest.mark.parametrize("trains", ["lora", "full"])
def test_training_layers_run_the_fused_kernels(dev, monkeypatch, trains):
    """A 2-layer forward_train (remat "full") and its backward: every norm,
    q/k norm + RoPE and SwiGLU runs through the kernels, in the forward,
    the recompute and the backward, with exact launch counts (the scales'
    gradients too with full finetuning); the plain route on the same
    weights launches none, and the two agree within bf16 rounding."""
    from speech_distill_tpu_torch.core.config import LoraConfig, qwen3_tiny
    from speech_distill_tpu_torch.core.tree import tree_leaves, tree_map
    from speech_distill_tpu_torch.distill.lora import init_lora
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.models.convert import model_to_tree
    cfg = qwen3_tiny(2048, hidden_size=1024, intermediate_size=3072,
                     head_dim=128, num_attention_heads=16,
                     num_key_value_heads=8)
    model = qwen3.init_params(cfg, seed=0, device=dev)
    if trains == "lora":      # PiSSA: the residual replaces the base weights
        src, base = init_lora(model, cfg, LoraConfig(), device=dev)
        src = src["layers"]
    else:
        src, base = model_to_tree(model), model
    B, T, L = 2, 512, cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T))).to(dev)
    w = _bf16(dev, (B, T, cfg.hidden_size), 11).float()

    def run():
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        src)
        kw = {"adapters": tree} if trains == "lora" else {"weights": tree}
        _cuda.reset_launches()
        h = qwen3.forward_train(base, ids, device=dev, **kw)
        (h.float() * w).sum().backward()
        torch.cuda.synchronize()
        return [t.grad for t in tree_leaves(tree)], dict(_cuda.launches)
    grads, launches = run()
    names = ("rms_norm_fwd", "rms_norm_bwd", "qk_norm_rope_fwd",
             "qk_norm_rope_bwd", "swiglu_fwd", "swiglu_bwd")
    # with LoRA the embedding is frozen: layer 0's input norm has nothing
    # to differentiate
    assert {n: launches[n] for n in names} == {
        "rms_norm_fwd": 2 * 2 * L + 1,
        "rms_norm_bwd": 2 * L + (trains == "full"),
        "qk_norm_rope_fwd": 2 * L, "qk_norm_rope_bwd": L,
        "swiglu_fwd": 2 * L, "swiglu_bwd": L}
    for pred in ("norm_kernel_takes", "rope_kernel_takes",
                 "swiglu_kernel_takes"):
        monkeypatch.setattr(fused_norm, pred, lambda *a, **k: False)
    ref, ref_launches = run()
    assert not any(ref_launches[n] for n in names)
    assert len(grads) == len(ref) and all(g is not None for g in grads)
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert _rel_err(a, b.float()) <= FUSED_MODEL_REL_TOL, i
