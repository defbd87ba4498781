"""ops/fused_norm on the CPU: the plain analytic backwards (the kernels'
arithmetic and rounding points, in fp32 torch) against autograd of the
plain forwards the model runs, and the routes of CPU and fp32 tensors.
The kernels themselves are held against these on the card
(tests/test_torch_cuda_kernels.py)."""
import numpy as np
import pytest
import torch

from speech_distill_tpu_torch.ops import _cuda
from speech_distill_tpu_torch.ops import fused_norm as fn

EPS = 1e-6
# bf16 results of two fp32 computations that differ only in summation
# order (~1e-6 relative): at most one bf16 rounding step apart, 2^-8 of the
# largest value
BF16_REL_TOL = 2.0 ** -8
# fp32 results: the same algebra in another order over <= 2,048 terms
FP32_REL_TOL = 1e-5
REL_TOL = {torch.bfloat16: BF16_REL_TOL, torch.float32: FP32_REL_TOL}


def _rel(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _t(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(dtype)


def _grads(f, inputs, outs_grad):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = f(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, outs_grad)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 1024, 2048])
def test_rms_norm_bwd_plain_matches_autograd(D, dtype):
    rng = np.random.default_rng(D)
    x = _t(rng, (3, 5, D), dtype, 2.0)
    scale = _t(rng, (D,), dtype) + 1.0
    dy = _t(rng, (3, 5, D), dtype)
    dx_ref, ds_ref = _grads(lambda a, s: fn.rms_norm_plain(a, s, EPS),
                            [x, scale], [dy])
    dx, ds = fn.rms_norm_bwd_plain(x, scale, EPS, dy)
    assert dx.dtype == x.dtype and ds.dtype == scale.dtype
    assert _rel(dx, dx_ref) <= REL_TOL[dtype]
    assert _rel(ds, ds_ref) <= REL_TOL[dtype]


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("tables", ["T", "BT"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("H,KV", [(16, 8), (14, 2)])
def test_qk_norm_rope_bwd_plain_matches_autograd(H, KV, Dh, tables,
                                                 qk_norm):
    rng = np.random.default_rng(H * Dh + KV)
    B, T = 2, 6
    bf = torch.bfloat16
    q, k = _t(rng, (B, T, H, Dh), bf, 3.0), _t(rng, (B, T, KV, Dh), bf, 3.0)
    pos = (torch.arange(T)[None] + torch.tensor([[0], [9]])
           if tables == "BT" else torch.arange(T) + 4)
    from speech_distill_tpu_torch.models.qwen3 import rope_angles
    cos, sin = rope_angles(pos, Dh, 1e6)
    scales = ([_t(rng, (Dh,), bf) + 1.0, _t(rng, (Dh,), bf) + 1.0]
              if qk_norm else [])
    dqo, dko = _t(rng, q.shape, bf), _t(rng, k.shape, bf)

    def plain(a, b, *s):
        return fn.qk_norm_rope_plain(a, b, cos, sin, *s, eps=EPS)
    ref = _grads(plain, [q, k, *scales], [dqo, dko])
    got = fn.qk_norm_rope_bwd_plain(q, k, cos, sin, *(scales or [None, None]),
                                    EPS, dqo, dko)
    if not qk_norm:
        assert got[2] is None and got[3] is None
        got = got[:2]
    for g, r in zip(got, ref):
        assert g.dtype == bf and _rel(g, r) <= BF16_REL_TOL


@pytest.mark.parametrize("shape", [(2, 3, 64), (3, 7, 3072), (1, 4, 6144)])
def test_swiglu_bwd_plain_matches_autograd(shape):
    rng = np.random.default_rng(shape[-1])
    bf = torch.bfloat16
    gate, up, dh = (_t(rng, shape, bf, 3.0), _t(rng, shape, bf),
                    _t(rng, shape, bf))
    ref = _grads(fn.swiglu_plain, [gate, up], [dh])
    got = fn.swiglu_bwd_plain(gate, up, dh)
    for g, r in zip(got, ref):
        assert g.dtype == bf and _rel(g, r) <= BF16_REL_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_cpu_and_other_dtypes_take_the_plain_route(dtype):
    rng = np.random.default_rng(0)
    B, T, H, KV, Dh, D = 2, 4, 4, 2, 64, 128
    x, scale = _t(rng, (B, T, D), dtype), _t(rng, (D,), dtype)
    q, k = _t(rng, (B, T, H, Dh), dtype), _t(rng, (B, T, KV, Dh), dtype)
    qs, ks = _t(rng, (Dh,), dtype), _t(rng, (Dh,), dtype)
    from speech_distill_tpu_torch.models.qwen3 import rope_angles
    cos, sin = rope_angles(torch.arange(T), Dh, 1e6)
    assert not fn.norm_kernel_takes(x)
    assert not fn.rope_kernel_takes(q)
    assert not fn.swiglu_kernel_takes(x)
    before = dict(_cuda.launches)
    assert torch.equal(fn.rms_norm(x, scale, EPS),
                       fn.rms_norm_plain(x, scale, EPS))
    # the model's chain before the fused op: norm each, then rotate each
    got = fn.qk_norm_rope(q, k, cos, sin, qs, ks, EPS)
    want = (fn.apply_rope(fn.rms_norm_plain(q, qs, EPS), cos, sin),
            fn.apply_rope(fn.rms_norm_plain(k, ks, EPS), cos, sin))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = fn.qk_norm_rope(q, k, cos, sin)
    assert torch.equal(got[0], fn.apply_rope(q, cos, sin))
    assert torch.equal(got[1], fn.apply_rope(k, cos, sin))
    assert torch.equal(fn.swiglu(x, x), fn.swiglu_plain(x, x))
    assert _cuda.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    bf = torch.bfloat16
    x, scale = torch.zeros(4, 128, dtype=bf), torch.ones(128, dtype=bf)
    q, k = torch.zeros(1, 4, 2, 64, dtype=bf), torch.zeros(1, 4, 1, 64,
                                                           dtype=bf)
    cos = sin = torch.zeros(4, 64)
    before = dict(_cuda.launches)
    with pytest.raises(ValueError, match="does not take"):
        fn.rms_norm_fwd(x, scale, EPS)
    with pytest.raises(ValueError, match="does not take"):
        fn.rms_norm_bwd(x, scale, EPS, x, True)
    with pytest.raises(ValueError, match="does not take"):
        fn.qk_norm_rope_fwd(q, k, cos, sin)
    with pytest.raises(ValueError, match="does not take"):
        fn.qk_norm_rope_bwd(q, k, cos, sin, None, None, EPS, q, k, False)
    with pytest.raises(ValueError, match="does not take"):
        fn.swiglu_fwd(x, x)
    with pytest.raises(ValueError, match="does not take"):
        fn.swiglu_bwd(x, x, x)
    assert _cuda.launches == before


def test_every_entry_point_is_counted_and_built_from_its_source():
    names = ("rms_norm_fwd", "rms_norm_bwd", "qk_norm_rope_fwd",
             "qk_norm_rope_bwd", "swiglu_fwd", "swiglu_bwd")
    src = (_cuda.CSRC / "fused_norm.cu").read_text()
    for name in names:
        assert name in _cuda.launches and _cuda.SOURCES[name] == "fused_norm"
        assert f'extern "C" int {name}(' in src
    # the launch geometry's query launches nothing and has no count
    assert "fused_norm_grid" in _cuda.QUERIES
    assert "fused_norm_grid" not in _cuda.launches
    assert _cuda.SOURCES["fused_norm_grid"] == "fused_norm"
    assert 'extern "C" int fused_norm_grid(' in src


@pytest.mark.parametrize("view", ["whole", "odd_offset", "transposed"])
def test_ready_copies_only_what_the_kernels_cannot_load(view):
    """The routers hand the kernels contiguous tensors on the 16-byte grid:
    a view at an odd offset or with strides is copied (same values), a
    tensor that is already fit is passed as it is."""
    base = torch.arange(2 * 1032, dtype=torch.float32).to(
        torch.bfloat16).reshape(2, 1032)
    t = {"whole": base, "odd_offset": base.reshape(-1)[4:1028],
         "transposed": base.t()}[view]
    got = fn._ready(t)
    assert torch.equal(got, t)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert (got.data_ptr() == t.data_ptr()) == (view == "whole")
