"""PyTorch port, attention ops: the plain versions of the two CUDA kernels
held against the JAX package on the CPU (Pallas kernels in interpret
mode, plus their XLA oracles). Inputs are numpy, fp32."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from speech_distill_tpu.ops.attention import sdpa_xla
from speech_distill_tpu.ops.flash_attention import _flash_call
from speech_distill_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention, paged_attention_xla)
from speech_distill_tpu_torch.ops import _cuda
from speech_distill_tpu_torch.ops import attention
from speech_distill_tpu_torch.ops.attention import sdpa, sdpa_plain, use_flash
from speech_distill_tpu_torch.ops.flash_attention import (
    flash_attention_fwd, flash_attention_fwd_plain)
from speech_distill_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_plain)

ATOL, RTOL = 2e-5, 1e-4      # fp32, as in tests/test_paged_attention.py


def _paged_inputs(B=4, KV=2, G=3, Dh=32, L=3, P=16, ps=16, max_pages=4,
                  seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, Dh)).astype(np.float32)
    kp = rng.normal(size=(L, P, KV, ps, Dh)).astype(np.float32)
    vp = rng.normal(size=(L, P, KV, ps, Dh)).astype(np.float32)
    # distinct pages per row; entries beyond the row's page count are junk
    bt = rng.permutation(P)[:B * max_pages].reshape(B, max_pages)
    # idle row, partial page, exact page boundary, multi-page
    lengths = np.asarray([0, ps // 2 + 3, ps, 2 * ps + 5][:B], np.int32)
    return q, kp, vp, bt.astype(np.int32), lengths


@pytest.mark.parametrize("layer", [0, 2])
def test_paged_plain_matches_jax_kernel_and_oracle(layer):
    q, kp, vp, bt, lengths = _paged_inputs(seed=layer)
    got = paged_attention_plain(*map(torch.from_numpy,
                                     (q, kp, vp, bt, lengths)), layer=layer)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths)]
    lay = jnp.asarray(layer, jnp.int32)
    ref_kernel = jax_paged_attention(*jargs, layer=lay, interpret=True)
    ref_xla = paged_attention_xla(*jargs, layer=lay)
    for ref in (ref_kernel, ref_xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL)
    assert np.all(got.numpy()[0] == 0.0)        # idle row: exact zeros


def test_paged_wrapper_takes_plain_version_on_cpu():
    q, kp, vp, bt, lengths = [torch.from_numpy(a)
                              for a in _paged_inputs(seed=5)]
    before = _cuda.launches["paged_decode"]
    got = paged_attention(q, kp, vp, bt, lengths, layer=1)
    assert _cuda.launches["paged_decode"] == before     # no launch on CPU
    torch.testing.assert_close(
        got, paged_attention_plain(q, kp, vp, bt, lengths, layer=1),
        atol=0, rtol=0)


def _qkv(B=2, T=128, H=4, KV=2, Dh=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, Dh)).astype(np.float32),
            rng.normal(size=(B, T, KV, Dh)).astype(np.float32),
            rng.normal(size=(B, T, KV, Dh)).astype(np.float32))


# the last two: shapes the CUDA kernel takes in its own ways, a group of 4
# (two query heads a warpgroup pair, twice a KV head) and a half last
# 128-row query tile (T 320) at Dh 64; or Dh 128 with one head a KV head
@pytest.mark.parametrize("H,KV,block,T,Dh",
                         [(4, 2, 64, 128, 32), (2, 2, 32, 128, 32),
                          (8, 2, 64, 320, 64), (4, 4, 64, 192, 128)],
                         ids=["gqa", "mha", "gqa4-half-tile", "mha-dh128"])
def test_flash_plain_matches_jax_kernel(H, KV, block, T, Dh):
    q, k, v = _qkv(T=T, H=H, KV=KV, Dh=Dh, seed=H)
    o, lse = flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)))
    ref_o, (_, ref_lse, *_) = _flash_call(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), block, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               atol=ATOL, rtol=RTOL)
    o2, lse2 = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_sdpa_plain_matches_xla_with_padding_mask():
    q, k, v = _qkv(B=2, T=24, seed=3)
    T = q.shape[1]
    mask = np.ones((2, T), np.int32)
    mask[1, 17:] = 0                                    # right padding
    keep = np.tril(np.ones((T, T), bool))[None, None] \
        & mask.astype(bool)[:, None, None, :]
    bias = np.where(keep, 0.0, -np.inf).astype(np.float32)
    got = sdpa_plain(*map(torch.from_numpy, (q, k, v, bias)))
    ref = sdpa_xla(*(jnp.asarray(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    # dispatch: CPU tensors always take the plain path
    torch.testing.assert_close(
        sdpa(*map(torch.from_numpy, (q, k, v, bias))), got, atol=0, rtol=0)


def test_flash_plain_matches_sdpa_plain_at_dispatch_width():
    """At the kernel's dispatch width (T = 512), causal flash == SDPA with
    a causal bias: the two routes of ``sdpa`` agree."""
    q, k, v = _qkv(B=1, T=512, H=4, KV=2, Dh=16, seed=7)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    pos = torch.arange(512)
    bias = torch.where(pos[None] <= pos[:, None], 0.0,
                       -float("inf"))[None, None]
    torch.testing.assert_close(flash_attention_fwd_plain(qt, kt, vt)[0],
                               sdpa_plain(qt, kt, vt, bias),
                               atol=ATOL, rtol=RTOL)


def _qk(T=512, S=None, Dh=128, dtype=torch.bfloat16):
    return (torch.zeros(1, T, 4, Dh, dtype=dtype),
            torch.zeros(1, T if S is None else S, 2, Dh, dtype=dtype))


@pytest.mark.parametrize("shape,dtype,route", [
    (dict(T=512), torch.bfloat16, True),
    (dict(T=768), torch.bfloat16, True),
    (dict(T=512), torch.float32, False),       # the kernels take bf16
    (dict(T=256), torch.bfloat16, False),      # below 512
    (dict(T=640), torch.bfloat16, False),      # not a multiple of 256
    (dict(T=512, S=1024), torch.bfloat16, False),   # T != S (prefill)
    (dict(T=512, Dh=96), torch.bfloat16, False),    # head dim
])
def test_auto_route_predicate(monkeypatch, shape, dtype, route):
    """The auto route on a card (the CUDA check stubbed): the JAX predicate
    plus what the kernels take, so an fp32 model computes on the plain
    route instead of raising in the kernel wrapper."""
    q, k = _qk(**shape, dtype=dtype)
    assert use_flash(q, k, "auto") is False          # CPU tensors
    monkeypatch.setattr(attention, "_on_cuda", lambda t: True)
    assert use_flash(q, k, "auto") is route
    assert use_flash(q, k, "xla") is False
    assert use_flash(q, k, "pallas") is True


def test_named_routes():
    """'pallas' takes the flash op (the plain versions on CPU tensors, as
    JAX interprets the kernel) and raises where it cannot apply; 'xla' is
    the plain route; the ring routes take the plain route where the
    forward built a bias, as JAX's ``sdpa`` does, and without one and
    without an sp mesh are a ring of one rank: causal attention (the ring
    ranks themselves: ``tests/test_torch_ring_attention.py``)."""
    q, k, v = map(torch.from_numpy, _qkv(B=1, T=64, seed=8))
    pos = torch.arange(64)
    bias = torch.where(pos[None] <= pos[:, None], 0.0,
                       -float("inf"))[None, None]
    torch.testing.assert_close(sdpa(q, k, v, bias, "pallas"),
                               flash_attention_fwd_plain(q, k, v)[0])
    torch.testing.assert_close(sdpa(q, k, v, bias, "xla"),
                               sdpa_plain(q, k, v, bias))
    with pytest.raises(ValueError, match="matching q"):
        sdpa(q[:, :32], k, v, bias[:, :, :32], "pallas")
    for impl in ("ring", "ring_zigzag"):
        torch.testing.assert_close(sdpa(q, k, v, bias, impl),
                                   sdpa_plain(q, k, v, bias))
        torch.testing.assert_close(sdpa(q, k, v, None, impl, mesh=None),
                                   sdpa_plain(q, k, v, bias))
    with pytest.raises(NotImplementedError, match="not ported"):
        sdpa(q, k, v, bias, "ring_bidirectional")
