"""PyTorch port, the flash-attention backward: the plain version of the
K1-dq / K1-dkv kernels held against ``jax.vjp`` of the JAX
``flash_attention`` (Pallas kernels in interpret mode) on the CPU, and the
port's autograd op against autograd of the plain forward. fp32."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from speech_distill_tpu_torch.ops import _cuda
from speech_distill_tpu_torch.ops.flash_attention import (
    _check_kernel_inputs, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd_plain)

ATOL, RTOL = 5e-5, 1e-3      # as tests/test_flash_attention.py


def _inputs(B=1, T=64, H=4, KV=2, Dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, n, Dh)).astype(np.float32)
            for n in (H, KV, KV, H)]              # q, k, v, dO


def _jax_grads(q, k, v, do, block=32):
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, block,
                                                         True),
                     *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do):
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_plain(qt, kt, vt)
    before = dict(_cuda.launches)
    grads = flash_attention_bwd(qt, kt, vt, o, lse, dot)
    assert _cuda.launches == before          # CPU: the plain version
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("H,KV", [(4, 2), (2, 2)], ids=["gqa", "mha"])
def test_bwd_plain_matches_jax_vjp(H, KV):
    q, k, v, do = _inputs(H=H, KV=KV, seed=H)
    for got, ref, name in zip(_port_grads(q, k, v, do),
                              _jax_grads(q, k, v, do), "qkv"):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_bwd_right_padding():
    """Right-padded keys change no gradient of the valid rows: with the
    cotangent zero on padded query rows, dq of valid queries and dk/dv of
    valid keys are the same whatever the padded tail holds, and agree
    with JAX."""
    q, k, v, do = _inputs(T=64, seed=4)
    do[:, 48:] = 0.0
    k2, v2 = k.copy(), v.copy()
    k2[:, 48:] = 999.0
    v2[:, 48:] = 999.0
    ref = _port_grads(q, k, v, do)
    got = _port_grads(q, k2, v2, do)
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a[:, :48], b[:, :48], atol=1e-5,
                                   err_msg=name)
    for a, b, name in zip(got, _jax_grads(q, k2, v2, do), "qkv"):
        np.testing.assert_allclose(a[:, :48], b[:, :48], atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def test_autograd_op_matches_autograd_of_plain_forward():
    q, k, v, do = _inputs(B=2, T=32, seed=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, _ = flash_attention_fwd_plain(*leaves)
    ref = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves]
    got = torch.autograd.grad(flash_attention(*leaves2), leaves2,
                              torch.from_numpy(do))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    qt, kt, vt = (t.detach() for t in leaves)
    o, lse = flash_attention_fwd_plain(qt, kt, vt)
    direct = flash_attention_bwd_plain(qt, kt, vt, o, lse,
                                       torch.from_numpy(do))
    for a, b in zip(direct, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_kernel_input_checks():
    """What the CUDA wrappers check before a launch: bf16, the tile and
    head-dim rules, contiguity."""
    bf = torch.bfloat16
    q = torch.zeros(1, 128, 4, 64, dtype=bf)
    lse = torch.zeros(1, 4, 128)
    _check_kernel_inputs("t", q=(q, bf), lse=(lse, torch.float32))
    with pytest.raises(ValueError, match="needs bf16"):
        _check_kernel_inputs("t", q=(q.float(), bf))
    with pytest.raises(ValueError, match="needs bf16"):
        _check_kernel_inputs("t", q=(q[:, :96], bf))
    with pytest.raises(ValueError, match="takes torch.float32 lse"):
        _check_kernel_inputs("t", q=(q, bf), lse=(lse.to(bf), torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        _check_kernel_inputs("t", q=(q, bf),
                             k=(q.transpose(1, 2), bf))
