"""PyTorch port, LoRA: ``LoraLinear`` against ``jax.vjp`` of the JAX
``lora_linear``, and the port's ``init_lora`` / ``merge_lora`` against the
JAX ones on the same weights. fp32, CPU."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import LoraConfig as JLora
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.distill import lora as jlora
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.ops.lora_linear import lora_linear as jax_lora_linear
from speech_distill_tpu_torch.core.config import LoraConfig, qwen3_tiny
from speech_distill_tpu_torch.core.tree import tree_leaves
from speech_distill_tpu_torch.distill import lora as tlora
from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                     params_from_jax,
                                                     tree_to_numpy)
from speech_distill_tpu_torch.ops.lora_linear import lora_linear


def test_lora_linear_matches_jax_vjp():
    rng = np.random.default_rng(0)
    B, T, din, dout, r, g = 2, 5, 16, 24, 4, 2.5
    x, w, a, b, dy = (rng.normal(size=s).astype(np.float32) for s in
                      ((B, T, din), (din, dout), (din, r), (r, dout),
                       (B, T, dout)))
    ref, vjp = jax.vjp(lambda x, w, a, b: jax_lora_linear(x, w, a, b, g),
                       *map(jnp.asarray, (x, w, a, b)))
    ref_grads = vjp(jnp.asarray(dy))
    xt, wt, at, bt = (torch.from_numpy(t).requires_grad_()
                      for t in (x, w, a, b))
    out = lora_linear(xt, wt, at, bt, g)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(dy))
    assert wt.grad is None                       # the frozen base: none
    assert not np.any(np.asarray(ref_grads[1]))  # JAX returns zeros
    for got, r_, name in ((xt.grad, ref_grads[0], "dx"),
                          (at.grad, ref_grads[2], "dA"),
                          (bt.grad, ref_grads[3], "dB")):
        np.testing.assert_allclose(got.numpy(), np.asarray(r_), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny(64, dtype="float32", remat=False,
                    tie_word_embeddings=False)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = qwen3_tiny(64, dtype="float32", tie_word_embeddings=False)
    return jcfg, params, cfg


def _port_model(tiny):
    jcfg, params, cfg = tiny
    return params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")


@pytest.mark.parametrize("r", [4, 32], ids=["randomized-svd", "full-svd"])
def test_pissa_init_matches_jax(tiny, r):
    """Leaf for leaf: A, B, the residual base weights and the saved
    copies."""
    jcfg, params, cfg = tiny
    jl, jbase = jlora.init_lora(jax.random.PRNGKey(1), params, jcfg,
                                JLora(r=r, alpha=2 * r))
    lora, base = tlora.init_lora(_port_model(tiny), cfg,
                                 LoraConfig(r=r, alpha=2 * r), device="cpu")
    got, ref = tree_to_numpy(lora), jax.tree.map(np.asarray, jl)
    assert set(got) == set(ref) == {"layers", "embed", "lm_head"}
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(tree_leaves(tree_to_numpy(model_to_tree(base))),
                    jax.tree.leaves(jax.tree.map(np.asarray, jbase))):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert tlora.count_trainable(lora) == sum(
        x.size for x in jax.tree.leaves(jl))
    assert all(t.requires_grad for t in tree_leaves(lora))


def test_merge_restores_weights_and_matches_jax(tiny):
    jcfg, params, cfg = tiny
    lcfg = LoraConfig(r=4, alpha=8)
    lora, base = tlora.init_lora(_port_model(tiny), cfg, lcfg, device="cpu")
    merged = tree_to_numpy(tlora.merge_and_export(base, lora, lcfg))
    ref = jax.tree.map(np.asarray, params)
    # at init, residual + scaled principal == the original weight
    for a, b in zip(tree_leaves(merged), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    jl, jbase = jlora.init_lora(jax.random.PRNGKey(1), params, jcfg,
                                JLora(r=4, alpha=8))
    jm = jax.tree.map(np.asarray, jlora.merge_lora(jbase, jl, JLora(
        r=4, alpha=8)))
    for a, b in zip(tree_leaves(merged), jax.tree.leaves(jm)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_gaussian_init_is_a_zero_delta(tiny):
    _, params, cfg = tiny
    lcfg = LoraConfig(r=4, alpha=8, init_weights="gaussian")
    gen = torch.Generator().manual_seed(0)
    lora, base = tlora.init_lora(_port_model(tiny), cfg, lcfg,
                                 generator=gen, device="cpu")
    a = lora["layers"]["attn"]["q"]["a"]
    assert a.shape == (2, 64, 4) and 0.1 < float(a.detach().std()) < 0.4
    assert not any(bool(ab["b"].any()) for mods in lora["layers"].values()
                   for ab in mods.values())
    merged = tree_to_numpy(tlora.merge_and_export(base, lora, lcfg))
    for a_, b in zip(tree_leaves(merged),
                     jax.tree.leaves(jax.tree.map(np.asarray, params))):
        np.testing.assert_allclose(a_, b, atol=1e-6)
    assert tlora.lora_scaling(LoraConfig(r=16, alpha=32,
                                         use_rslora=False)) == 2.0
    assert tlora.lora_scaling(LoraConfig(r=16, alpha=32)) == 8.0
