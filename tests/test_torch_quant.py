"""PyTorch port, weight quantization: ``ops/quant`` held against the JAX
package on the same fp32 numpy weights (codes integer-equal, scales
bit-equal), quantized trees carried across by ``params_from_jax``, and the
quantized ``qwen3.forward`` against the JAX forward on the same tree."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.ops import quant as jquant
from speech_distill_tpu_torch.core.config import qwen3_tiny
from speech_distill_tpu_torch.models import qwen3
from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                     params_from_jax)
from speech_distill_tpu_torch.ops import quant
from speech_distill_tpu_torch.ops.quant_matmul import int4_route

METHODS = {
    "int8": lambda m: m.quantize_array_int8,
    "int4": lambda m: m.quantize_array_int4,
    "nf4": lambda m: m.quantize_array_nf4,
    "nf4_single": lambda m: (lambda w: m.quantize_array_nf4(
        w, double_quant=False)),
}
SHAPES = {"2d": (128, 96), "stacked": (3, 64, 128)}


def _weights(shape, seed=0):
    # N(0, 0.02) like the model's init, with an all-zero output channel
    # (the 1e-12 scale guard) and a few exact rounding ties
    w = np.random.default_rng(seed).normal(0, 0.02, shape).astype(np.float32)
    w[..., 3] = 0.0
    return w


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same(name, got, ref):
    """Codes integer-equal and fp32 scales bit-equal. The one exception is
    nf4's double quantization: ``absmax_offset`` is a mean over the absmax
    blocks, which XLA and torch sum in different orders, so its last bit
    may differ, and with them those of ``absmax_scale`` = max |absmax -
    offset| / 127 (within 4 ulp each; the int8 codes of the absmax stay
    equal)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    if "absmax_offset" in name or "absmax_scale" in name:
        assert np.all(np.abs(got - ref) <= 4 * np.spacing(np.abs(ref))), name
    else:
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("method", METHODS, ids=str)
def test_codes_and_scales_equal_jax(method, shape):
    w = _weights(SHAPES[shape])
    ref = _np(METHODS[method](jquant)(jnp.asarray(w)))
    got = METHODS[method](quant)(torch.from_numpy(w))
    assert set(got) == set(ref)
    for k, r in ref.items():
        _assert_same(k, got[k].numpy(), r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", METHODS, ids=str)
def test_dequantize_matches_jax(method, dtype):
    w = _weights(SHAPES["stacked"], seed=1)
    leaf = _np(METHODS[method](jquant)(jnp.asarray(w)))
    ref = np.asarray(jquant.dequantize_array(
        {k: jnp.asarray(v) for k, v in leaf.items()}, jnp.dtype(dtype)),
        np.float32)
    got = quant.dequantize_array({k: torch.from_numpy(np.array(v))
                                  for k, v in leaf.items()},
                                 getattr(torch, dtype)).float().numpy()
    # one rounding of a product of the same operands: within 1 ulp of the
    # result type (bf16 keeps 16 fewer mantissa bits than fp32)
    ulp = np.spacing(np.abs(ref)) * (2.0 ** 16 if dtype == "bfloat16" else 1)
    assert np.all(np.abs(got - ref) <= ulp)


def _tiny_trees(method, seed=3, vocab=48):
    jcfg = jax_tiny(vocab, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(seed), jcfg)
    jtree = jquant.quantize_params(params, bits=4, method=method,
                                   quantize_embed=True)
    return jcfg, params, jtree, qwen3_tiny(vocab, dtype="float32")


@pytest.mark.parametrize("method", ["int8", "int4", "nf4"])
def test_quantize_params_matches_jax(method):
    _, params, jtree, cfg = _tiny_trees(method)
    model = params_from_jax(_np(params), cfg, "cpu")
    got = quant.quantize_params(model_to_tree(model), bits=4, method=method,
                                quantize_embed=True)
    flat_ref = jax.tree_util.tree_flatten_with_path(_np(jtree))[0]
    flat_got = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(
                    jax.tree.map(lambda t: t.numpy(), got))[0]}
    assert len(flat_got) == len(flat_ref)
    for path, r in flat_ref:
        key = jax.tree_util.keystr(path)
        _assert_same(key, flat_got[key], r)
    assert quant.param_bytes(got) == jquant.param_bytes(jtree)
    assert quant.is_quantized_leaf(got["embed"]["weight"])
    assert not quant.is_quantized_leaf(got["final_ln"]["scale"])


@pytest.mark.parametrize("method", ["int4", "nf4"])
def test_params_from_jax_carries_quantized_leaves_exactly(method):
    _, _, jtree, cfg = _tiny_trees(method)
    ref = _np(jtree)
    model = params_from_jax(ref, cfg, "cpu")
    assert isinstance(model.embed, qwen3.QuantWeight)
    assert isinstance(model.layers[1].mlp.down, qwen3.QuantWeight)
    assert model.device == torch.device("cpu")      # embed is quantized
    # per layer: the JAX stack sliced at the layer, codes untouched
    lay = model.layers[1].attn.q.leaf
    for k, v in ref["layers"]["attn"]["q"].items():
        np.testing.assert_array_equal(lay[k].numpy(), v[1])
    back = jax.tree.map(lambda t: t.numpy(), model_to_tree(model))
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree.leaves(back)):
        assert g.dtype == r.dtype, path
        np.testing.assert_array_equal(g, r, err_msg=str(path))


def _forward_pair(method="int4"):
    jcfg, _, jtree, cfg = _tiny_trees(method)
    model = params_from_jax(_np(jtree), cfg, "cpu")
    ids = np.random.default_rng(2).integers(0, 48, (2, 9))
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0
    ref = np.asarray(jq.forward(jtree, jnp.asarray(ids), jcfg,
                                attention_mask=jnp.asarray(mask)))
    return model, torch.from_numpy(ids), torch.from_numpy(mask), ref


def test_quantized_forward_matches_jax():
    """fp32 qwen3_tiny, int4 layers and an int8 embed/tied head: the CPU
    route is the JAX CPU route (x @ dequantized weight), so only summation
    order differs; the head is dequantized to bf16 on both sides."""
    model, ids, mask, ref = _forward_pair()
    got = qwen3.forward(model, ids, attention_mask=mask)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_quantized_forward_plain_int4_route_close_to_jax():
    """The same through ``int4_matmul_plain`` (the kernel's function): x
    rounds to bf16 before each of the 7 x 2 projections (2^-9 relative),
    so the logits (O(0.1)) move by ~1e-3 at most."""
    model, ids, mask, ref = _forward_pair()
    with int4_route("plain"):
        got = qwen3.forward(model, ids, attention_mask=mask)
    err = np.abs(got.numpy() - ref).max()
    assert 0 < err < 5e-3, err


def test_int8_layers_forward_matches_jax():
    """int8 projections take dequantize-then-matmul on every route."""
    model, ids, mask, ref = _forward_pair("int8")
    with int4_route("plain"):
        got = qwen3.forward(model, ids, attention_mask=mask)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
