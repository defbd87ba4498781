"""PyTorch port, the flow's upsampling conformer encoder
(``models/flow_encoder.py``) held against the JAX module on the same
weights and inputs (fp32, tiny config, CPU).

Tolerances: the rel-pos table, the Transformer-XL shift and the mask bias
are exact (same arithmetic, or pure data movement); single blocks agree
to 1e-5, and the whole encoder (10 fp32 layers) to 1e-4, summation order
being all that differs."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.models import flow as jflow
from speech_distill_tpu.models import flow_encoder as jenc
from speech_distill_tpu_torch.models import flow_encoder as tenc
from tests.test_flow import tiny_cfg
from tests.test_torch_flow import port_flow

BLOCK_ATOL = 1e-5
ENCODER_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_cfg()
    params = jflow.init_params(jax.random.PRNGKey(0), jcfg)
    model, cfg = port_flow(params, jcfg)
    return params["encoder"], jcfg.encoder, model.encoder, cfg.encoder


def _pick(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_rel_shift_matches_jax():
    """Pure data movement: bit-equal, on a non-square head count."""
    x = _x(np.random.default_rng(0), 2, 3, 5, 9)
    got = tenc._rel_shift(torch.from_numpy(x)).numpy()
    ref = np.asarray(jenc._rel_shift(jnp.asarray(x)))
    assert got.shape == (2, 3, 5, 5)
    np.testing.assert_array_equal(got, ref)


def test_rel_pos_encoding_matches_jax():
    np.testing.assert_array_equal(tenc.rel_pos_encoding(7, 16),
                                  jenc.rel_pos_encoding(7, 16))


@pytest.mark.parametrize("chunk", [0, 2, 3])
def test_chunk_mask_bias_matches_jax(chunk):
    lens = np.asarray([7, 4], np.int64)
    got = tenc.chunk_mask_bias(7, torch.from_numpy(lens), 2, chunk).numpy()
    ref = np.asarray(jenc.chunk_mask_bias(7, jnp.asarray(lens), 2, chunk))
    np.testing.assert_array_equal(got, ref)


def test_rel_attention_matches_jax(models):
    jp, jc, enc, _ = models
    rng = np.random.default_rng(1)
    T, D = 6, jc.output_size
    x = _x(rng, 2, T, D)
    pos = tenc.rel_pos_encoding(T, D)
    lens = np.asarray([6, 4])
    bias_t = tenc.chunk_mask_bias(T, torch.from_numpy(lens), 2, 2)
    bias_j = jenc.chunk_mask_bias(T, jnp.asarray(lens), 2, 2)
    got = tenc._rel_attention(enc.encoders[1].self_attn, torch.from_numpy(x),
                              torch.from_numpy(pos), bias_t,
                              jc.attention_heads)
    ref = jenc._rel_attention(_pick(jp["encoders"], 1)["attn"],
                              jnp.asarray(x), jnp.asarray(pos), bias_j,
                              jc.attention_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=BLOCK_ATOL)


def test_conformer_layer_matches_jax(models):
    jp, jc, enc, _ = models
    rng = np.random.default_rng(2)
    T, D = 5, jc.output_size
    x = _x(rng, 1, T, D)
    pos = tenc.rel_pos_encoding(T, D)
    got = tenc._conformer_layer(enc.encoders[0], torch.from_numpy(x),
                                torch.from_numpy(pos), None,
                                jc.attention_heads)
    ref = jenc._conformer_layer(_pick(jp["encoders"], 0), jnp.asarray(x),
                                jnp.asarray(pos), None, jc.attention_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=BLOCK_ATOL)


@pytest.mark.parametrize("form", ["right_pad", "context"])
def test_pre_lookahead_matches_jax(models, form):
    jp, jc, enc, _ = models
    rng = np.random.default_rng(3)
    la = jc.pre_lookahead_len
    x = _x(rng, 2, 7, jc.output_size)
    ctx = _x(rng, 2, la, jc.output_size) if form == "context" else None
    got = tenc.pre_lookahead(
        enc.pre_lookahead_layer, torch.from_numpy(x), la,
        None if ctx is None else torch.from_numpy(ctx))
    ref = jenc.pre_lookahead(jp["pre_lookahead"], jnp.asarray(x), la,
                             None if ctx is None else jnp.asarray(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=BLOCK_ATOL)


def test_upsample1d_matches_jax(models):
    jp, jc, enc, _ = models
    x = _x(np.random.default_rng(4), 2, 5, jc.output_size)
    got = tenc.upsample1d(enc.up_layer, torch.from_numpy(x), jc.up_stride)
    ref = jenc.upsample1d(jp["up_layer"], jnp.asarray(x), jc.up_stride)
    assert got.shape == (2, 10, jc.output_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=BLOCK_ATOL)


@pytest.mark.parametrize("streaming", [False, True])
def test_encoder_forward_matches_jax(models, streaming):
    """Ragged lengths; with streaming the chunk masks of both stages."""
    jp, jc, enc, tc = models
    jc = dataclasses.replace(jc, static_chunk_size=3)
    tc = dataclasses.replace(tc, static_chunk_size=3)
    rng = np.random.default_rng(5)
    xs = _x(rng, 2, 9, jc.input_size)
    lens = np.asarray([9, 6])
    got, got_lens = tenc.forward(enc, torch.from_numpy(xs),
                                 torch.from_numpy(lens), tc,
                                 streaming=streaming)
    ref, ref_lens = jenc.forward(jp, jnp.asarray(xs), jnp.asarray(lens), jc,
                                 streaming=streaming)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ENCODER_ATOL)


def test_encoder_forward_with_context_matches_jax(models):
    jp, jc, enc, tc = models
    rng = np.random.default_rng(6)
    xs = _x(rng, 1, 8, jc.input_size)
    ctx = _x(rng, 1, jc.pre_lookahead_len, jc.input_size)
    lens = np.asarray([8])
    got, _ = tenc.forward(enc, torch.from_numpy(xs), torch.from_numpy(lens),
                          tc, context=torch.from_numpy(ctx), streaming=True)
    ref, _ = jenc.forward(jp, jnp.asarray(xs), jnp.asarray(lens), jc,
                          context=jnp.asarray(ctx), streaming=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ENCODER_ATOL)


def test_encoder_state_dict_is_reference_format(models):
    """The encoder's state_dict, read by the JAX ``convert_torch_state``
    under the reference prefix, rebuilds the JAX tree exactly."""
    jp, jc, enc, _ = models
    state = {"encoder." + k: v for k, v in enc.state_dict().items()}
    back = jenc.convert_torch_state(state, jc, prefix="encoder.")
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(jp))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_b[path]))
