"""PyTorch port, the flow-matching decoder (``models/flow.py``): the
estimator blocks, the CFM Euler solve, ``forward_flow`` (whole, with
``enc_len``, with the ``finalize=False`` context path) and the incremental
path, held against the JAX module on the same weights, inputs and noise
(fp32, tiny configs, CPU); plus the weight carry-over: the port's
``state_dict()`` is a reference ``flow.pt`` state dict that the JAX
``convert_torch_state`` reads back to the JAX tree.

Tolerances: single blocks 1e-5; whole estimator passes and solves 1e-4
(fp32, only summation order differs; the JAX tests hold the same paths to
1e-4 - 2e-4); init and conversion are exact."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.models import flow as jflow
from speech_distill_tpu_torch.models import flow as tflow
from speech_distill_tpu_torch.models.convert import flow_params_from_jax
from speech_distill_tpu_torch.models.flow_encoder import FlowEncoderConfig
from tests.test_flow import tiny_cfg

BLOCK_ATOL = 1e-5
FLOW_ATOL = 1e-4


def port_flow_cfg(jcfg) -> tflow.FlowConfig:
    d = dataclasses.asdict(jcfg)
    enc = FlowEncoderConfig(**d.pop("encoder"))
    return tflow.FlowConfig(**d, encoder=enc)


def port_flow(params, jcfg):
    """(port Flow on the CPU, port config) from a JAX tree and config."""
    cfg = port_flow_cfg(jcfg)
    return (flow_params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                 "cpu"), cfg)


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_cfg()
    params = jflow.init_params(jax.random.PRNGKey(0), jcfg)
    model, cfg = port_flow(params, jcfg)
    return params, jcfg, model, cfg


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


def _leaves_equal(a, b):
    fa = jax.tree_util.tree_leaves_with_path(a)
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(fa) == len(fb)
    for path, leaf in fa:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(fb[path]),
                                      err_msg=str(path))


def test_init_params_is_the_jax_init():
    """Seed 0 draws the JAX init's weights, leaf for leaf."""
    jcfg = tiny_cfg()
    model = tflow.init_params(port_flow_cfg(jcfg), seed=0, device="cpu")
    _leaves_equal(jflow.convert_torch_state(model.state_dict(), jcfg),
                  jflow.init_params(jax.random.PRNGKey(0), jcfg))


def test_state_dict_round_trips_through_jax_convert(models):
    """The port's state_dict is a reference flow.pt: the JAX converter
    reads it back to the JAX tree, and the JAX flow on that tree gives the
    port's mel."""
    params, jcfg, model, cfg = models
    back = jflow.convert_torch_state(model.state_dict(), jcfg)
    _leaves_equal(back, params)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (1, 6))
    args = (tok, [6], _x(rng, 1, 4, 8), [4], _x(rng, 1, 6))
    noise = _x(rng, 1, 12, 8)
    ref, _ = jflow.forward_flow(back, *map(jnp.asarray, args), jcfg,
                                noise=jnp.asarray(noise))
    got, _ = tflow.forward_flow(model, *map(_t, args), cfg, noise=_t(noise))
    _close(got, ref, FLOW_ATOL)


def test_causal_block_matches_jax(models):
    params, jcfg, model, _ = models
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 7, jcfg.est_channels)
    mask = np.ones((2, 7, 1), np.float32)
    mask[1, 5:] = 0
    est = model.decoder.estimator
    got = tflow._causal_block(est.final_block, _t(x), _t(mask))
    ref = jflow._causal_block(params["estimator"]["final_block"],
                              jnp.asarray(x), jnp.asarray(mask))
    _close(got, ref, BLOCK_ATOL)


def test_causal_resnet_matches_jax(models):
    params, jcfg, model, _ = models
    rng = np.random.default_rng(2)
    x = _x(rng, 2, 6, jcfg.est_in_channels)
    mask = np.ones((2, 6, 1), np.float32)
    t_emb = _x(rng, 2, 4 * jcfg.est_channels)
    got = tflow._causal_resnet(model.decoder.estimator.down_blocks[0][0],
                               _t(x), _t(mask), _t(t_emb))
    ref = jflow._causal_resnet(params["estimator"]["down"]["resnet"],
                               jnp.asarray(x), jnp.asarray(mask),
                               jnp.asarray(t_emb))
    _close(got, ref, BLOCK_ATOL)


def test_transformer_block_matches_jax(models):
    """Mid block 1's first transformer block, under a chunk-causal bias."""
    params, jcfg, model, _ = models
    rng = np.random.default_rng(3)
    x = _x(rng, 2, 6, jcfg.est_channels)
    pos = np.arange(6)
    keep = pos[None, :] < ((pos // 4 + 1) * 4)[:, None]
    bias = np.where(keep, 0.0, -1e10).astype(np.float32)[None, None]
    lp = jax.tree.map(lambda a: a[1, 0],
                      params["estimator"]["mid"]["blocks"])
    got = tflow._transformer_block(
        model.decoder.estimator.mid_blocks[1][1][0], _t(x), _t(bias),
        jcfg.est_num_heads, jcfg.est_head_dim)
    ref = jflow._transformer_block(lp, jnp.asarray(x), jnp.asarray(bias),
                                   jcfg.est_num_heads, jcfg.est_head_dim)
    _close(got, ref, BLOCK_ATOL)


def test_time_embedding_matches_jax(models):
    params, jcfg, model, _ = models
    t = np.asarray([0.0, 0.3, 1.0], np.float32)
    got = tflow._time_embedding(model.decoder.estimator.time_mlp, _t(t),
                                jcfg.est_in_channels)
    ref = jflow._time_embedding(params["estimator"]["time_mlp"],
                                jnp.asarray(t), jcfg.est_in_channels)
    _close(got, ref, BLOCK_ATOL)


def _est_inputs(rng, B, T, C=8):
    mask = np.ones((B, T, 1), np.float32)
    mask[-1, T - 3:] = 0
    return (_x(rng, B, T, C), mask, _x(rng, B, T, C),
            rng.uniform(size=B).astype(np.float32), _x(rng, B, C),
            _x(rng, B, T, C))


@pytest.mark.parametrize("streaming", [False, True])
def test_estimator_forward_matches_jax(models, streaming):
    params, jcfg, model, cfg = models
    jcfg = dataclasses.replace(jcfg, static_chunk_size=4)
    cfg = dataclasses.replace(cfg, static_chunk_size=4)
    args = _est_inputs(np.random.default_rng(4), 2, 10)
    got = tflow.estimator_forward(model.decoder.estimator, *map(_t, args),
                                  cfg, streaming)
    ref = jflow.estimator_forward(params["estimator"],
                                  *map(jnp.asarray, args), jcfg, streaming)
    _close(got, ref, FLOW_ATOL)


def test_solve_euler_matches_jax(models):
    """Two Euler steps with CFG over the doubled batch, streaming."""
    params, jcfg, model, cfg = models
    x, mask, mu, _, spks, cond = _est_inputs(np.random.default_rng(5), 2, 8)
    args = (x, mu, mask, spks, cond)
    got = tflow.solve_euler(model.decoder.estimator, *map(_t, args), cfg,
                            streaming=True)
    ref = jflow.solve_euler(params["estimator"], *map(jnp.asarray, args),
                            jcfg, streaming=True)
    _close(got, ref, FLOW_ATOL)


def _flow_inputs(rng, jcfg, B=2, T=9):
    token = rng.integers(0, jcfg.vocab_size, (B, T))
    token_len = np.asarray([T, T - 3][:B])
    prompt = _x(rng, B, 6, jcfg.output_size)
    prompt_len = np.asarray([6, 4][:B])
    emb = _x(rng, B, jcfg.spk_embed_dim)
    noise = _x(rng, B, 2 * T, jcfg.output_size)
    return (token, token_len, prompt, prompt_len, emb), noise


@pytest.mark.parametrize("form", ["whole", "enc_len", "finalize_false"])
def test_forward_flow_matches_jax(models, form):
    """Token -> mel on the same noise: the offline call, the inline
    lookahead (``enc_len``), and the context path (``finalize=False``)."""
    params, jcfg, model, cfg = models
    args, noise = _flow_inputs(np.random.default_rng(6), jcfg)
    kw_j, kw_t = {}, {}
    if form == "enc_len":
        kw_j["enc_len"] = jnp.asarray([6, 4])
        kw_t["enc_len"] = torch.tensor([6, 4])
    if form == "finalize_false":
        kw_j["finalize"] = kw_t["finalize"] = False
        noise = noise[:, :2 * (noise.shape[1] // 2 - 3)]
    ref, ref_lens = jflow.forward_flow(params, *map(jnp.asarray, args), jcfg,
                                       streaming=True,
                                       noise=jnp.asarray(noise), **kw_j)
    got, got_lens = tflow.forward_flow(model, *map(_t, args), cfg,
                                       streaming=True, noise=_t(noise),
                                       **kw_t)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    assert got.dtype == torch.float32
    _close(got, ref, FLOW_ATOL)


def test_forward_flow_negative_ids_read_row_zero(models):
    """JAX embeds max(id, 0); so does the port."""
    params, jcfg, model, cfg = models
    rng = np.random.default_rng(7)
    args, noise = _flow_inputs(rng, jcfg, B=1, T=6)
    args[0][0, 2] = -5
    ref, _ = jflow.forward_flow(params, *map(jnp.asarray, args), jcfg,
                                noise=jnp.asarray(noise))
    got, _ = tflow.forward_flow(model, *map(_t, args), cfg, noise=_t(noise))
    _close(got, ref, FLOW_ATOL)


def test_encode_flow_tokens_matches_jax(models):
    params, jcfg, model, cfg = models
    rng = np.random.default_rng(8)
    tok = rng.integers(0, jcfg.vocab_size, (1, 16))
    ref = jflow.encode_flow_tokens(params, jnp.asarray(tok),
                                   jnp.asarray([11]), jcfg,
                                   enc_len=jnp.asarray([8]))
    got = tflow.encode_flow_tokens(model, _t(tok), torch.tensor([11]), cfg,
                                   enc_len=torch.tensor([8]))
    _close(got, ref, FLOW_ATOL)


def test_solve_flow_incremental_matches_jax(models):
    """Two incremental calls (a first chunk over the prompt, then one
    partial chunk) against the JAX incremental solver on fp32 caches:
    the new mel and every cache leaf."""
    params, jcfg, model, cfg = models
    rng = np.random.default_rng(9)
    h = _x(rng, 1, 40, 8)
    pmel, emb = _x(rng, 1, 6, 8), _x(rng, 1, jcfg.spk_embed_dim)
    noise = _x(rng, 1, 40, 8)
    jc = jflow.init_incremental_cache(jcfg, 1, 32, kv_dtype=jnp.float32)
    tc = tflow.init_incremental_cache(cfg, 1, 32, kv_dtype=torch.float32,
                                      device="cpu")
    for t_past, F, enc_len in ((0, 16, 8), (16, 8, 11)):
        ref, jc = jflow.solve_flow_incremental(
            params, jnp.asarray(h[:, t_past:t_past + F]), jnp.asarray(pmel),
            jnp.asarray([6]), jnp.asarray(emb), jcfg, jc,
            jnp.asarray(t_past), jnp.asarray(noise[:, t_past:t_past + F]),
            jnp.asarray([enc_len]))
        got = tflow.solve_flow_incremental(
            model, _t(h[:, t_past:t_past + F]), _t(pmel), torch.tensor([6]),
            _t(emb), cfg, tc, t_past, _t(noise[:, t_past:t_past + F]),
            enc_len)
        _close(got, ref, FLOW_ATOL)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jc),
                            jax.tree_util.tree_leaves(
                                jax.tree.map(lambda t: t.numpy(), tc))):
        np.testing.assert_allclose(b, np.asarray(a), atol=FLOW_ATOL,
                                   err_msg=str(path))


def test_incremental_cache_size_at_the_full_config():
    """15 steps x 2 CFG rows x 56 blocks x (K, V) x 512 = 1,720,320 K/V
    elements a frame for one stream (3.4 MB bf16); the layout is JAX's."""
    cfg = tflow.FlowConfig()
    cache = tflow.init_incremental_cache(cfg, 1, 1, device="cpu")
    kv = [cache[s]["attn"][n] for s in ("down", "mid", "up")
          for n in ("k", "v")]
    assert sum(t.numel() for t in kv) == 1_720_320
    assert all(t.dtype == torch.bfloat16 for t in kv)
    jc = jax.eval_shape(lambda: jflow.init_incremental_cache(
        jflow.FlowConfig(), 1, 1))
    shapes_j = [tuple(a.shape) for a in jax.tree_util.tree_leaves(jc)]
    shapes_t = [tuple(t.shape) for t in jax.tree_util.tree_leaves(cache)]
    assert shapes_t == shapes_j
