"""PyTorch port, the HiFT vocoder (``models/hift.py``) held against the
JAX module on the same weights and inputs (fp32, tiny configs, CPU): the
STFT/ISTFT heads, the transposed convs at the three upsample shapes, the
Snake ResBlock, the F0 predictor, the linear interpolation, the NSF source
on JAX's own draws, ``decode`` and ``forward`` with ``cache_source``; the
port's ``state_dict()`` read back by the JAX ``convert_torch_state``; and
``fold_weight_norm`` on both weight-norm layouts.

Tolerances: 1e-5 for single primitives (fp32, summation order only);
1e-4 for ``decode``/``forward``, whose exp(magnitude) head amplifies the
conv stack's rounding (the JAX tests hold the ISTFT and resblock to torch
at 1e-4). Per-row generators are held to bit-equality within the port."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.models import hift as jhift
from speech_distill_tpu_torch.models import hift as thift
from speech_distill_tpu_torch.models.convert import hift_params_from_jax
from tests.test_hift import _tiny_cfg

PRIM_ATOL = 1e-5
VOCODER_ATOL = 1e-4


def port_hift_cfg(jcfg) -> thift.HiFTConfig:
    return thift.HiFTConfig(**dataclasses.asdict(jcfg))


def port_hift(params, jcfg):
    """(port HiFTGenerator on the CPU, port config) from a JAX tree."""
    cfg = port_hift_cfg(jcfg)
    return (hift_params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                 "cpu"), cfg)


def jax_nsf_draws(key, B, T, H):
    """The draws the JAX ``nsf_source`` makes from ``key`` (split once:
    uniform phase offsets, then normal noise)."""
    k_rand, k_noise = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(k_rand, (B, H)))),
            torch.from_numpy(np.array(
                jax.random.normal(k_noise, (B, T, H)))))


@pytest.fixture(scope="module")
def models():
    jcfg = _tiny_cfg()
    params = jhift.init_params(jax.random.PRNGKey(0), jcfg)
    # nonzero biases and a trained-looking F0 head, so every term counts
    rng = np.random.default_rng(9)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype),
        params)
    model, cfg = port_hift(params, jcfg)
    return params, jcfg, model, cfg


def _x(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


WINDOW = np.hanning(17)[:-1].astype(np.float32)


def test_stft_matches_jax():
    x = _x(np.random.default_rng(0), 2, 96)
    gr, gi = thift._stft(_t(x), 16, 4, _t(WINDOW))
    rr, ri = jhift._stft(jnp.asarray(x), 16, 4, jnp.asarray(WINDOW))
    _close(gr, rr, PRIM_ATOL)
    _close(gi, ri, PRIM_ATOL)


def test_istft_matches_jax():
    rng = np.random.default_rng(1)
    real, imag = _x(rng, 2, 9, 30), _x(rng, 2, 9, 30)
    got = thift._istft(_t(real), _t(imag), 16, 4, _t(WINDOW))
    ref = jhift._istft(jnp.asarray(real), jnp.asarray(imag), 16, 4,
                       jnp.asarray(WINDOW))
    assert got.shape == (2, 29 * 4)
    _close(got, ref, PRIM_ATOL)


@pytest.mark.parametrize("k,s,p", [(16, 8, 4), (11, 5, 3), (7, 3, 2)])
def test_conv_transpose_matches_jax(k, s, p):
    """The three upsample shapes of the reference config."""
    rng = np.random.default_rng(2)
    x = _x(rng, 2, 12, 6)
    w, b = _x(rng, k, 4, 6), _x(rng, 4)          # JAX [k, Cout, Cin]
    conv = torch.nn.ConvTranspose1d(6, 4, k, s)
    conv.weight.data.copy_(_t(w.transpose(2, 1, 0)))
    conv.bias.data.copy_(_t(b))
    with torch.no_grad():
        got = thift._conv_transpose(_t(x), conv, s, p)
    ref = jhift._conv_transpose(jnp.asarray(x), {"w": jnp.asarray(w),
                                                 "b": jnp.asarray(b)},
                                s, k, p)
    assert got.shape == ref.shape == (2, 11 * s - 2 * p + k, 4)
    _close(got, ref, PRIM_ATOL)


def test_resblock_matches_jax(models):
    params, jcfg, model, _ = models
    x = _x(np.random.default_rng(3), 1, 20, 16)
    k, d = jcfg.resblock_kernel_sizes[0], jcfg.resblock_dilations[0]
    got = thift._resblock(model.resblocks[0], _t(x), k, d)
    ref = jhift._resblock(params["resblocks"][0][0], jnp.asarray(x), k, d)
    _close(got, ref, PRIM_ATOL)


def test_f0_predict_matches_jax(models):
    params, jcfg, model, _ = models
    mel = _x(np.random.default_rng(4), 2, 7, jcfg.in_channels)
    got = thift.f0_predict(model.f0_predictor, _t(mel))
    ref = jhift.f0_predict(params["f0_predictor"], jnp.asarray(mel))
    _close(got, ref, PRIM_ATOL)


@pytest.mark.parametrize("out_len", [4, 6, 24, 36])
def test_interp_linear_matches_jax(out_len):
    x = _x(np.random.default_rng(5), 2, 12, 3)
    got = thift._interp_linear(_t(x), out_len)
    ref = jhift._interp_linear(jnp.asarray(x), out_len)
    _close(got, ref, PRIM_ATOL)


def _f0_up(rng, cfg, B, frames):
    """An upsampled F0 track, voiced (> threshold) in places."""
    f0 = np.abs(rng.normal(100, 80, (B, frames))).astype(np.float32)
    f0[:, 1] = 0.0
    return np.repeat(f0, cfg.upsample_scale, axis=1)[..., None]


def test_nsf_source_with_jax_draws_matches_jax(models):
    params, jcfg, model, cfg = models
    key = jax.random.PRNGKey(11)
    f0 = _f0_up(np.random.default_rng(6), jcfg, 2, 3)
    T, H = f0.shape[1], jcfg.nb_harmonics + 1
    got = thift.nsf_source(model.m_source, _t(f0), cfg,
                           draws=jax_nsf_draws(key, 2, T, H))
    ref = jhift.nsf_source(params["m_source"], jnp.asarray(f0), jcfg, key)
    _close(got, ref, PRIM_ATOL)


def test_nsf_per_row_generators_equal_single_rows(models):
    """Each row of a batched call with per-row generators is bit-equal to
    its B = 1 call with that generator."""
    _, jcfg, model, cfg = models
    f0 = _t(_f0_up(np.random.default_rng(7), jcfg, 3, 2))

    def gens():
        return [torch.Generator().manual_seed(s) for s in (5, 6, 7)]
    batched = thift.nsf_source(model.m_source, f0, cfg,
                               per_row_generators=gens())
    for b, g in enumerate(gens()):
        single = thift.nsf_source(model.m_source, f0[b:b + 1], cfg,
                                  generator=g)
        assert torch.equal(batched[b:b + 1], single)


def test_decode_matches_jax(models):
    params, jcfg, model, cfg = models
    rng = np.random.default_rng(8)
    mel = _x(rng, 2, 6, jcfg.in_channels)
    src = 0.1 * _x(rng, 2, 6 * jcfg.upsample_scale)
    got = thift.decode(model, _t(mel), _t(src), cfg)
    ref = jhift.decode(params, jnp.asarray(mel), jnp.asarray(src), jcfg)
    _close(got, ref, VOCODER_ATOL)


@pytest.mark.parametrize("cached", [0, 2 * 480])
def test_forward_matches_jax(models, cached):
    """mel -> (wav, source) on JAX's NSF draws, with and without a
    spliced source tail."""
    params, jcfg, model, cfg = models
    rng = np.random.default_rng(10)
    mel = _x(rng, 1, 5, jcfg.in_channels)
    cache = 0.1 * _x(rng, 1, cached)
    key = jax.random.PRNGKey(3)
    T, H = 5 * jcfg.upsample_scale, jcfg.nb_harmonics + 1
    got_w, got_s = thift.forward(model, _t(mel), cfg,
                                 cache_source=_t(cache),
                                 draws=jax_nsf_draws(key, 1, T, H))
    ref_w, ref_s = jhift.forward(params, jnp.asarray(mel), jcfg, rng=key,
                                 cache_source=jnp.asarray(cache))
    _close(got_s, ref_s, PRIM_ATOL)
    _close(got_w, ref_w, VOCODER_ATOL)
    assert got_w.abs().max() <= cfg.audio_limit


def test_state_dict_round_trips_through_jax_convert(models):
    params, jcfg, model, _ = models
    back = jhift.convert_torch_state(model.state_dict(), jcfg)
    fa = jax.tree_util.tree_leaves_with_path(back)
    fb = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(fa) == len(fb)
    for path, leaf in fa:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(fb[path]),
                                      err_msg=str(path))


def test_init_params_is_the_jax_init():
    jcfg = _tiny_cfg()
    model = thift.init_params(port_hift_cfg(jcfg), seed=0, device="cpu")
    back = jhift.convert_torch_state(model.state_dict(), jcfg)
    ref = jhift.init_params(jax.random.PRNGKey(0), jcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_fold_weight_norm_matches_jax(models, layout):
    """A weight-normed state dict (both torch layouts) folds to the JAX
    folding's weights, and the port loads it."""
    _, _, model, cfg = models
    rng = np.random.default_rng(12)
    state = {}
    for k, v in model.state_dict().items():
        if k.endswith(".weight") and v.dim() == 3:
            base = k[:-len(".weight")]
            g = np.abs(rng.normal(1, 0.2, (v.shape[0], 1, 1))).astype(
                np.float32)
            vv = v.numpy() * 3.0 + 0.01
            if layout == "weight_g":
                state[base + ".weight_g"] = torch.from_numpy(g)
                state[base + ".weight_v"] = torch.from_numpy(vv)
            else:
                pre = base + ".parametrizations.weight."
                state[pre + "original0"] = torch.from_numpy(g)
                state[pre + "original1"] = torch.from_numpy(vv)
        else:
            state[k] = v.clone()
    got = thift.fold_weight_norm(state)
    ref = jhift.fold_weight_norm(state)
    assert sorted(got) == sorted(ref) == sorted(model.state_dict())
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    fresh = thift.HiFTGenerator(cfg, "cpu")
    fresh.load_state_dict(got)
    assert torch.equal(fresh.conv_pre.weight, got["conv_pre.weight"])
