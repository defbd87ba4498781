"""PyTorch port, the optimizers of ``make_optimizer``: the 8-bit AdamW
(``distill/optim8bit``) and the one-traversal ``adamw(fused=True)``, held
against the JAX package step by step on the same leaves and gradients
(bf16 and fp32 leaves, one of them not a multiple of the 256-wide block,
steps under and over the clip norm, with and without weight decay)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_distill_tpu.distill import optim8bit as joptim8
from speech_distill_tpu.distill import train_step as jts
from speech_distill_tpu_torch.core.tree import tree_leaves
from speech_distill_tpu_torch.distill import optim8bit
from speech_distill_tpu_torch.distill import train_step as tts

# leaf shapes and dtypes: 703 and 300 elements are not multiples of 256
LEAVES = {"a": ((37, 19), "float32"), "b": {"c": ((16, 32), "bfloat16")},
          "d": ((300,), "bfloat16"), "e": ((256,), "float32")}
LR, WARMUP, TOTAL, STEPS = 1e-2, 2, 8, 5
# the updates: rtol 1e-6. The clip's global norm is an fp32 sum whose
# order differs from XLA's, so after a step over the clip norm the fp32
# leaves' clipped gradients sit an ulp apart (bf16 leaves round it away):
# the first moment's block scales then an ulp, the second moment's (g^2)
# two; the codes are equal. Fed JAX's clipped gradients, the scales are
# equal too (the test's "jax" clip)
UPD_RTOL, UPD_ATOL = 1e-6, 1e-9
SCALE_MAX_ULP = 2


def _draw(rng, scale):
    """Seeded params or grads as (jax tree, torch tree) of equal values."""
    jt, tt = {}, {}

    def one(spec):
        shape, dt = spec
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        j = jnp.asarray(a, jnp.dtype(dt))
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            getattr(torch, dt))

    def walk(spec, jo, to):
        for k, v in spec.items():
            if isinstance(v, dict):
                jo[k], to[k] = {}, {}
                walk(v, jo[k], to[k])
            else:
                jo[k], to[k] = one(v)
    walk(LEAVES, jt, tt)
    return jt, tt


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def _jax_adam_state(state):
    return next(s for s in state if isinstance(s, joptim8.Adam8bitState))


def _check_updates(ju, tu):
    for a, b in zip(jax.tree.leaves(ju), tree_leaves(tu)):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_allclose(_np(b), _np(a), rtol=UPD_RTOL,
                                   atol=UPD_ATOL)


def _check_codes(ja, ts, scale_ulp: int):
    for name in ("mu_q", "mu_scale", "nu_q", "nu_scale"):
        for a, b in zip(jax.tree.leaves(getattr(ja, name)),
                        tree_leaves(getattr(ts, name))):
            assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
            if name.endswith("_q") or not scale_ulp:
                np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)
            else:
                np.testing.assert_array_max_ulp(_np(b), _np(a), scale_ulp)


def test_scale_by_adam_8bit_codes_match_jax_bit_for_bit():
    """The 8-bit Adam step alone, five steps on the same gradients (bf16
    and fp32 leaves, sizes off the 256 block): codes and block scales
    equal JAX's bit for bit, the updates within rtol 1e-6 (torch's CPU
    sqrt is an ulp off the correctly rounded one for ~0.6% of inputs;
    the sqrt feeds only the update, never the codes)."""
    rng = np.random.default_rng(2)
    jp, tp = _draw(rng, 1.0)
    jopt, topt = joptim8.scale_by_adam_8bit(), optim8bit.scale_by_adam_8bit()
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(STEPS):
        jg, tg = _draw(rng, 10.0 ** (step % 3 - 1))
        ju, js = jopt.update(jg, js)
        tu, ts = topt.update(tg, ts)
        _check_updates(ju, tu)
        assert ts.count == int(js.count) == step + 1
        _check_codes(js, ts, 0)


def _to_torch(tree):
    """A JAX tree as torch tensors of the same values and dtypes."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(getattr(torch, str(a.dtype))), tree)


@pytest.mark.parametrize("clip", ["port", "jax"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_8bit_codes_scales_and_updates_match_jax(wd, clip,
                                                       monkeypatch):
    """Five steps of make_optimizer(eight_bit=True), the chain clip ->
    8-bit Adam -> decay -> learning rate: the int8 / uint8 codes equal
    JAX's, the fp32 block scales within two ulps, the updates and the
    parameters after each update within rtol 1e-6. With JAX's clipped
    gradients in place of the port's clip (clip "jax") the scales are
    equal bit for bit: the clip's global norm is where the ulps arise."""
    rng = np.random.default_rng(0)
    jp, tp = _draw(rng, 1.0)
    jopt = jts.make_optimizer(LR, WARMUP, TOTAL, weight_decay=wd,
                              eight_bit=True)
    topt = tts.make_optimizer(LR, WARMUP, TOTAL, weight_decay=wd,
                              eight_bit=True)
    jclip, clipped = optax.clip_by_global_norm(1.0), {}
    if clip == "jax":
        monkeypatch.setattr(optim8bit, "clip_by_global_norm",
                            lambda grads, max_norm: clipped["grads"])
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(STEPS):
        jg, tg = _draw(rng, 0.01 if step % 2 == 0 else 10.0)  # under / over
        clipped["grads"] = _to_torch(jclip.update(jg, jclip.init(jg))[0])
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        _check_updates(ju, tu)
        ja = _jax_adam_state(js)
        assert ts.count == int(ja.count) == step + 1
        _check_codes(ja, ts, SCALE_MAX_ULP if clip == "port" else 0)
        jp = optax.apply_updates(jp, ju)
        tp = tts.apply_updates(tp, tu, in_place=False)
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            np.testing.assert_allclose(_np(b), _np(a), rtol=UPD_RTOL,
                                       atol=UPD_ATOL)


def test_adam_8bit_state_is_codes_and_first_step_reads_zero_codes():
    """init: int8 / uint8 all-zero codes and zero scales, one block row a
    256 elements (padded); about two bytes a parameter in all."""
    tp = {"w": torch.zeros(100, 10)}
    st = optim8bit.scale_by_adam_8bit().init(tp)
    assert st.count == 0
    assert st.mu_q["w"].dtype == torch.int8
    assert st.nu_q["w"].dtype == torch.uint8
    assert tuple(st.mu_q["w"].shape) == (4, 256)
    assert tuple(st.mu_scale["w"].shape) == (4, 1)
    assert not st.mu_q["w"].any() and not st.nu_scale["w"].any()
    assert optim8bit.state_bytes(st) < 1000 * 2 * 1.1 + 64
    ups, st = optim8bit.scale_by_adam_8bit().update(
        {"w": torch.ones(100, 10)}, st)
    # m = 0.1 g, v = 0.001 g^2 from zero codes: the bias-corrected ratio 1
    np.testing.assert_allclose(ups["w"].numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_clip_adamw_matches_jax(wd):
    """adamw(fused=True) against the JAX fused_clip_adamw over five steps under and over
    the clip norm: updates at JAX's own leaf-exact bound (atol 1e-7,
    rtol 1e-6), the update and moment dtypes equal after each step (bf16
    leaves: bf16 updates, fp32 moments)."""
    rng = np.random.default_rng(1)
    jp, tp = _draw(rng, 1.0)
    jsched = optax.schedules.linear_schedule(1e-3, 0.0, 10)
    jopt = jts.fused_clip_adamw(jsched, weight_decay=wd, max_grad_norm=1.0)

    def tsched(count):
        return float(jsched(count))
    topt = tts.adamw(tsched, weight_decay=wd, max_grad_norm=1.0,
                     fused=True)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(STEPS):
        jg, tg = _draw(rng, 0.01 if step % 2 == 0 else 10.0)
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        for a, b in zip(jax.tree.leaves(ju), tree_leaves(tu)):
            assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-7,
                                       rtol=1e-6)
        count, mu, nu = js
        assert ts["count"] == int(count)
        for ja, ta in ((mu, ts["mu"]), (nu, ts["nu"])):
            for a, b in zip(jax.tree.leaves(ja), tree_leaves(ta)):
                assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
                np.testing.assert_allclose(_np(b), _np(a), atol=1e-7,
                                           rtol=1e-6)
        jp = optax.apply_updates(jp, ju)
        tp = tts.apply_updates(tp, tu, in_place=False)


def test_warmup_linear_schedule_matches_optax_fp32():
    """The schedule of make_optimizer is JAX's join of two linear
    schedules, evaluated in fp32 bit for bit."""
    sched = tts.warmup_linear_schedule(3e-4, 7, 31)
    warm = optax.schedules.join_schedules([
        optax.schedules.linear_schedule(0.0, 3e-4, 7),
        optax.schedules.linear_schedule(3e-4, 0.0, 24)], [7])
    for c in range(0, 35):
        assert sched(c) == float(np.float32(warm(c))), c
