"""PyTorch port, KD losses: ``sparse_distill_loss``, the fused
``head_sparse_kd_loss`` and the unfused head's ``unembed_train`` held
against the JAX package on the same numpy inputs. fp32, CPU."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.distill import losses as jlosses
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.ops import fused_lm_loss as jfused
from speech_distill_tpu_torch.core.config import qwen3_tiny
from speech_distill_tpu_torch.distill import losses
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.ops.fused_lm_loss import head_sparse_kd_loss


def _setup(seed, B=2, T=12, D=32, V=200, K=8):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, T, D)).astype(np.float32)
    lm_w = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int64)
    labels[:, :3] = -100                                  # ignored labels
    tv = (rng.normal(size=(B, T, K)) - 3).astype(np.float16)
    ti = np.argsort(rng.random((B, T, V)), axis=-1)[..., :K].astype(
        np.int32)
    ti[0, 5, 0] = labels[0, 6]                            # a gold hit
    smask = (rng.random((B, T)) > 0.25).astype(np.float32)
    return hidden, lm_w, labels, tv, ti, smask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_sparse_distill_loss_matches_jax():
    hidden, lm_w, labels, tv, ti, smask = _setup(0)
    logits = hidden @ lm_w.T
    ref = jlosses.sparse_distill_loss(*map(jnp.asarray, (
        logits, tv, ti, labels, smask)), temperature=2.0, alpha=0.3)
    got = losses.sparse_distill_loss(*_t(logits, tv, ti, labels, smask),
                                     temperature=2.0, alpha=0.3)
    assert float(ref.teacher) != 0.0
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-7)


def test_head_sparse_kd_loss_forward_matches_jax():
    hidden, lm_w, labels, tv, ti, smask = _setup(1)
    args = (labels, tv, ti, smask)
    ref = jfused.head_sparse_kd_loss(jnp.asarray(hidden), jnp.asarray(lm_w),
                                     *map(jnp.asarray, args))
    got = head_sparse_kd_loss(*_t(hidden, lm_w, *args))
    unfused = losses.sparse_distill_loss(
        torch.from_numpy(hidden @ lm_w.T), *_t(tv, ti, labels, smask))
    for a, b, c in zip(got, ref, unfused):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(a), float(c), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("smask_on", [False, True], ids=["no-mask", "mask"])
def test_head_sparse_kd_loss_grads_match_jax(smask_on):
    """The analytic backward against ``jax.grad`` of the JAX op (both
    round d_logits to bf16), normalised by max, as
    tests/test_fused_loss.py."""
    hidden, lm_w, labels, tv, ti, smask = _setup(2)
    smask = smask if smask_on else None

    def jloss(h, w):
        return jfused.head_sparse_kd_loss(h, w, jnp.asarray(labels),
                                          jnp.asarray(tv), jnp.asarray(ti),
                                          None if smask is None
                                          else jnp.asarray(smask)).total
    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(hidden),
                                          jnp.asarray(lm_w))
    h, w = (torch.from_numpy(a).requires_grad_() for a in (hidden, lm_w))
    head_sparse_kd_loss(h, w, *_t(labels, tv, ti),
                        None if smask is None else torch.from_numpy(smask)
                        ).total.backward()
    for got, r, name in zip((h.grad, w.grad), ref, ("dh", "dW")):
        r = np.asarray(r, np.float32)
        scale = np.abs(r).max() + 1e-12
        np.testing.assert_allclose(got.numpy() / scale, r / scale,
                                   atol=2e-2, err_msg=name)


@pytest.mark.parametrize("bwd", ["float32", "bfloat16"])
def test_unembed_train_matches_jax(bwd):
    """The unfused head's lm-head product and its backward, exact in fp32
    and with the d_logits cast of ``head_bwd_dtype`` bf16."""
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = rng.normal(size=(40, 16)).astype(np.float32)
    g = rng.normal(size=(2, 5, 40)).astype(np.float32)
    jcfg = jax_tiny(40, dtype="float32", head_bwd_dtype=bwd)
    ref, vjp = jax.vjp(lambda h, w_: jq.unembed({"embed": {"weight": w_}},
                                                 h, jcfg),
                       jnp.asarray(hidden), jnp.asarray(w))
    ref_grads = vjp(jnp.asarray(g))
    cfg = qwen3_tiny(40, dtype="float32", head_bwd_dtype=bwd)
    h, wt = (torch.from_numpy(a).requires_grad_() for a in (hidden, w))
    out = tq.unembed_train(h, wt, cfg)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for got, r in zip((h.grad, wt.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("teacher", ["dense", "sparse", "none"])
def test_distillation_loss_dispatches_as_jax(teacher):
    """The facade: the dense loss when the teacher's logits are given, the
    sparse one on top-K values and indices (1e-5), and the same
    ValueError as JAX with neither."""
    hidden, lm_w, labels, tv, ti, smask = _setup(3)
    logits = hidden @ lm_w.T
    t_logits = (np.random.default_rng(4).normal(size=logits.shape)
                * 3).astype(np.float32)
    kw = {"dense": {"teacher_logits": t_logits},
          "sparse": {"teacher_top_k_v": tv, "teacher_top_k_i": ti},
          "none": {"teacher_top_k_v": tv}}[teacher]
    args = dict(speech_token_mask=smask, temperature=2.0, alpha=0.3)
    if teacher == "none":
        for fn, conv in ((jlosses.distillation_loss, jnp.asarray),
                         (losses.distillation_loss, torch.from_numpy)):
            with pytest.raises(ValueError, match="Either teacher_logits"):
                fn(conv(logits), conv(labels),
                   **{k: conv(v) for k, v in kw.items()},
                   speech_token_mask=conv(smask))
        return
    ref = jlosses.distillation_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        **{k: jnp.asarray(v) for k, v in kw.items()},
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in args.items()})
    got = losses.distillation_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        **{k: torch.from_numpy(v) for k, v in kw.items()},
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in args.items()})
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
