"""PyTorch port, the KD training step: the training forward with adapters
and three steps of ``make_kd_step(mode="precomputed")`` held against the
JAX package on the same weights, PiSSA LoRA and batch. fp32, qwen3_tiny,
CPU."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import (DistillConfig as JDistill,
                                            LoraConfig as JLora,
                                            qwen3_tiny as jax_tiny)
from speech_distill_tpu.distill import train_step as jts
from speech_distill_tpu.distill.lora import init_lora as jax_init_lora
from speech_distill_tpu.distill.lora import lora_scaling as jax_scaling
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.ops import pallas_lm_loss as jpallas
from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  qwen3_tiny)
from speech_distill_tpu_torch.core.tree import tree_leaves
from speech_distill_tpu_torch.distill import train_step as tts
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.models.convert import (params_from_jax,
                                                     trainable_from_jax,
                                                     tree_to_numpy)

VOCAB, R, ALPHA = 128, 4, 8
# learning rate of the step parity test. The fused head rounds d_logits to
# bf16 by design, so a 1-ulp fp32 difference upstream can flip one
# rounding (0.4% of one d_logits element); Adam's normalised update turns
# such a relative change of a small gradient into an absolute change of
# the leaf proportional to the rate. At 1e-3 that stays below the leaves'
# atol; a wrong gradient, scale or schedule step moves a leaf by ~1e-3.
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """JAX weights and PiSSA LoRA, and the port's copies of both."""
    jcfg = jax_tiny(VOCAB, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg)
    jlcfg = JLora(r=R, alpha=ALPHA, init_weights="pissa")
    lora, base = jax_init_lora(jax.random.PRNGKey(1), params, jcfg, jlcfg)
    return jcfg, _np(lora), _np(base)


def _port(setup, **cfg_kw):
    jcfg, lora, base = setup
    cfg = qwen3_tiny(VOCAB, dtype="float32", **cfg_kw)
    return cfg, params_from_jax(base, cfg, "cpu"), \
        trainable_from_jax(lora, cfg, "cpu")


def _batch(B=2, T=12, A=1, K=4, seed=0):
    """The JAX test batch (tests/test_train_step.py) with right padding in
    one row, a speech mask and distinct top-K indices."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (A, B, T)).astype(np.int32)
    mask = np.ones((A, B, T), np.int32)
    mask[:, -1, T - 3:] = 0
    labels = ids.astype(np.int64).copy()
    labels[..., :3] = -100
    labels[mask == 0] = -100
    v = rng.normal(size=(A, B, T, K)).astype(np.float16) - 3
    # distinct indices in each row, as a teacher's top-K are
    i = np.argsort(rng.random((A, B, T, VOCAB)), axis=-1)[..., :K].astype(
        np.int32)
    smask = (rng.random((A, B, T)) > 0.2).astype(np.float32)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "teacher_top_k_v": v, "teacher_top_k_i": i,
            "speech_token_mask": smask}


def test_training_forward_with_adapters_matches_jax(setup):
    jcfg, lora, base = setup
    cfg, model, trainable = _port(setup, remat=False)
    g = jax_scaling(JLora(r=R, alpha=ALPHA))
    b = _batch(seed=1)
    ids, mask = b["input_ids"][0], b["attention_mask"][0]
    eff = dict(jax.tree.map(jnp.asarray, base))
    eff["embed"] = {"weight": jnp.asarray(lora["embed"]["weight"])}
    ref = jq.forward(eff, jnp.asarray(ids), jcfg,
                     attention_mask=jnp.asarray(mask),
                     adapters=jax.tree.map(jnp.asarray, lora["layers"]),
                     adapter_scale=g)
    got = tq.forward_train(model, torch.from_numpy(ids),
                           attention_mask=torch.from_numpy(mask),
                           embed=trainable["embed"]["weight"],
                           adapters=trainable["layers"], adapter_scale=g,
                           return_hidden=False, device="cpu")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=2e-4, rtol=2e-4)


def test_remat_gives_the_same_loss_and_grads(setup):
    """Activation checkpointing recomputes; it changes nothing."""
    dcfg = DistillConfig(lora=LoraConfig(r=R, alpha=ALPHA))
    b = _batch(seed=2)
    out = {}
    for remat in (False, True):
        cfg, model, trainable = _port(setup, remat=remat)
        opt = tts.make_optimizer(1e-2, 1, 10)
        step = tts.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                                donate=False, device="cpu")
        state, m = step(tts.init_state(trainable, opt), model, None, b)
        state, m = step(state, model, None, b)
        out[remat] = (m, tree_leaves(state.trainable))
    for k in out[False][0]:
        torch.testing.assert_close(out[True][0][k], out[False][0][k],
                                   atol=0, rtol=1e-6)
    for a, b_ in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b_, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("A,head_loss,merge", [
    (1, "fused", False), (2, "fused", False), (1, "unfused", False),
    (1, "fused", True)], ids=["A1", "A2", "A1-unfused", "A1-merged"])
def test_kd_steps_match_jax(setup, A, head_loss, merge):
    """Three steps from the same PiSSA LoRA and batch: per-step metrics and
    the LoRA and embed leaves after them agree with JAX."""
    jcfg, lora, base = setup
    jd = JDistill(lora=JLora(r=R, alpha=ALPHA))
    jopt = jts.make_optimizer(LR, 1, 10)
    jstep = jts.make_kd_step(jcfg, jd, jopt, mode="precomputed",
                             donate=False, head_loss=head_loss,
                             merge_weights=merge)
    jstate = jts.init_state(jax.tree.map(jnp.asarray, lora), jopt)
    jbase = jax.tree.map(jnp.asarray, base)

    cfg, model, trainable = _port(setup, remat=False)
    dcfg = DistillConfig(lora=LoraConfig(r=R, alpha=ALPHA))
    opt = tts.make_optimizer(LR, 1, 10)
    step = tts.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                            head_loss=head_loss, merge_weights=merge,
                            device="cpu")
    state = tts.init_state(trainable, opt)

    batch = _batch(A=A, seed=3)
    for _ in range(3):
        jstate, jm = jstep(jstate, jbase, None,
                           jax.tree.map(jnp.asarray, batch))
        state, m = step(state, model, None, batch)
        for k in ("loss", "student_loss", "distill_loss", "teacher_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert state.step == 3
    got = tree_to_numpy(state.trainable)
    ref = _np(jstate.trainable)
    for a, b_ in zip(tree_leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b_, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_kd_fused_loss_steps_match_jax(setup, monkeypatch, backend):
    """``fused_loss=True``: three steps of the row-statistics loss (chunked
    route, or K2 plain on the CPU) against the JAX step of the same
    backend, its Pallas K2 run in interpret mode."""
    jcfg, lora, base = setup
    stats = jpallas.lm_head_stats
    monkeypatch.setattr(jpallas, "lm_head_stats",
                        lambda h, w, l, t, bn, bv, interpret=False:
                        stats(h, w, l, t, bn, bv, True))
    jd = JDistill(lora=JLora(r=R, alpha=ALPHA))
    jopt = jts.make_optimizer(LR, 1, 10)
    jstep = jts.make_kd_step(jcfg, jd, jopt, mode="precomputed",
                             donate=False, fused_loss=True,
                             fused_backend=backend, loss_chunk_size=48)
    jstate = jts.init_state(jax.tree.map(jnp.asarray, lora), jopt)
    jbase = jax.tree.map(jnp.asarray, base)
    cfg, model, trainable = _port(setup, remat=False)
    dcfg = DistillConfig(lora=LoraConfig(r=R, alpha=ALPHA))
    opt = tts.make_optimizer(LR, 1, 10)
    step = tts.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                            fused_loss=True, fused_backend=backend,
                            loss_chunk_size=48, device="cpu")
    state = tts.init_state(trainable, opt)
    batch = _batch(seed=4)
    for _ in range(3):
        jstate, jm = jstep(jstate, jbase, None,
                           jax.tree.map(jnp.asarray, batch))
        state, m = step(state, model, None, batch)
        for k in ("loss", "student_loss", "distill_loss", "teacher_loss",
                  "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
    for a, b_ in zip(tree_leaves(tree_to_numpy(state.trainable)),
                     jax.tree.leaves(_np(jstate.trainable))):
        np.testing.assert_allclose(a, b_, rtol=1e-4, atol=1e-6)


def test_optimizer_matches_optax_chain():
    """clip_by_global_norm + AdamW on the warmup/decay schedule: updates
    leaf for leaf against the JAX ``make_optimizer`` over several steps,
    under and over the clip threshold, with and without weight decay."""
    for wd in (0.0, 0.01):
        jopt = jts.make_optimizer(1e-3, 2, 6, weight_decay=wd)
        opt = tts.make_optimizer(1e-3, 2, 6, weight_decay=wd)
        rng = np.random.default_rng(0)
        params = {"a": rng.normal(size=(4, 8)).astype(np.float32),
                  "b": {"c": rng.normal(size=(16,)).astype(np.float32)}}
        jp = jax.tree.map(jnp.asarray, params)
        tp = {"a": torch.from_numpy(params["a"]),
              "b": {"c": torch.from_numpy(params["b"]["c"])}}
        js, ts = jopt.init(jp), opt.init(tp)
        for i in range(7):
            scale = 0.01 if i % 2 == 0 else 10.0       # under / over clip
            g = {"a": rng.normal(size=(4, 8)).astype(np.float32) * scale,
                 "b": {"c": rng.normal(size=(16,)).astype(np.float32)
                       * scale}}
            ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
            tu, ts = opt.update({"a": torch.from_numpy(g["a"]),
                                 "b": {"c": torch.from_numpy(g["b"]["c"])}},
                                ts, tp)
            for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-9, rtol=1e-5)
            jp = jax.tree.map(lambda p, u: p + u, jp, ju)
            tp = tts.apply_updates(tp, tu, in_place=False)
        assert ts["count"] == 7


def test_kd_split_apply_matches_monolithic_and_jax(setup):
    """split_apply=True (JAX: a grad program, then a donated apply
    program): the eager step is the monolithic one whatever the flag (one
    code path, so it is bit-equal to it by construction); three steps
    equal JAX's split step within the KD step tolerances above."""
    jcfg, lora, base = setup
    jd = JDistill(lora=JLora(r=R, alpha=ALPHA))
    jopt = jts.make_optimizer(LR, 1, 10)
    jstep = jts.make_kd_step(jcfg, jd, jopt, mode="precomputed",
                             donate=True, split_apply=True)
    jstate = jts.init_state(jax.tree.map(jnp.asarray, lora), jopt)
    jbase = jax.tree.map(jnp.asarray, base)
    dcfg = DistillConfig(lora=LoraConfig(r=R, alpha=ALPHA))
    opt = tts.make_optimizer(LR, 1, 10)
    cfg, model, trainable = _port(setup, remat=False)
    step = tts.make_kd_step(cfg, dcfg, opt, mode="precomputed", donate=True,
                            split_apply=True, device="cpu")
    s_s, m_s = tts.init_state(trainable, opt), []
    for _ in range(3):
        s_s, m = step(s_s, model, None, _batch(seed=5))
        m_s.append(m)
    assert s_s.step == 3
    for m in m_s:
        jstate, jm = jstep(jstate, jbase, None,
                           jax.tree.map(jnp.asarray, _batch(seed=5)))
        for k in ("loss", "student_loss", "distill_loss", "teacher_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    for a, b_ in zip(tree_leaves(tree_to_numpy(s_s.trainable)),
                     jax.tree.leaves(_np(jstate.trainable))):
        np.testing.assert_allclose(a, b_, rtol=1e-3, atol=1e-5)
