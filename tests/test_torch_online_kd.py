"""PyTorch port, the teacher in the loop: the dense KD losses, two steps of
``make_kd_step`` in the online modes (sparse with the materialized and the
fused extraction, dense with the fused and the unfused head, an int8 and
an nf4 teacher, full finetuning) and ``make_kd_eval_step`` in the three
modes, held against the JAX package on the same weights, LoRA, teacher
and batch. fp32, a qwen3_tiny student, a wider teacher with a larger
vocab, CPU; the JAX side runs ``attn_impl="xla"``."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.core.config import (DistillConfig as JDistill,
                                            LoraConfig as JLora,
                                            qwen3_tiny as jax_tiny)
from speech_distill_tpu.distill import losses as jlosses
from speech_distill_tpu.distill import train_step as jts
from speech_distill_tpu.distill.lora import init_lora as jax_init_lora
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.ops import fused_lm_loss as jfused
from speech_distill_tpu.ops import quant as jquant
from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  qwen3_tiny)
from speech_distill_tpu_torch.core.tree import tree_leaves
from speech_distill_tpu_torch.distill import losses
from speech_distill_tpu_torch.distill import train_step as tts
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.models.convert import (model_to_tree,
                                                     params_from_jax,
                                                     trainable_from_jax,
                                                     tree_to_numpy)
from speech_distill_tpu_torch.ops.fused_lm_loss import head_dense_kd_loss
from speech_distill_tpu_torch.pipelines.extract_logits import (
    extract_teacher_logprobs)

VOCAB, T_VOCAB, R, ALPHA, K = 128, 136, 4, 8, 8
TEACHER = dict(hidden_size=96, intermediate_size=192)
# the step parity's learning rate (tests/test_torch_train_step.py): the
# fused heads round d_logits to bf16, so a 1-ulp fp32 difference upstream
# can flip one rounding; at 1e-3 Adam's normalised update keeps that far
# below the leaves' tolerance
LR = 1e-3
METRIC_RTOL = 1e-4
LEAF_TOL = 1e-4
# d_logits of the fused dense head are rounded to bf16 (2^-9 relative) on
# both sides from bf16 logits residuals; a flipped rounding of one element
# moves a gradient entry by up to 2^-8 of that element's term
HEAD_GRAD_RTOL, HEAD_GRAD_ATOL = 1e-3, 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """JAX student, PiSSA LoRA and teacher weights as numpy, and the
    quantized teachers."""
    jcfg = jax_tiny(VOCAB, dtype="float32", remat=False, attn_impl="xla")
    jtcfg = jax_tiny(T_VOCAB, dtype="float32", remat=False, attn_impl="xla",
                     **TEACHER)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = jq.init_params(jax.random.PRNGKey(7), jtcfg)
    lora, base = jax_init_lora(jax.random.PRNGKey(1), params, jcfg,
                               JLora(r=R, alpha=ALPHA))
    quant = {"int8": _np(jquant.quantize_params(
                 tparams, bits=8, quantize_embed=True, method="int8")),
             "nf4": _np(jquant.quantize_params(
                 tparams, bits=4, quantize_embed=False, method="nf4"))}
    return dict(jcfg=jcfg, jtcfg=jtcfg, params=_np(params),
                tparams=_np(tparams), lora=_np(lora), base=_np(base),
                quant=quant)


def _cfgs(**kw):
    return (qwen3_tiny(VOCAB, dtype="float32", remat=False, **kw),
            qwen3_tiny(T_VOCAB, dtype="float32", remat=False, **TEACHER))


def _batch(A=1, B=2, T=12, seed=0, topk=False):
    """Right padding in one row, labels masked before a speech start,
    a speech mask, and teacher ids of their own over the teacher vocab."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (A, B, T)).astype(np.int32)
    mask = np.ones((A, B, T), np.int32)
    mask[:, -1, T - 3:] = 0
    labels = ids.astype(np.int64).copy()
    labels[..., :3] = -100
    labels[mask == 0] = -100
    out = {"input_ids": ids, "attention_mask": mask, "labels": labels,
           "speech_token_mask": (rng.random((A, B, T)) > 0.2).astype(
               np.float32),
           "teacher_input_ids": rng.integers(0, T_VOCAB, (A, B, T)).astype(
               np.int32),
           "teacher_attention_mask": mask.copy()}
    if topk:
        out["teacher_top_k_v"] = (rng.normal(size=(A, B, T, K)) - 3).astype(
            np.float16)
        out["teacher_top_k_i"] = np.argsort(
            rng.random((A, B, T, VOCAB)), axis=-1)[..., :K].astype(np.int32)
    return out


def test_dense_distill_loss_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(2, 9, 40)).astype(np.float32) * 3
    t = rng.normal(size=(2, 9, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 9))
    labels[0, :3] = -100
    smask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    ref = jlosses.dense_distill_loss(jnp.asarray(s), jnp.asarray(t),
                                     jnp.asarray(labels), jnp.asarray(smask),
                                     2.0, 0.3)
    got = losses.dense_distill_loss(torch.from_numpy(s), torch.from_numpy(t),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(smask), 2.0, 0.3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_head_dense_kd_loss_matches_jax(dtype):
    """Forward values (1e-5) and dh, dW against the JAX custom VJP on the
    same hidden states, head and teacher logits."""
    rng = np.random.default_rng(1)
    B, T, D, V = 2, 10, 32, 96
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    w = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    t = (rng.normal(size=(B, T, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, T))
    labels[1, :4] = -100
    smask = (rng.random((B, T)) > 0.2).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jh, jw = jnp.asarray(h, jdt), jnp.asarray(w, jdt)

    def jloss(hh, ww):
        out = jfused.head_dense_kd_loss(hh, ww, jnp.asarray(t),
                                        jnp.asarray(labels),
                                        jnp.asarray(smask), 2.0, 0.5)
        return out.total, out
    (_, jout), (jdh, jdw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jh, jw)
    th = torch.tensor(h).to(dtype).requires_grad_(True)
    tw = torch.tensor(w).to(dtype).requires_grad_(True)
    out = head_dense_kd_loss(th, tw, torch.from_numpy(t),
                             torch.from_numpy(labels),
                             torch.from_numpy(smask), 2.0, 0.5)
    for g, r in zip(out, jout):
        np.testing.assert_allclose(float(g.detach()), float(r), rtol=1e-5)
    dh, dw = torch.autograd.grad(out.total, (th, tw))
    assert dh.dtype == dtype and dw.dtype == dtype
    np.testing.assert_allclose(dh.float().numpy(), np.asarray(jdh, np.float32),
                               rtol=HEAD_GRAD_RTOL, atol=HEAD_GRAD_ATOL)
    np.testing.assert_allclose(dw.float().numpy(), np.asarray(jdw, np.float32),
                               rtol=HEAD_GRAD_RTOL, atol=HEAD_GRAD_ATOL)
    # the same loss through autograd of the plain dense loss, in fp32
    if dtype == torch.float32:
        th2 = torch.tensor(h).requires_grad_(True)
        tw2 = torch.tensor(w).requires_grad_(True)
        plain = losses.dense_distill_loss(
            th2 @ tw2.t(), torch.from_numpy(t), torch.from_numpy(labels),
            torch.from_numpy(smask), 2.0, 0.5)
        # the bf16 d_logits: each element within 2^-9 of its own value
        for got_g, ref_g in zip((dh, dw), torch.autograd.grad(
                plain.total, (th2, tw2))):
            err = (got_g - ref_g).abs().max() / ref_g.abs().max()
            assert float(err) < 1e-2


# (mode, JAX DistillConfig overrides, make_kd_step keywords, use_lora,
# teacher quantization)
CASES = {
    "sparse": ("online_sparse", {}, {}, True, None),
    "sparse-fused-extract": ("online_sparse", {"online_extract": "fused"},
                             {}, True, None),
    "dense": ("online_dense", {}, {}, True, None),
    "dense-unfused": ("online_dense", {}, {"head_loss": "unfused"}, True,
                      None),
    "full-finetune": ("online_sparse", {}, {}, False, None),
    "int8-teacher": ("online_dense", {"teacher_quant": "int8"}, {}, True,
                     "int8"),
    "nf4-teacher": ("online_dense", {"teacher_quant": "nf4"}, {}, True,
                    "nf4"),
}


@pytest.mark.parametrize("case", CASES)
def test_online_kd_steps_match_jax(setup, case):
    """Two steps from the same start: per-step metrics (1e-4) and every
    trainable leaf after them (1e-4) agree with JAX."""
    mode, dkw, kw, use_lora, quant = CASES[case]
    jd = JDistill(top_k=K, lora=JLora(r=R, alpha=ALPHA), **dkw)
    jopt = jts.make_optimizer(LR, 1, 10)
    jstep = jts.make_kd_step(setup["jcfg"], jd, jopt, mode=mode,
                             teacher_cfg=setup["jtcfg"], donate=False,
                             use_lora=use_lora, **kw)
    jtrain = setup["lora"] if use_lora else setup["params"]
    jbase = setup["base"] if use_lora else setup["params"]
    tparams = setup["quant"][quant] if quant else setup["tparams"]
    jstate = jts.init_state(_jnp(jtrain), jopt)

    cfg, tcfg = _cfgs()
    dcfg = DistillConfig(top_k=K, lora=LoraConfig(r=R, alpha=ALPHA), **dkw)
    assert dcfg.use_dense == jd.use_dense
    model = params_from_jax(jbase, cfg, "cpu")
    trainable = (trainable_from_jax(setup["lora"], cfg, "cpu") if use_lora
                 else tts.full_trainable(model))
    teacher = params_from_jax(tparams, tcfg, "cpu")
    opt = tts.make_optimizer(LR, 1, 10)
    step = tts.make_kd_step(cfg, dcfg, opt, mode=mode, use_lora=use_lora,
                            device="cpu", **kw)
    state = tts.init_state(trainable, opt)
    teacher_before = [t.clone() for t in tree_leaves(model_to_tree(teacher))]

    batch = _batch(seed=3)
    for _ in range(2):
        jstate, jm = jstep(jstate, _jnp(jbase), _jnp(tparams), _jnp(batch))
        state, m = step(state, model, teacher, batch)
        for k in ("loss", "student_loss", "distill_loss", "teacher_loss",
                  "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=METRIC_RTOL, err_msg=k)
    got = tree_leaves(tree_to_numpy(state.trainable))
    ref = jax.tree.leaves(_np(jstate.trainable))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=LEAF_TOL, atol=LEAF_TOL)
    # the teacher is untouched and out of every graph
    for a, b in zip(teacher_before, tree_leaves(model_to_tree(teacher))):
        assert torch.equal(a, b)
    assert all(p.grad is None for p in teacher.parameters())
    if not use_lora:
        # the in-place update trained the model itself
        for a, b in zip(tree_leaves(tree_to_numpy(model_to_tree(model))),
                        got):
            np.testing.assert_array_equal(a, b)


def test_full_trainable_has_the_jax_layout_and_shares_the_model(setup):
    cfg, _ = _cfgs()
    model = params_from_jax(setup["params"], cfg, "cpu")
    tree = tts.full_trainable(model)
    ref = setup["params"]
    assert jax.tree.structure(ref) == jax.tree.structure(
        tree_to_numpy(tree))
    for a, b in zip(tree_leaves(tree), jax.tree.leaves(ref)):
        assert a.requires_grad
        np.testing.assert_array_equal(a.detach().numpy(), b)
    with torch.no_grad():
        tree["layers"]["mlp"]["down"][1].add_(1.0)
        tree["final_ln"]["scale"].mul_(2.0)
    np.testing.assert_array_equal(model.layers[1].mlp.down.numpy(),
                                  ref["layers"]["mlp"]["down"][1] + 1.0)
    np.testing.assert_array_equal(model.final_ln.numpy(),
                                  ref["final_ln"]["scale"] * 2.0)


@pytest.mark.parametrize("quant", ["int8", "nf4"])
def test_quantize_teacher_gives_the_jax_codes(setup, quant):
    """``quantize_teacher`` quantizes as the JAX benchmark does: int8
    projections and embed, or nf4 projections over a dense embed."""
    _, tcfg = _cfgs()
    teacher = params_from_jax(setup["tparams"], tcfg, "cpu")
    got = tree_to_numpy(model_to_tree(tts.quantize_teacher(teacher, quant)))
    ref = setup["quant"][quant]
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        g = got
        for p in path:
            g = g[p.key]
        name = jax.tree_util.keystr(path)
        if r.dtype.kind in "iu":
            np.testing.assert_array_equal(g.astype(r.dtype), r,
                                          err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=0,
                                       err_msg=name)
    with pytest.raises(ValueError):
        tts.quantize_teacher(teacher, "fp8")


def test_online_sparse_equals_precomputed_on_extracted_top_k(setup):
    """One online_sparse step equals a precomputed step whose top-K is the
    offline extraction of the same teacher (JAX
    tests/test_train_step.py::test_kd_online_sparse_matches_precomputed)."""
    cfg, tcfg = _cfgs()
    dcfg = DistillConfig(top_k=K, lora=LoraConfig(r=R, alpha=ALPHA))
    model = params_from_jax(setup["base"], cfg, "cpu")
    teacher = params_from_jax(setup["tparams"], tcfg, "cpu")
    batch = _batch(seed=5)
    feats = [{"teacher_input_ids": batch["teacher_input_ids"][0, b],
              "teacher_attention_mask": batch["teacher_attention_mask"][0, b]}
             for b in range(2)]
    v, i = extract_teacher_logprobs(
        teacher, lambda tm, ids, mask: tq.forward(tm, ids,
                                                  attention_mask=mask),
        feats, top_k=K, batch_size=2, pad_to_multiple_of=None,
        vocab_limit=VOCAB, progress=False, device="cpu")
    T = batch["input_ids"].shape[-1]
    pre = dict(batch)
    pre["teacher_top_k_v"] = np.zeros((1, 2, T, K), np.float16)
    pre["teacher_top_k_i"] = np.zeros((1, 2, T, K), np.int32)
    for b in range(2):
        pre["teacher_top_k_v"][0, b, :len(v[b])] = v[b]
        pre["teacher_top_k_i"][0, b, :len(i[b])] = i[b]
    metrics = {}
    for mode, bt in (("online_sparse", batch), ("precomputed", pre)):
        opt = tts.make_optimizer(0.0, 1, 10)
        step = tts.make_kd_step(cfg, dcfg, opt, mode=mode, donate=False,
                                device="cpu")
        tr = trainable_from_jax(setup["lora"], cfg, "cpu")
        _, metrics[mode] = step(tts.init_state(tr, opt), model, teacher, bt)
    for k in metrics["precomputed"]:
        np.testing.assert_allclose(float(metrics["online_sparse"][k]),
                                   float(metrics["precomputed"][k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode", ["precomputed", "online_sparse",
                                  "online_dense"])
def test_kd_eval_step_matches_jax(setup, mode):
    """The eval step's losses, averaged over A = 2 microbatches."""
    jd = JDistill(top_k=K, lora=JLora(r=R, alpha=ALPHA))
    jeval = jts.make_kd_eval_step(setup["jcfg"], jd, mode=mode,
                                  teacher_cfg=setup["jtcfg"])
    cfg, tcfg = _cfgs()
    dcfg = DistillConfig(top_k=K, lora=LoraConfig(r=R, alpha=ALPHA))
    ev = tts.make_kd_eval_step(cfg, dcfg, mode=mode, device="cpu")
    batch = _batch(A=2, seed=6, topk=True)
    ref = jeval(_jnp(setup["lora"]), _jnp(setup["base"]),
                _jnp(setup["tparams"]), _jnp(batch))
    got = ev(trainable_from_jax(setup["lora"], cfg, "cpu"),
             params_from_jax(setup["base"], cfg, "cpu"),
             params_from_jax(setup["tparams"], tcfg, "cpu"), batch)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                   rtol=METRIC_RTOL, err_msg=k)


def test_online_entry_points_raise_without_cuda(monkeypatch):
    cfg, tcfg = _cfgs()
    opt = tts.make_optimizer(1e-3, 1, 10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("online_sparse", "online_dense"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tts.make_kd_step(cfg, DistillConfig(), opt, mode=mode)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tts.make_kd_eval_step(cfg, DistillConfig(), mode=mode)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.init_params_on_device(0, tcfg)
    # the explicit CPU request runs
    tts.make_kd_step(cfg, DistillConfig(), opt, mode="online_sparse",
                     use_lora=False, device="cpu")


def test_init_params_on_device_draws_from_its_seed():
    """Norm scales are ones, matrices N(0, 0.02) in the model dtype, the
    same seed gives the same weights and another seed others."""
    cfg = dataclasses.replace(qwen3_tiny(VOCAB), dtype="bfloat16")
    a = tq.init_params_on_device(3, cfg, device="cpu")
    b = tq.init_params_on_device(3, cfg, device="cpu")
    c = tq.init_params_on_device(4, cfg, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert pa.dtype == torch.bfloat16, name
        assert torch.equal(pa, pb), name
        if pa.dim() == 1:
            assert bool((pa == 1).all()), name
        else:
            assert not torch.equal(pa, pc), name
    w = torch.cat([p.float().flatten() for p in a.parameters()
                   if p.dim() == 2])
    assert abs(float(w.mean())) < 1e-3
    assert abs(float(w.std()) - 0.02) < 1e-3


def test_unknown_mode_raises():
    cfg, _ = _cfgs()
    opt = tts.make_optimizer(1e-3, 1, 10)
    with pytest.raises(ValueError, match="unknown mode"):
        tts.make_kd_step(cfg, DistillConfig(), opt, mode="online",
                         device="cpu")
    # 1F1B takes the precomputed mode only: ValueError, as in JAX
    with pytest.raises(ValueError, match="supports mode='precomputed'"):
        tts.make_kd_step(cfg, DistillConfig(), opt, mode="online_sparse",
                         pp_schedule="1f1b", device="cpu")
