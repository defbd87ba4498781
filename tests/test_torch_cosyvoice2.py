"""PyTorch port, the CosyVoice2 teacher (``models/cosyvoice2``) and its
Qwen2 backbone, held against the JAX package on the same weights: the
backbone against JAX and HF ``Qwen2ForCausalLM`` (random, no download),
the unified forward and table, ``convert_torch_state``,
``prepare_lm_sequences``, both extract routes, online KD steps and the
agreement step with the teacher, and the speech-text tokenizer. Where the
JAX package fails (a quantized teacher, a teacher narrower than the
student, ids past the unified table) its failure is shown beside the
port's ``ValueError``. fp32, tiny configs, CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_distill_tpu.core.config import DistillConfig as JDistill
from speech_distill_tpu.core.config import LoraConfig as JLora
from speech_distill_tpu.core.config import Qwen3Config as JQwen3Config
from speech_distill_tpu.core.config import qwen3_tiny as jax_tiny
from speech_distill_tpu.distill import evaluate as jev
from speech_distill_tpu.distill import train_step as jts
from speech_distill_tpu.distill.lora import init_lora as jax_init_lora
from speech_distill_tpu.models import cosyvoice2 as jcv2
from speech_distill_tpu.models import qwen3 as jq
from speech_distill_tpu.models.hf_loader import (
    from_state_dict as jax_from_state_dict)
from speech_distill_tpu.ops import quant as jquant
from speech_distill_tpu.tokenizer.speech_text import (
    SpeechTextTokenizer as JaxSpeechTextTokenizer)
from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  Qwen3Config, qwen3_tiny)
from speech_distill_tpu_torch.core.tree import tree_leaves, tree_map
from speech_distill_tpu_torch.distill import evaluate as ev
from speech_distill_tpu_torch.distill import train_step as tts
from speech_distill_tpu_torch.models import cosyvoice2 as cv2
from speech_distill_tpu_torch.models import qwen3 as tq
from speech_distill_tpu_torch.models.convert import (
    cosyvoice2_params_from_jax, model_to_tree, params_from_jax,
    trainable_from_jax)
from speech_distill_tpu_torch.models.hf_loader import (config_from_hf,
                                                       from_state_dict,
                                                       to_state_dict)
from speech_distill_tpu_torch.ops.quant import quantize_params
from speech_distill_tpu_torch.pipelines import train as train_cli
from speech_distill_tpu_torch.tokenizer.speech_text import (
    SpeechTextTokenizer)

# fp32 logits, losses and gradients against JAX and HF
TOL = 1e-5
TEXT, SPEECH, UNIFIED = 104, 20, 130          # 104 + 2 + 23 + 1 unmapped
K, R, ALPHA = 6, 4, 8


def _backbone_kw(vocab):
    return dict(vocab_size=vocab, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=8, attention_bias=True,
                qk_norm=False, dtype="float32", remat=False,
                max_position_embeddings=256)


def _cfgs(vocab=100):
    """(JAX, port) CosyVoice2 configs over a tiny Qwen2 backbone whose
    vocab (100) is narrower than the text range (104)."""
    jb = JQwen3Config(attn_impl="xla", **_backbone_kw(vocab))
    tb = Qwen3Config(**_backbone_kw(vocab))
    kw = dict(text_vocab_size=TEXT, speech_token_size=SPEECH,
              unified_vocab_size=UNIFIED)
    return (jcv2.CosyVoice2Config(backbone=jb, **kw),
            cv2.CosyVoice2Config(backbone=tb, **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def teacher():
    """JAX init_params with random (not zero) q/k/v and decoder biases,
    as numpy, and the port's model of the same weights."""
    jcfg, cfg = _cfgs()
    params = _np(jcv2.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(11)
    attn = params["backbone"]["layers"]["attn"]
    for name in ("q_bias", "k_bias", "v_bias"):
        attn[name] = (rng.normal(size=attn[name].shape) * 0.1).astype(
            np.float32)
    params["llm_decoder"]["b"] = (rng.normal(
        size=params["llm_decoder"]["b"].shape) * 0.1).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, params=params,
                model=cosyvoice2_params_from_jax(params, cfg, "cpu"))


def _unified_ids(cfg, rng, B=2, T=9):
    """Text, sos, speech, eos and one unmapped id in every row."""
    return np.concatenate([
        rng.integers(0, 100, (B, T - 6)), np.full((B, 1), cfg.sos_id),
        rng.integers(cfg.speech_offset, cfg.speech_offset + SPEECH, (B, 3)),
        np.full((B, 1), cfg.eos_unified), np.full((B, 1), UNIFIED - 1)],
        axis=1).astype(np.int32)


def _hf_qwen2(vocab=160, seed=0):
    from transformers import Qwen2Config as HFQwen2Config
    from transformers import Qwen2ForCausalLM
    kw = _backbone_kw(vocab)
    hf_cfg = HFQwen2Config(
        vocab_size=vocab, hidden_size=kw["hidden_size"],
        intermediate_size=kw["intermediate_size"],
        num_hidden_layers=kw["num_hidden_layers"],
        num_attention_heads=kw["num_attention_heads"],
        num_key_value_heads=kw["num_key_value_heads"],
        head_dim=kw["head_dim"], rms_norm_eps=1e-6, rope_theta=1e6,
        tie_word_embeddings=True, attention_bias=True,
        max_position_embeddings=256)
    torch.manual_seed(seed)
    model = Qwen2ForCausalLM(hf_cfg).eval().to(torch.float32)
    with torch.no_grad():      # HF zero-inits the biases: make them count
        for name, p in model.named_parameters():
            if name.endswith("proj.bias"):
                p.normal_(0.0, 0.1)
    return hf_cfg, model


def test_qwen2_backbone_matches_jax_and_hf():
    """config_from_hf reads the Qwen2 config (bias on, no q/k norm); the
    port's backbone from the HF state dict gives HF's and JAX's logits
    (1e-5); the export carries the biases back under HF's names."""
    hf_cfg, hf = _hf_qwen2()
    cfg = config_from_hf(hf_cfg.to_dict())
    assert cfg.attention_bias and not cfg.qk_norm
    import dataclasses
    cfg = dataclasses.replace(cfg, dtype="float32")
    jcfg = JQwen3Config(attn_impl="xla", **_backbone_kw(cfg.vocab_size))
    state = hf.state_dict()
    model = from_state_dict(state, cfg, device="cpu")
    jparams = jax_from_state_dict(state, jcfg, dtype="float32")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids)).logits.numpy()
    got = tq.forward(model, torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    jgot = np.asarray(jq.forward(jparams, jnp.asarray(ids), jcfg))
    np.testing.assert_allclose(got, jgot, atol=TOL, rtol=TOL)
    out = to_state_dict(model_to_tree(model), cfg)
    for k, v in state.items():
        if k != "lm_head.weight":       # tied
            np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)
    assert not any("norm.weight" in k and "self_attn" in k for k in out)


def test_qwen2_config_round_trips_through_json(tmp_path):
    """qwen2_cosyvoice_backbone equals JAX's on every field both configs
    have; attention_bias and qk_norm go out through to_dict and back in
    through from_initial_and_json, on both sides."""
    import json
    cfg = cv2.CosyVoice2Config().backbone
    ref = jcv2.CosyVoice2Config().backbone.to_dict()
    shared = set(ref) & set(cfg.to_dict())
    assert {"attention_bias", "qk_norm"} <= shared
    assert {k: cfg.to_dict()[k] for k in shared} == {k: ref[k]
                                                    for k in shared}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg.to_dict()))
    back = Qwen3Config.from_initial_and_json(json_file=str(path))
    assert back == cfg and back.attention_bias and not back.qk_norm
    jback = JQwen3Config.from_initial_and_json(json_file=str(path))
    assert (jback.attention_bias, jback.qk_norm) == (True, False)


def test_unified_forward_and_table_match_jax(teacher):
    """The unified logits [B, T, 130] (1e-5) with the -10000 filler where
    JAX has it; the table's padded text rows (100..103) and unmapped
    tail are zero and the table equals JAX's."""
    jcfg, cfg, params, model = (teacher[k] for k in
                                ("jcfg", "cfg", "params", "model"))
    ids = _unified_ids(cfg, np.random.default_rng(1))
    mask = np.ones_like(ids)
    mask[1, -2:] = 0
    ref = np.asarray(jcv2.forward(_jnp(params), jnp.asarray(ids), jcfg,
                                  attention_mask=jnp.asarray(mask)))
    got = cv2.forward(model, ids, attention_mask=mask).numpy()
    assert got.shape == (2, 9, UNIFIED) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got == cv2.NEG_FILL, ref == jcv2.NEG_FILL)
    table = cv2.unified_embedding_table(model).numpy()
    assert table.shape == (UNIFIED, 32)
    assert np.abs(table[100:TEXT]).max() == 0 and np.abs(table[-1]).max() == 0
    np.testing.assert_array_equal(
        table, np.asarray(jcv2.unified_embedding_table(_jnp(params), jcfg)))


def test_convert_torch_state_matches_jax():
    """A torch-named CosyVoice2 checkpoint (an HF Qwen2 under llm.model.,
    random extras) through both converters gives the same logits (1e-5);
    the port's torch_state writes back the names and values it read."""
    jcfg, cfg = _cfgs()
    _, hf = _hf_qwen2(vocab=100, seed=3)
    g = torch.Generator().manual_seed(4)
    n = cfg.num_decoder_out
    state = {f"llm.model.{k}": v for k, v in hf.state_dict().items()
             if k != "lm_head.weight"}          # tied
    state.update({"llm_embedding.weight": torch.randn(2, 32, generator=g),
                  "speech_embedding.weight": torch.randn(n, 32, generator=g),
                  "llm_decoder.weight": torch.randn(n, 32, generator=g),
                  "llm_decoder.bias": torch.randn(n, generator=g)})
    model = cv2.convert_torch_state(state, cfg, device="cpu")
    assert model.llm_decoder.w.dtype == torch.float32
    jparams = jcv2.convert_torch_state(state, jcfg)
    ids = _unified_ids(cfg, np.random.default_rng(5))
    np.testing.assert_allclose(
        cv2.forward(model, ids).numpy(),
        np.asarray(jcv2.forward(jparams, jnp.asarray(ids), jcfg)),
        atol=TOL, rtol=TOL)
    back = cv2.torch_state(model)
    assert set(back) == set(state)
    for k, v in state.items():
        torch.testing.assert_close(back[k].float(), v.float(), rtol=0,
                                   atol=0, msg=k)


@pytest.mark.parametrize("bistream", [False, True],
                         ids=["unistream", "bistream"])
def test_prepare_lm_sequences_match_jax(bistream):
    """Ids, targets and lengths equal JAX's, for a batch with a short row,
    a row of exactly one text chunk plus a remainder, and a long one."""
    jcfg, cfg = _cfgs()
    m_t, m_s = cfg.mix_ratio
    text = [[7, 8], list(range(10, 10 + m_t)), list(range(30, 42))]
    speech = [[1, 2, 3], list(range(m_s + 3)), list(range(19)) * 3]
    flags = [bistream] * 3
    got = cv2.prepare_lm_sequences(cfg, text, speech, flags)
    ref = jcv2.prepare_lm_sequences(jcfg, text, speech, flags)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    padded = cv2.prepare_lm_sequences(cfg, text, speech, flags, pad_to=64)
    np.testing.assert_array_equal(
        padded[0], jcv2.prepare_lm_sequences(jcfg, text, speech, flags,
                                             pad_to=64)[0])
    if bistream:
        assert cfg.fill_unified in got[1][2]


@pytest.mark.parametrize("extract", cv2.EXTRACTS)
@pytest.mark.parametrize("svs", [UNIFIED, TEXT + 2 + 10],
                         ids=["whole", "cut-in-speech"])
def test_teacher_extract_routes_match_jax(teacher, extract, svs):
    """make_teacher_extract against JAX's same route: equal index sets,
    values within 1e-5 (before the fp16 cast the routes take the same
    fp32 logits; both round to fp16)."""
    jcfg, cfg, params, model = (teacher[k] for k in
                                ("jcfg", "cfg", "params", "model"))
    ids = _unified_ids(cfg, np.random.default_rng(4), T=7)
    mask = np.ones_like(ids)
    jv, ji = jcv2.make_teacher_extract(jcfg, K, svs, chunk_size=32,
                                       extract=extract)(
        _jnp(params), jnp.asarray(ids), jnp.asarray(mask))
    v, i = cv2.make_teacher_extract(cfg, K, svs, chunk_size=32,
                                    extract=extract)(model, ids, mask)
    assert v.dtype == torch.float16 and i.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(i.numpy(), -1),
                                  np.sort(np.asarray(ji), -1))
    np.testing.assert_allclose(np.sort(v.float().numpy(), -1),
                               np.sort(np.asarray(jv, np.float32), -1),
                               atol=TOL, rtol=TOL)
    assert int(i.max()) < svs


def _student(vocab):
    jcfg = jax_tiny(vocab, dtype="float32", remat=False, attn_impl="xla")
    params = jq.init_params(jax.random.PRNGKey(1), jcfg)
    lora, base = jax_init_lora(jax.random.PRNGKey(2), params, jcfg,
                               JLora(r=R, alpha=ALPHA))
    cfg = qwen3_tiny(vocab, dtype="float32", remat=False)
    return jcfg, cfg, _np(lora), _np(base)


def _kd_batch(cfg, vocab, seed=3):
    rng = np.random.default_rng(seed)
    A, B, T = 1, 2, 9
    ids = rng.integers(0, vocab, (A, B, T)).astype(np.int32)
    mask = np.ones((A, B, T), np.int32)
    mask[:, -1, -2:] = 0
    labels = ids.astype(np.int64)
    labels[..., :2] = -100
    labels[mask == 0] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "teacher_input_ids": _unified_ids(cfg, rng)[None],
            "teacher_attention_mask": mask.copy()}


class _Negate:
    """An optimizer whose update is -g (optax.sgd(1.0)): the step's
    parameter change is minus its gradient."""
    init = staticmethod(lambda params: {})
    update = staticmethod(lambda g, s, p=None: (tree_map(lambda x: -x, g),
                                                s))


# the teacher side of the step: (mode, route). Dense KD takes the
# unfused head here: the fused one rounds d_logits to bf16 on both sides
# (held to JAX at its own bound in test_torch_online_kd.py)
KD_CASES = {"sparse-forward": ("online_sparse", None),
            "sparse-materialized": ("online_sparse", "materialized"),
            "sparse-fused": ("online_sparse", "fused"),
            "dense-unfused": ("online_dense", None)}


@pytest.mark.parametrize("case", KD_CASES)
def test_kd_step_with_the_teacher_matches_jax(teacher, case):
    """One KD step of a LoRA student (vocab = the unified 130) against the
    CosyVoice2 teacher, through its forward or an extract route: the
    losses and the gradient of every trainable leaf equal JAX's (1e-5)."""
    mode, route = KD_CASES[case]
    jcfg, cfg, params, model = (teacher[k] for k in
                                ("jcfg", "cfg", "params", "model"))
    sj, sc, lora, base = _student(UNIFIED)
    kw = {"head_loss": "unfused"} if mode == "online_dense" else {}
    jkw = dict(kw)
    if route:
        jkw["teacher_extract"] = jcv2.make_teacher_extract(
            jcfg, K, UNIFIED, chunk_size=32, extract=route)
        kw["teacher_extract"] = cv2.make_teacher_extract(
            cfg, K, UNIFIED, chunk_size=32, extract=route)
    jstep = jts.make_kd_step(
        sj, JDistill(top_k=K, lora=JLora(r=R, alpha=ALPHA)), optax.sgd(1.0),
        mode=mode, teacher_cfg=jcfg.backbone,
        teacher_forward=jcv2.make_teacher_forward(jcfg), donate=False, **jkw)
    step = tts.make_kd_step(
        sc, DistillConfig(top_k=K, lora=LoraConfig(r=R, alpha=ALPHA)),
        _Negate, mode=mode, teacher_forward=cv2.make_teacher_forward(cfg),
        donate=False, device="cpu", **kw)
    batch = _kd_batch(cfg, UNIFIED)
    jstate = jts.init_state(_jnp(lora), optax.sgd(1.0))
    jstate2, jm = jstep(jstate, _jnp(base), _jnp(params), _jnp(batch))
    trainable = trainable_from_jax(lora, sc, "cpu")
    state2, m = step(tts.init_state(trainable, _Negate), params_from_jax(
        base, sc, "cpu"), model, batch)
    for k in ("loss", "student_loss", "distill_loss", "teacher_loss",
              "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                          jstate.trainable, jstate2.trainable)
    grads = [(a - b).detach().numpy() for a, b in zip(
        tree_leaves(trainable), tree_leaves(state2.trainable))]
    for g, r in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g, r, atol=TOL * np.abs(r).max(),
                                   rtol=TOL)


def test_agreement_step_with_the_teacher_matches_jax(teacher):
    """The exact agreement sums with the CosyVoice2 teacher, the student
    as wide as the unified vocabulary (1e-5)."""
    jcfg, cfg, params, model = (teacher[k] for k in
                                ("jcfg", "cfg", "params", "model"))
    sj, sc, _, base = _student(UNIFIED)
    batch = {k: v[0] for k, v in _kd_batch(cfg, UNIFIED).items()}
    ref = jev.make_agreement_step(sj, jcfg.backbone, k=3,
                                  teacher_forward=jcv2.make_teacher_forward(
                                      jcfg))(_jnp(base), _jnp(params),
                                             _jnp(batch))
    step = ev.make_agreement_step(
        sc, k=3, teacher_forward=cv2.make_teacher_forward(cfg), device="cpu")
    got = step(params_from_jax(base, sc, "cpu"), model, batch)
    for k, r in ref.items():
        np.testing.assert_allclose(float(got[k]), float(r), rtol=TOL,
                                   atol=TOL, err_msg=k)


# -- where the JAX package fails: its failure beside the port's error ------


def test_quantized_teacher_fails_in_jax_and_raises_in_port(teacher):
    """JAX: the int8 backbone embedding is a {"q8", "scale"} dict and the
    unified table reads its .shape (AttributeError). The port refuses it
    with ValueError, and the train CLI before any weight loads."""
    jcfg, cfg, params, model = (teacher[k] for k in
                                ("jcfg", "cfg", "params", "model"))
    ids = _unified_ids(cfg, np.random.default_rng(6))
    jq8 = dict(_jnp(params), backbone=jquant.quantize_params(
        _jnp(params["backbone"]), bits=8))
    with pytest.raises(AttributeError, match="shape"):
        jcv2.forward(jq8, jnp.asarray(ids), jcfg)
    q8 = cv2.CosyVoice2(cfg, "cpu", backbone=params_from_jax(
        quantize_params(model_to_tree(model.backbone), bits=8),
        cfg.backbone, "cpu"))
    with pytest.raises(ValueError, match="quantized CosyVoice2"):
        cv2.forward(q8, ids)
    for flag in ("load_teacher_in_8bit", "load_teacher_in_4bit"):
        args = train_cli.build_parser().parse_args(
            ["--dataset_path", "unused", "--teacher_family", "cosyvoice2",
             f"--{flag}"])
        with pytest.raises(ValueError, match="quantized CosyVoice2"):
            train_cli.check_ported(args)


def test_narrow_teacher_fails_in_jax_and_raises_in_port(teacher):
    """A student vocab (140) wider than the unified one (130): JAX's dense
    KD step and agreement step fail on the shapes (TypeError); the port's
    raise ValueError naming both widths, as the CLIs do before the
    teacher loads. The sparse route runs on both sides."""
    jcfg, cfg, params, model = (teacher[k] for k in
                                ("jcfg", "cfg", "params", "model"))
    sj, sc, lora, base = _student(140)
    batch = _kd_batch(cfg, 140)
    jd = JDistill(top_k=K, lora=JLora(r=R, alpha=ALPHA))
    jstep = jts.make_kd_step(sj, jd, jts.make_optimizer(1e-3, 1, 10),
                             mode="online_dense", teacher_cfg=jcfg.backbone,
                             teacher_forward=jcv2.make_teacher_forward(jcfg),
                             donate=False)
    opt = jts.make_optimizer(1e-3, 1, 10)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jstep(jts.init_state(_jnp(lora), opt), _jnp(base), _jnp(params),
              _jnp(batch))
    flat = {k: v[0] for k, v in batch.items()}
    with pytest.raises(TypeError, match="incompatible shapes"):
        jev.make_agreement_step(sj, jcfg.backbone, k=3,
                                teacher_forward=jcv2.make_teacher_forward(
                                    jcfg))(_jnp(base), _jnp(params),
                                           _jnp(flat))
    topt = tts.make_optimizer(1e-3, 1, 10)
    dcfg = DistillConfig(top_k=K, lora=LoraConfig(r=R, alpha=ALPHA))
    step = tts.make_kd_step(sc, dcfg, topt, mode="online_dense",
                            teacher_forward=cv2.make_teacher_forward(cfg),
                            device="cpu")
    student = params_from_jax(base, sc, "cpu")
    with pytest.raises(ValueError, match="130 wide.*140"):
        step(tts.init_state(trainable_from_jax(lora, sc, "cpu"), topt),
             student, model, batch)
    with pytest.raises(ValueError, match="130 wide.*140"):
        ev.make_agreement_step(sc, k=3, teacher_forward=cv2.
                               make_teacher_forward(cfg), device="cpu")(
            student, model, flat)
    with pytest.raises(ValueError, match="159271 wide.*159488"):
        tts.check_width(159271, 159488)
    sparse = tts.make_kd_step(
        sc, dcfg, topt, mode="online_sparse",
        teacher_forward=cv2.make_teacher_forward(cfg),
        teacher_extract=cv2.make_teacher_extract(cfg, K, 140), device="cpu")
    _, m = sparse(tts.init_state(trainable_from_jax(lora, sc, "cpu"), topt),
                  student, model, batch)
    assert np.isfinite(float(m["loss"]))


def test_ids_past_the_table_read_nan_in_jax_and_raise_in_port(teacher):
    """An id at or past unified_vocab_size: JAX reads a NaN row (its
    logits turn NaN), the port raises ValueError for host and device ids
    alike; below -unified_vocab_size too."""
    jcfg, cfg, params, model = (teacher[k] for k in
                                ("jcfg", "cfg", "params", "model"))
    ids = _unified_ids(cfg, np.random.default_rng(7))
    ids[0, 2] = UNIFIED
    ref = np.asarray(jcv2.forward(_jnp(params), jnp.asarray(ids), jcfg))
    heads = ref[0, 2] != jcv2.NEG_FILL
    assert np.isnan(ref[0, 2][heads]).all() and np.isfinite(ref[1]).all()
    for bad in (ids, torch.from_numpy(ids), -UNIFIED - 1 + 0 * ids):
        with pytest.raises(ValueError, match="outside the unified"):
            cv2.forward(model, bad)


def test_negative_ids_wrap_as_in_jax(teacher):
    """-1 reads the last row and -V the first, as jnp.take wraps them:
    the logits equal JAX's and the wrapped ids' own."""
    jcfg, cfg, params, model = (teacher[k] for k in
                                ("jcfg", "cfg", "params", "model"))
    ids = _unified_ids(cfg, np.random.default_rng(8))
    neg = ids.copy()
    neg[:, 0], neg[:, 3] = -1, -UNIFIED
    wrapped = np.where(neg < 0, neg + UNIFIED, neg)
    got = cv2.forward(model, neg).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jcv2.forward(_jnp(params), jnp.asarray(neg), jcfg)),
        atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got, cv2.forward(model, wrapped).numpy())


# -- the speech-text tokenizer ----------------------------------------------


class CharTokenizer:
    """One id per ascii character (the JAX package's test tokenizer)."""
    pad_token = "#"
    eos_token = "$"

    def encode(self, text, add_special_tokens=False, **kw):
        return [ord(c) % 128 for c in text]

    def decode(self, ids, **kw):
        return "".join(chr(i) for i in ids)


def _toks():
    return (SpeechTextTokenizer(CharTokenizer(), text_vocab_size=128,
                                num_speech_tokens=100),
            JaxSpeechTextTokenizer(CharTokenizer(), text_vocab_size=128,
                                   num_speech_tokens=100))


def test_speech_text_tokenizer_round_trip_matches_jax():
    tok, jtok = _toks()
    text = ("ab<|text_start|>cd<|text_end|><|semantic_token_start|><|5|>"
            "<|99|><|semantic_token_end|>")
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert ids[:2] == [ord("a"), ord("b")] and ids[2] == tok.sos_token_id
    assert tok.speech_token_offset + 99 in ids
    assert ids[-1] == tok.speech_eos_id
    s = "hi<|semantic_token_start|><|7|><|semantic_token_end|>"
    assert tok.decode(tok.encode(s)) == s == jtok.decode(jtok.encode(s))
    assert tok.decode(ids) == jtok.decode(ids)
    assert len(tok) == len(jtok) and tok.pad_token_id == jtok.pad_token_id


def test_speech_text_tokenizer_batch_padding_matches_jax():
    tok, jtok = _toks()
    for kw in ({"padding": True}, {"padding": True, "truncation": True,
                                   "max_length": 4}, {}):
        out = tok(["ab", "abcdef"], **kw)
        assert out == jtok(["ab", "abcdef"], **kw)
    out = tok(["ab", "abcdef"], padding=True)
    assert out["attention_mask"][0] == [1, 1, 0, 0, 0, 0]
    assert out["input_ids"][0][2:] == [ord("#")] * 4
    assert tok("ab<|3|>") == jtok("ab<|3|>")
