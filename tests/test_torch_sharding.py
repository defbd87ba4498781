"""PyTorch port, dp x tp training, extraction and the CLIs on 4 gloo ranks
(one process each, spawned once for the file through
``parallel/multihost.launch``) against the JAX package's one-device
functions and its CLIs on the 8 virtual devices:

  * the KD step at dp 2 x tp 2 (online sparse, LoRA and full finetuning;
    online dense) and with ZeRO-1, against JAX's one-device step at
    ``test_sharding.py``'s tolerances (loss rtol 1e-5; leaves and the
    AdamW moments atol 1e-5, rtol 1e-4), the dp shards holding unequal
    numbers of valid tokens;
  * data-parallel extraction (dp 4): top-K ids equal to JAX's, values
    within 2e-3 (``test_sharding.py:68-104``);
  * ``train --tp 2 --zero1`` against the JAX CLI with ``--tp 2 --zero1``
    on the same global batch (metrics rtol 1e-5, the exported model rtol
    1e-4 / atol 1e-6, as ``test_torch_train_cli.py``), and ``evaluate
    --dp 2 --tp 2`` against the JAX CLI with the same flags (rtol 1e-5).

fp32 throughout. The children import torch and the port only (JAX is
imported lazily, on the parent's side)."""
import dataclasses
import functools
import json
import os
import threading

import numpy as np
import pytest
import torch

from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  MeshConfig, qwen3_tiny)
from speech_distill_tpu_torch.parallel import multihost

WORLD = 4
V = 128
B, T = 8, 16
MODES = {"lora": dict(use_lora=True, zero1=False),
         "full": dict(use_lora=False, zero1=False),
         "lora_zero1": dict(use_lora=True, zero1=True),
         "dense": dict(use_lora=True, zero1=False, mode="online_dense")}
EXTRACT = dict(top_k=8, batch_size=8, pad_token_id=0, pad_to_multiple_of=8)


def _cfg():
    return dataclasses.replace(qwen3_tiny(V), dtype="float32", remat=False)


def _dcfg():
    return DistillConfig(top_k=8, lora=LoraConfig(r=4, alpha=8,
                                                  init_weights="gaussian"))


def _batch():
    """[1, 8, 16]; the first dp shard (rows 0-3) holds fewer valid
    tokens than the second."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, V, (1, B, T))
    labels[0, :3, 6:] = -100
    return {"input_ids": rng.integers(0, V, (1, B, T)),
            "attention_mask": np.ones((1, B, T), np.int64),
            "labels": labels}


def _extract_feats():
    rng = np.random.default_rng(1)
    feats = []
    for _ in range(16):
        n = int(rng.integers(6, 14))
        feats.append({"teacher_input_ids": rng.integers(0, V, n).tolist(),
                      "teacher_attention_mask": [1] * n})
    return feats


def _jax_trees():
    """The JAX ``init_params`` weights (student seed 0, teacher seed 1,
    extraction teacher seed 3) and the gaussian LoRA tree (key 2), as
    numpy trees."""
    import jax
    from speech_distill_tpu.core.config import LoraConfig as JLora
    from speech_distill_tpu.core.config import qwen3_tiny as jtiny
    from speech_distill_tpu.distill.lora import init_lora
    from speech_distill_tpu.models import qwen3 as jq
    jcfg = jtiny(V, dtype="float32", remat=False)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg)
    lora, base = init_lora(jax.random.PRNGKey(2), params, jcfg,
                           JLora(r=4, alpha=8, init_weights="gaussian"))
    teacher = jq.init_params(jax.random.PRNGKey(1), jcfg)
    xteacher = jq.init_params(jax.random.PRNGKey(3), jcfg)
    trees = {"base": base, "lora": lora, "teacher": teacher,
             "xteacher": xteacher}
    return {"cfg": jcfg, "params": params, **trees,
            "np": {k: jax.tree.map(np.asarray, v) for k, v in trees.items()}}


def _lora_state(mesh, trees, zero1):
    """A LoRA TrainState of this rank's slices (moments zero1-sliced) and
    its specs."""
    from speech_distill_tpu_torch.core.tree import tree_map
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.parallel import sharding
    full = tree_map(lambda x: torch.from_numpy(np.array(x)), trees["lora"])
    tr = sharding.shard_lora(mesh, full)
    specs = sharding.lora_pspecs(tr)
    st = train_step.init_state(tr, train_step.make_optimizer(1e-3, 1, 20))
    return st._replace(opt_state=sharding.shard_opt_state(
        mesh, st.opt_state, specs, zero1=zero1)), specs


def _ckpt(directory, mesh, specs, zero1):
    from speech_distill_tpu_torch.core.checkpoint import CheckpointManager
    from speech_distill_tpu_torch.parallel import sharding
    return CheckpointManager(directory, mesh=mesh, specs_fn=lambda st: (
        sharding.state_pspecs(st, specs, mesh, zero1=zero1)))


def _numpy_state(st):
    from speech_distill_tpu_torch.core.tree import tree_map
    return {"trainable": tree_map(lambda x: x.detach().numpy(),
                                  st.trainable),
            "mu": tree_map(lambda x: x.numpy(), st.opt_state["mu"]),
            "nu": tree_map(lambda x: x.numpy(), st.opt_state["nu"]),
            "count": st.opt_state["count"], "step": st.step}


def _steps(mesh, trees, use_lora, zero1, n_steps, ckpt_dir=None,
           mode="online_sparse"):
    """The port's KD step on this rank: (losses, the trainable tree and
    the moments after each step, made whole); with ``ckpt_dir`` the last
    state is saved there (gathered to rank 0)."""
    from speech_distill_tpu_torch.core.tree import tree_map
    from speech_distill_tpu_torch.distill import train_step
    from speech_distill_tpu_torch.parallel import sharding
    cfg, dcfg = _cfg(), _dcfg()
    base = sharding.shard_params(mesh, trees["base"], cfg)
    teacher = sharding.shard_params(mesh, trees["teacher"], cfg)
    if use_lora:
        full = tree_map(lambda x: torch.from_numpy(np.array(x)),
                        trees["lora"])
        tr = sharding.shard_lora(mesh, full)
    else:
        tr = train_step.full_trainable(base)
    specs = sharding.trainable_pspecs(tr, cfg, use_lora)
    opt = train_step.make_optimizer(1e-3, 1, 20)
    st = train_step.init_state(tr, opt)
    st = st._replace(opt_state=sharding.shard_opt_state(
        mesh, st.opt_state, specs, zero1=zero1))
    step = train_step.make_kd_step(cfg, dcfg, opt, mode=mode,
                                   use_lora=use_lora, donate=False,
                                   mesh=mesh, zero1=zero1)
    batch = sharding.shard_batch(mesh, _batch())
    out = []
    for _ in range(n_steps):
        st, m = step(st, base, teacher, batch)
        whole = sharding.gather_state(st, sharding.state_pspecs(
            st, specs, mesh, zero1=zero1), mesh)
        out.append({"loss": float(m["loss"]),
                    "trainable": tree_map(lambda x: x.numpy(),
                                          whole.trainable),
                    "mu": tree_map(lambda x: x.numpy(),
                                   whole.opt_state["mu"]),
                    "nu": tree_map(lambda x: x.numpy(),
                                   whole.opt_state["nu"])})
    if ckpt_dir:
        _ckpt(ckpt_dir, mesh, specs, zero1).save(st.step, st)
    return out


def _fp32_loader():
    from speech_distill_tpu_torch.models import hf_loader as thf
    thf.load_pretrained = functools.partial(thf.load_pretrained,
                                            dtype="float32")


def _ranks(rank, world, trees, ws, out_dir):
    from speech_distill_tpu_torch.models import qwen3
    from speech_distill_tpu_torch.parallel import mesh as meshlib
    from speech_distill_tpu_torch.parallel import sharding
    from speech_distill_tpu_torch.pipelines import evaluate as tevaluate
    from speech_distill_tpu_torch.pipelines import train as ttrain
    from speech_distill_tpu_torch.pipelines.extract_logits import (
        extract_teacher_logprobs)
    res = {}
    mesh = meshlib.make_mesh(MeshConfig(dp=2, tp=2), device="cpu")
    ckpt_dir = os.path.join(out_dir, "ckpt")
    for name, kw in MODES.items():
        res[name] = _steps(mesh, trees, n_steps=1 if name == "full" else 2,
                           ckpt_dir=ckpt_dir if name == "lora_zero1"
                           else None, **kw)
    cfg = _cfg()
    dp4 = meshlib.make_mesh(MeshConfig(dp=4, tp=1), device="cpu")
    # the dp 2 x tp 2 ZeRO-1 checkpoint restored at dp 4 x tp 1, no ZeRO-1
    st, specs = _lora_state(dp4, trees, zero1=False)
    st = _ckpt(ckpt_dir, dp4, specs, False).restore(st)
    res["restored_dp4"] = _numpy_state(sharding.gather_state(
        st, sharding.state_pspecs(st, specs, dp4), dp4))
    teacher = sharding.shard_params(dp4, trees["xteacher"], cfg)

    def fwd(model, ids, mask):
        return qwen3.forward(model, ids, attention_mask=mask)
    res["extract"] = extract_teacher_logprobs(
        teacher, fwd, _extract_feats(), progress=False, mesh=dp4,
        **EXTRACT)
    _fp32_loader()
    flags = ["--device", "cpu", "--coordinator_address", "file://unused",
             "--num_processes", str(world), "--process_id", str(rank)]
    ttrain.main(_train_args(ws) + ["--per_device_train_batch_size", "2",
                                   "--output_dir",
                                   os.path.join(out_dir, "train")] + flags)
    tevaluate.main(_eval_args(ws) + ["--output", os.path.join(
        out_dir, "eval.json"), "--device", "cpu"])
    return res


def _train_args(ws):
    return ["--dataset_path", ws["enriched"], "--student_model",
            ws["student"], "--gradient_accumulation_steps", "1",
            "--pad_to_multiple_of", "16", "--test_size", "8",
            "--max_steps", "10", "--warmup_steps", "1",
            "--learning_rate", "2e-4", "--use_lora", "--lora_r", "4",
            "--lora_alpha", "8", "--tp", "2", "--zero1"]


def _eval_args(ws):
    return ["--student_model", ws["student"], "--batch_size", "2",
            "--test_size", "6", "--agree_k", "3", "--pad_to_multiple_of",
            "16", "--max_length", "64", "--dataset_path", ws["raw"],
            "--teacher_model", ws["teacher"], "--dp", "2", "--tp", "2"]


@pytest.fixture(scope="module")
def jax_side():
    return _jax_trees()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A student and a teacher of other weights (tiny HF dirs), 40 raw
    rows, their JAX prepare-dataset output enriched by the JAX
    extract-logits CLI (fp32, top-K 8)."""
    datasets = pytest.importorskip("datasets")
    from speech_distill_tpu.models import hf_loader as jhf
    from speech_distill_tpu.pipelines.extract_logits import main as jextract
    from speech_distill_tpu.pipelines.prepare_dataset import main as jprep
    from tests.test_pipelines import make_tiny_model_dir
    root = tmp_path_factory.mktemp("tshard")
    student, teacher = str(root / "student"), str(root / "teacher")
    make_tiny_model_dir(student, vocab_size=96)
    make_tiny_model_dir(teacher, vocab_size=96, seed=1)
    rng = np.random.default_rng(5)
    rows = {"codes": [rng.integers(0, 50, rng.integers(3, 9)).tolist()
                      for _ in range(40)],
            "text": ["hello", "abc", "good day", "xyz"] * 10,
            "lang": ["en", "zh", "yue", "en"] * 10}
    raw = str(root / "raw")
    datasets.Dataset.from_dict(rows).save_to_disk(raw)
    proc, enriched = str(root / "proc"), str(root / "enriched")
    jprep(["--dataset_path", raw, "--output_path", proc,
           "--student_model", student, "--max_length", "64"])
    mp = pytest.MonkeyPatch()
    mp.setattr(jhf, "load_pretrained", functools.partial(
        jhf.load_pretrained, dtype="float32"))
    try:
        jextract(["--teacher_model_path", teacher, "--dataset_path", proc,
                  "--output_path", enriched, "--top_k", "8",
                  "--batch_size", "8", "--pad_to_multiple_of", "16"])
    finally:
        mp.undo()
    return {"root": str(root), "student": student, "teacher": teacher,
            "raw": raw, "enriched": enriched}


def _jax_steps(jax_side, use_lora, n_steps, mode="online_sparse"):
    import jax
    from speech_distill_tpu.core.config import DistillConfig as JD
    from speech_distill_tpu.core.config import LoraConfig as JLora
    from speech_distill_tpu.distill import train_step as jts
    jcfg = jax_side["cfg"]
    dcfg = JD(top_k=8, lora=JLora(r=4, alpha=8, init_weights="gaussian"))
    opt = jts.make_optimizer(1e-3, 1, 20)
    step = jts.make_kd_step(jcfg, dcfg, opt, mode=mode,
                            teacher_cfg=jcfg, donate=False,
                            use_lora=use_lora)
    base = jax_side["base"] if use_lora else jax_side["params"]
    st = jts.init_state(jax_side["lora"] if use_lora else base, opt)
    batch = {k: jax.numpy.asarray(v) for k, v in _batch().items()}
    out = []
    for _ in range(n_steps):
        st, m = step(st, base, jax_side["teacher"], batch)
        adam = next(s for s in jax.tree.leaves(
            st.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu"))
        out.append({"loss": float(m["loss"]),
                    "trainable": jax.tree.leaves(st.trainable),
                    "mu": jax.tree.leaves(adam.mu),
                    "nu": jax.tree.leaves(adam.nu)})
    return out


def _jax_extract(jax_side):
    from speech_distill_tpu.models import qwen3 as jq
    from speech_distill_tpu.pipelines.extract_logits import (
        extract_teacher_logprobs)
    jcfg = jax_side["cfg"]

    def fwd(pp, ids, mask):
        return jq.forward(pp, ids, jcfg, attention_mask=mask)
    return extract_teacher_logprobs(jax_side["xteacher"], fwd,
                                    _extract_feats(), progress=False,
                                    **EXTRACT)


def _jax_clis(ws, out):
    """The JAX train and evaluate CLIs (fp32) on their 8 devices."""
    from speech_distill_tpu.models import hf_loader as jhf
    from speech_distill_tpu.pipelines.evaluate import main as jeval
    from speech_distill_tpu.pipelines.train import main as jtrain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhf, "load_pretrained", functools.partial(
            jhf.load_pretrained, dtype="float32"))
        jtrain(_train_args(ws) + ["--per_device_train_batch_size", "1",
                                  "--output_dir", os.path.join(out,
                                                               "train")])
        jeval(_eval_args(ws) + ["--output", os.path.join(out,
                                                         "eval.json")])


@pytest.fixture(scope="module")
def run(jax_side, ws, tmp_path_factory):
    """The 4 ranks (launched in a thread) and, meanwhile, the JAX side:
    the one-device steps, extraction and the two CLIs."""
    port = str(tmp_path_factory.mktemp("tshard_port"))
    jax_out = str(tmp_path_factory.mktemp("tshard_jax"))
    box = {}

    def ranks():
        try:
            box["ranks"] = multihost.launch(
                _ranks, WORLD, jax_side["np"], ws, port,
                store_dir=str(tmp_path_factory.mktemp("store")),
                device="cpu", timeout_s=400, threads=1)
        except BaseException as e:            # re-raised below
            box["error"] = e
    th = threading.Thread(target=ranks)
    th.start()
    try:
        refs = {name: _jax_steps(jax_side, kw["use_lora"],
                                 1 if name == "full" else 2,
                                 kw.get("mode", "online_sparse"))
                for name, kw in MODES.items()}
        refs["extract"] = _jax_extract(jax_side)
        _jax_clis(ws, jax_out)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "port": port, "jax": jax_out,
            "refs": refs}


def _leaves(tree):
    from speech_distill_tpu_torch.core.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("name", list(MODES))
def test_kd_step_dp2_tp2_matches_jax_one_device(run, name):
    """The loss, every trainable leaf and both AdamW moments of each step
    (the moments are the gradients' image: the first step's learning rate
    is 0), on every rank."""
    ref = run["refs"][name]
    for r in run["ranks"]:
        assert len(r[name]) == len(ref)
        for got, want in zip(r[name], ref):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            for key in ("trainable", "mu", "nu"):
                g, w = _leaves(got[key]), want[key]
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    np.testing.assert_allclose(a, np.asarray(b), atol=1e-5,
                                               rtol=1e-4, err_msg=key)


def test_dp_extraction_matches_jax(run):
    v0, i0 = run["refs"]["extract"]
    for r in run["ranks"]:
        v1, i1 = r["extract"]
        assert len(v1) == len(i1) == len(v0) == 16
        for a, b in zip(i0, i1):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(v0, v1):
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32), atol=2e-3)


def test_train_cli_tp2_zero1_matches_jax(run):
    """10 steps of precomputed KD with LoRA at tp 2 and ZeRO-1: the JAX
    CLI over its 8 devices (dp 4, per-device batch 1) and the port over 4
    ranks (dp 2, per-device batch 2) train on the same global batches."""
    from safetensors.numpy import load_file
    port = os.path.join(run["port"], "train")
    jax_dir = os.path.join(run["jax"], "train")

    def metrics(d):
        return [json.loads(x) for x in open(os.path.join(d,
                                                         "metrics.jsonl"))]
    got, ref = metrics(port), metrics(jax_dir)
    assert [m["step"] for m in got] == [m["step"] for m in ref]
    for g, r in zip(got, ref):
        keys = [k for k in r if "loss" in k]
        assert keys and all(k in g for k in keys)
        for k in keys:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
    g = load_file(os.path.join(port, "final_model", "model.safetensors"))
    r = load_file(os.path.join(jax_dir, "final_model", "model.safetensors"))
    assert sorted(g) == sorted(r)
    for k in r:
        np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_evaluate_cli_dp2_tp2_matches_jax(run):
    got = json.loads(open(os.path.join(run["port"], "eval.json")).read())
    ref = json.loads(open(os.path.join(run["jax"], "eval.json")).read())
    assert got["mode"] == ref["mode"] == "online"
    assert got["rows"] == ref["rows"] == 6
    for sl in ("all", "speech"):
        g, r = got["metrics"][sl], ref["metrics"][sl]
        assert g["positions"] == r["positions"] > 0
        for k, v in r.items():
            if v is not None and k != "positions":
                np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=k)


def test_checkpoints_move_between_layouts(run, jax_side):
    """The state saved at dp 2 x tp 2 with ZeRO-1 (gathered, rank 0
    writes) is the one-device state: a one-device restore reads the
    ranks' last state, and the dp 4 x tp 1 ranks restore it whole."""
    from speech_distill_tpu_torch.core.checkpoint import CheckpointManager
    from speech_distill_tpu_torch.core.tree import tree_map
    from speech_distill_tpu_torch.distill import train_step
    lora = tree_map(lambda x: torch.from_numpy(np.array(x)).requires_grad_(),
                    jax_side["np"]["lora"])
    template = train_step.init_state(lora,
                                     train_step.make_optimizer(1e-3, 1, 20))
    one = _numpy_state(CheckpointManager(os.path.join(
        run["port"], "ckpt")).restore(template))
    last = run["ranks"][0]["lora_zero1"][-1]
    assert one["step"] == 2 and one["count"] == 2
    for key in ("trainable", "mu", "nu"):
        for a, b in zip(_leaves(one[key]), _leaves(last[key])):
            np.testing.assert_array_equal(a, b)
    for r in run["ranks"]:
        got = r["restored_dp4"]
        assert got["step"] == 2 and got["count"] == 2
        for key in ("trainable", "mu", "nu"):
            for a, b in zip(_leaves(got[key]), _leaves(one[key])):
                np.testing.assert_array_equal(a, b)


def test_unported_train_flags_still_raise():
    """The sp and pp flags are ported (``tests/test_torch_ring_attention.
    py``, ``tests/test_torch_pipeline.py``): ``check_ported`` takes them,
    and refuses what the JAX CLI refuses (sp with pp, an interleave
    without 1F1B) with ``ValueError``; so are the disaggregated
    teacher's (``tests/test_torch_disaggregate.py``): ``--teacher_tp``
    alone changes nothing, as in JAX, and ``--teacher_devices`` with dense
    KD (``--top_k`` <= 0 or a quantized teacher) raises JAX's
    ``ValueError``, sparse KD not."""
    from speech_distill_tpu_torch.pipelines import train as ttrain

    def config(flag):
        return ttrain.build_parser().parse_args(["--dataset_path", "x"] +
                                                flag)
    for flag in (["--sp", "2"], ["--sp_zigzag"], ["--pp", "2"],
                 ["--pp_microbatches", "2"],
                 ["--pp", "2", "--pp_schedule", "1f1b", "--pp_interleave",
                  "2"]):
        ttrain.check_ported(config(flag))
    for flag, match in ((["--sp", "2", "--pp", "2"], "cannot combine"),
                        (["--pp_interleave", "2"], "requires"),
                        (["--pp_schedule", "1f1b"], "pp > 1")):
        with pytest.raises(ValueError, match=match):
            ttrain.check_ported(config(flag))
    for flag in (["--teacher_devices", "2"], ["--teacher_tp", "2"]):
        ttrain.check_ported(config(flag))
        ttrain.check_ported(config(flag), "online_sparse")
    ttrain.check_ported(config(["--teacher_tp", "2"]), "online_dense")
    for flag in (["--teacher_devices", "2", "--top_k", "0"],
                 ["--teacher_devices", "2", "--load_teacher_in_8bit"]):
        with pytest.raises(ValueError, match="dense KD"):
            ttrain.check_ported(config(flag), "online_dense")