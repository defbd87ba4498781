"""PyTorch port, the train CLI against the JAX train CLI on the same tiny
HF artifacts and stored top-K, in fp32 (both packages' ``load_pretrained``
patched to fp32): with PiSSA LoRA and with full finetuning, the losses of
metrics.jsonl at rtol 1e-5 and the exported final_model at rtol 1e-4 /
atol 1e-6 (``tests/test_torch_train_step.py``'s tolerance). Then one run of
the chain at the CLIs' default bf16 (stage1 -> prepare-dataset ->
extract-logits -> train, precomputed, online sparse and with a 4-bit
teacher -> evaluate), and the flags that are not ported. CPU.

The JAX CLI trains data-parallel over the 8 virtual CPU devices of
``tests/conftest.py`` (global batch 8 x the per-device flag); the port
runs that batch on one device."""
import functools
import json
import os

import numpy as np
import pytest
import torch

from speech_distill_tpu.models import hf_loader as jhf
from speech_distill_tpu_torch.models import hf_loader as thf
from speech_distill_tpu_torch.pipelines import train as ttrain
from tests.test_pipelines import make_tiny_model_dir

datasets = pytest.importorskip("datasets")

CPU = ["--device", "cpu"]
DP = 8                    # the JAX CLI's data-parallel width here
LOSSES = ("loss", "student_loss", "distill_loss", "teacher_loss",
          "eval_loss", "eval_student_loss", "eval_distill_loss",
          "eval_teacher_loss")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: as fast alone on these tiny models, and the
    port's CPU ops then do not oversubscribe the cores the other test
    workers share (a bf16 CLI chain ran 16x slower with 8 threads under
    six busy workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp32(monkeypatch):
    monkeypatch.setattr(jhf, "load_pretrained", functools.partial(
        jhf.load_pretrained, dtype="float32"))
    monkeypatch.setattr(thf, "load_pretrained", functools.partial(
        thf.load_pretrained, dtype="float32"))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A 40-row raw dataset, its JAX prepare-dataset output and the JAX
    extract-logits enrichment (fp32, top-K 8) with a second tiny model as
    the teacher."""
    from speech_distill_tpu.pipelines.extract_logits import main as jextract
    from speech_distill_tpu.pipelines.prepare_dataset import main as jprep
    root = tmp_path_factory.mktemp("ttrain")
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
    _fp32(mp)
    try:
        jextract(["--teacher_model_path", teacher, "--dataset_path", proc,
                  "--output_path", enriched, "--top_k", "8",
                  "--batch_size", "8", "--pad_to_multiple_of", "16"])
    finally:
        mp.undo()
    return {"root": root, "student": student, "teacher": teacher,
            "raw": raw, "proc": proc, "enriched": enriched}


def _metrics(path):
    return [json.loads(line) for line in open(os.path.join(path,
                                                           "metrics.jsonl"))]


def _final(path):
    from safetensors.numpy import load_file
    return load_file(os.path.join(path, "final_model", "model.safetensors"))


@pytest.mark.parametrize("lora", [True, False], ids=["pissa", "full"])
def test_train_cli_matches_jax(ws, tmp_path, monkeypatch, lora):
    """Precomputed KD, 10 steps over two epochs (4 steps each, logged at
    step 10), per-epoch eval on the held-out split, load-best, export.
    Adam divides each gradient element by its own running scale, so an
    element near zero, summed in another order (JAX over 8 devices),
    moves by up to the learning rate a step whatever its size: at lr
    1e-3 one embed element of 6,144 ends 2.3e-6 apart after 10 steps;
    lr 2e-4 keeps that within the atol as train_step's 3-step test
    does at 1e-3."""
    from speech_distill_tpu.pipelines.train import main as jmain
    _fp32(monkeypatch)
    args = ["--dataset_path", ws["enriched"], "--student_model",
            ws["student"], "--gradient_accumulation_steps", "1",
            "--pad_to_multiple_of", "16", "--test_size", "8",
            "--max_steps", "10", "--warmup_steps", "1",
            "--learning_rate", "2e-4"]
    if lora:
        args += ["--use_lora", "--lora_r", "4", "--lora_alpha", "8"]
    jmain(args + ["--per_device_train_batch_size", "1", "--output_dir",
                  str(tmp_path / "jax")])
    ttrain.main(args + ["--per_device_train_batch_size", str(DP),
                        "--output_dir", str(tmp_path / "port")] + CPU)
    got, ref = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert [m["step"] for m in got] == [m["step"] for m in ref] \
        == [4, 8, 10, 10]
    for g, r in zip(got, ref):
        keys = [k for k in LOSSES if k in r]
        assert keys and keys == [k for k in LOSSES if k in g]
        for k in keys:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
    g, r = _final(tmp_path / "port"), _final(tmp_path / "jax")
    assert sorted(g) == sorted(r)
    start = thf.read_state_dict(ws["student"])
    for k in r:
        np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert not np.array_equal(g["model.layers.0.mlp.up_proj.weight"],
                              start["model.layers.0.mlp.up_proj.weight"]
                              .numpy())
    assert os.path.exists(tmp_path / "port" / "final_model" /
                          "tokenizer.json")


def test_cli_chain_bf16(ws, tmp_path):
    """The chain at the CLIs' default dtype (bf16): every artifact has its
    shape and finite values."""
    from speech_distill_tpu_torch.pipelines import (evaluate,
                                                    extract_logits,
                                                    prepare_dataset, stage1)
    s1 = str(tmp_path / "s1")
    stage1.main(["--model_path", ws["student"], "--dataset_path", ws["raw"],
                 "--output_dir", s1, "--num_epochs", "1", "--batch_size",
                 "4", "--gradient_accumulation_steps", "2",
                 "--max_seq_length", "32", "--num_new_tokens", "50",
                 "--warmup_steps", "1", "--logging_steps", "1",
                 "--eval_size", "4", "--eval_steps", "2"] + CPU)
    m = _metrics(s1)
    assert any("eval_loss" in r for r in m)
    assert all(np.isfinite(r.get("loss", r.get("eval_loss"))) for r in m)
    cfg, teacher = thf.load_pretrained(os.path.join(s1, "final_model"),
                                       device="cpu")
    assert cfg.dtype == "bfloat16" and cfg.vocab_size == 96
    proc, enr = str(tmp_path / "proc"), str(tmp_path / "enr")
    prepare_dataset.main(["--dataset_path", ws["raw"], "--output_path",
                          proc, "--student_model", ws["student"]] + CPU)
    extract_logits.main(["--teacher_model_path",
                         os.path.join(s1, "final_model"), "--dataset_path",
                         proc, "--output_path", enr, "--top_k", "8",
                         "--batch_size", "8", "--pad_to_multiple_of",
                         "32"] + CPU)
    ds = datasets.load_from_disk(enr)
    for row in ds:
        v = np.asarray(row["teacher_top_k_v"], np.float32)
        i = np.asarray(row["teacher_top_k_i"])
        assert v.shape == i.shape == (len(row["teacher_input_ids"]), 8)
        assert np.isfinite(v).all() and (v <= 0).all()
        assert ((i >= 0) & (i < 96)).all()
    common = ["--student_model", ws["student"],
              "--per_device_train_batch_size", "4",
              "--gradient_accumulation_steps", "1",
              "--pad_to_multiple_of", "32", "--test_size", "4",
              "--max_steps", "10", "--warmup_steps", "1"] + CPU
    runs = {"precomputed": (enr, ["--use_lora", "--lora_r", "4"]),
            "online_sparse": (proc, ["--teacher_model", ws["teacher"],
                                     "--top_k", "8"]),
            "nf4_teacher": (proc, ["--teacher_model", ws["teacher"],
                                   "--load_teacher_in_4bit", "--use_lora",
                                   "--init_lora_weights", "gaussian"])}
    for name, (data, extra) in runs.items():
        out = str(tmp_path / name)
        ttrain.main(["--dataset_path", data, "--output_dir", out]
                    + common + extra)
        m = _metrics(out)
        assert [r["step"] for r in m] == [9, 10, 10], name     # 9 an epoch
        assert all(np.isfinite(v) for r in m for k, v in r.items()
                   if k in LOSSES), name
        _, model = thf.load_pretrained(os.path.join(out, "final_model"),
                                       device="cpu")
        assert all(np.isfinite(p.float().numpy()).all()
                   for p in model.parameters()), name
    rep = evaluate.main(["--student_model",
                         str(tmp_path / "precomputed" / "final_model"),
                         "--dataset_path", enr, "--batch_size", "2",
                         "--test_size", "4", "--pad_to_multiple_of", "32",
                         "--output", str(tmp_path / "q.json")] + CPU)
    assert rep["mode"] == "precomputed" and rep["rows"] == 4
    assert all(np.isfinite(v) for sl in ("all", "speech")
               for k, v in rep["metrics"][sl].items() if v is not None)


def test_load_teacher_quantizes_as_the_jax_cli(ws):
    """--load_teacher_in_4bit: nf4 layers and an int8 embed (JAX
    ``quantize_params`` defaults), --load_teacher_in_8bit: int8 both."""
    from speech_distill_tpu_torch.models.qwen3 import QuantWeight
    for quant, layer_key in (("int4", "nf4"), ("int8", "q8")):
        t = ttrain.load_teacher(ws["teacher"], quant, "cpu")
        assert isinstance(t.embed, QuantWeight) and "q8" in t.embed.leaf
        assert isinstance(t.layers[0].mlp.up, QuantWeight)
        assert layer_key in t.layers[0].mlp.up.leaf


# dp x tp and the multi-process start-up are ported: on one process an
# incomplete start-up raises ValueError before any weight loads (the runs
# themselves: tests/test_torch_sharding.py, tests/test_torch_ring_attention
# .py, tests/test_torch_pipeline.py). One process asking for an sp or pp
# axis fails the mesh's arithmetic; --pp_interleave without 1F1B and 1F1B
# without a pp axis raise as JAX's CLI does (JAX's step raises the latter
# once the model has loaded)
_PORTED = {"--tp": "device count", "--zero1": "device count",
           "--coordinator_address": "process", "--num_processes": "process",
           "--process_id": "process", "--sp": "device count",
           "--pp": "device count", "--pp_interleave": "requires",
           "--pp_schedule": "pp > 1"}
# flags that change nothing on one rank (sp 1, pp 1): check_ported takes
# them and the run is the plain one
_NO_OP = ("--sp_zigzag", "--pp_microbatches")


@pytest.mark.parametrize("flag", [
    ["--tp", "2"], ["--sp", "2"], ["--sp_zigzag"], ["--pp", "2"],
    ["--pp_microbatches", "4"], ["--pp_schedule", "1f1b"],
    ["--pp_interleave", "2"], ["--zero1", "--tp", "2"],
    ["--teacher_devices", "4"], ["--teacher_tp", "2"],
    ["--coordinator_address", "localhost:1"], ["--num_processes", "2"],
    ["--process_id", "0", "--num_processes", "2"]],
    ids=lambda f: f[0])
def test_unported_train_flags_raise(ws, flag):
    if flag[0] in _PORTED:
        with pytest.raises(ValueError, match=_PORTED[flag[0]]):
            ttrain.main(["--dataset_path", ws["enriched"]] + flag + CPU)
        return
    if flag[0] in _NO_OP:
        ttrain.check_ported(ttrain.build_parser().parse_args(
            ["--dataset_path", ws["enriched"]] + flag + CPU))
        return
    with pytest.raises(NotImplementedError, match="item 15"):
        ttrain.main(["--dataset_path", ws["enriched"]] + flag + CPU)


def test_unported_family_and_stage1_flags_raise(ws, tmp_path):
    """The CosyVoice2 teacher and the 8-bit optimizer are ported (item 8),
    stage 1's --sp too (item 11: one process asking for 2 ranks fails the
    mesh's arithmetic before any weight loads); a quantized CosyVoice2
    teacher raises ValueError (the JAX CLI fails on it)."""
    from speech_distill_tpu_torch.pipelines import stage1
    for flag in ("--load_teacher_in_8bit", "--load_teacher_in_4bit"):
        with pytest.raises(ValueError, match="quantized CosyVoice2"):
            ttrain.main(["--dataset_path", ws["enriched"],
                         "--teacher_family", "cosyvoice2", flag] + CPU)
    base = ["--model_path", ws["student"], "--dataset_path", ws["raw"],
            "--output_dir", str(tmp_path)] + CPU
    with pytest.raises(ValueError, match="device count"):
        stage1.main(base + ["--sp", "2"])


def tiny_cosyvoice2(monkeypatch, tmp_path):
    """Both CLIs build ``CosyVoice2Config()``: point both packages at the
    tiny config of tests/test_torch_cosyvoice2.py (unified vocab 130) and
    write a reference-named fp32 checkpoint of random weights."""
    from speech_distill_tpu.models import cosyvoice2 as jcv2
    from speech_distill_tpu_torch.models import cosyvoice2 as cv2
    from tests.test_torch_cosyvoice2 import _cfgs
    jcfg, cfg = _cfgs()
    monkeypatch.setattr(jcv2, "CosyVoice2Config", lambda: jcfg)
    monkeypatch.setattr(cv2, "CosyVoice2Config", lambda: cfg)
    path = str(tmp_path / "cosyvoice2.pt")
    torch.save(cv2.torch_state(cv2.init_params(cfg, seed=3, device="cpu")),
               path)
    return path


@pytest.mark.parametrize("top_k", [8, 0], ids=["sparse", "dense"])
def test_train_cli_cosyvoice2_matches_jax(ws, tmp_path, monkeypatch, top_k):
    """--teacher_family cosyvoice2, online KD for 2 steps (PiSSA LoRA) on
    the processed rows, whose teacher ids lie in the unified text range:
    the eval losses (rtol 1e-5) and the exported final_model (rtol 1e-4,
    atol 1e-6) equal the JAX CLI's. Dense KD runs because the unified
    vocabulary (130) is wider than the student's (96); its fused head
    rounds d_logits to bf16 on both sides, and the eval KL of these
    near-uniform random models is ~0.02, so the losses there also take
    atol 1e-6."""
    from speech_distill_tpu.pipelines.train import main as jmain
    _fp32(monkeypatch)
    ckpt = tiny_cosyvoice2(monkeypatch, tmp_path)
    args = ["--dataset_path", ws["proc"], "--student_model", ws["student"],
            "--teacher_model", ckpt, "--teacher_family", "cosyvoice2",
            "--top_k", str(top_k), "--gradient_accumulation_steps", "1",
            "--pad_to_multiple_of", "16", "--test_size", "8",
            "--max_steps", "2", "--warmup_steps", "1",
            "--learning_rate", "2e-4", "--use_lora", "--lora_r", "4",
            "--lora_alpha", "8"]
    jmain(args + ["--per_device_train_batch_size", "1", "--output_dir",
                  str(tmp_path / "jax")])
    ttrain.main(args + ["--per_device_train_batch_size", str(DP),
                        "--output_dir", str(tmp_path / "port")] + CPU)
    got, ref = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert [m["step"] for m in got] == [m["step"] for m in ref] == [2]
    for k in LOSSES[4:]:
        np.testing.assert_allclose(got[0][k], ref[0][k], rtol=1e-5,
                                   atol=1e-6 if top_k <= 0 else 0,
                                   err_msg=k)
    g, r = _final(tmp_path / "port"), _final(tmp_path / "jax")
    assert sorted(g) == sorted(r)
    for k in r:
        np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_train_cli_cosyvoice2_narrow_teacher_raises(ws, tmp_path,
                                                    monkeypatch):
    """Dense KD against a unified vocabulary narrower than the student's
    raises ValueError with both widths before the teacher loads (the
    JAX step fails on the shapes: tests/test_torch_cosyvoice2.py)."""
    from speech_distill_tpu_torch.models import cosyvoice2 as cv2
    from tests.test_torch_cosyvoice2 import _cfgs
    _fp32(monkeypatch)
    import dataclasses
    narrow = dataclasses.replace(_cfgs()[1], unified_vocab_size=90)
    monkeypatch.setattr(cv2, "CosyVoice2Config", lambda: narrow)
    with pytest.raises(ValueError, match="90 wide.*96"):
        ttrain.main(["--dataset_path", ws["proc"], "--student_model",
                     ws["student"], "--teacher_model",
                     str(tmp_path / "not-there.pt"), "--teacher_family",
                     "cosyvoice2", "--top_k", "0",
                     "--output_dir", str(tmp_path / "out")] + CPU)
