"""PyTorch port, the offline pipeline CLIs against the JAX CLIs on the same
tiny HF artifacts (``tests/test_pipelines.make_tiny_model_dir``): the
template and processors id for id, ``prepare_dataset`` columns equal,
``prepare_student``'s export bit-equal, ``extract_logits`` top-K (indices
equal but at near-ties, values within one fp16 ulp), ``stage1``
(metrics.jsonl losses at rtol 1e-5, final_model at rtol 1e-4 / atol 1e-6)
and ``evaluate`` (metrics at rtol 1e-5) in fp32, both packages'
``load_pretrained`` patched to fp32; audio rows through a tiny S3
checkpoint (prepare-dataset and stage 1 id for id with JAX) and stage 1's
text fallback without one; the ``python -m speech_distill_tpu_torch``
entry point. CPU.

The JAX training CLIs run data-parallel over the 8 virtual CPU devices of
``tests/conftest.py``, so their global batch is 8 x the per-device flag;
the port runs that batch on one device."""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speech_distill_tpu.data import processor as jproc
from speech_distill_tpu.data import template as jtmpl
from speech_distill_tpu.models import hf_loader as jhf
from speech_distill_tpu_torch.data import processor as tproc
from speech_distill_tpu_torch.data import template as ttmpl
from speech_distill_tpu_torch.models import hf_loader as thf
from tests.test_pipelines import make_tiny_model_dir

datasets = pytest.importorskip("datasets")

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
DP = 8                    # the JAX CLIs' data-parallel width here
PREFIXES = [("<|task_podcast|><|SPEAKER_0|>", ""),
            ("", "<|SPEAKER_0|>"),
            ('{"en": "<|task_podcast|>", "default": "<|SPEAKER_0|>"}', ""),
            ("<|task_podcast|>", '{"yue": "<|Yue|><|Yue|><|Yue|>"}')]


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


def _rows(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return {"codes": [rng.integers(0, 50, rng.integers(3, 8)).tolist()
                      for _ in range(n)],
            "text": [" hello", "abc ", "good day", "xyz"] * (n // 4),
            "lang": ["en", "zh", "yue", "en"] * (n // 4)}


def _fp32(monkeypatch):
    """Both packages' CLIs load their models in fp32 (they import
    ``load_pretrained`` when called)."""
    monkeypatch.setattr(jhf, "load_pretrained", functools.partial(
        jhf.load_pretrained, dtype="float32"))
    monkeypatch.setattr(thf, "load_pretrained", functools.partial(
        thf.load_pretrained, dtype="float32"))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The student and a teacher of other weights, the raw dataset with a
    codes column, its JAX
    prepare-dataset output and that output enriched by the JAX
    extract-logits CLI at top-K 8 (fp32)."""
    from speech_distill_tpu.pipelines.extract_logits import main as jextract
    from speech_distill_tpu.pipelines.prepare_dataset import main as jprep
    root = tmp_path_factory.mktemp("tpipe")
    student, teacher = str(root / "student"), str(root / "teacher")
    make_tiny_model_dir(student, vocab_size=96)
    make_tiny_model_dir(teacher, vocab_size=96, seed=1)
    raw = str(root / "raw")
    datasets.Dataset.from_dict(_rows()).save_to_disk(raw)
    proc = str(root / "proc")
    jprep(["--dataset_path", raw, "--output_path", proc,
           "--student_model", student, "--max_length", "64"])
    enriched = str(root / "enriched")
    mp = pytest.MonkeyPatch()
    _fp32(mp)
    try:
        jextract(["--teacher_model_path", student, "--dataset_path", proc,
                  "--output_path", enriched, "--top_k", "8",
                  "--batch_size", "4", "--pad_to_multiple_of", "16"])
    finally:
        mp.undo()
    return {"root": root, "student": student, "teacher": teacher,
            "raw": raw, "proc": proc, "enriched": enriched}


@pytest.fixture(scope="module")
def tok(ws):
    from transformers import AutoTokenizer
    t = AutoTokenizer.from_pretrained(ws["student"])
    t.pad_token = "<|semantic_token_end|>"
    return t


@pytest.mark.parametrize("teacher,student", PREFIXES)
def test_template_matches_jax(tok, teacher, student):
    t, s = ttmpl.parse_prefix(teacher), ttmpl.parse_prefix(student)
    assert (t, s) == (jtmpl.parse_prefix(teacher),
                      jtmpl.parse_prefix(student))
    got = ttmpl.align_prefixes(t, s, tok)
    ref = jtmpl.align_prefixes(t, s, tok)
    assert got == ref
    text_prefix = ttmpl.parse_prefix('{"en": "", "zh": "", "yue": "<|Yue|>"}')
    kw = dict(text_bos="<|text_start|>", text_eos="<|text_end|>",
              speech_bos="<|semantic_token_start|>",
              speech_eos="<|semantic_token_end|>")
    for lang in ("en", "yue", "fr"):
        for prefix in got:
            args = (" some text ", [3, 14, 15], lang)
            a = ttmpl.build_example_text(*args, prefix=prefix,
                                         text_prefix=text_prefix, **kw)
            b = jtmpl.build_example_text(*args, prefix=prefix,
                                         text_prefix=text_prefix, **kw)
            assert a == b
            assert tok(a)["input_ids"] == tok(b)["input_ids"]


@pytest.mark.parametrize("max_length", [None, 64, 9])
def test_processors_match_jax(tok, max_length):
    """One example and a batch, single and dual, id for id (9 truncates)."""
    rows = _rows(8)
    kw = dict(text_prefix={"yue": "<|Yue|>"}, max_length=max_length)
    pairs = [(cls(tok, prefix=p, **kw), jcls(tok, prefix=p, **kw))
             for p in ("", "<|task_podcast|>")
             for cls, jcls in [(tproc.SpeechDistillProcessor,
                                jproc.SpeechDistillProcessor)]]
    for got, ref in pairs:
        for i in range(8):
            ex = {k: v[i] for k, v in rows.items()}
            assert got.process_example(ex) == ref.process_example(ex)
        assert got.process_batch(rows) == ref.process_batch(rows)
    dual = tproc.DualProcessor(pairs[0][0], pairs[1][0])
    jdual = jproc.DualProcessor(pairs[0][1], pairs[1][1])
    assert dual(rows) == jdual(rows)
    ex = {k: v[3] for k, v in rows.items()}
    assert dual(ex) == jdual(ex)


def test_prepare_dataset_cli_matches_jax(ws):
    from speech_distill_tpu_torch.pipelines.prepare_dataset import main
    out = str(ws["root"] / "proc_port")
    main(["--dataset_path", ws["raw"], "--output_path", out,
          "--student_model", ws["student"], "--max_length", "64"] + CPU)
    got, ref = datasets.load_from_disk(out), datasets.load_from_disk(
        ws["proc"])
    assert got.column_names == ref.column_names
    assert got.to_dict() == ref.to_dict()


def test_prepare_student_cli_bit_equal(tmp_path):
    """The expanded student: the same tokenizer, config.json and
    model.safetensors bytes as the JAX CLI's (bf16-rounded tables)."""
    from speech_distill_tpu.pipelines.prepare_student import main as jmain
    from speech_distill_tpu_torch.pipelines.prepare_student import main
    teacher, small = str(tmp_path / "teacher"), str(tmp_path / "small")
    make_tiny_model_dir(teacher, vocab_size=96, seed=1)
    make_tiny_model_dir(small, vocab_size=48, seed=2, n_speech=10)
    args = ["--teacher-model", teacher, "--student-model", small,
            "--seed", "3"]
    jmain(args + ["--output-dir", str(tmp_path / "jax")])
    main(args + ["--output-dir", str(tmp_path / "port")] + CPU)
    for name in ("model.safetensors", "config.json", "tokenizer.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def _assert_topk_match(got_v, got_i, ref_v, ref_i):
    """Indices equal except where two candidates sit within one fp16 ulp
    (their order is rounding); values within one fp16 ulp."""
    got_v, ref_v = (np.asarray(x, np.float32) for x in (got_v, ref_v))
    got_i, ref_i = np.asarray(got_i), np.asarray(ref_i)
    assert got_v.shape == ref_v.shape and got_i.shape == ref_i.shape
    ulp = np.spacing(np.abs(ref_v).astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(got_v - ref_v) <= ulp)
    swapped = got_i != ref_i
    if swapped.any():
        # a swapped slot's entry sits within an ulp of its neighbour
        near = np.zeros_like(swapped)
        near[..., 1:] |= np.abs(ref_v[..., 1:] - ref_v[..., :-1]) <= ulp[..., 1:]
        near[..., :-1] |= np.abs(ref_v[..., :-1] - ref_v[..., 1:]) \
            <= ulp[..., :-1]
        assert np.all(near[swapped])


@pytest.mark.parametrize("source", ["processed", "raw"])
def test_extract_cli_matches_jax(ws, tmp_path, monkeypatch, source):
    """On the prepare-dataset output, and on the raw rows, which the CLI
    tokenizes with the teacher prefix first."""
    from speech_distill_tpu.pipelines.extract_logits import main as jmain
    from speech_distill_tpu_torch.pipelines.extract_logits import main
    _fp32(monkeypatch)
    args = ["--teacher_model_path", ws["student"], "--top_k", "8",
            "--batch_size", "4", "--pad_to_multiple_of", "16"]
    if source == "processed":
        args += ["--dataset_path", ws["proc"]]
        ref_path = ws["enriched"]
    else:
        args += ["--dataset_path", ws["raw"], "--max_length", "20"]
        ref_path = str(tmp_path / "jax")
        jmain(args + ["--output_path", ref_path])
    main(args + ["--output_path", str(tmp_path / "port")] + CPU)
    got = datasets.load_from_disk(str(tmp_path / "port"))
    ref = datasets.load_from_disk(ref_path)
    assert got.column_names == ref.column_names
    ids = "teacher_input_ids" if source == "processed" else "input_ids"
    for g, r in zip(got, ref):
        assert len(g["teacher_top_k_v"]) == len(g[ids])
        _assert_topk_match(g["teacher_top_k_v"], g["teacher_top_k_i"],
                           r["teacher_top_k_v"], r["teacher_top_k_i"])
        assert {k: v for k, v in g.items() if "top_k" not in k} == \
            {k: v for k, v in r.items() if "top_k" not in k}


def _metrics(path):
    return [json.loads(line) for line in open(os.path.join(path,
                                                           "metrics.jsonl"))]


def _assert_metrics_close(got, ref, keys, rtol):
    assert [m["step"] for m in got] == [m["step"] for m in ref]
    for g, r in zip(got, ref):
        assert sorted(k for k in g if k in keys) == \
            sorted(k for k in r if k in keys)
        for k in keys:
            if k in r:
                np.testing.assert_allclose(g[k], r[k], rtol=rtol, err_msg=k)


def _final(path):
    from safetensors.numpy import load_file
    return load_file(os.path.join(path, "final_model", "model.safetensors"))


def test_stage1_cli_matches_jax(ws, tmp_path, monkeypatch):
    """The test_pipelines stage-1 recipe (eval every step, load-best) on
    both CLIs in fp32, 3 steps an epoch and a padded last eval group;
    only the embedding changes."""
    from speech_distill_tpu.pipelines.stage1 import main as jmain
    from speech_distill_tpu_torch.pipelines.stage1 import main
    _fp32(monkeypatch)
    raw = str(tmp_path / "raw")
    datasets.Dataset.from_dict(_rows(40, seed=1)).save_to_disk(raw)
    args = ["--model_path", ws["student"], "--dataset_path", raw,
            "--num_epochs", "2", "--gradient_accumulation_steps", "1",
            "--max_seq_length", "16", "--num_new_tokens", "50",
            "--warmup_steps", "1", "--learning_rate", "1e-2",
            "--logging_steps", "1", "--save_steps", "100",
            "--eval_size", "0.25", "--eval_steps", "2",
            "--num_workers", "2"]
    jmain(args + ["--batch_size", "1", "--eval_batch_size", "1",
                  "--output_dir", str(tmp_path / "jax")])
    main(args + ["--batch_size", str(DP), "--eval_batch_size", str(DP),
                 "--output_dir", str(tmp_path / "port")] + CPU)
    got, ref = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert any("eval_loss" in m for m in ref)
    _assert_metrics_close(got, ref, ("loss", "eval_loss"), 1e-5)
    start = thf.read_state_dict(ws["student"])
    g, r = _final(tmp_path / "port"), _final(tmp_path / "jax")
    assert sorted(g) == sorted(r)
    for k in r:
        np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        if k != "model.embed_tokens.weight":
            np.testing.assert_array_equal(g[k], start[k].numpy(), err_msg=k)
    old = 96 - 50          # the new rows moved
    assert not np.array_equal(g["model.embed_tokens.weight"][old:],
                              start["model.embed_tokens.weight"][old:]
                              .numpy())


def test_stage1_cli_8bit_matches_jax(ws, tmp_path, monkeypatch):
    """--use_8bit_optimizer on both CLIs in fp32 (int8 / uint8 moments,
    ``make_optimizer(eight_bit=True)``): the losses (rtol 1e-5) and the
    final embedding (rtol 1e-4, atol 1e-6); every other tensor stays
    bit-equal to the input. The JAX CLI sums its gradients over 8
    devices, so a moment whose scaled value lands on a rounding edge can
    take the neighbouring code there (tests/test_torch_optim8bit.py holds
    the codes equal on equal gradients): at most 0.1% of the elements
    may then differ, each by less than Adam's largest step (lr / sqrt(1 -
    b2) ~ 32 lr) a step."""
    from speech_distill_tpu.pipelines.stage1 import main as jmain
    from speech_distill_tpu_torch.pipelines.stage1 import main
    _fp32(monkeypatch)
    raw = str(tmp_path / "raw")
    datasets.Dataset.from_dict(_rows(24, seed=2)).save_to_disk(raw)
    args = ["--model_path", ws["student"], "--dataset_path", raw,
            "--num_epochs", "1", "--gradient_accumulation_steps", "1",
            "--max_seq_length", "16", "--num_new_tokens", "50",
            "--warmup_steps", "1", "--learning_rate", "1e-2",
            "--weight_decay", "0.01", "--logging_steps", "1",
            "--save_steps", "100", "--eval_size", "0",
            "--num_workers", "2", "--use_8bit_optimizer"]
    jmain(args + ["--batch_size", "1", "--output_dir",
                  str(tmp_path / "jax")])
    main(args + ["--batch_size", str(DP), "--output_dir",
                 str(tmp_path / "port")] + CPU)
    got, ref = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert len(ref) >= 2
    _assert_metrics_close(got, ref, ("loss",), 1e-5)
    start = thf.read_state_dict(ws["student"])
    g, r = _final(tmp_path / "port"), _final(tmp_path / "jax")
    for k in r:
        if k != "model.embed_tokens.weight":
            np.testing.assert_array_equal(g[k], start[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    ge, re_ = g["model.embed_tokens.weight"], r["model.embed_tokens.weight"]
    close = np.isclose(ge, re_, rtol=1e-4, atol=1e-6)
    assert (~close).mean() <= 1e-3
    assert np.abs(ge - re_).max() < len(ref) * 32 * 1e-2
    assert not np.array_equal(ge[96 - 50:],
                              start["model.embed_tokens.weight"][96 - 50:]
                              .numpy())


@pytest.mark.parametrize("width", ["wide", "narrow"])
def test_evaluate_cli_cosyvoice2_matches_jax(ws, tmp_path, monkeypatch,
                                            width):
    """--teacher_family cosyvoice2: with the unified vocabulary (130)
    wider than the student's (96) the agreement report equals the JAX
    CLI's (rtol 1e-5); narrower (90), the port raises ValueError before
    the teacher loads (JAX fails on the shapes in the step)."""
    from speech_distill_tpu.pipelines.evaluate import main as jmain
    from speech_distill_tpu_torch.models import cosyvoice2 as cv2
    from speech_distill_tpu_torch.pipelines.evaluate import main
    from tests.test_torch_train_cli import tiny_cosyvoice2
    _fp32(monkeypatch)
    ckpt = tiny_cosyvoice2(monkeypatch, tmp_path)
    args = ["--student_model", ws["student"], "--dataset_path", ws["raw"],
            "--teacher_model", ckpt, "--teacher_family", "cosyvoice2",
            "--batch_size", "2", "--test_size", "6", "--agree_k", "3",
            "--pad_to_multiple_of", "16", "--max_length", "64"]
    if width == "narrow":
        import dataclasses
        narrow = dataclasses.replace(cv2.CosyVoice2Config(),
                                     unified_vocab_size=90)
        monkeypatch.setattr(cv2, "CosyVoice2Config", lambda: narrow)
        with pytest.raises(ValueError, match="90 wide.*96"):
            main(args + ["--output", str(tmp_path / "port.json")] + CPU)
        return
    jmain(args + ["--dp", "1", "--output", str(tmp_path / "jax.json")])
    main(args + ["--output", str(tmp_path / "port.json")] + CPU)
    got = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert got["mode"] == ref["mode"] == "online"
    for sl in ("all", "speech"):
        g, r = got["metrics"][sl], ref["metrics"][sl]
        assert g["positions"] == r["positions"] > 0
        for k, v in r.items():
            if v is not None and k != "positions":
                np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=k)


def _s3_checkpoint(tmp_path, monkeypatch):
    """A tiny-width S3 checkpoint with the whisper front end's 128 mels,
    written to ``tmp_path`` and named by ``$S3_TOKENIZER_CKPT``."""
    import dataclasses
    import jax
    from speech_distill_tpu.tokenizer import s3 as js3
    from speech_distill_tpu_torch.models.convert import s3_params_from_jax
    from speech_distill_tpu_torch.tokenizer import s3 as ts3
    jcfg = dataclasses.replace(js3.s3_tiny(), n_mels=128)
    params = js3.init_params(jax.random.PRNGKey(0), jcfg)
    model = s3_params_from_jax(jax.tree.map(np.asarray, params),
                               ts3.S3Config(**dataclasses.asdict(jcfg)),
                               "cpu")
    path = tmp_path / "speech_tokenizer_v2.pt"
    torch.save(model.state_dict(), path)
    monkeypatch.setenv("S3_TOKENIZER_CKPT", str(path))


def _audio_rows(n=4, seed=0):
    """Rows with audio (24 kHz arrays) and text, no codes column."""
    rng = np.random.default_rng(seed)
    return {"audio": [{"array": (0.3 * rng.normal(size=int(
                           rng.integers(6000, 12000)))).astype(np.float32),
                       "sampling_rate": 24000} for _ in range(n)],
            "text": ["hello", "abc", "good day", "xyz"][:n],
            "lang": ["en", "zh", "yue", "en"][:n]}


def test_audio_rows_tokenized_as_jax(ws, tmp_path, monkeypatch):
    """Audio rows without codes go through the S3 tokenizer of
    ``$S3_TOKENIZER_CKPT``: prepare-dataset's columns and stage 1's
    example ids equal the JAX CLIs', and the stage-1 CLI trains on
    them."""
    from speech_distill_tpu.pipelines.prepare_dataset import main as jprep
    from speech_distill_tpu.tokenizer.s3 import (
        default_speech_tokens_fn as jfn)
    from speech_distill_tpu_torch.pipelines import stage1
    from speech_distill_tpu_torch.pipelines.prepare_dataset import main
    from speech_distill_tpu_torch.tokenizer.s3 import (
        default_speech_tokens_fn)
    _s3_checkpoint(tmp_path, monkeypatch)
    rows = _audio_rows()
    raw = str(tmp_path / "audio")
    datasets.Dataset.from_dict(rows).save_to_disk(raw)
    args = ["--dataset_path", raw, "--student_model", ws["student"],
            "--max_length", "512"]
    jprep(args + ["--output_path", str(tmp_path / "jax")])
    main(args + ["--output_path", str(tmp_path / "port")] + CPU)
    got = datasets.load_from_disk(str(tmp_path / "port")).to_dict()
    ref = datasets.load_from_disk(str(tmp_path / "jax")).to_dict()
    assert got["teacher_input_ids"] == ref["teacher_input_ids"]
    assert got == ref

    tok = load_tok(ws)
    port = tproc.SpeechDistillProcessor(
        tok, speech_tokens_fn=default_speech_tokens_fn("cpu"))
    jax_p = jproc.SpeechDistillProcessor(tok, speech_tokens_fn=jfn())
    for i in range(len(rows["text"])):
        ex = {k: v[i] for k, v in rows.items()}
        ids = stage1._process_one(port, tok, ex)
        assert ids == jax_p.process_example(ex)["input_ids"]
        assert len(ids) > len(tok.encode(ex["text"])) + 4
    stage1.main(["--model_path", ws["student"], "--dataset_path", raw,
                 "--output_dir", str(tmp_path / "s1"), "--num_epochs", "1",
                 "--batch_size", "1", "--max_seq_length", "16",
                 "--num_new_tokens", "50", "--warmup_steps", "1",
                 "--eval_size", "0", "--num_workers", "2"] + CPU)
    assert (tmp_path / "s1" / "final_model" / "config.json").exists()


def load_tok(ws):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(ws["student"])


def test_stage1_audio_row_text_fallback(ws, tmp_path, monkeypatch):
    """Without an S3 checkpoint an audio row's processing fails, and stage
    1 falls back to the tokenized text as the JAX CLI does (as for any
    other failing row); the CLI then trains on the text."""
    from speech_distill_tpu_torch.pipelines import stage1
    from speech_distill_tpu_torch.tokenizer.s3 import (
        default_speech_tokens_fn)
    monkeypatch.delenv("S3_TOKENIZER_CKPT", raising=False)
    tok = load_tok(ws)
    port = tproc.SpeechDistillProcessor(
        tok, speech_tokens_fn=default_speech_tokens_fn("cpu"))
    ex = {"audio": "a.wav", "text": " hello "}
    assert stage1._process_one(port, tok, ex) == tok.encode("hello")
    raw = str(tmp_path / "audio")
    datasets.Dataset.from_dict({"audio": ["a.wav", "b.wav"],
                                "text": ["hello", "abc"]}).save_to_disk(raw)
    stage1.main(["--model_path", ws["student"], "--dataset_path", raw,
                 "--output_dir", str(tmp_path / "out"), "--num_epochs", "1",
                 "--batch_size", "1", "--max_seq_length", "8",
                 "--num_new_tokens", "50", "--eval_size", "0",
                 "--num_workers", "1"] + CPU)
    assert (tmp_path / "out" / "final_model" / "config.json").exists()

    class Failing:
        def process_example(self, example):
            raise ValueError("bad row")

    class Tok:
        def encode(self, text):
            return [len(text)]

    assert stage1._process_one(Failing(), Tok(), {"text": " abc "}) == [3]
    assert stage1._process_one(Failing(), Tok(), {"text": " "}) is None


@pytest.mark.parametrize("mode", ["precomputed", "online"])
def test_evaluate_cli_matches_jax(ws, tmp_path, monkeypatch, mode):
    """Stored top-K (precomputed), or the raw rows processed by the CLI
    and scored against another model in the step (online; a teacher of
    other weights, so the KL is not a cancellation near 0); the
    held-out split, fp32."""
    from speech_distill_tpu.pipelines.evaluate import main as jmain
    from speech_distill_tpu_torch.pipelines.evaluate import main
    _fp32(monkeypatch)
    args = ["--student_model", ws["student"], "--batch_size", "2",
            "--test_size", "6", "--agree_k", "3", "--pad_to_multiple_of",
            "16", "--max_length", "64"]
    if mode == "precomputed":
        args += ["--dataset_path", ws["enriched"]]
    else:
        args += ["--dataset_path", ws["raw"], "--teacher_model",
                 ws["teacher"]]
    jmain(args + ["--dp", "1", "--output", str(tmp_path / "jax.json")])
    main(args + ["--output", str(tmp_path / "port.json")] + CPU)
    got = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert got["mode"] == ref["mode"] == mode
    assert got["rows"] == ref["rows"] == 6
    for sl in ("all", "speech"):
        g, r = got["metrics"][sl], ref["metrics"][sl]
        assert g["positions"] == r["positions"] > 0
        for k, v in r.items():
            if v is not None and k != "positions":
                np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=k)


def test_evaluate_cli_smoke_tiny(ws, tmp_path):
    """The audio smoke over the tiny flow and HiFT, bf16 student: a report
    with a status; with speech tokens, the exact sample count."""
    from speech_distill_tpu_torch.pipelines.evaluate import main
    rep = main(["--student_model", ws["student"], "--dataset_path",
                ws["enriched"], "--batch_size", "2", "--test_size", "4",
                "--pad_to_multiple_of", "16", "--smoke", "--smoke_tiny",
                "--smoke_max_tokens", "6", "--output",
                str(tmp_path / "r.json")] + CPU)
    sm = rep["smoke"]
    assert sm["status"] in ("ok", "no_speech_tokens")
    assert sm["generated_tokens"] == 6
    if sm["status"] == "ok":
        assert sm["wav_samples"] == sm["expected_samples"]
    # --dp / --tp are ported: one process cannot hold dp 2
    with pytest.raises(ValueError, match="device count"):
        main(["--student_model", ws["student"], "--dataset_path",
              ws["enriched"], "--dp", "2"] + CPU)


def _run_main(*args, env=None):
    return subprocess.run([sys.executable, "-m", "speech_distill_tpu_torch",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=env)


def test_main_usage_and_exit_codes():
    res = _run_main("--help")
    assert res.returncode == 0
    assert "usage: python -m speech_distill_tpu_torch" in res.stdout
    for cmd in ("prepare-student", "stage1", "prepare-dataset",
                "extract-logits", "train", "synthesize", "evaluate"):
        assert f"  {cmd} " in res.stdout
    assert _run_main().returncode == 1
    res = _run_main("nope")
    assert res.returncode == 1 and "unknown command: nope" in res.stdout
    res = _run_main("synthesize", "--help")
    assert res.returncode == 0
    for flag in ("--model_path", "--script", "--output_dir", "--seed",
                 "--llm_engine", "--fp16_flow", "--streaming", "--device"):
        assert flag in res.stdout, flag


def test_main_force_cpu(ws, tmp_path, monkeypatch):
    """SDT_FORCE_CPU=1 means --device cpu; without it the CLI asks for
    CUDA and raises here."""
    from speech_distill_tpu_torch import __main__ as entry
    out = str(tmp_path / "proc")
    argv = ["speech_distill_tpu_torch", "prepare-dataset", "--dataset_path",
            ws["raw"], "--output_path", out, "--student_model",
            ws["student"]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", list(argv))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main()
    monkeypatch.setenv("SDT_FORCE_CPU", "1")
    monkeypatch.setattr(sys, "argv", list(argv))
    entry.main()
    assert datasets.load_from_disk(out).num_rows == 12


SYN_OFFSET, SYN_CODES = 100, 6561      # speech ids at 100 .. 6660, eos 6661


def _tiny_synth_dir(root, monkeypatch):
    """A tiny model directory for ``synthesize``: a vocab-6,662 LLM (the
    full speech range: any generated id maps into the flow vocabulary)
    with the test tokenizer, its ``soulxpodcast_config.json``, a tiny
    flow (6,561 tokens, 80 mels, 192-d speaker) and HiFT, a 128-mel
    tiny S3 checkpoint, the published CAM++; the port's flow and HiFT
    configs patched to the tiny ones, and each turn capped at 12 tokens
    through the run's EngineConfig (the CLI has no flag for it)."""
    from speech_distill_tpu_torch.core.checkpoint import export_hf
    from speech_distill_tpu_torch.core.config import (EngineConfig,
                                                      SamplingParams,
                                                      qwen3_tiny)
    from speech_distill_tpu_torch.infer import infer_utils
    from speech_distill_tpu_torch.models import campplus, flow, hift, qwen3
    from speech_distill_tpu_torch.models.convert import model_to_tree
    from speech_distill_tpu_torch.models.flow_encoder import (
        FlowEncoderConfig)
    from tests.test_pipelines import make_tiny_tokenizer

    d = root / "model"
    make_tiny_tokenizer(str(d))
    eos = SYN_OFFSET + SYN_CODES
    cfg = qwen3_tiny(eos + 1, dtype="float32", speech_token_offset=SYN_OFFSET,
                     eos_token_id=eos)
    export_hf(model_to_tree(qwen3.init_params(cfg, 0, "cpu")), cfg, str(d))
    (d / "soulxpodcast_config.json").write_text(json.dumps(cfg.to_dict()))
    fc = flow.FlowConfig(
        input_size=16, n_timesteps=2, est_channels=16, est_n_blocks=1,
        est_num_mid_blocks=1, est_num_heads=2, est_head_dim=8,
        encoder=FlowEncoderConfig(input_size=16, output_size=16,
                                  attention_heads=2, linear_units=32,
                                  num_blocks=1, num_up_blocks=1))
    hc = hift.HiFTConfig(base_channels=16, nb_harmonics=2,
                         resblock_kernel_sizes=(3,),
                         resblock_dilations=((1,),),
                         source_resblock_kernel_sizes=(3, 3, 3),
                         source_resblock_dilations=((1,), (1,), (1,)),
                         f0_cond_channels=8)
    torch.save(flow.init_params(fc, 0, "cpu").state_dict(), d / "flow.pt")
    torch.save(hift.init_params(hc, 0, "cpu").state_dict(), d / "hift.pt")
    torch.save(campplus.CAMPPlus(device="cpu").state_dict(),
               d / "campplus.pt")
    _s3_checkpoint(d, monkeypatch)
    monkeypatch.delenv("S3_TOKENIZER_CKPT")     # the directory's own file
    monkeypatch.setattr(flow, "FlowConfig", lambda: fc)
    monkeypatch.setattr(hift, "HiFTConfig", lambda: hc)
    sp = SamplingParams(max_tokens=12, stop_token_ids=(eos,))
    monkeypatch.setattr(infer_utils, "EngineConfig",
                        lambda **kw: EngineConfig(sampling=sp, **kw))
    return d


def _synth_script(root) -> str:
    from scipy.io.wavfile import write as wav_write
    rng = np.random.default_rng(0)
    speakers = {}
    for name, sr, secs in (("S1", 44100, 1.1), ("S2", 24000, 0.9)):
        path = root / f"{name}.wav"
        wav_write(str(path), sr, (0.2 * rng.normal(size=int(sr * secs))
                                  * 32767).astype(np.int16))
        speakers[name] = {"prompt_text": f"prompt of {name.lower()}",
                          "prompt_audio": str(path)}
    script = root / "script.json"
    script.write_text(json.dumps({
        "speakers": speakers,
        "text": [["S1", "hello there"], ["S2", "hi"], ["S1", "good day"]]}))
    return str(script)


@pytest.mark.parametrize("engine", ["jax", "paged"])
def test_synthesize_cli_tiny(tmp_path, monkeypatch, engine):
    """``synthesize.main --device cpu`` over a three-turn two-speaker
    script: a 24 kHz int16 wav of (2 x the tokens each turn hands the
    flow) x 480 samples, the same bytes on a second run with the seed
    (the streaming run gives the same tokens and length)."""
    from scipy.io.wavfile import read as wav_read
    from speech_distill_tpu_torch.infer.soulxpodcast import SoulXPodcast
    from speech_distill_tpu_torch.pipelines import synthesize
    d = _tiny_synth_dir(tmp_path, monkeypatch)
    script = _synth_script(tmp_path)
    flow_tokens = []
    real = SoulXPodcast._token_to_wav

    def spy(self, speech_tokens, *a, **kw):
        flow_tokens.append(list(speech_tokens))
        return real(self, speech_tokens, *a, **kw)
    monkeypatch.setattr(SoulXPodcast, "_token_to_wav", spy)
    wavs = []
    for run in range(2):
        path = synthesize.main(["--model_path", str(d), "--script", script,
                                "--output_dir", str(tmp_path / f"o{run}"),
                                "--llm_engine", engine, "--seed", "3"]
                               + CPU)
        rate, wav = wav_read(path)
        assert rate == 24000 and wav.dtype == np.int16
        wavs.append(wav)
    assert len(flow_tokens) == 6 and flow_tokens[:3] == flow_tokens[3:]
    n = sum(2 * len(t) * 480 for t in flow_tokens[:3])
    assert len(wavs[0]) == n and wavs[0].tobytes() == wavs[1].tobytes()
    if engine == "jax":
        path = synthesize.main(["--model_path", str(d), "--script", script,
                                "--output_dir", str(tmp_path / "s"),
                                "--streaming", "--seed", "3"] + CPU)
        assert len(wav_read(path)[1]) == n
