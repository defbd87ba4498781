"""PyTorch port, the offline pipeline CLIs against the JAX CLIs on the same
tiny HF artifacts (``tests/test_pipelines.make_tiny_model_dir``): the
template and processors id for id, ``prepare_dataset`` columns equal,
``prepare_student``'s export bit-equal, ``extract_logits`` top-K (indices
equal but at near-ties, values within one fp16 ulp), ``stage1``
(metrics.jsonl losses at rtol 1e-5, final_model at rtol 1e-4 / atol 1e-6)
and ``evaluate`` (metrics at rtol 1e-5) in fp32, both packages'
``load_pretrained`` patched to fp32; the stage-1 audio-row guard and the
``python -m speech_distill_tpu_torch`` entry point. CPU.

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


def test_stage1_audio_row_raises(ws, tmp_path):
    """An audio row without codes needs the unported S3 tokenizer: the
    port raises instead of training on the text alone (the JAX CLI's
    fallback for other failures)."""
    from speech_distill_tpu_torch.pipelines import stage1
    raw = str(tmp_path / "audio")
    datasets.Dataset.from_dict({"audio": ["a.wav", "b.wav"],
                                "text": ["hello", "abc"]}).save_to_disk(raw)
    with pytest.raises(NotImplementedError, match="item 9"):
        stage1.main(["--model_path", ws["student"], "--dataset_path", raw,
                     "--output_dir", str(tmp_path / "out"),
                     "--max_seq_length", "8", "--num_workers", "1"] + CPU)

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
    with pytest.raises(NotImplementedError, match="item 11"):
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
    res = _run_main("synthesize")
    assert res.returncode == 1 and "item 10" in res.stdout


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
