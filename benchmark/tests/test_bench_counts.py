"""The operation and byte counts the roofline and mfu metrics divide by,
against shapes worked by hand (and against the kernel table's bounds of
``PERF.md`` where those count the same thing)."""
import importlib.util
import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
Q06 = json.loads((BENCH / "configs" / "qwen3_0.6b_speech.json").read_text())


def metric(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k1_by_hand():
    k1 = metric("k1_roofline.train")
    # T 2, one head of width 1: 3 causal scores, 3 value products; q, k,
    # v, o of 2 bf16 values and 2 fp32 log-sum-exps
    assert k1.call_bound("fwd", 1, 2, 1, 1, 1) == pytest.approx(
        max(12 / 989e12, (4 * 4 + 4 * 2) / 3.35e12))


@pytest.mark.parametrize("kind,B,T,ms", [
    ("fwd", 8, 512, 0.01510), ("dq", 8, 512, 0.02019),
    ("dkv", 8, 512, 0.02019), ("fwd", 4, 4096, 0.2779),
    ("dq", 4, 4096, 0.4169), ("dkv", 4, 4096, 0.5559)])
def test_k1_against_the_kernel_table(kind, B, T, ms):
    k1 = metric("k1_roofline.train")
    assert k1.call_bound(kind, B, T, 16, 8, 128) * 1e3 == pytest.approx(
        ms, rel=2e-3)


def test_k2_is_six_nvd():
    k2 = metric("k2_roofline.train")
    # the kernel table's stats bound (2 N V D) is 5.410 ms at N 16,380
    assert k2.microbatch_bound(16380, 159488, 1024) * 1e3 == pytest.approx(
        3 * 5.410, rel=2e-3)


def test_mfu_train_kd_by_hand():
    mfu = metric("mfu.train")
    t = {"seq": 512, "lora_r": 32}
    mm = 2 * (1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024 + 3 * 1024 * 3072)
    attn = 4 * 256.5 * 16 * 128
    lora = 2 * 32 * (3072 + 2048 + 2048 + 3072 + 3 * 4096)
    head = 2 * 1024 * 159488
    want = (28 * (mm + lora + attn) + head
            + 28 * (mm + lora + 2 * attn) + head + 28 * lora + head)
    assert mfu.per_token(Q06, t) == pytest.approx(want)
    assert want == pytest.approx(3.0391e9, rel=1e-4)


def test_mfu_train_stage1_by_hand():
    mfu = metric("mfu.train")
    t = {"seq": 4096, "new_tokens": 8220}
    mm = 2 * (1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024 + 3 * 1024 * 3072)
    attn = 4 * 2048.5 * 16 * 128
    head = 2 * 1024 * 159488
    want = (28 * (mm + attn) + head + 28 * (mm + 2 * attn) + head
            + 2 * 1024 * 8220)
    assert mfu.per_token(Q06, t) == pytest.approx(want)
