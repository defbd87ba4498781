"""Each driver's traffic is fixed in size and drawn from the seed, and
the reference's batches are the program's."""
import numpy as np
import pytest

from benchmark.harness import core

KD = core.driver("kd_train")
S1 = core.driver("stage1_train")


def params(cell, tiny=False):
    w = core.workload(cell)
    mix = core.traffic(w["traffic"])
    p = dict(mix["params"])
    cfg = core.config(w["config"])
    if tiny:
        p.update(mix["rehearsal"])
        cfg = {**cfg, **core.TINY}
    return cfg, p


def test_kd_rows_by_seed():
    cfg, t = params("kd_lora_0.6b")
    a, b = KD.rows(cfg, t, 5, 0), KD.rows(cfg, t, 5, 0)
    assert all(x["input_ids"] == y["input_ids"] for x, y in zip(a, b))
    c = KD.rows(cfg, t, 6, 0)
    assert a[0]["input_ids"] != c[0]["input_ids"]
    d = KD.rows(cfg, t, 5, 1)
    assert a[0]["input_ids"] != d[0]["input_ids"]
    # every row as long as the truncation length, for every seed
    assert len(a) == len(c) == t["batch"]
    assert all(len(x["input_ids"]) == t["seq"] for x in a + c)
    big = 2 ** 31 + 12345
    assert KD.rows(cfg, t, big, 0)[0]["input_ids"] == \
        KD.rows(cfg, t, big, 0)[0]["input_ids"]


def test_kd_reference_batch_matches_the_collator():
    from speech_distill_tpu_torch.data.collator import DistillCollator
    cfg, t = params("kd_lora_0.6b", tiny=True)
    feats = KD.rows(cfg, t, 3, 0)
    ref = KD.reference_batch(cfg, t, feats)
    got = DistillCollator(cfg["eos_token_id"],
                          KD.SPEECH_BOS % cfg["vocab_size"],
                          t["pad_multiple"])(feats)
    assert np.array_equal(ref["ids"], got["input_ids"])
    assert np.array_equal(ref["mask"], got["attention_mask"])
    assert np.array_equal(ref["labels"], got["labels"])


def test_stage1_rows_by_seed():
    cfg, t = params("stage1_0.6b", tiny=True)
    a = S1.packed(cfg, t, 5, 0)
    assert np.array_equal(a, S1.packed(cfg, t, 5, 0))
    assert not np.array_equal(a, S1.packed(cfg, t, 6, 0))
    assert a.shape == (t["batch"] * t["accum"], t["seq"])
    old = cfg["vocab_size"] - t["new_tokens"]
    assert (a >= old).mean() > 0.5          # mostly new speech ids


def test_stage1_reference_packing_matches_the_program():
    from speech_distill_tpu_torch.pipelines.stage1 import pack_sequences
    cfg, t = params("stage1_0.6b", tiny=True)
    n, T = t["batch"] * t["accum"], t["seq"]
    ex = S1.examples(cfg, t, 5, 0, n * T)
    assert np.array_equal(pack_sequences(ex, T, cfg["eos_token_id"])[:n],
                          S1.packed(cfg, t, 5, 0))
