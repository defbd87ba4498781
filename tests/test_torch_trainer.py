"""PyTorch port, host layer and loop: the collator and batch grouping
against the JAX package, and ``train_loop`` resume and retention. CPU."""
import json
import os

import numpy as np
import pytest
import torch

from speech_distill_tpu.core.trainer import batches_from as jax_batches_from
from speech_distill_tpu.data.collator import DistillCollator as JCollator
from speech_distill_tpu_torch.core.checkpoint import CheckpointManager
from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  qwen3_tiny)
from speech_distill_tpu_torch.core.trainer import (LoopConfig, batches_from,
                                                   train_loop)
from speech_distill_tpu_torch.core.tree import tree_leaves
from speech_distill_tpu_torch.data.collator import DistillCollator
from speech_distill_tpu_torch.distill import train_step
from speech_distill_tpu_torch.distill.lora import init_lora
from speech_distill_tpu_torch.models import qwen3

VOCAB, BOS = 64, 7


def _features(n=16, seed=0):
    rng = np.random.default_rng(seed)
    feats = []
    for _ in range(n):
        L = int(rng.integers(8, 14))
        ids = rng.integers(8, VOCAB, L)
        ids[int(rng.integers(1, 4))] = BOS                # speech starts
        feats.append({
            "student_input_ids": ids.tolist(),
            "student_attention_mask": [1] * L,
            "teacher_top_k_v": (rng.normal(size=(L, 4)) - 2).astype(
                np.float16),
            "teacher_top_k_i": rng.integers(0, VOCAB, (L, 4)).astype(
                np.int32)})
    return feats


@pytest.mark.parametrize("buffer", [None, 5], ids=["whole", "windowed"])
def test_collated_batches_match_jax(buffer):
    feats = _features(n=15)
    kw = dict(pad_token_id=0, speech_bos_id=BOS, pad_to_multiple_of=16,
              emit_speech_mask=True)
    got = list(batches_from(feats, DistillCollator(**kw), 2, 2,
                            shuffle_seed=3, epoch=1, drop_last=False,
                            shuffle_buffer=buffer))
    ref = list(jax_batches_from(feats, JCollator(**kw), 2, 2,
                                shuffle_seed=3, epoch=1, drop_last=False,
                                shuffle_buffer=buffer))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in g:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape
            np.testing.assert_array_equal(g[k], r[k])


def _run(out_dir, max_steps, save_total_limit=2, eval_fn=None):
    """A fresh state (the same every call) trained by ``train_loop`` up to
    ``max_steps``; resumes from ``out_dir`` if it holds checkpoints."""
    cfg = qwen3_tiny(VOCAB, dtype="float32", remat=False)
    model = qwen3.init_params(cfg, seed=0, device="cpu")
    dcfg = DistillConfig(lora=LoraConfig(r=4, alpha=8))
    lora, base = init_lora(model, cfg, dcfg.lora, device="cpu")
    opt = train_step.make_optimizer(1e-2, 1, 100)
    step = train_step.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                                   device="cpu")
    collate = DistillCollator(pad_token_id=0, speech_bos_id=BOS,
                              pad_to_multiple_of=16)
    feats = _features()

    def batch_iter(epoch):
        return batches_from(feats, collate, batch_size=2, accum=2,
                            shuffle_seed=0, epoch=epoch)
    loop = LoopConfig(num_epochs=2, max_steps=max_steps, logging_steps=1,
                      save_steps=1, save_total_limit=save_total_limit,
                      output_dir=out_dir)
    return train_loop(step, train_step.init_state(lora, opt), (base, None),
                      batch_iter, loop, eval_fn=eval_fn, device="cpu")


def test_train_loop_resume_equals_uninterrupted_run(tmp_path):
    """Stopped at step 2 and resumed to step 5 (across the epoch boundary
    at 4) == an uninterrupted run to step 5; retention keeps
    save_total_limit checkpoints; metrics are logged every step."""
    whole = _run(str(tmp_path / "whole"), 5)
    part = str(tmp_path / "part")
    assert _run(part, 2).step == 2
    resumed = _run(part, 5)
    assert whole.step == resumed.step == 5
    assert resumed.opt_state["count"] == 5
    for a, b in zip(tree_leaves(whole.trainable),
                    tree_leaves(resumed.trainable)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert CheckpointManager(os.path.join(part, "ckpt")).steps() == [4, 5]
    with open(os.path.join(part, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3, 4, 5]


def test_train_loop_loads_the_best_eval_state(tmp_path):
    """With an eval_fn, the loop evaluates per epoch and ends on the state
    of the best eval loss (here the end of epoch 1, step 4)."""
    losses = iter([1.0, 2.0])
    evaluated = []

    def eval_fn(state):
        evaluated.append(state.step)
        return {"loss": next(losses)}
    final = _run(str(tmp_path / "best"), 6, save_total_limit=5,
                 eval_fn=eval_fn)
    assert evaluated == [4, 6] and final.step == 4
    at4 = CheckpointManager(str(tmp_path / "best" / "ckpt")).restore(
        final, 4)
    for a, b in zip(tree_leaves(final.trainable),
                    tree_leaves(at4.trainable)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_checkpoint_round_trip_and_retention(tmp_path):
    st = train_step.TrainState(
        {"a": torch.arange(4.0).requires_grad_()},
        {"count": 3, "mu": {"a": torch.ones(4)}}, 3)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore(st) is None
    for s in (1, 2, 3):
        mgr.save(s, st)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    back = mgr.restore(st)
    assert isinstance(back, train_step.TrainState) and back.step == 3
    assert back.trainable["a"].requires_grad
    torch.testing.assert_close(back.trainable["a"], st.trainable["a"])
    assert back.opt_state["count"] == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore(st, 1)
