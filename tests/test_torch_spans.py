"""PyTorch port, ``core/metrics.span``: the phase spans of the training
steps. Off without a profiler; self times under one; the KD and stage-1
steps' phases and their counts; the same outputs with and without the
profiler. CPU (no device clock: ``device_s`` is None)."""
import json
import threading

import numpy as np
import pytest
import torch

from speech_distill_tpu_torch.core import metrics
from speech_distill_tpu_torch.core.config import (DistillConfig, LoraConfig,
                                                  qwen3_tiny)
from speech_distill_tpu_torch.core.metrics import span, span_table
from speech_distill_tpu_torch.core.prefetch import prefetch
from speech_distill_tpu_torch.core.tree import tree_leaves
from speech_distill_tpu_torch.distill import train_step as tts
from speech_distill_tpu_torch.distill.lora import init_lora
from speech_distill_tpu_torch.models import qwen3

VOCAB, OLD, LAYERS = 96, 64, 2
PHASES = {"train.forward", "train.head", "train.backward",
          "train.recompute", "train.optimizer"}


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_table():
    span_table(reset=True)
    yield
    span_table(reset=True)


class _Clock:
    """A host clock that moves only when told."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def test_off_without_a_profiler_records_nothing():
    a, b = span("train.forward"), span("train.head")
    assert a is b
    with a:
        with span("train.backward"):
            pass
    assert span_table() == {}


def test_self_times_add_up_to_the_root(monkeypatch):
    """Each span's self time is its interval less its children's; the
    self times of a tree add up to its root's interval. A span opened on
    another thread inside an open one is its child."""
    clock = _Clock()
    monkeypatch.setattr(metrics, "time", clock)

    def worker():
        with span("child"):
            clock.t += 3.0

    with _profiler():
        with span("root"):
            with span("a"):
                clock.t += 5.0
                with span("b"):
                    clock.t += 3.0
            with span("b"):
                clock.t += 2.0
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
            clock.t += 4.0
    table = span_table()
    host = {k: v["host_s"] for k, v in table.items()}
    assert host == {"root": 4.0, "a": 5.0, "b": 5.0, "child": 3.0}
    assert sum(host.values()) == clock.t == 17.0
    assert {k: v["n"] for k, v in table.items()} == {
        "root": 1, "a": 1, "b": 2, "child": 1}
    assert all(v["device_s"] is None for v in table.values())
    assert span_table() == {}                  # read with reset


def test_data_wait_spans_the_prefetch_queue():
    with _profiler():
        assert list(prefetch(iter(range(3)))) == [0, 1, 2]
    assert span_table()["data.wait"]["n"] == 4   # 3 items and the end


def _batch(kind, seed=0, B=2, T=10, K=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (1, B, T)).astype(np.int32)
    labels = ids.astype(np.int64).copy()
    labels[..., :2] = -100
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids),
             "labels": labels}
    if kind == "kd":
        batch["teacher_top_k_v"] = (rng.normal(size=(1, B, T, K)) - 3
                                    ).astype(np.float32)
        batch["teacher_top_k_i"] = np.argsort(
            rng.random((1, B, T, VOCAB)), axis=-1)[..., :K].astype(np.int32)
    return batch


def _run(kind, remat, steps, profile, trace_path=None):
    """``steps`` steps of the tiny KD (LoRA, the fused head) or stage-1
    (K2's plain route) step from one initial state; returns the metrics,
    the trained leaves and the span table."""
    cfg = qwen3_tiny(VOCAB, dtype="float32", num_hidden_layers=LAYERS,
                     remat=remat)
    model = qwen3.init_params(cfg, seed=0, device="cpu")
    opt = tts.make_optimizer(1e-2, 1, 10)
    if kind == "kd":
        dcfg = DistillConfig(lora=LoraConfig(r=2, alpha=4,
                                             init_weights="gaussian"))
        lora, model = init_lora(model, cfg, dcfg.lora,
                                generator=torch.Generator().manual_seed(1),
                                device="cpu")
        step = tts.make_kd_step(cfg, dcfg, opt, mode="precomputed",
                                donate=False, device="cpu")
        state = tts.init_state(lora, opt)

        def run(state, batch):
            return step(state, model, None, batch)
    else:
        step = tts.make_stage1_step(cfg, opt, OLD, donate=False,
                                    fused_loss=True, fused_backend="pallas",
                                    device="cpu")
        state = tts.init_state({"embed": {"weight": model.embed.detach()
                                          .clone().requires_grad_()}}, opt)

        def run(state, batch):
            return step(state, model, batch)
    out = []
    prof = _profiler() if profile else None
    if prof is not None:
        prof.__enter__()
    try:
        for i in range(steps):
            state, m = run(state, _batch(kind, seed=i))
            out.append({k: v.detach().clone() for k, v in m.items()})
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return out, [t.detach().clone() for t in tree_leaves(state.trainable)], \
        span_table()


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("kind", ["kd", "stage1"])
def test_step_spans_name_the_phases(tmp_path, kind, remat):
    """Under a profiler the step records exactly its phases: the forward
    twice a step (the batch's placement, the microbatch), the head twice
    (its forward and its backward inside ``train.backward``), one
    backward and one optimizer update, and a recompute a layer a step
    under remat "full"; the Chrome trace carries the same names."""
    steps = 2
    path = tmp_path / "trace.json"
    _, _, table = _run(kind, remat, steps, True, path)
    want = PHASES if remat else PHASES - {"train.recompute"}
    assert set(table) == want
    n = {k: v["n"] for k, v in table.items()}
    assert n == {"train.forward": 2 * steps, "train.head": 2 * steps,
                 "train.backward": steps, "train.optimizer": steps,
                 **({"train.recompute": LAYERS * steps} if remat else {})}
    assert all(v["device_s"] is None and v["host_s"] >= 0
               for v in table.values())
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert want <= names


@pytest.mark.parametrize("kind", ["kd", "stage1"])
def test_children_of_the_backward(monkeypatch, kind):
    """The head's backward and each recompute are children of the
    ``train.backward`` that holds ``autograd.grad``."""
    parents = []
    real_exit = metrics._Span.__exit__

    def exit_(self, *exc):
        if self.name in ("train.recompute", "train.head"):
            parents.append((self.name, self.parent and self.parent.name))
        return real_exit(self, *exc)
    monkeypatch.setattr(metrics._Span, "__exit__", exit_)
    _run(kind, True, 1, True)
    assert set(parents) == {("train.head", None),
                            ("train.head", "train.backward"),
                            ("train.recompute", "train.backward")}


@pytest.mark.parametrize("kind", ["kd", "stage1"])
def test_profiler_changes_no_output(kind):
    """Loss, grad norm and every updated leaf are bit-identical with and
    without the profiler (and its spans)."""
    m_off, leaves_off, table_off = _run(kind, True, 2, False)
    m_on, leaves_on, table_on = _run(kind, True, 2, True)
    assert table_off == {} and set(table_on) == PHASES
    for a, b in zip(m_off, m_on):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(leaves_off, leaves_on))
