"""PyTorch port, ``core/metrics``: the JSONL logger against the JAX one
(``report_to="wandb"`` without wandb falls back to the JSONL, as JAX does),
and the profiler window, alone and under ``train_loop`` with
``SDT_PROFILE``. CPU."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from speech_distill_tpu.core.metrics import MetricsLogger as JaxLogger
from speech_distill_tpu_torch.core.metrics import (MetricsLogger,
                                                   ProfilerWindow)
from speech_distill_tpu_torch.core.trainer import LoopConfig, train_loop


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("time_per_step", "tokens_per_sec")}
                for line in f]


@pytest.mark.parametrize("report_to", ["wandb", "none"])
def test_metrics_logger_writes_jax_records(tmp_path, monkeypatch, capsys,
                                           report_to):
    """With wandb unimportable, both loggers write the same JSONL records
    (less the timing fields) and the same step lines."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    logs = {}
    for name, cls in (("jax", JaxLogger), ("port", MetricsLogger)):
        d = tmp_path / name
        lg = cls(str(d), report_to)
        lg.log(1, {"loss": 1.0, "grad_norm": np.float32(0.5)})
        lg.log(2, {"loss": torch.tensor(0.25)}, tokens_per_step=64)
        lg.log(3, {"eval_loss": 2.0})
        lg.close()
        out = capsys.readouterr().out.splitlines()
        logs[name] = (_records(d / "metrics.jsonl"),
                      [ln.split(" time_per_step")[0] for ln in out])
    assert logs["port"] == logs["jax"]
    assert logs["port"][0][0] == {"step": 1, "loss": 1.0, "grad_norm": 0.5}
    assert len(logs["port"][1]) == 3


def _traces(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".pt.trace.json")) \
        if os.path.isdir(d) else []


def test_profiler_window_traces_steps_10_to_13(tmp_path):
    """Enabled: one Chrome-trace file holding the ops run after step 10's
    on_step and before step 13's; disabled: none."""
    on, off = tmp_path / "on", tmp_path / "off"
    for d, enabled in ((on, True), (off, False)):
        win = ProfilerWindow(str(d), start=10, stop=13, enabled=enabled)
        for step in range(1, 16):
            with torch.profiler.record_function(f"step_{step}"):
                torch.ones(8).sum()
            win.on_step(step)
        win.close()
    files = _traces(on)
    assert len(files) == 1 and _traces(off) == []
    with open(on / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step_11", "step_12", "step_13"} <= names
    assert not names & {"step_10", "step_14"}


def test_train_loop_profiles_under_sdt_profile(tmp_path, monkeypatch):
    """SDT_PROFILE=<dir> makes train_loop trace its steps 11-13 into it;
    the loop's metrics.jsonl still holds every logged step."""
    trace = tmp_path / "trace"
    monkeypatch.setenv("SDT_PROFILE", str(trace))

    def step_fn(state, batch):
        w = state["w"] + torch.as_tensor(batch["x"]).float().sum()
        return {"w": w}, {"loss": w}

    def batches(epoch):
        for i in range(15):
            yield {"x": np.full((1, 1, 2), i, np.float32)}

    out = tmp_path / "run"
    state = train_loop(step_fn, {"w": torch.zeros(())}, (), batches,
                       LoopConfig(num_epochs=1, logging_steps=5,
                                  output_dir=str(out)), device="cpu")
    assert float(state["w"]) == 2 * sum(range(15))
    assert len(_traces(trace)) == 1
    assert [r["step"] for r in _records(out / "metrics.jsonl")] == [5, 10, 15]


def test_metrics_logger_times_the_steps_between_records(tmp_path,
                                                        monkeypatch):
    """time_per_step is the interval since the last record over the steps
    in it, tokens_per_sec those steps' tokens over it, the clock read once
    the values are on the host; an eval record at the same step carries
    neither, and a resumed run counts from its first step."""
    from speech_distill_tpu_torch.core import metrics as metrics_mod

    class Clock:
        t = 0.0

        def perf_counter(self):
            return self.t
    clock = Clock()
    monkeypatch.setattr(metrics_mod, "time", clock)

    class Synced:
        """A value whose read waits 1 s (a device synchronise)."""

        def __float__(self):
            clock.t += 1.0
            return 0.5

    lg = MetricsLogger(str(tmp_path / "a"))
    clock.t = 4.0
    lg.log(10, {"loss": Synced()}, tokens_per_step=100)    # 5 s, 10 steps
    clock.t = 6.0
    lg.log(10, {"eval_loss": 2.0})
    clock.t = 8.0
    lg.log(15, {"loss": 1.0}, tokens_per_step=100)          # 2 s, 5 steps
    resumed = MetricsLogger(str(tmp_path / "b"), step=20)
    clock.t = 11.0
    resumed.log(30, {"loss": 1.0}, tokens_per_step=100)     # 3 s, 10 steps
    recs = [json.loads(line) for path in ("a", "b")
            for line in open(tmp_path / path / "metrics.jsonl")]
    assert recs == [
        {"step": 10, "time_per_step": 0.5, "loss": 0.5,
         "tokens_per_sec": 200.0},
        {"step": 10, "eval_loss": 2.0},
        {"step": 15, "time_per_step": 0.4, "loss": 1.0,
         "tokens_per_sec": 250.0},
        {"step": 30, "time_per_step": 0.3, "loss": 1.0,
         "tokens_per_sec": 333.3}]


def test_train_loop_writes_the_window_spans(tmp_path, monkeypatch):
    """Under SDT_PROFILE the window's spans (steps 11-13 and their batches'
    waits) are written as spans.json beside the trace."""
    from speech_distill_tpu_torch.core.metrics import span
    trace = tmp_path / "trace"
    monkeypatch.setenv("SDT_PROFILE", str(trace))

    def step_fn(state, batch):
        with span("train.forward"):
            w = state["w"] + torch.as_tensor(batch["x"]).float().sum()
        with span("train.optimizer"):
            return {"w": w}, {"loss": w}

    def batches(epoch):
        for i in range(15):
            yield {"x": np.full((1, 1, 2), i, np.float32)}

    train_loop(step_fn, {"w": torch.zeros(())}, (), batches,
               LoopConfig(num_epochs=1, logging_steps=5,
                          output_dir=str(tmp_path / "run")), device="cpu")
    with open(trace / "spans.json") as f:
        table = json.load(f)
    assert {k: v["n"] for k, v in table.items()} == {
        "data.wait": 3, "train.forward": 3, "train.optimizer": 3}
    assert all(v["device_s"] is None and v["host_s"] >= 0
               for v in table.values())
