"""Metrics logging and a profiler window (port of
``speech_distill_tpu/core/metrics.py``).

``MetricsLogger`` always writes a JSONL record under the output directory
and a line on stdout; with ``report_to="wandb"`` it also logs to wandb
when wandb imports (and goes on without it when it does not).
``ProfilerWindow`` traces a window of training steps with
``torch.profiler`` (JAX: ``jax.profiler``) into a trace file that
TensorBoard's profiler plugin and Perfetto read.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "none",
                 write: bool = True):
        """``write=False``: a silent sink (the ranks but the primary of a
        multi-process run: they must not race it on the shared
        metrics.jsonl and stdout)."""
        self._write = write
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._wandb = None
        if not write:
            return
        os.makedirs(output_dir, exist_ok=True)
        if report_to == "wandb":
            try:
                import wandb
                wandb.init(project="speech-distill-tpu", name="run",
                           dir=output_dir)
                self._wandb = wandb
            except Exception:
                self._wandb = None
        self._t_last = time.perf_counter()

    def log(self, step: int, metrics: Dict[str, Any],
            tokens_per_step: Optional[int] = None):
        if not self._write:
            return
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        rec = {"step": step, "time_per_step": round(dt, 4)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if tokens_per_step:
            rec["tokens_per_sec"] = round(tokens_per_step / max(dt, 1e-9), 1)
        with open(self.path, "a") as f:     # one record, appended whole
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(rec, step=step)
        parts = " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                         else f"{k}={v}"
                         for k, v in rec.items() if k != "step")
        print(f"[step {step}] {parts}", flush=True)

    def close(self):
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


class ProfilerWindow:
    """A ``torch.profiler`` trace of the steps after ``on_step(start)``
    up to ``on_step(stop)``: the CPU and, where there is one, the CUDA
    activity, written by ``torch.profiler.tensorboard_trace_handler`` as
    ``<host>_<pid>.<ms>.pt.trace.json`` under ``log_dir`` (a Chrome-trace
    file: TensorBoard's profiler plugin and Perfetto read it)."""

    def __init__(self, log_dir: str, start: int = 10, stop: int = 13,
                 enabled: bool = False):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self.enabled = enabled
        self._prof = None

    def on_step(self, step: int):
        if not self.enabled:
            return
        if step == self.start and self._prof is None:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif step >= self.stop and self._prof is not None:
            self.close()

    def close(self):
        """Stop an open trace and write it."""
        if self._prof is None:
            return
        import torch
        self._prof.stop()
        torch.profiler.tensorboard_trace_handler(self.log_dir)(self._prof)
        self._prof = None
