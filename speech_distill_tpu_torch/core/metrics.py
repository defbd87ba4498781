"""Metrics logging (port of ``MetricsLogger`` in
``speech_distill_tpu/core/metrics.py``).

A JSONL sink under the output directory and a line on stdout each
``logging_steps``; ``report_to`` other than "none" (wandb in the JAX
package) is not ported and raises. The JAX ``ProfilerWindow`` waits:
``chip_smoke.py`` traces a training step with ``torch.profiler`` itself.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "none"):
        if report_to != "none":
            raise NotImplementedError(
                f"report_to={report_to!r}: only 'none' (JSONL) is ported")
        self.path = os.path.join(output_dir, "metrics.jsonl")
        os.makedirs(output_dir, exist_ok=True)
        self._t_last = time.perf_counter()

    def log(self, step: int, metrics: Dict[str, Any],
            tokens_per_step: Optional[int] = None):
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        rec = {"step": step, "time_per_step": round(dt, 4)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if tokens_per_step:
            rec["tokens_per_sec"] = round(tokens_per_step / max(dt, 1e-9), 1)
        with open(self.path, "a") as f:     # one record, appended whole
            f.write(json.dumps(rec) + "\n")
        parts = " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                         else f"{k}={v}"
                         for k, v in rec.items() if k != "step")
        print(f"[step {step}] {parts}", flush=True)
