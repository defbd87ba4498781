"""Metrics logging, a profiler window and phase spans (port of
``speech_distill_tpu/core/metrics.py``).

``MetricsLogger`` always writes a JSONL record under the output directory
and a line on stdout; with ``report_to="wandb"`` it also logs to wandb
when wandb imports (and goes on without it when it does not).
``ProfilerWindow`` traces a window of training steps with
``torch.profiler`` (JAX: ``jax.profiler``) into a trace file that
TensorBoard's profiler plugin and Perfetto read, and writes the window's
:func:`span_table` beside it.

:func:`span` names a phase of the program (``train.forward``,
``data.wait``, ...). It records only while a ``torch.profiler`` records;
otherwise it is one shared no-op context. A recorded span is a
``record_function`` range on the profiler's timeline, a pair of CUDA
events on the current stream (the device's clock) and a pair of host
clock readings. :func:`span_table` sums them by name as self times.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "none",
                 write: bool = True, step: int = 0):
        """``write=False``: a silent sink (the ranks but the primary of a
        multi-process run: they must not race it on the shared
        metrics.jsonl and stdout). ``step``: the step the run starts from
        (a resumed run's), where the first record's steps are counted
        from."""
        self._write = write
        self._step_last = step
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
        """One record. Its ``time_per_step`` is the host interval since
        the last record over the steps taken in it, and ``tokens_per_sec``
        the tokens of those steps over the interval; the clock is read
        once the values are on the host (``float`` waits for the device).
        A record at the step of the last one (an eval after a training
        record) carries neither."""
        if not self._write:
            return
        values = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        dt = max(now - self._t_last, 1e-9)
        steps = step - self._step_last
        self._t_last, self._step_last = now, step
        rec: Dict[str, Any] = {"step": step}
        if steps > 0:
            rec["time_per_step"] = round(dt / steps, 4)
        rec.update(values)
        if tokens_per_step and steps > 0:
            rec["tokens_per_sec"] = round(tokens_per_step * steps / dt, 1)
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
    file: TensorBoard's profiler plugin and Perfetto read it), and the
    window's :func:`span_table` as ``spans.json`` beside it."""

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
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            span_table(reset=True)          # spans of an earlier profiler
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif step >= self.stop and self._prof is not None:
            self.close()

    def close(self):
        """Stop an open trace and write it, and its spans."""
        if self._prof is None:
            return
        self._prof.stop()
        torch.profiler.tensorboard_trace_handler(self.log_dir)(self._prof)
        self._prof = None
        with open(os.path.join(self.log_dir, "spans.json"), "w") as f:
            json.dump(span_table(reset=True), f, indent=1)


class _Span:
    """One recorded span: its range, its events and host readings, and
    the spans opened inside it."""
    __slots__ = ("name", "parent", "children", "range", "e0", "e1", "h0",
                 "h1")

    def __init__(self, name: str):
        self.name = name
        self.children: List["_Span"] = []

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.e0 = self.e1 = None
        if torch.cuda.is_initialized():
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        with _LOCK:
            self.parent = _STACK[-1] if _STACK else None
            _STACK.append(self)
        self.h0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.h1 = time.perf_counter()
        if self.e1 is not None:
            self.e1.record()
        with _LOCK:
            _STACK.remove(self)
            if self.parent is not None:
                self.parent.children.append(self)
            _CLOSED.append(self)
        self.range.__exit__(*exc)
        return False

    def device_s(self) -> Optional[float]:
        if self.e0 is None:
            return None
        return self.e0.elapsed_time(self.e1) * 1e-3


# the open spans, innermost last, and the closed ones: one stack for every
# thread, so a span the autograd engine's thread opens in a backward (the
# head's, a layer's recompute) is a child of the ``train.backward`` that
# the main thread holds open while it waits in ``autograd.grad``
_LOCK = threading.Lock()
_STACK: List[_Span] = []
_CLOSED: List[_Span] = []
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming a phase. It records only inside a recorded span
    or while a ``torch.profiler`` records; otherwise it is one shared no-op
    context, at the cost of one check."""
    if not _STACK and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def span_table(reset: bool = True) -> Dict[str, Dict[str, Any]]:
    """The closed spans by name: ``{name: {"n": calls, "device_s": self
    seconds on the device, "host_s": self seconds on the host}}``, one
    synchronise. A span's self time is its interval less its child spans'
    intervals; on the device the interval holds the time the stream
    waited for the host inside it, so the self times of all spans and the
    time outside them add up to the device's timeline. ``device_s`` is
    None where CUDA was not in use. ``reset`` forgets the spans read."""
    with _LOCK:
        closed = list(_CLOSED)
        if reset:
            _CLOSED.clear()
    if any(s.e0 is not None for s in closed):
        torch.cuda.synchronize()
    table: Dict[str, Dict[str, Any]] = {}
    for s in closed:
        row = table.setdefault(s.name, {"n": 0, "device_s": None,
                                        "host_s": 0.0})
        row["n"] += 1
        row["host_s"] += (s.h1 - s.h0) - sum(c.h1 - c.h0
                                             for c in s.children)
        d = s.device_s()
        if d is not None:
            kids = sum(c.device_s() or 0.0 for c in s.children)
            row["device_s"] = (row["device_s"] or 0.0) + d - kids
    return table
