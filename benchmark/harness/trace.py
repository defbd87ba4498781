"""The traced sub-window: ``torch.profiler`` over a few steady seconds, and
its reduction to what the per-layer metrics read.

The trace is written as Chrome JSON under ``TMPDIR``, read back and
deleted. Device operations are the kernels, copies and sets of the
trace; the device is busy where any of them runs (the union of their
intervals), idle elsewhere in the window. The metrics' sub-window records
the device alone: recording every host operator as well slows a
host-bound step by half or more, and its idle share with it. A second,
shorter sub-window records both, to name each idle gap by the innermost
host event open at its middle: an operator of the program, or the
benchmark's own span (``bench.*``), or ``host`` where neither is.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Reduced:
    """A reduced trace: device operations by name, busy and window
    seconds, idle gaps by host activity."""

    def __init__(self, ops: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_s: float):
        self.ops = ops                 # (name, start us, duration us)
        self.window_s = window_s
        iv = sorted((s, s + d) for _, s, d in ops)
        merged: List[List[float]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-6
        self.gaps = self._name_gaps(merged, host)

    @staticmethod
    def _name_gaps(merged, host) -> Dict[str, float]:
        host = sorted(host, key=lambda h: h[1])
        out: Dict[str, float] = defaultdict(float)
        j = 0
        open_: List[Tuple[str, float, float]] = []
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = 0.5 * (e0 + s1)
            while j < len(host) and host[j][1] <= mid:
                open_.append(host[j])
                j += 1
            open_ = [h for h in open_ if h[1] + h[2] >= mid]
            # innermost: the latest start among those still open
            name = max(open_, key=lambda h: h[1])[0] if open_ else "host"
            out[name] += (s1 - e0) * 1e-6
        return dict(out)

    def time_of(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(d for n, _, d in self.ops
                   if any(x in n for x in needles)) * 1e-6

    def count_of(self, *needles: str) -> int:
        return sum(1 for n, _, _ in self.ops if any(x in n for x in needles))

    def breakdown(self, top: int = 10) -> dict:
        by: Dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            by[short(n)] += d * 1e-6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short(name: str, n: int = 96) -> str:
    """A kernel's name without its template arguments and parameters."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    base = base.split("(")[0].split("<")[0]
    return base[:n]


class Profile:
    """Start and stop ``torch.profiler`` around a sub-window of the run;
    ``reduced`` holds the result once stopped. Never started: None.
    ``host``: record the host's operators too (to name the gaps)."""

    def __init__(self, host: bool = False):
        self.host = host
        self.reduced: Optional[Reduced] = None
        self._prof = None
        self._t0 = 0.0

    @property
    def running(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.host:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        ops, host = [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            item = (ev.get("name", "?"), float(ev["ts"]),
                    float(ev.get("dur", 0.0)))
            if cat in DEVICE_CATS:
                ops.append(item)
            elif cat in HOST_CATS:
                host.append(item)
        if not ops:
            raise RuntimeError("the profiler recorded no device operation "
                               "in the traced window")
        self.reduced = Reduced(ops, host, window_s)


class Traced:
    """The two sub-windows of a traced run, one after the other: the
    device alone (the metrics), then device and host (the gaps' names)."""

    def __init__(self):
        self.device, self.named = Profile(), Profile(host=True)

    @property
    def done(self) -> bool:
        return self.named.reduced is not None

    def next(self) -> None:
        """Start the first sub-window, or end the running one (and start
        the second after the first)."""
        if self.device.running:
            self.device.stop()
            self.named.start()
        elif self.named.running:
            self.named.stop()
        else:
            self.device.start()

    @property
    def reduced(self) -> Optional[Reduced]:
        """The device sub-window's reduction, its gaps named by the
        second's."""
        if not self.done:
            return None
        r = self.device.reduced
        r.gaps = self.named.reduced.gaps
        return r
