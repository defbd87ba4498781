#!/usr/bin/env python3
"""The training step's phases on the card: one traced run of a benchmark
cell (``benchmark/run.py``, its result line printed as usual) with the
program's spans (``core/metrics.span``) read over the traced steps of its
device sub-window, beside that sub-window's kernels.

    python3 scripts/train_spans.py --workload stage1_0.6b --seed 7 \
        --seconds 10 [--out spans.jsonl]

Prints one more JSON line (``spans ...``, also appended to ``--out``):
each span's calls, device and host self ms a step; the sub-window's
device ms a step and the share of it outside every ``train.*`` span; the
sum check (every span's self time and the time outside all of them
against the sub-window's own pair of CUDA events); each phase beside the
kernels it must hold (K1-fwd in the forward and the recompute, K1-dq and
-dkv in the backward, K2 in the head); the device ms of each kind of
kernel by the phase that launched it, and the device's idle ms by the
innermost span open on the host, from the host-and-device sub-window's
step; and the host cost of a span, live and idle.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K1_FWD = ("flash_fwd_kernel",)
K1_BWD = ("flash_dq_kernel", "flash_dkv_kernel")
K2 = ("lm_head_stats_kernel", "lm_head_combine_kernel", "lm_head_dl_kernel",
      "lm_head_gemm_kernel")
# kinds of device operation, by a piece of the name; the first match wins
KINDS = (("k1", ("flash_",)), ("k2", ("lm_head_",)),
         ("fused_norm", ("rms_norm_", "qk_norm_rope_", "swiglu_")),
         ("elementwise", ("elementwise_kernel",)), ("reduce", ("reduce_",)),
         ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
         ("copy", ("Memcpy", "Memset", "CatArray", "copy")))


def hook_traced(got: dict) -> None:
    """Make the benchmark's traced sub-windows hand the device sub-window's
    spans to ``got``: a root span ``bench.window`` and a pair of CUDA events
    around its steps, the table read after its profiler stops."""
    import torch

    from benchmark.harness import trace
    from speech_distill_tpu_torch.core.metrics import span, span_table
    plain = trace.Traced.next
    load = trace.json.load

    def keep(f):
        # the raw events of each sub-window (the trace file is deleted)
        out = load(f)
        got.setdefault("events", []).append(out.get("traceEvents", []))
        return out
    trace.json = type("Json", (), {"load": staticmethod(keep)})

    def next_(self):
        if self.device.running:
            got["root"].__exit__(None, None, None)
            got["e1"].record()
            self.device.stop()
            got["table"] = span_table(reset=True)
            got["window_ms"] = got["e0"].elapsed_time(got["e1"])
            got["reduced"] = self.device.reduced
            self.named.start()
            return
        plain(self)
        if self.device.running:
            span_table(reset=True)
            got["e0"] = torch.cuda.Event(enable_timing=True)
            got["e1"] = torch.cuda.Event(enable_timing=True)
            got["e0"].record()
            got["root"] = span("bench.window")
            got["root"].__enter__()
    trace.Traced.next = next_


def phases(table: dict, window_ms: float, reduced) -> dict:
    """The spans a step, the sum check and the kernels' floors."""
    steps = table["train.optimizer"]["n"]
    per = {k: {"n": v["n"] / steps,
               "device_ms": 1e3 * v["device_s"] / steps,
               "host_ms": 1e3 * v["host_s"] / steps}
           for k, v in sorted(table.items())}
    total = sum(v["device_s"] for v in table.values()) * 1e3
    train = sum(v["device_s"] for k, v in table.items()
                if k.startswith("train.")) * 1e3
    ms = {k: v["device_ms"] for k, v in per.items()}

    def kernels(names):
        return 1e3 * reduced.time_of(*names) / steps
    k1_fwd, k1_bwd, k2 = kernels(K1_FWD), kernels(K1_BWD), kernels(K2)
    fwd = ms.get("train.forward", 0.0) + ms.get("train.recompute", 0.0)
    return {
        "steps": steps, "spans": per,
        "window_ms_a_step": window_ms / steps,
        "outside_train_share": 1.0 - train / window_ms,
        "sum_gap": abs(total - window_ms) / window_ms,
        "busy_share": reduced.busy_s / reduced.window_s,
        "kernels_ms_a_step": {"k1_fwd": k1_fwd, "k1_bwd": k1_bwd, "k2": k2},
        "holds": {"fwd+recompute>=k1_fwd": fwd >= k1_fwd,
                  "bwd>=k1_dq+dkv": ms.get("train.backward", 0.0) >= k1_bwd,
                  "head>=k2": ms.get("train.head", 0.0) >= k2},
    }


def kind(name: str) -> str:
    for k, needles in KINDS:
        if any(x in name for x in needles):
            return k
    return "other"


def by_phase(events: list, steps: int = 1) -> dict:
    """Device ms a step of each kind of operation, by the innermost span
    open on the launching thread when it was launched (or on any thread,
    for a launch from the autograd engine's thread outside its own
    spans); ``outside`` where none was open."""
    spans, launches, ops = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args", {})
        if cat == "user_annotation" and "." in ev.get("name", ""):
            spans.append((ev["tid"], float(ev["ts"]),
                          float(ev["ts"]) + float(ev.get("dur", 0)),
                          ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (ev["tid"], float(ev["ts"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append((args.get("correlation"), ev.get("name", "?"),
                        float(ev.get("dur", 0))))
    out: dict = {}
    for corr, name, dur in ops:
        tid, t = launches.get(corr, (None, None))
        phase = "outside"
        if t is not None:
            around = [s for s in spans if s[1] <= t <= s[2]]
            mine = [s for s in around if s[0] == tid] or around
            if mine:
                phase = max(mine, key=lambda s: s[1])[3]
        row = out.setdefault(phase, {})
        k = kind(name)
        row[k] = row.get(k, 0.0) + dur * 1e-3 / steps
    return out


def idle_by_phase(events: list) -> dict:
    """Idle device ms between consecutive device operations, by the
    innermost span open on the host (any thread) at the gap's middle."""
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                    ev["name"]) for ev in events
                   if ev.get("ph") == "X" and ev.get("cat") ==
                   "user_annotation" and "." in ev.get("name", ""))
    iv = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
                for ev in events if ev.get("ph") == "X" and ev.get("cat") in
                ("kernel", "gpu_memcpy", "gpu_memset"))
    merged: list = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out: dict = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        around = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        name = max(around)[2] if around else "outside"
        out[name] = out.get(name, 0.0) + (s1 - e0) * 1e-3
    return out


def span_cost(n: int = 20000) -> dict:
    """Host microseconds a span costs: live (a CUDA-only profiler
    records, as in the benchmark's device sub-window) and idle."""
    import torch

    from speech_distill_tpu_torch.core.metrics import span, span_table
    out = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            with span("cost"):
                pass
        out["live_us"] = (time.perf_counter() - t) / n * 1e6
        out["live_recorded"] = span_table(reset=True).get("cost", {}).get(
            "n")
        # its parts: the profiler's range, and a pair of timed events
        t = time.perf_counter()
        for _ in range(n):
            with torch.profiler.record_function("cost"):
                pass
        out["range_us"] = (time.perf_counter() - t) / n * 1e6
        t = time.perf_counter()
        for _ in range(n):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            e1.record()
        out["events_us"] = (time.perf_counter() - t) / n * 1e6
        t = time.perf_counter()
        for _ in range(n):
            e0.record()
            e1.record()
        out["records_us"] = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for _ in range(n):
        e0.record()
        e1.record()
    out["records_unprofiled_us"] = (time.perf_counter() - t) / n * 1e6
    t = time.perf_counter()
    for _ in range(n):
        with span("cost"):
            pass
    out["idle_us"] = (time.perf_counter() - t) / n * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    from benchmark import run
    got: dict = {}
    hook_traced(got)
    rc = run.main(["--workload", a.workload, "--seed", str(a.seed),
                   "--seconds", str(a.seconds), "--trace", "1"])
    if rc != 0 or "table" not in got:
        print(f"no traced spans (rc {rc})", file=sys.stderr)
        return rc or 1
    rec = {"workload": a.workload, "seed": a.seed,
           **phases(got["table"], got["window_ms"], got["reduced"]),
           "named_step_by_phase": by_phase(got["events"][-1]),
           "named_step_idle_by_phase": idle_by_phase(got["events"][-1]),
           "span_cost": span_cost()}
    line = json.dumps(rec)
    print("spans " + line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
