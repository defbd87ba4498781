#!/usr/bin/env python3
"""Run one cell of the benchmark of ``speech_distill_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's file (``benchmark/workloads/<cell>.json``) names its
configuration, its driver and its metrics. The driver builds the
program's inputs and weights from ``--seed``, warms every shape the cell
uses (set-up), measures for ``--seconds``, then checks what the timed path
produced against the plain reference. With ``--trace 0`` the result
carries the cell's end-to-end metrics; with ``--trace 1`` a profiled
sub-window gives its per-layer metrics and ``breakdown``. The last line
of standard output is the result, a JSON object; the numbers compared
for ``correct`` are also the last lines of standard error.

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, or if a JAX module was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import core  # noqa: E402


class RunView:
    """What a per-layer metric's reader sees of a run."""

    def __init__(self, bench, out: dict):
        self.config = bench.config
        self.traffic = bench.workload["traffic"]
        self.counters = out["counters"]
        self.trace = out["counters"].get("trace")
        self.shapes = out.get("shapes", {})
        self.end_to_end = out["end_to_end"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core.env_for_run()
    import torch

    man = core.manifest()
    cell = {w["name"]: w for w in man["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    bench = core.Bench(workload_name=args.workload, seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device="cuda:0", t_start=T_START)
    out = core.driver(bench.workload["driver"]).run(bench)

    units = {m["name"]: m["unit"]
             for m in man["end_to_end"] + man["per_layer"]}
    metrics = {}
    if args.trace:
        view = RunView(bench, out)
        for name in bench.workload["per_layer"]:
            v = core.metric(name).read(view)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        values = {**out["end_to_end"], "setup_s": bench.setup_s}
        for name in bench.workload["end_to_end"]:
            metrics[name] = {"value": values[name], "unit": units[name]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c["ok"] for c in out["checks"].values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    tr = out["counters"].get("trace")
    if args.trace:
        if tr is None:
            print("the traced run recorded no trace", file=sys.stderr)
            return 3
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    extra = {k: v for k, v in out["counters"].items()
             if k in ("steps", "window_s", "launches")}
    print("counters " + json.dumps(extra, default=str), file=sys.stderr)
    bad = core.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in out["checks"].items()}
    core.print_checks(out["checks"])
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
