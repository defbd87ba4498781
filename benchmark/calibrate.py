#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card at the cell's own size,
many seeds in one process: the program's, the control's (the reference
computed with float8 linear layers in the program's place) and each fault
the cell can have, every one against the float32 reference.

    python3 benchmark/calibrate.py --workload kd_lora_0.6b \
        --seeds 11 12 13 [--faults half_batch] [--control]

Per seed the first steps of the program (and of each faulty program) and
of the control, no window. One JSON line a seed and kind on standard
output. Needs the card; the benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import core, training  # noqa: E402


def values(checks: dict) -> dict:
    return {k: c["value"] for k, c in checks.items()}


def train_seed(drv, bench, faults, control: bool) -> list:
    t = bench.workload["traffic"]
    split = (drv.split_rows(bench.config["vocab_size"] - t["new_tokens"])
             if hasattr(drv, "split_rows") else None)
    progs = {}
    for kind in [None] + list(faults):
        t0 = time.perf_counter()
        prog = drv.Program(bench, fault=kind)
        _, readings = training.first_steps(
            prog.run_step, prog.state, prog.feed, t["max_grad_norm"],
            t["check_steps"], split)
        prog.feed.close()
        del prog
        training.free_program()
        progs[kind or "program"] = (readings, time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref = drv.reference(bench, "fp32")
    ref_s = time.perf_counter() - t0
    training.free_program()
    out = []
    for kind, (readings, s) in progs.items():
        c = training.compare(readings, ref, {})
        out.append({"seed": bench.seed, "kind": kind, "s": s,
                    "reference_s": ref_s, **values(c),
                    "leaves": [c["grad_gap"]["leaf"],
                               c["change_gap"]["leaf"]],
                    "loss": readings["loss"], "ref_loss": ref["loss"]})
    if control:
        ctl = drv.reference(bench, "fp8")
        training.free_program()
        c = training.compare(ctl, ref, {})
        out.append({"seed": bench.seed, "kind": "control_fp8", **values(c),
                    "leaves": [c["grad_gap"]["leaf"],
                               c["change_gap"]["leaf"]]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args()
    core.env_for_run()
    import torch
    if not torch.cuda.is_available():
        print("calibration needs the card", file=sys.stderr)
        return 2
    for seed in a.seeds:
        bench = core.Bench(workload_name=a.workload, seed=seed,
                           seconds=0.0, trace=False, device="cuda:0",
                           t_start=time.perf_counter())
        drv = core.driver(bench.workload["driver"])
        for row in train_seed(drv, bench, a.faults, a.control):
            print(json.dumps(row, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
