#!/usr/bin/env python3
"""CPU rehearsal of a cell: its driver end to end at the tiny sizes of the
workload's ``rehearsal`` block, the program on the CPU (each kernel's
plain version), then the reference and the comparison. Prints the
numbers compared and the counters; no device metric.

    python3 benchmark/rehearse.py --workload kd_lora_0.6b [--seed 3] \
        [--seconds 2] [--fault half_batch|unchanged|alter_token]
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import core  # noqa: E402


def rehearse(workload: str, seed: int = 3, seconds: float = 2.0,
             fault: str = None) -> dict:
    core.env_for_run()
    bench = core.Bench(workload_name=workload, seed=seed, seconds=seconds,
                       trace=False, device="cpu",
                       t_start=time.perf_counter(), rehearsal=True)
    return core.driver(bench.workload["driver"]).run(bench, fault=fault)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    a = ap.parse_args()
    out = rehearse(a.workload, a.seed, a.seconds, a.fault)
    counters = {k: v for k, v in out["counters"].items() if k != "trace"}
    print(json.dumps({"checks": out["checks"], "counters": counters,
                      "attempted": out["attempted"]}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
