"""What every cell's run shares: the manifest and the files it names, the
benchmark's own host spans, the check that no JAX module was loaded, and
the result line.

Nothing here imports the program: the drivers do, inside their functions.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# top-level module names that must never be loaded by a run (compared
# whole: ``speech_distill_tpu_torch`` is the program, ``speech_distill_tpu``
# the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speech_distill_tpu")


def forbidden_loaded() -> list:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file at ``path`` as a module called ``name`` (file names
    may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def driver(name: str):
    return load_module(BENCH_DIR / "drivers" / f"{name}.py",
                       f"bench_driver_{name}")


def metric(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


# the decoder the CPU rehearsal and the tests run every configuration at
TINY = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16,
        "speech_token_offset": 256, "eos_token_id": 511}


class Spans:
    """The benchmark's own host spans: seconds by name, taken
    around its calls into the program. Under a profiler each span is also
    a ``record_function`` range, so a trace names the idle gaps by it."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        t = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            try:
                yield
            finally:
                dt = time.perf_counter() - t
                self.seconds[name] = self.seconds.get(name, 0.0) + dt


class Bench:
    """One run of one cell: its arguments, files and device, handed to the
    cell's driver."""

    def __init__(self, *, workload_name: str, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float,
                 rehearsal: bool = False):
        self.workload_name = workload_name
        w = workload(workload_name)
        mix = traffic(w["traffic"])
        params = dict(mix["params"])
        self.config_name = w["config"]
        self.config = config(self.config_name)
        if rehearsal:
            # the tiny sizes the CPU rehearsal and the tests run at, and the
            # limits set from readings at those sizes
            self.config = {**self.config, **TINY}
            params.update(mix["rehearsal"])
            w = {**w, "limits": w["rehearsal_limits"]}
        # the cell with its traffic mix's driver and parameters in place
        self.workload = {**w, "traffic_name": w["traffic"],
                         "driver": mix["driver"], "traffic": params}
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.spans = Spans()
        self.t_window0: Optional[float] = None

    def window_opens(self) -> float:
        """Set-up ends here; returns the window's start on the host clock."""
        self.t_window0 = time.perf_counter()
        return self.t_window0

    @property
    def setup_s(self) -> float:
        return self.t_window0 - self.t_start


def print_checks(checks: Dict[str, Dict[str, Any]]) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c.get('ok') else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()


def env_for_run() -> None:
    """Caches inside the checkout at fixed paths, and no library loading
    JAX by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
