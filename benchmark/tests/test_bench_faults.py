"""A run with the timed path broken underneath comes out not correct; the
sound run and the control come out as they should. Each cell's driver
runs end to end on the CPU at its tiny rehearsal sizes (the look for a
card skipped), against the cell's ``rehearsal_limits``, set from readings
at those sizes as the cell's limits are at its own. ``card`` tests run
each control at the cell's own size."""
import time

import pytest

from benchmark.harness import core, training
from benchmark.rehearse import rehearse

FAULTS = {"kd_lora_0.6b": ["unchanged", "half_batch"],
          "stage1_0.6b": ["unchanged", "half_batch", "mask_broken"]}


def correct(out) -> bool:
    return all(c["ok"] for c in out["checks"].values())


@pytest.mark.parametrize("cell,fault", [
    (cell, f) for cell, fs in FAULTS.items() for f in [None] + fs])
def test_training_faults(cell, fault):
    out = rehearse(cell, seed=3, seconds=0.3, fault=fault)
    assert correct(out) == (fault is None), out["checks"]


def test_mask_broken_fails_on_the_frozen_rows():
    out = rehearse("stage1_0.6b", seed=4, seconds=0.3, fault="mask_broken")
    assert not out["checks"]["frozen_change"]["ok"], out["checks"]


@pytest.mark.parametrize("cell", ["kd_lora_0.6b", "stage1_0.6b"])
def test_training_control_fails(cell):
    bench = core.Bench(workload_name=cell, seed=3, seconds=0.3, trace=False,
                       device="cpu", t_start=time.perf_counter(),
                       rehearsal=True)
    drv = core.driver(bench.workload["driver"])
    ref = drv.reference(bench, "fp32")
    ctl = drv.reference(bench, "fp8")
    checks = training.compare(ctl, ref, bench.workload["limits"])
    assert not all(c["ok"] for c in checks.values()), checks


@pytest.mark.card
@pytest.mark.parametrize("cell", ["kd_lora_0.6b", "stage1_0.6b"])
def test_training_control_fails_on_the_card(card, cell):
    bench = core.Bench(workload_name=cell, seed=5, seconds=1, trace=False,
                       device=str(card), t_start=time.perf_counter())
    drv = core.driver(bench.workload["driver"])
    ref = drv.reference(bench, "fp32")
    ctl = drv.reference(bench, "fp8")
    checks = training.compare(ctl, ref, bench.workload["limits"])
    assert not all(c["ok"] for c in checks.values()), checks
