"""The reduction of a trace: busy time as the union of device operations,
idle gaps named by the innermost host event open, kernels by name."""
import pytest

from benchmark.harness.trace import Reduced, short


def test_busy_is_the_union_and_gaps_are_named():
    ops = [("void (anonymous namespace)::paged_decode_kernel<float>(P)",
            0.0, 10.0),
           ("flash_fwd_kernel", 5.0, 10.0),      # overlaps: union 0-15
           ("Memcpy DtoD (Device -> Device)", 40.0, 10.0)]
    host = [("bench.step", 0.0, 100.0), ("aten::item", 20.0, 5.0),
            ("aten::mm", 26.0, 10.0)]
    r = Reduced(ops, host, window_s=1e-4)
    assert r.busy_s == pytest.approx(25e-6)
    # one gap, 15-40 us; at its middle (27.5) aten::mm is the innermost
    assert r.gaps == {"aten::mm": pytest.approx(25e-6)}
    assert r.time_of("paged_decode") == pytest.approx(10e-6)
    assert r.count_of("flash_", "paged_") == 2
    b = r.breakdown()
    assert b["device_ops"][0][0] in ("paged_decode_kernel",
                                     "flash_fwd_kernel", "Memcpy DtoD")
    assert b["idle_gaps"] == [["aten::mm", pytest.approx(25e-6)]]


def test_a_gap_with_no_host_event_is_the_host():
    r = Reduced([("k", 0.0, 1.0), ("k", 5.0, 1.0)], [], window_s=1e-5)
    assert r.gaps == {"host": pytest.approx(4e-6)}


def test_short_names():
    assert short("void at::native::(anonymous namespace)::f<4>(float*)") \
        == "at::native::f"
    assert short("nvjet_tst_64x32") == "nvjet_tst_64x32"
