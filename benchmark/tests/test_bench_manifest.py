"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
is a file of its own under ``benchmark/``."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def load_metric(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "m", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_24_cells():
    s = MAN["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry and key != "source" or key == "source" and \
                entry.get("source", "").startswith("http"):
            assert TEXT.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / cfg["file"]
    assert path.parent == BENCH / "configs" and path.stem == cfg["name"]
    body = json.loads(path.read_text())
    assert body["reduced"] == cfg["reduced"]
    widths = ("hidden_size", "intermediate_size", "head_dim",
              "num_attention_heads", "num_key_value_heads")
    assert not set(cfg["reduced"]) & set(widths)
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    w = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert (w["config"], w["traffic"], w["chips"]) == (
        cell["config"], cell["traffic"], cell["chips"])
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").exists()
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    assert (BENCH / "drivers" / f"{mix['driver']}.py").exists()
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in w["end_to_end"] and len(w["end_to_end"]) >= 2
    assert w["per_layer"]
    for m in w["end_to_end"]:
        assert m in e2e
        assert cell["name"] in e2e[m].get("workloads", [cell["name"]])


def test_pairs_and_four_chip_share():
    pairs = [(c["config"], c["traffic"]) for c in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(c["chips"] == 4 for c in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_end_to_end_metrics():
    names = [m["name"] for m in MAN["end_to_end"]]
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    mod = load_metric(m["name"])
    assert mod.MOVES == m["moves"] and mod.UNIT == m["unit"]
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    e2e = {x["name"]: x for x in MAN["end_to_end"]}
    moved = e2e[m["moves"]]
    for cell in m["workloads"]:
        w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        assert m["name"] in w["per_layer"]
        assert m["moves"] in w["end_to_end"]
        assert cell in moved.get("workloads", [cell])
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cell_metrics_listed(cell):
    w = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    listed = {m["name"] for m in MAN["per_layer"]
              if cell["name"] in m["workloads"]}
    assert set(w["per_layer"]) == listed
