"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.common import harness
from benchmark.run import metrics_of

from .tiny import BENCH, ROOT, SPEC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
LAYER_METRICS = [m["name"] for m in SPEC["per_layer"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    path = ROOT / entry["file"]
    assert path == BENCH / "configs" / f"{entry['name']}.json"
    frozen = json.loads(path.read_text())
    assert frozen["source"] == entry["source"]
    assert frozen["reduced"] == entry["reduced"]
    assert all(NAME.match(k) for k in entry["reduced"])
    assert 1 <= len(entry["source"]) <= 200
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_workload_file(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    w = json.loads((BENCH / "workloads" / f"{entry['name']}.json").read_text())
    assert w["config"] == entry["config"]
    assert w["traffic"]["kind"] == entry["traffic"]
    assert w["why"] == entry["why"] and w["chips"] == entry["chips"]
    assert harness.traffic_class(entry["traffic"]) is not None
    assert "limit" in w["traffic"] and "control" in w["traffic"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_and_a_layer(cell):
    e2e, layers, _ = metrics_of(SPEC, cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layers


def test_metrics_shape():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", LAYER_METRICS)
def test_layer_metric_found_and_its_cells_report_what_it_moves(name):
    m = next(x for x in SPEC["per_layer"] if x["name"] == name)
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert callable(harness.metric_reader(name))
    for cell in m["workloads"]:
        e2e, layers, _ = metrics_of(SPEC, cell)
        assert m["moves"] in e2e and name in layers


def test_shares_of_a_peak_are_named_for_it():
    for m in SPEC["per_layer"]:
        if m["unit"] == "%" and "idle" not in m["name"]:
            assert m["name"].startswith("mfu") or "_roofline" in m["name"]


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_reference_found_by_name(entry):
    """The reference's model type and decoder are modules named as the
    configuration names them."""
    frozen = json.loads((ROOT / entry["file"]).read_text())
    model = frozen["Model"]
    assert (BENCH / "reference" / "model_types"
            / f"{model.get('type', 's2g_v2')}.py").is_file()
    assert (BENCH / "reference" / "decoders"
            / f"{model['Decoder']['type']}.py").is_file()


def test_a_configuration_without_a_reference_is_refused_by_name():
    from benchmark.reference import model as rm

    cfg = json.loads((BENCH / "configs" / "beat-ours.json").read_text())
    cfg["Model"]["Decoder"]["type"] = "no_such_decoder"
    with pytest.raises(ValueError, match="reference/decoders/no_such_decoder"):
        rm.build(cfg, "meta")
