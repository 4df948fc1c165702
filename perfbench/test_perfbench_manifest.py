"""The manifest keeps the benchmark's rules, and every file a cell needs
is where the harness looks for it."""
import json
import re

import pytest

from perfbench import check, manifest, reference

MAN = manifest.load()


def test_manifest_has_no_problems():
    assert manifest.problems(MAN, root=manifest.ROOT) == []


def test_command_and_paths():
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    cells = len(MAN["workloads"])
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, cells // 4)


@pytest.mark.parametrize("name", [e["name"] for k in ("configs", "workloads", "end_to_end",
                                                       "per_layer") for e in MAN[k]])
def test_names(name):
    assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", name)


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", metric["unit"])
    keys = {"name", "unit", "better", "source", "workloads"}
    keys |= {"bound"} if metric in MAN["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= keys
    assert callable(manifest.reader(metric["name"]))


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    for key in entry["reduced"]:
        assert key in cfg and key in cfg["published"]
    assert cfg["dtype"] in reference.DTYPES


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_limits_files(cell):
    limits = manifest.limits(cell["name"])
    assert limits and set(limits) <= set(check.NUMBERS)
    assert all(v > 0 for v in limits.values())
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
