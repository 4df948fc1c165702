"""``BENCHMARK.json`` and the files the harness finds by name in it.

For a cell (an entry of ``workloads``) the harness reads its configuration
from the file the ``configs`` entry names, the model's plain reference
from ``perfbench/references/<reference>.py`` (the configuration's
``reference`` key; ``reference.model``), its traffic from
``perfbench/traffic/<traffic>.json``, the limits of its correctness check
from ``perfbench/limits/<workload>.json``, and each metric from the reader
``perfbench/metrics/<metric>.py`` (a ``read(ctx)`` that returns the value,
or None where it finds nothing to read).

A new model is a new configuration file, a new reference module (or the
name of one there is), traffic, limits and manifest entries; a new traffic
mix or metric is its file and its entries.  No existing file changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Mapping, Optional

__all__ = ["ROOT", "BENCH", "load", "workload", "config", "traffic", "limits",
           "cell_metrics", "reader", "problems"]

ROOT = Path(__file__).resolve().parent.parent
BENCH = "perfbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(man: Mapping, name: str) -> dict:
    return _by_name(man["workloads"], name, "workload")


def config(man: Mapping, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(man["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / BENCH / "traffic" / f"{name}.json").read_text())


def limits(name: str, root: Path = ROOT) -> dict:
    """The cell's correctness limits: number name -> limit."""
    return json.loads((Path(root) / BENCH / "limits" / f"{name}.json").read_text())["limits"]


def cell_metrics(man: Mapping, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in man[kind] if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = Path(root) / BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(man: Mapping, root: Optional[Path] = None) -> list[str]:
    """What in the manifest breaks the benchmark's rules (empty if none);
    with ``root``, also every file a cell needs that is missing."""
    out = []
    if set(man) != TOP_KEYS:
        out.append(f"top-level keys {sorted(man)}")
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in man[k]]
    for n in names:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for kind in ("configs", "workloads"):
        seen = [e["name"] for e in man[kind]]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate {kind} names")
    metrics = man["end_to_end"] + man["per_layer"]
    if len({m["name"] for m in metrics}) != len(metrics):
        out.append("duplicate metric names")
    e2e = {m["name"] for m in man["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    cells = {w["name"] for w in man["workloads"]}
    configs = {c["name"] for c in man["configs"]}
    for m in metrics:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher") \
                or m["source"] not in SOURCES:
            out.append(f"metric {m['name']}: unit, better or source")
        if not set(m.get("workloads", ())) <= cells:
            out.append(f"metric {m['name']}: unknown workloads")
    for m in man["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace") or not 0 < m["bound"] <= 0.25:
            out.append(f"end-to-end metric {m['name']}: source or bound")
    for m in man["per_layer"]:
        if m["moves"] not in e2e or "\n" in m["layer"] or not 0 < len(m["layer"]) <= 200:
            out.append(f"per-layer metric {m['name']}: moves or layer")
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a configuration and traffic pair appears twice")
    for w in man["workloads"]:
        if w["config"] not in configs or w["chips"] not in (1, 4) or not NAME.match(w["traffic"]):
            out.append(f"workload {w['name']}: config, chips or traffic")
        if not 0 < len(w["why"]) <= 200:
            out.append(f"workload {w['name']}: why")
        reports = [m for m in metrics if "workloads" not in m or w["name"] in m["workloads"]]
        if not any(m["name"] != "setup_s" for m in reports if m["name"] in e2e) \
                or not any(m["name"] not in e2e for m in reports):
            out.append(f"workload {w['name']}: reports no end-to-end or no per-layer metric")
    for c in man["configs"]:
        if not any(w["config"] == c["name"] for w in man["workloads"]):
            out.append(f"configuration {c['name']} has no cell")
        if not all(NAME.match(k) for k in c["reduced"]) or len(c["reduced"]) > 16:
            out.append(f"configuration {c['name']}: reduced")
        if not c["file"].startswith(BENCH + "/"):
            out.append(f"configuration {c['name']}: file outside {BENCH}/")
    if root is not None:
        root = Path(root)
        need = [root / c["file"] for c in man["configs"]]
        for c in man["configs"]:
            if not (root / c["file"]).exists():
                continue
            ref = json.loads((root / c["file"]).read_text()).get("reference")
            if not isinstance(ref, str) or not ref.isidentifier():
                out.append(f"configuration {c['name']}: reference {ref!r}")
            elif not (root / BENCH / "references" / f"{ref}.py").exists():
                out.append(f"configuration {c['name']}: missing {BENCH}/references/{ref}.py")
        need += [root / BENCH / "traffic" / f"{w['traffic']}.json" for w in man["workloads"]]
        need += [root / BENCH / "limits" / f"{w['name']}.json" for w in man["workloads"]]
        need += [root / BENCH / "metrics" / f"{m['name']}.py" for m in metrics]
        out += [f"missing {p.relative_to(root)}" for p in need if not p.exists()]
    return out
