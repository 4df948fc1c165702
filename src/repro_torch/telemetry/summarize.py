"""Offline consumers of a telemetry stream: ``summarize`` and ``diff`` (a
copy of ``repro/telemetry/summarize.py``).

``summarize(records)`` folds a validated record stream into per-phase
aggregates — a *phase* is the span between consensus-controller
``transition`` events (the rung in force), or the whole run when no
controller ran — and ``render_summary`` prints the step-time / comm /
Ξ_t / streamed-variance tables.  ``diff_summaries`` aligns two runs and
prints per-metric deltas (phase-count mismatches are reported, not
hidden).

CLI::

    python -m repro_torch.telemetry summarize run.jsonl
    python -m repro_torch.telemetry diff a.jsonl b.jsonl
"""
from __future__ import annotations

import math
from typing import Optional

__all__ = ["summarize", "render_summary", "diff_summaries", "main"]


def _percentile(xs: list, q: float) -> float:
    if not xs:
        return float("nan")
    ys = sorted(xs)
    i = (len(ys) - 1) * q
    lo, hi = int(math.floor(i)), int(math.ceil(i))
    return ys[lo] + (ys[hi] - ys[lo]) * (i - lo)


def _fmt(v, nd: int = 2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if not math.isfinite(v):
            return str(v)
        if v != 0 and (abs(v) >= 1e5 or abs(v) < 10 ** (-nd)):
            return f"{v:.{nd}e}"
        return f"{v:.{nd}f}"
    return str(v)


def summarize(records: list) -> dict:
    """Fold a record stream into manifest + per-phase + run aggregates."""
    manifests = [r for r in records if r["kind"] == "manifest"]
    steps = [r.get("step", 0) for r in records if r["kind"] != "manifest"]
    last_step = max(steps) if steps else 0

    # phase boundaries: controller transitions (a transition observed at
    # step s governs step s onward — mirrors ConsensusController.rung_at)
    transitions = [
        r for r in records
        if r["kind"] == "event" and r["name"] == "transition"
    ]
    bounds, labels = [0], ["run" if not transitions else "start"]
    for t in transitions:
        data = t.get("data") or {}
        bounds.append(int(t["step"]))
        labels.append(f"k={data.get('k', data.get('rung', '?'))}")
    bounds.append(last_step + 1)

    def phase_of(step: int) -> int:
        p = 0
        for i in range(1, len(bounds) - 1):
            if step >= bounds[i]:
                p = i
        return p

    n_phases = len(bounds) - 1
    phases = [
        {
            "label": labels[i],
            "start": bounds[i],
            "end": bounds[i + 1] - 1,
            "round_ms": [],
            "overruns": 0,
            "comm_bytes": 0,
            "xi": [],       # (step, value)
            "loss": [],     # (step, value)
            "variance": None,   # last variance record's metrics
            "events": [],   # (step, name, reason-or-None)
        }
        for i in range(n_phases)
    ]

    counters: dict[str, float] = {}
    per_layer: Optional[dict] = None
    for r in records:
        kind = r["kind"]
        if kind == "manifest":
            continue
        ph = phases[phase_of(int(r.get("step", 0)))]
        if kind == "span" and r["name"] == "round":
            ph["round_ms"].append(float(r["ms"]))
            if r.get("overrun"):
                ph["overruns"] += 1
        elif kind == "counter":
            counters[r["name"]] = float(r["total"])
            if r["name"] == "comm_bytes":
                ph["comm_bytes"] += float(r["inc"])
        elif kind == "gauge" and r["name"] in ("xi", "loss"):
            if r["value"] is not None:
                ph[r["name"]].append((int(r["step"]), float(r["value"])))
        elif kind == "variance":
            ph["variance"] = r["metrics"]
            per_layer = r.get("per_layer")
        elif kind == "event":
            reason = (r.get("data") or {}).get("reason")
            ph["events"].append((int(r["step"]), r["name"], reason))

    for ph in phases:
        ms = ph.pop("round_ms")
        ph["rounds"] = len(ms)
        ph["median_ms"] = _percentile(ms, 0.5) if ms else None
        ph["p95_ms"] = _percentile(ms, 0.95) if ms else None
        ph["xi_first"] = ph["xi"][0][1] if ph["xi"] else None
        ph["xi_last"] = ph["xi"][-1][1] if ph["xi"] else None
        ph["loss_first"] = ph["loss"][0][1] if ph["loss"] else None
        ph["loss_last"] = ph["loss"][-1][1] if ph["loss"] else None
        del ph["xi"], ph["loss"]

    return {
        "manifest": manifests[0]["run"] if manifests else None,
        "segments": len(manifests),
        "last_step": last_step,
        "counters": counters,
        "phases": phases,
        "per_layer_variance": per_layer,
    }


def _table(headers: list, rows: list) -> str:
    cells = [headers] + [[_fmt(c) if not isinstance(c, str) else c
                          for c in row] for row in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]
    lines = []
    for i, row in enumerate(cells):
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def render_summary(s: dict) -> str:
    out = []
    man = s.get("manifest") or {}
    if man:
        cfg = man.get("config") or {}
        out.append(
            "run: " + " ".join(
                str(man.get(k)) for k in ("topology",) if man.get(k)
            )
        )
        interesting = {
            k: cfg[k] for k in ("steps", "seed", "arch", "mesh") if k in cfg
        }
        if interesting or man.get("git"):
            out.append(
                f"provenance: git={man.get('git') or '?'} {interesting}"
            )
    if s.get("segments", 0) > 1:
        out.append(f"segments: {s['segments']} (resumed run)")
    out.append(f"steps: 0..{s['last_step']}")

    out.append("\nper-phase step time / comm / consensus distance:")
    out.append(_table(
        ["phase", "steps", "rounds", "med ms", "p95 ms", "overruns",
         "comm MiB", "xi first", "xi last", "loss last"],
        [[
            ph["label"], f"{ph['start']}..{ph['end']}", ph["rounds"],
            ph["median_ms"], ph["p95_ms"], ph["overruns"],
            ph["comm_bytes"] / 2**20 if ph["comm_bytes"] else 0.0,
            ph["xi_first"], ph["xi_last"], ph["loss_last"],
        ] for ph in s["phases"]],
    ))

    if s["counters"]:
        out.append("\nrun counters:")
        out.append(_table(
            ["counter", "total"],
            [[k, v] for k, v in sorted(s["counters"].items())],
        ))

    var_phases = [ph for ph in s["phases"] if ph["variance"]]
    if var_phases:
        metrics = sorted(var_phases[-1]["variance"])
        out.append("\nstreamed DBench variance (phase-final, mean over layers):")
        out.append(_table(
            ["phase"] + metrics,
            [[ph["label"]] + [ph["variance"].get(m) for m in metrics]
             for ph in var_phases],
        ))
    pl = s.get("per_layer_variance")
    if pl:
        metrics = sorted(pl)
        n_layers = max((len(v) for v in pl.values()), default=0)
        out.append("\nper-layer variance (final sample — the paper's Fig-5 axis):")
        out.append(_table(
            ["layer"] + metrics,
            [[str(i)] + [pl[m][i] if i < len(pl[m]) else None
                         for m in metrics] for i in range(n_layers)],
        ))

    events = [ev for ph in s["phases"] for ev in ph["events"]]
    if events:
        out.append("\nevents:")
        # controller events re-emit per same-step coalescing update; keep
        # the last emission per (step, name)
        dedup: dict = {}
        for step, name, reason in events:
            dedup[(step, name)] = reason
        out.append(_table(
            ["step", "event", "detail"],
            [[str(step), name, reason or ""]
             for (step, name), reason in sorted(dedup.items())],
        ))
    return "\n".join(out)


def diff_summaries(a: dict, b: dict, labels=("a", "b")) -> str:
    out = []
    la, lb = labels

    def row(name, va, vb):
        delta = None
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            delta = vb - va
        return [name, va, vb, delta]

    rows = [
        row("last_step", a["last_step"], b["last_step"]),
        row("phases", len(a["phases"]), len(b["phases"])),
    ]
    for name in sorted(set(a["counters"]) | set(b["counters"])):
        rows.append(row(
            name, a["counters"].get(name), b["counters"].get(name)
        ))
    for pa, pb in zip(a["phases"], b["phases"]):
        tag = f"[{pa['label']}]"
        rows.append(row(f"{tag} rounds", pa["rounds"], pb["rounds"]))
        rows.append(row(f"{tag} med ms", pa["median_ms"], pb["median_ms"]))
        rows.append(row(f"{tag} overruns", pa["overruns"], pb["overruns"]))
        rows.append(row(f"{tag} xi last", pa["xi_last"], pb["xi_last"]))
        rows.append(row(f"{tag} loss last", pa["loss_last"], pb["loss_last"]))
        va, vb = pa["variance"] or {}, pb["variance"] or {}
        for m in sorted(set(va) | set(vb)):
            rows.append(row(f"{tag} {m}", va.get(m), vb.get(m)))
    if len(a["phases"]) != len(b["phases"]):
        out.append(
            f"note: phase count differs ({len(a['phases'])} vs "
            f"{len(b['phases'])}); trailing phases not compared"
        )
    out.append(_table(["metric", la, lb, "delta"], rows))
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse

    from repro_torch.telemetry.schema import SchemaError
    from repro_torch.telemetry.sinks import read_jsonl

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="summarize / diff run-telemetry JSONL streams",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("summarize", help="render one run's tables")
    ps.add_argument("path")
    pd = sub.add_parser("diff", help="compare two runs phase by phase")
    pd.add_argument("path_a")
    pd.add_argument("path_b")
    args = ap.parse_args(argv)

    try:
        if args.cmd == "summarize":
            print(render_summary(summarize(read_jsonl(args.path))))
        else:
            a = summarize(read_jsonl(args.path_a))
            b = summarize(read_jsonl(args.path_b))
            print(diff_summaries(a, b, labels=(args.path_a, args.path_b)))
    except BrokenPipeError:
        # piped into head(1) etc. — the consumer got what it wanted
        import os
        import sys

        try:
            sys.stdout.close()
        except BrokenPipeError:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    except (OSError, SchemaError) as e:
        print(f"error: {e}")
        return 1
    return 0
