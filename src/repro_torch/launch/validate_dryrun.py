"""Validate dry-run records against the analytic FLOP model; list outliers.

The counterpart of ``repro/launch/validate_dryrun.py``.  A record is
suspect when its ``hlo.dot_flops`` is far below the 6·N_active·D model (a
step that left out its layers) or zero where compute must exist.  Prints
suspect (arch, shape, mesh) triples; ``--fix`` deletes them from the
artifact so a ``--skip-existing`` re-run regenerates exactly those.

  PYTHONPATH=src python -m repro_torch.launch.validate_dryrun --in dryrun_results.json [--fix]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.launch.roofline import model_flops_per_device, record_shape


def is_suspect(rec: dict) -> str | None:
    if "error" in rec:
        return "error"
    hlo = rec.get("hlo")
    if not hlo:
        return "no-hlo"
    cfg = get_config(rec["arch"])
    shape = record_shape(rec)
    mflops = model_flops_per_device(
        cfg, shape, rec["mesh_shape"], rec.get("gossip_nodes", 1)
    )
    dot = hlo.get("dot_flops", 0.0)
    if dot <= 0:
        return "zero-dot-flops"
    # allow [0.3, 8]x of analytic: remat adds ~1.33x, attention quadratic adds
    # more at long context, capacity factors ~1.25x; a missing layer loop
    # shows up as an ~L-fold (>= 20x) deficit.
    ratio = dot / mflops
    if ratio < 0.3:
        return f"dot/model={ratio:.3f} (trip counts likely missing)"
    if ratio > 8.0:
        return f"dot/model={ratio:.1f} (double counting?)"
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="dryrun_results.json")
    ap.add_argument("--fix", action="store_true")
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        records = json.load(f)
    keep, bad = [], []
    for r in records:
        why = is_suspect(r)
        if why:
            bad.append((r["arch"], r["shape"], r["mesh"], why))
        else:
            keep.append(r)
    for arch, shape, mesh, why in bad:
        print(f"SUSPECT {arch:24s} {shape:12s} {mesh:6s} {why}")
    print(f"{len(keep)} ok, {len(bad)} suspect")
    if args.fix and bad:
        with open(args.inp, "w") as f:
            json.dump(keep, f, indent=1)
        print(f"removed {len(bad)} records from {args.inp}")


if __name__ == "__main__":
    main()
