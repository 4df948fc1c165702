"""Dry run: build every (arch × input shape × mesh) step on ``meta``.

The counterpart of ``repro/launch/dryrun.py``.  The reference proves its
distribution config coherent by lowering and compiling every step over 512
placeholder devices; the port runs eagerly, so it builds each step on the
``meta`` device instead — shapes and dtypes only, no device byte
allocated, nothing computed — once, under the op accounting
(``launch/hlo_analysis.py``).  Each record carries the reference's fields
(``memory``, ``cost``, ``hlo``, ``collectives``, ``lower_s``; there is no
compile), so ``launch/roofline.py`` and ``launch/validate_dryrun.py`` read
it unchanged.

One node is one card.  A training record is one node's step: rank 0 of a
G-rank world whose collectives a ``RecordingComm`` records and bills
without moving data.  The meshes keep the reference's gossip-node counts:
``single`` is G = 16 (``{"data": 16, "model": 1}``), ``multi`` G = 32
(``{"pod": 2, "data": 16, "model": 1}``), and ``mini`` is the (2, 2)
gossip grid of ``tests/spmd_dryrun_script.py`` (G = 4).  kimi-k2 gossips
across pods only (the reference's ``launch/mesh.py`` rule, copied here
until tensor parallelism is ported): G = 1 on ``single``, 2 on ``multi``.
A serving record is one card's replica: the global batch split over the
mesh's data axes when they divide it (the reference's ``_batch_axes``),
else all of it on one card.  ``mesh_shape`` holds the node layout the
record was built for, so per-device figures are per node.

What one card cannot hold says so: the records show the bytes as they
are (granite-8b's node state at full width is about 82 GB, kimi-k2's
about 10 TB) until tensor parallelism splits a node.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch all] [--shape all] [--mesh single,multi] \\
      [--topology d_ada] [--mixing ppermute] [--out dryrun_results.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

from repro_torch.launch.hlo_analysis import collective_stats

__all__ = ["MESHES", "collective_stats", "gossip_axes_for", "run_one", "main"]

MESHES = {
    "single": {"data": 16, "model": 1},
    "multi": {"pod": 2, "data": 16, "model": 1},
    "mini": {"pod": 2, "data": 2, "model": 1},
}


def gossip_axes_for(arch_name: str, mesh_shape: dict) -> tuple[str, ...]:
    """Which mesh axes enumerate gossip nodes (``repro/launch/mesh.py``):
    every non-"model" axis; kimi-k2, whose replica needs a whole pod,
    gossips across pods only (() on a single pod: G = 1)."""
    if arch_name.startswith("kimi-k2"):
        return ("pod",) if "pod" in mesh_shape else ()
    return tuple(a for a in mesh_shape if a != "model")


def _apply_overrides(cfg, override: str):
    """--override "remat=False,capacity_factor=2.0" -> dataclasses.replace."""
    if not override:
        return cfg
    kw = {}
    for item in override.split(","):
        k, v = item.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float):
            kw[k] = float(v)
        elif cur is None and v.isdigit():
            kw[k] = int(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def run_one(arch: str, shape, mesh_kind: str, topology: str = "d_ada",
            mixing: str = "ppermute", override: str = "", tag: str = "") -> dict:
    """The record of one (arch, shape, mesh): ``shape`` a ``SHAPES`` name
    or an ``InputShape`` (the record then carries it as ``input_shape``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, InputShape
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.comm import RecordingComm
    from repro_torch.launch.roofline import TRANSPORT
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    cfg = _apply_overrides(get_config(arch), override)
    if not isinstance(shape, InputShape):
        shape = SHAPES[shape]
    mesh = MESHES[mesh_kind]
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind, "kind": shape.kind,
           "mixing": mixing, "device": "meta", "transport": TRANSPORT}
    if shape.name not in SHAPES:
        rec["input_shape"] = dataclasses.asdict(shape)
    if override:
        rec["override"] = override
    if tag:
        rec["tag"] = tag
    if shape.kind == "train":
        gx = gossip_axes_for(arch, mesh)
        g = math.prod(mesh[a] for a in gx)
        topo = make_topology(topology if g > 2 else "d_ring", g)
        kw = {} if g == 1 else {"comm": RecordingComm(0, g)}
        trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), mixing=mixing, device="meta",
                              **kw)
        rec["mesh_shape"] = {a: (n if a in gx else 1) for a, n in mesh.items()}
        rec["gossip_axes"] = list(gx)
        rec["gossip_nodes"] = g
        rec["topology"] = topo.name
        graph = topo.graph_at(0)
        rec["graph"] = graph.describe() if graph else "none"
        rec.update(trainer.lower_step(shape))
    else:
        data = [a for a in mesh if a != "model"]
        replicas = math.prod(mesh[a] for a in data)
        if shape.global_batch % replicas:
            replicas = 1
        rec["mesh_shape"] = {a: (mesh[a] if replicas > 1 and a in data else 1) for a in mesh}
        rec["replicas"] = replicas
        node_shape = dataclasses.replace(shape, global_batch=shape.global_batch // replicas)
        engine = ServeEngine(cfg, device="meta")
        if shape.kind == "prefill":
            rec.update(engine.lower_prefill(node_shape))
        else:
            rec.update(engine.lower_decode(node_shape))
            rec["window"] = engine.decode_window(shape)
    return rec


def _isolated(args, archs, shapes, meshes) -> None:
    """Every (arch, shape, mesh) in its own interpreter, appending to the
    same artifact (``--skip-existing``)."""
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                    "--topology", args.topology, "--mixing", args.mixing,
                    "--out", args.out, "--skip-existing",
                ] + (["--override", args.override] if args.override else []) \
                  + (["--tag", args.tag] if args.tag else [])
                r = subprocess.run(cmd)
                if r.returncode not in (0, 1):
                    print(f"[DIED] {arch} × {shape} × {mesh_kind}: rc={r.returncode}",
                          flush=True)


def main(argv=None) -> None:
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.configs.base import SHAPES

    ap = argparse.ArgumentParser(description="dry run of every step on the meta device")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--topology", default="d_ada")
    ap.add_argument("--mixing", default="ppermute", choices=["ppermute", "dense"])
    ap.add_argument("--override", default="", help="cfg field overrides k=v,k=v")
    ap.add_argument("--tag", default="", help="label stored in the record")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--isolate", action="store_true",
                    help="run every (arch, shape, mesh) combo in its own subprocess")
    args = ap.parse_args(argv)
    archs = list(ARCH_NAMES) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")
    if args.isolate:
        _isolated(args, archs, shapes, meshes)
        return

    results = []
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag", ""))
            for r in results if "error" not in r}
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = (arch, shape, mesh_kind, args.tag)
                if key in done:
                    continue
                label = f"{arch} × {shape} × {mesh_kind}"
                try:
                    t0 = time.perf_counter()
                    rec = run_one(arch, shape, mesh_kind, args.topology, args.mixing,
                                  args.override, args.tag)
                    coll = rec["collectives"].get("total_wire_bytes", 0)
                    print(f"[OK]   {label}: built in {time.perf_counter() - t0:.1f}s  "
                          f"flops/node {rec['cost']['flops']:.3e}  "
                          f"coll {coll / 1e6:.1f} MB/node", flush=True)
                except Exception as e:
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"[FAIL] {label}: {type(e).__name__}: {str(e)[:200]}", flush=True)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"], r.get("tag", "")) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                gc.collect()
    print(f"\n{len(results)} records, {n_fail} failures -> {args.out}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
