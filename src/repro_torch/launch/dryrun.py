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

The meshes are the reference's production meshes (``launch/mesh.py``):
``single`` is (16 data × 16 model), ``multi`` (2 pod × 16 data × 16
model), and ``mini`` the (2, 2) gossip grid of
``tests/spmd_dryrun_script.py`` (G = 4, no model axis).  The gossip axes
are ``gossip_axes_for``'s: every non-model axis, except for kimi-k2, whose
replica needs a whole pod (G = 1 on ``single``, 2 on ``multi``).  A
training record is rank (0, 0, 0)'s step of the tensor-parallel ranks
engine: shard 0 of node 0, whose gossip, model-group and (for kimi-k2)
data-group collectives ``RecordingComm``s record and bill without moving
data, so ``argument_bytes`` and ``temp_bytes`` are per card and
``mesh_shape`` counts the axes that split the work (the gossip axes, the
model axis, and at G = 1 the data axes the batch is split over); every family
trains so, the ssm and hybrid ones included.  kimi-k2's node on
``single`` is the reference trainer's G = 1 placement: every leaf
FSDP-sharded over the 16 data ranks and its experts over the 16 model
ranks (the data group's all-gathers at use and reduce-scatters of the
gradients in its record), the batch split over the data ranks; on
``multi`` its data ranks hold the leaves whole, except the experts' d_ff
under ``moe_shard_ff``.
A serving record is rank (0, 0)'s card of ``ServeEngine(cfg, mesh=...)``
(its model and data groups two ``RecordingComm``s): the weights divided
over "model", the global batch split over the mesh's data axes when they
divide it (the reference's ``_batch_axes``; a MoE model serves all of it,
``ServeEngine.batch_rows``), and the rank's decode state (its KV heads
by ``transformer.cache_kv_heads``, its RWKV and Mamba2 heads); its
``mesh_shape`` counts the model axis and the data axes that split the
batch.  A decode record's ``decode_state_bytes`` gives that state's bytes
a card beside those of the reference's placement of the same whole
state (``repro/launch/serve.py::_state_shardings``, whose rule
``reference_placement_bytes`` repeats: one dim over "model", the later and
smaller first; the combined axes on the slots at B = 1), which the port
does not realize: a placement, not a different number.

What one card cannot hold says so: the records show the bytes as they
are (kimi-k2 on ``multi`` keeps a node's dense leaves whole on each of
its 16 data ranks).

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
from repro_torch.launch.mesh import data_axes_for, gossip_axes_for, gossip_size

__all__ = ["MESHES", "collective_stats", "gossip_axes_for", "run_one", "main"]

MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "mini": {"pod": 2, "data": 2, "model": 1},
}



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
    from repro_torch.launch.mesh import make_mesh
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
        g = gossip_size(mesh, gx)
        tp = mesh.get("model", 1)
        data = data_axes_for(mesh, gx)
        d = math.prod(mesh[a] for a in data)
        topo = make_topology(topology if g > 2 else "d_ring", g)
        kw = {} if g == 1 and tp * d == 1 else {"comm": RecordingComm(0, g)}
        if tp * d > 1:
            kw.update(model_comm=RecordingComm(0, tp),
                      mesh=make_mesh(tuple(mesh.values()), tuple(mesh)))
        if d > 1:
            kw["data_comm"] = RecordingComm(0, d)
        trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), mixing=mixing, device="meta",
                              **kw)
        # the data axes split the work at G = 1 (the batch over them); at
        # G > 1 the node's data ranks each hold its whole batch
        rec["mesh_shape"] = {a: (n if a in gx or (a in data and g == 1)
                                 or (a == "model" and tp > 1) else 1)
                             for a, n in mesh.items()}
        rec["gossip_axes"] = list(gx)
        rec["gossip_nodes"] = g
        rec["topology"] = topo.name
        graph = topo.graph_at(0)
        rec["graph"] = graph.describe() if graph else "none"
        rec.update(trainer.lower_step(shape))
    else:
        data = [a for a in mesh if a != "model"]
        d, tp = math.prod(mesh[a] for a in data), mesh.get("model", 1)
        engine = ServeEngine(cfg, device="meta", mesh=make_mesh((d, tp), ("data", "model")),
                             model_comm=RecordingComm(0, tp) if tp > 1 else None,
                             data_comm=RecordingComm(0, d) if d > 1 else None)
        rows = engine.batch_rows(shape.global_batch)
        replicas = shape.global_batch // (rows.stop - rows.start)
        rec["mesh_shape"] = {a: (mesh[a] if (replicas > 1 and a in data) or a == "model"
                                 else 1) for a in mesh}
        rec["replicas"] = replicas
        if shape.kind == "prefill":
            rec.update(engine.lower_prefill(shape))
        else:
            rec.update(engine.lower_decode(shape))
            rec["window"] = engine.decode_window(shape)
            rec["decode_state_bytes"] = decode_state_bytes(engine, shape, mesh)
    return rec


def _leaf_bytes(state) -> list:
    import torch
    from torch.utils._pytree import tree_leaves

    return [(tuple(t.shape), t.element_size()) for t in tree_leaves(state)
            if isinstance(t, torch.Tensor)]


def reference_placement_bytes(leaves, b: int, mesh: dict) -> int:
    """Bytes a card of a whole decode state (``leaves``: (shape, item
    bytes)) under the reference's ``ServeEngine._state_shardings`` rule on
    ``mesh``: the batch dim (the first dim of ``b`` among the first three)
    over the data axes where they divide ``b``; one more dim over "model",
    the later and smaller (≤ 1024) dims first; at a batch the data axes do
    not divide, the combined axes on the first dim they divide that is at
    least their size, in place of "model"."""
    dsize = math.prod(n for a, n in mesh.items() if a != "model")
    msize, csize = mesh.get("model", 1), math.prod(mesh.values())
    split = b % dsize == 0
    total = 0
    for shape, item in leaves:
        parts = [1] * len(shape)
        bdim = next((i for i, n in enumerate(shape) if n == b and i <= 2), None)
        if bdim is not None and split:
            parts[bdim] = dsize
        cands = [i for i in range((bdim + 1) if bdim is not None else 0, len(shape))
                 if parts[i] == 1]
        on_model = next((i for i in sorted(cands, key=lambda i: (shape[i] > 1024, -i))
                         if shape[i] % msize == 0), None)
        if on_model is not None:
            parts[on_model] = msize
        if not split:
            for i in cands:
                if parts[i] == 1 and shape[i] >= csize and shape[i] % csize == 0:
                    if on_model is not None:
                        parts[on_model] = 1
                    parts[i] = csize
                    break
        total += math.prod(n // p for n, p in zip(shape, parts)) * item
    return total


def decode_state_bytes(engine, shape, mesh: dict) -> dict:
    """A decode record's state bytes a card: the port's (this rank's share)
    and the reference placement's of the whole state."""
    from repro_torch.models import transformer as tfm

    local, window = engine.abstract_decode_state(shape)
    whole = tfm.init_decode_state(engine.cfg, shape.global_batch, shape.seq_len, window=window,
                                  device="meta", tp_size=engine.tp_size, tp_rank=None)
    return {"port": sum(math.prod(s) * i for s, i in _leaf_bytes(local)),
            "reference_placement": reference_placement_bytes(
                _leaf_bytes(whole), shape.global_batch, mesh)}


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
