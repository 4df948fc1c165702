"""Roofline analysis over dry-run records: the counterpart of
``repro/launch/roofline.py``, with NVIDIA H100 SXM figures in place of the
reference's TPU v5e ones.

Three terms per (arch × shape × mesh), all *seconds per step, per node*
(one node is one card):

  compute = dot_FLOPs_per_node / PEAK_FLOPS     (989 TFLOP/s dense bf16)
  memory  = traffic_bytes_per_node / HBM_BW     (3.35 TB/s)
  wire    = wire_bytes_per_node / NVLINK_BW     (450 GB/s, NVLink 4, one way)

The dry run (``launch/dryrun.py``) records one node's step — rank 0 of a
G-rank world on ``meta`` — so its op accounting (``launch/hlo_analysis.py``)
is already per node (a device of the tables' columns is a node).  Every
record and every roofline names the wire's ``transport``, and each table
ends with a line that names it: a node is one card, so the wire is the
card's NVLink.

MODEL_FLOPS uses the 6·N_active·D rule (D = tokens processed per node per
step; decode: D = batch/node, one token each; the backward pass is counted
by the standard 3× multiplier for training).  The ratio
MODEL_FLOPS / dot_FLOPs shows how much counted compute is "useful"
(remat, capacity factors and padding push it below 1; attention's
quadratic terms push dot_FLOPs above the 6ND rule at long context).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --in dryrun_results.json [--md]
"""
from __future__ import annotations

import argparse
import json
import math

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ArchConfig, InputShape

# NVIDIA H100 SXM5 data sheet: dense BF16 tensor-core rate (without
# sparsity), HBM3 bandwidth, and NVLink 4 (900 GB/s both ways, 450 one way)
PEAK_FLOPS = 989e12     # FLOP/s, bf16, one card
HBM_BW = 3.35e12        # bytes/s, one card
NVLINK_BW = 450e9       # bytes/s, one card, one direction
TRANSPORT = "nvlink"

__all__ = ["active_params", "model_flops_per_device", "roofline_terms", "analyze",
           "to_markdown", "dryrun_markdown"]


def _attn_params_per_layer(cfg: ArchConfig) -> int:
    dh = cfg.head_dim
    return cfg.d_model * dh * (2 * cfg.n_heads + 2 * cfg.n_kv)


def _ffn_params_per_layer(cfg: ArchConfig, active: bool) -> int:
    if not cfg.n_experts:
        return 3 * cfg.d_model * cfg.d_ff
    e = cfg.top_k if active else cfg.n_experts
    per_expert = 3 * cfg.d_model * cfg.d_ff
    shared = cfg.n_shared_experts * 3 * cfg.d_model * cfg.d_ff
    router = cfg.d_model * cfg.n_experts
    return e * per_expert + shared + router


def active_params(cfg: ArchConfig, *, total: bool = False) -> int:
    """N (dense) or N_active (MoE) excluding embeddings (standard 6ND rule)."""
    n = 0
    if cfg.family == "ssm":
        d, f = cfg.d_model, cfg.d_ff
        per_layer = 5 * d * d + 2 * d * 64 + (d * f + f * d + d * d)
        n = cfg.n_layers * per_layer
    elif cfg.family == "hybrid":
        group = cfg.attn_every
        n_groups, tail = divmod(cfg.n_layers, group)
        d_inner = 2 * cfg.d_model
        mamba = (
            2 * cfg.d_model * d_inner        # z, x proj
            + 2 * cfg.d_model * cfg.ssm_state
            + cfg.d_model * (d_inner // 64)
            + d_inner * cfg.d_model          # out proj
        )
        n_mamba = n_groups * (group - 1) + tail
        attn = _attn_params_per_layer(cfg) + 3 * cfg.d_model * cfg.d_ff
        n = n_mamba * mamba + n_groups * attn if not total else (
            n_mamba * mamba + attn  # weights are shared: stored once
        )
    else:
        per_layer = _attn_params_per_layer(cfg) + _ffn_params_per_layer(
            cfg, active=not total
        )
        n = cfg.n_layers * per_layer
    return n


def _mixer_flops_per_token(cfg: ArchConfig, context: float) -> float:
    """Sequence-mixing FLOPs per token at a given average context length.

    Attention: 4·H·Dh·context per layer (QKᵀ + PV, 2 flops each).
    RWKV wkv: ~8·D·Dh per layer (context-independent state ops).
    Mamba2 SSD: ~8·d_inner·N per layer.
    """
    if cfg.family == "ssm":
        dh = cfg.d_model // max(cfg.n_heads or cfg.d_model // 64, 1)
        return cfg.n_layers * 8.0 * cfg.d_model * dh
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        n_mamba = cfg.n_layers - n_attn
        attn = n_attn * 4.0 * cfg.n_heads * cfg.head_dim * context
        mamba = n_mamba * 8.0 * (2 * cfg.d_model) * cfg.ssm_state
        return attn + mamba
    if cfg.n_heads == 0:
        return 0.0
    return cfg.n_layers * 4.0 * cfg.n_heads * cfg.head_dim * context


def model_flops_per_device(cfg: ArchConfig, shape, mesh_shape: dict, gossip_nodes: int) -> float:
    """6·N_active·D rule + sequence-mixing term, D = tokens per device (one
    node is one card: the mesh's size is the gossip size G)."""
    n_dev = math.prod(mesh_shape.values())
    n_act = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        # causal: average context = S/2; backward = 2x forward
        mix = tokens * _mixer_flops_per_token(cfg, shape.seq_len / 2) * 3.0
        return (6.0 * n_act * tokens + mix) / n_dev
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mix = tokens * _mixer_flops_per_token(cfg, shape.seq_len / 2)
        return (2.0 * n_act * tokens + mix) / n_dev
    # decode: 1 token per sequence against a seq_len-deep context (window-
    # limited for the sliding-window archs on long_500k)
    ctx = shape.seq_len
    if shape.seq_len > 100_000 and cfg.family not in ("ssm",):
        ctx = min(ctx, cfg.sliding_window or 8192)
    mix = shape.global_batch * _mixer_flops_per_token(cfg, ctx)
    return (2.0 * n_act * shape.global_batch + mix) / n_dev


def record_shape(rec: dict) -> InputShape:
    """A record's input shape: one of ``SHAPES`` by name, or the record's
    own ``input_shape`` (the dry run's mini shapes)."""
    if rec["shape"] in SHAPES:
        return SHAPES[rec["shape"]]
    return InputShape(**rec["input_shape"])


def roofline_terms(rec: dict, cfg: ArchConfig = None) -> dict:
    """The three terms of a record; ``cfg`` stands in for the record's
    ``arch`` (a configuration cut to another depth, say)."""
    cfg = cfg or get_config(rec["arch"])
    shape = record_shape(rec)
    hlo = rec.get("hlo")
    if hlo:  # the op accounting (every loop trip counted)
        flops = hlo["dot_flops"]
        bytes_acc = hlo["traffic_bytes"]
        wire = hlo["total_wire_bytes"]
    else:
        flops = rec["cost"]["flops"]
        bytes_acc = rec["cost"]["bytes_accessed"]
        wire = rec.get("collectives", {}).get("total_wire_bytes", 0)
    t_c = flops / PEAK_FLOPS
    t_m = bytes_acc / HBM_BW
    t_x = wire / NVLINK_BW
    dominant = max(
        (("compute", t_c), ("memory", t_m), ("collective", t_x)), key=lambda kv: kv[1]
    )[0]
    mflops = model_flops_per_device(
        cfg, shape, rec["mesh_shape"], rec.get("gossip_nodes", 1)
    )
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "transport": rec.get("transport", TRANSPORT),
        "dominant": dominant,
        "model_flops": mflops,
        "useful_ratio": (mflops / flops) if flops else 0.0,
        "bound_s": max(t_c, t_m, t_x),
    }


def analyze(path: str) -> list[dict]:
    with open(path) as f:
        records = json.load(f)
    out = []
    for rec in records:
        if "error" in rec:
            out.append({**rec, "roofline": None})
            continue
        out.append({**rec, "roofline": roofline_terms(rec)})
    return out


def _wire_note(rows: list[dict]) -> str:
    """The line under a table that names the wire's transport."""
    transport = next((r["transport"] for r in rows if r.get("transport")), TRANSPORT)
    return f"\n\ncollective term over {transport} at {NVLINK_BW / 1e9:g} GB/s a card, one way"


def to_markdown(rows: list[dict]) -> str:
    """The roofline table (the reference's columns), then the transport."""
    hdr = (
        "| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) "
        "| dominant | useful FLOP ratio |\n|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        if r.get("tag"):
            continue  # hillclimb variants live apart from the baseline table
        rf = r.get("roofline")
        if rf is None:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | ERROR | — |"
            )
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rf['compute_s']*1e3:.2f} | {rf['memory_s']*1e3:.2f} "
            f"| {rf['collective_s']*1e3:.2f} | **{rf['dominant']}** "
            f"| {rf['useful_ratio']:.2f} |"
        )
    return hdr + "\n".join(lines) + _wire_note(rows)


def _fmt_bytes(b: float) -> str:
    if b >= 1e9:
        return f"{b/2**30:.2f} GiB"
    if b >= 1e6:
        return f"{b/2**20:.1f} MiB"
    return f"{b/2**10:.0f} KiB"


def dryrun_markdown(rows: list[dict], mesh: str) -> str:
    """The dry-run table: per-node memory and collective schedule (the
    reference's columns), then the transport."""
    out = [
        "| arch | shape | gossip | compile (s) | args/dev | temp/dev "
        "| collective schedule (loop-aware, per device/step) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        if r.get("mesh") != mesh or r.get("roofline") is None or r.get("tag"):
            continue
        m = r["memory"]
        h = r.get("hlo", {})
        colls = ", ".join(
            f"{k}×{v}" for k, v in sorted(h.get("coll_counts", {}).items())
        ) or "—"
        wire = _fmt_bytes(h.get("total_wire_bytes", 0))
        gossip = r.get("graph", "—") if r.get("kind") == "train" else "serving"
        out.append(
            f"| {r['arch']} | {r['shape']} | {gossip.split('(')[0]} "
            f"| {r.get('compile_s', 0)} | {_fmt_bytes(m['argument_bytes'])} "
            f"| {_fmt_bytes(m['temp_bytes'])} | {colls} = {wire} |"
        )
    return "\n".join(out) + _wire_note(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="dryrun_results.json")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--dryrun-md", metavar="MESH", help="emit the dry-run table for a mesh")
    args = ap.parse_args(argv)
    rows = analyze(args.inp)
    if args.dryrun_md:
        print(dryrun_markdown(rows, args.dryrun_md))
        return
    if args.md:
        print(to_markdown(rows))
        return
    for r in rows:
        rf = r.get("roofline")
        tag = f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s}"
        if rf is None:
            print(f"{tag} ERROR: {r.get('error', '?')[:80]}")
        else:
            print(
                f"{tag} C={rf['compute_s']*1e3:8.2f}ms M={rf['memory_s']*1e3:8.2f}ms "
                f"X={rf['collective_s']*1e3:8.2f}ms ({rf['transport']}) -> "
                f"{rf['dominant']:10s} useful={rf['useful_ratio']:.2f}"
            )


if __name__ == "__main__":
    main()
