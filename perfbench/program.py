"""The system under test: the port's stacked decentralized trainer
(``repro_torch.launch.train.SPMDTrainer``), built from a configuration
file and a traffic file.  This is the harness's only module that imports
the program.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Mapping, Optional

import torch

from perfbench import reference
from perfbench.reference import DTYPES, mixing_matrix

__all__ = ["import_program", "arch_config", "build", "build_kernels", "counters",
           "watch_rebuilds", "stats_dict", "peak_bytes"]


def import_program() -> None:
    """Import the trainer and what it runs (timed as set-up's imports)."""
    import repro_torch.launch.train  # noqa: F401


def arch_config(cfg: Mapping, root: Optional[Path] = None):
    """The port's ``ArchConfig`` of a configuration file: the field values
    its reference module gives (``arch_fields``), which refuses what the
    reference does not compute; a key that is no field raises TypeError."""
    from repro_torch.configs.base import ArchConfig

    fields = reference.model(cfg, root).arch_fields(cfg)
    return ArchConfig(**{**fields, "dtype": DTYPES[fields["dtype"]]})


def build_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA kernels."""
    from repro_torch.kernels import _build

    _build.load_all()


def build(cfg: Mapping, traffic: Mapping, weights: Mapping, device,
          root: Optional[Path] = None):
    """(trainer, state): the trainer the traffic drives, its state holding
    ``weights`` on every node.  Every step mixes once and probes, as the
    reference does; a topology the reference cannot build, or leaves whose
    names, shapes or dtypes differ from the reference's table, are
    refused."""
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    arch = arch_config(cfg, root)
    opt = cfg["optimizer"]
    if opt["kind"] != "sgd":
        raise ValueError(f"optimizer {opt['kind']!r}: the reference covers momentum SGD")
    mixing_matrix(traffic["topology"], cfg["nodes"])
    trainer = SPMDTrainer(
        arch, make_topology(traffic["topology"], cfg["nodes"]), sgd(momentum=opt["momentum"]),
        collect_norms=True, mix_every=1,
        fused_apply=traffic["fused_apply"], bucket_mb=traffic["bucket_mb"], device=device)
    want = [(k, tuple(shape), dt) for k, shape, _, dt in reference.leaves(cfg, root)]
    layout = trainer.layout
    have = list(zip(layout.names, layout.shapes, layout.dtypes))
    if have != want:
        raise ValueError(f"the program's leaves {have} differ from the reference's {want}")
    state = trainer.init_state(params=weights)
    return trainer, state


def counters() -> dict:
    """The port's kernel launch counters and rebuild counters' state."""
    from repro_torch.kernels import ops

    return ops.launch_counts()


def watch_rebuilds(label: str):
    """A context that counts nvcc builds, device-table misses and new
    program keys (``repro_torch.analysis.recompile``)."""
    from repro_torch.analysis import recompile

    return recompile.watch_retrace(label)


def stats_dict(stats) -> dict:
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name != "label"}


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
