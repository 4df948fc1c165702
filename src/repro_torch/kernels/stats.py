"""Segmented L2-norm reduction (kernel K3): the DBench in-step probe.

The counterpart of ``repro/kernels/stats.py::l2_norms``.  DBench reads the
L2 norm of every parameter tensor on every node each iteration (paper
§3.1.2); at 10⁹-parameter scale that probe is a full sweep of device
memory, so it gets a kernel.  ``segment_l2_norms`` reduces column segments
of an (R, P) matrix given by an offsets table — over the port's flat
(G, P) parameter buffer that is the (G, n_leaves) probe, with no padded
(R, Pmax) copy — and ``l2_norms`` is its one-segment-per-row case.

The CUDA kernel (``csrc/l2_norms.cu``) reduces in two fixed-order passes
(per-tile partial sums, then a fixed-tree sum per segment): deterministic,
no float atomics.  CUDA tensors launch it and count the launch in
``segment_l2_norms.launches``; CPU tensors take the plain twin.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["l2_norms", "segment_l2_norms", "segment_l2_norms_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 1 << 15  # columns reduced by one block in pass 1


def segment_l2_norms_plain(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """The plain twin: (R, P) and n+1 column offsets -> (R, n) float32."""
    cols = [
        torch.sqrt(torch.sum(torch.square(x[:, a:b].float()), dim=1))
        for a, b in zip(offsets[:-1], offsets[1:])
    ]
    return torch.stack(cols, dim=1)


@lru_cache(maxsize=64)
def _tiles(offsets: tuple[int, ...], device):
    """Device tables (tile_start, tile_end, seg_first_tile) and the tile
    count for these segments, cached per (offsets, device)."""
    starts, ends, first = [], [], [0]
    for a, b in zip(offsets[:-1], offsets[1:]):
        for t in range(a, b, TILE):
            starts.append(t)
            ends.append(min(t + TILE, b))
        first.append(len(starts))
    i64 = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)
    return i64(starts), i64(ends), i64(first), len(starts)


def segment_l2_norms(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """Per-segment row L2 norms: (R, P) -> (R, len(offsets) - 1) float32.

    ``offsets`` are nondecreasing host integers in [0, P]; segment s is
    columns ``offsets[s]:offsets[s+1]`` of every row.
    """
    offsets = tuple(int(o) for o in offsets)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, P), got shape {tuple(x.shape)}")
    r, p = x.shape
    if len(offsets) < 2 or offsets[0] < 0 or offsets[-1] > p or any(
        a > b for a, b in zip(offsets[:-1], offsets[1:])
    ):
        raise ValueError(f"offsets must be nondecreasing within [0, {p}], got {offsets}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    if x.device.type == "cpu":
        return segment_l2_norms_plain(x, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    fn = _build.load("l2_norms").repro_segment_l2_norms
    starts, ends, first, n_tiles = _tiles(offsets, x.device)
    n_seg = len(offsets) - 1
    partial = torch.empty((r, max(n_tiles, 1)), dtype=torch.float32, device=x.device)
    out = torch.empty((r, n_seg), dtype=torch.float32, device=x.device)
    vec = 16 // x.element_size()
    vec_ok = p % vec == 0 and all(o % vec == 0 for o in offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            _DTYPES[x.dtype], x.data_ptr(), r, p, starts.data_ptr(), ends.data_ptr(),
            n_tiles, first.data_ptr(), n_seg, partial.data_ptr(), out.data_ptr(),
            int(vec_ok), stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_l2_norms kernel launch failed: CUDA error {err}")
    segment_l2_norms.launches += 1
    return out


segment_l2_norms.launches = 0


def l2_norms(x: torch.Tensor) -> torch.Tensor:
    """Row L2 norms of (R, P) -> (R,) float32."""
    return segment_l2_norms(x, (0, x.shape[1]))[:, 0]
