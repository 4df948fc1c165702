"""Mamba2's grouped SSD chunk scan, forward and backward (kernel K5).

The function of ``models/recurrence.py::_ssd_groups``: per head j of H,
reading group g = j // (H / G) of B and C,

    h_t = exp(dt_t a_j) h_{t-1} + dt_t x_t B_tᵀ        (h: P × N)
    y_t = h_t C_t

over x (B, L, H, P), dt (B, L, H), B and C (B, L, G, N) group-major, a
(H,) and h0 (B, H, P, N); y (B, L, H, P) and the final state, float32.
The JAX package has no SSD kernel (its scan is plain ``jnp``): K5 replaces
no Pallas kernel.

Algorithm: the sequence is walked in sub-chunks of 64 rows, the chunked
SSD at a 64-row chunk.  Within a sub-chunk the pairs' decays
exp(la_t − la_s) (la the sub-chunk's cumulative dt·a, s ≤ t); across
sub-chunks the state that enters each one.  The result does not depend on
the caller's chunk (zero rows past L are neutral: dt 0 leaves the state as
it is), so the scan takes any L and ``ssd_chunked``'s chunk only sets the
eager route's padding.  The forward keeps the (B, H, L/64 + 1, P, N)
states that enter each sub-chunk (the last is the final state); the
backward walks the sub-chunks in reverse from them, recomputing every
decay, and saves nothing of shape (…, chunk, chunk).

``ssd_scan`` checks shapes (P = N = 64: the kernel's tiles) and raises
``SSDScanShapeError`` on any other, on every device; it takes CUDA float32
tensors only (CPU, meta and float64 inputs take ``ssd_chunked``'s eager
``_ssd_groups``).  The kernel pair (``csrc/ssd_scan.cu``) is counted in
``ssd_scan.launches`` (forward) and ``ssd_scan.backward_launches``, and
each forward counts ``ssd_kernel`` in an open device trace.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.telemetry.recorder import trace_count

__all__ = ["ssd_scan", "scan_cost", "SSDScanShapeError"]

ROWS = 64        # rows of a sub-chunk
WIDTH = 64       # P and N: the kernel's 64 × 64 tiles


class SSDScanShapeError(ValueError):
    """An input shape the SSD scan kernel does not take."""


def check_shapes(x, dt, b_in, c_in, a, h0) -> None:
    """Raise ``SSDScanShapeError`` unless the inputs are one grouped scan
    the kernel takes: x (B, L, H, 64), dt (B, L, H), B and C (B, L, G, 64)
    with G dividing H, a (H,), h0 (B, H, 64, 64)."""
    if x.dim() != 4 or b_in.dim() != 4:
        raise SSDScanShapeError(
            f"x must be (B, L, H, P) and B, C (B, L, G, N); got {tuple(x.shape)}, "
            f"{tuple(b_in.shape)}")
    bsz, l, h, p = x.shape
    g, n = b_in.shape[2:]
    if p != WIDTH or n != WIDTH:
        raise SSDScanShapeError(f"the SSD scan kernel takes P = N = {WIDTH}; got P {p}, N {n}")
    if g == 0 or h % g:
        raise SSDScanShapeError(f"heads {h} must be a multiple of groups {g}")
    want = {"dt": (bsz, l, h), "c_in": (bsz, l, g, n), "a": (h,), "h0": (bsz, h, p, n)}
    for name, t in (("dt", dt), ("c_in", c_in), ("a", a), ("h0", h0)):
        if tuple(t.shape) != want[name]:
            raise SSDScanShapeError(f"{name} must be {want[name]}; got {tuple(t.shape)}")
    if tuple(b_in.shape) != (bsz, l, g, n):
        raise SSDScanShapeError(f"b_in must be {(bsz, l, g, n)}; got {tuple(b_in.shape)}")


def scan_cost(bsz: int, l: int, h: int, g: int) -> tuple[dict, dict]:
    """({"forward", "backward"}: FLOPs, {...}: least bytes) of one scan
    with P = N = 64, the work the function needs at 64-row sub-chunks and
    not the work K5 does: 2 · 64³ FLOPs a tile product; C Bᵀ once per
    group and sub-chunk, its lower triangle only (half a product); per head
    and sub-chunk 2.5 products forward (M X half: M is lower triangular;
    C hᵀ; the state's Xᵀ (w B)) and 6 backward (dY Xᵀ half: only s ≤ t is
    read; B dHᵀ, dY h, X dH and dYᵀ (e^la C) whole; Sᵀ dY, dCB B and
    dCBᵀ C half).  Bytes: each input read and each output written once,
    float32, the states (B, H, k + 1, P, N) written by the forward and
    read by the backward."""
    k = -(-l // ROWS)
    heads, groups_k = bsz * h * k, bsz * g * k
    prod = 2 * WIDTH ** 3
    seq, gates = bsz * l * h * WIDTH * 4, bsz * l * h * 4
    groups, state = 2 * bsz * l * g * WIDTH * 4, bsz * h * WIDTH * WIDTH * 4
    states = state * (k + 1)
    return ({"forward": prod * (2.5 * heads + 0.5 * groups_k),
             "backward": prod * (6.0 * heads + 0.5 * groups_k)},
            {"forward": 2 * seq + gates + groups + state + states,
             "backward": 3 * seq + 2 * gates + 2 * groups + 2 * state + states})


# ---------------------------------------------------------------------------
# the kernel pair

def _launch(fn_name, *args) -> None:
    fn = getattr(_build.load("ssd_scan"), fn_name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def _dense(t):
    """t contiguous and on a 16-byte boundary (the kernels read float4s)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _kernel_forward(x, dt, b_in, c_in, a, h0):
    bsz, l, h, p = x.shape
    g = b_in.shape[2]
    k = -(-l // ROWS)
    y = torch.empty_like(x)
    states = torch.empty((bsz, h, k + 1, p, p), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch("repro_ssd_scan_forward", x.data_ptr(), dt.data_ptr(), b_in.data_ptr(),
                c_in.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(), states.data_ptr(),
                bsz, l, h, g, stream)
    return y, states


def _kernel_backward(x, dt, b_in, c_in, a, states, dy, dh):
    bsz, l, h, p = x.shape
    g, n = b_in.shape[2:]
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    # each head's share of dB and dC, summed over the group's heads below
    db_heads = torch.empty((bsz, l, h, n), dtype=x.dtype, device=x.device)
    dc_heads = torch.empty_like(db_heads)
    dh0 = torch.empty((bsz, h, p, n), dtype=x.dtype, device=x.device)
    da_rows = torch.empty((bsz, h), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch("repro_ssd_scan_backward", x.data_ptr(), dt.data_ptr(), b_in.data_ptr(),
                c_in.data_ptr(), a.data_ptr(), states.data_ptr(), dy.data_ptr(),
                0 if dh is None else dh.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), db_heads.data_ptr(), dc_heads.data_ptr(),
                dh0.data_ptr(), da_rows.data_ptr(), bsz, l, h, g, stream)
    grouped = lambda t: t.view(bsz, l, g, h // g, n).sum(3)
    return dx, ddt, grouped(db_heads), grouped(dc_heads), da_rows.sum(0), dh0


class _SSDScan(torch.autograd.Function):
    """The kernel pair under autograd; ``ssd_scan`` checks its inputs."""

    @staticmethod
    def forward(ctx, x, dt, b_in, c_in, a, h0):
        y, states = _kernel_forward(x, dt, b_in, c_in, a, h0)
        ssd_scan.launches += 1
        ctx.save_for_backward(x, dt, b_in, c_in, a, states)
        return y, states[:, :, -1].clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh):
        x, dt, b_in, c_in, a, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else _dense(dy)
        dh = None if dh is None else _dense(dh)
        grads = _kernel_backward(x, dt, b_in, c_in, a, states, dy, dh)
        ssd_scan.backward_launches += 1
        return grads


def ssd_scan(x, dt, b_in, c_in, a, h0):
    """The grouped SSD scan on CUDA float32 tensors: (y (B, L, H, P), final
    state (B, H, P, N)), both float32, differentiable in every input.
    Raises ``SSDScanShapeError`` on a shape the kernel does not take, on
    every device, then ``ValueError`` on any device but CUDA."""
    check_shapes(x, dt, b_in, c_in, a, h0)
    ts = (x, dt, b_in, c_in, a, h0)
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"the SSD scan's inputs lie on different devices: {[t.device for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"the SSD scan takes float32; got {[t.dtype for t in ts]}")
    if not x.is_cuda:
        raise ValueError(f"the SSD scan kernel runs on CUDA tensors; got {x.device} "
                         "(ssd_chunked takes the eager _ssd_groups there)")
    y, h_final = _SSDScan.apply(*(_dense(t) for t in ts))
    trace_count("ssd_kernel", 1)
    return y, h_final


ssd_scan.launches = 0
ssd_scan.backward_launches = 0
