"""Fused gossip apply (kernels K1 and K2): momentum-SGD step + weighted
neighbor mix.

The counterpart of ``repro/kernels/gossip_update.py``:
``gossip_program_update`` (K1) with its glue ``fused_apply_stacked`` runs
over all G stacked nodes, and with ``fused_bucket_update`` over one
bucket (a column slice) of them; ``gossip_update`` (K2) with its glue
``fused_apply_shard`` runs over one rank's own node.  Per node i and
element p:

    m'  = u (beta m + g) + (1 - u) m
    w0' = w0 + Σ_k (1 - f_k) w_k
    post: θ' = w0' (θ - lr u m') + Σ_k f_k w_k n_k[p]
    pre:  θ' = w0' θ + Σ_k f_k w_k n_k[p] - lr u m'

with the per-node weight row w, fault row f = [u, edge_1..edge_deg] and
neighbour rows n_k: ``wire[srcs[i, k]]`` for K1 (``srcs`` from the
program's ``permute_tables``), row k of the permute landing buffer for K2.

State layout: the port holds the stacked state as flat (G, P) buffers
(``core/flat.py``).  The reference concatenates θ, g and m into fresh
(n, P) matrices, pads them to a block multiple and gathers an (n, deg, P)
neighbor copy; at granite-8b width that glue alone would not fit beside
the state on one card.  Here K1 reads neighbor rows straight from the
(G, P) wire through ``srcs``, masks the ragged tail itself, and writes
θ' and m' IN PLACE into the state buffers.  The only transient is the
wire: the senders' post-update θ* for ``mix_order="post"``, a copy of θ
for ``"pre"`` (the in-place update must not overwrite rows that other
nodes still read).  A rank sends its own θ* (or, for ``"pre"``, θ itself:
the landing buffer is filled before K2 writes θ) and K2 updates its (P,)
row in place.

A multi-round program (``GossipProgram.fuse``) runs its first round in
the kernel and the remaining rounds through ``mix_in_place``: the
program's interpreter over the flat buffer in column chunks, so no
whole-buffer float32 copy is made.

Each wrapper launches its CUDA kernel (``csrc/gossip_update.cu``) on CUDA
tensors and counts each launch in its ``launches``; for CPU tensors it
takes its plain twin (``*_plain``).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build

__all__ = [
    "gossip_program_update",
    "gossip_program_update_plain",
    "gossip_update",
    "gossip_update_plain",
    "gossip_wire",
    "fused_apply_stacked",
    "fused_apply_shard",
    "fused_bucket_update",
    "fault_rows",
    "mix_in_place",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# columns per chunk of the plain wire computation: bounds its float32
# temporaries to G × 2^24 × 4 bytes whatever the state size
WIRE_CHUNK = 1 << 24


def gossip_program_update_plain(theta, wire, srcs, weights, grad, mom, *,
                                lr, beta, fault, mix_order="post"):
    """The plain twin of K1: returns new (θ', m') and leaves its inputs alone.

    theta/wire/grad (G, P); mom (G, P) float32; srcs (G, deg) int;
    weights/fault (G, deg+1) float32.  θ, g, m and the wire may be column
    slices of wider buffers, as K1's operands may.
    """
    deg = srcs.shape[1]
    g = grad.float()
    m = mom.float()
    u = fault[:, :1]
    m_new = u * (beta * m + g) + (1.0 - u) * m
    self_w = weights[:, 0]
    for k in range(deg):
        self_w = self_w + (1.0 - fault[:, k + 1]) * weights[:, k + 1]
    self_w = self_w[:, None]
    base = theta.float()
    lru = lr * u
    if mix_order == "post":
        acc = self_w * (base - lru * m_new)
    else:
        acc = self_w * base
    idx = srcs.long()
    for k in range(deg):
        fw = (fault[:, k + 1] * weights[:, k + 1])[:, None]
        acc = acc + fw * wire.index_select(0, idx[:, k]).float()
    if mix_order == "pre":
        acc = acc - lru * m_new
    return acc.to(theta.dtype), m_new


def _check_operands(theta, want: dict, *, contiguous=True) -> None:
    """``want``: name -> (tensor, shape, dtype); each on θ's device, and
    contiguous unless ``contiguous`` is False."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != theta.device:
            raise ValueError(f"{name} is on {t.device}, theta on {theta.device}")
    if not contiguous:
        return
    for name, (t, _, _) in want.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _span(t):
    """[first, last) byte addresses a tensor's elements occupy."""
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride())) + 1
    return t.data_ptr(), t.data_ptr() + last * t.element_size()


def _check_disjoint(nbrs_name, nbrs, theta, mom) -> None:
    """The in-place update must not overwrite the neighbour rows it reads."""
    lo_n, hi_n = _span(nbrs)
    for name, t in (("theta", theta), ("mom", mom)):
        lo, hi = _span(t)
        if lo < hi_n and lo_n < hi:
            raise ValueError(
                f"{nbrs_name} overlaps {name}: the in-place update needs its own buffer"
            )


def _row_stride(t) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _check(theta, wire, srcs, weights, grad, mom, fault):
    """K1's operands; returns the row strides (ld_state, ld_wire).  θ, g
    and m may be column slices of wider buffers (a bucket of the flat
    state) but share one row stride; the wire its own; each row's
    elements are contiguous."""
    if theta.dim() != 2:
        raise ValueError(f"theta must be (G, P), got shape {tuple(theta.shape)}")
    g, p = theta.shape
    if theta.dtype not in _DTYPES:
        raise TypeError(f"theta dtype {theta.dtype} not supported (float32, bfloat16)")
    deg = srcs.shape[1] if srcs.dim() == 2 else -1
    _check_operands(theta, {
        "srcs": (srcs, (g, deg), torch.int32),
        "weights": (weights, (g, deg + 1), torch.float32),
        "fault": (fault, (g, deg + 1), torch.float32),
    })
    rows = {"theta": theta, "wire": wire, "grad": grad, "mom": mom}
    _check_operands(theta, {
        "wire": (wire, (g, p), theta.dtype),
        "grad": (grad, (g, p), theta.dtype),
        "mom": (mom, (g, p), torch.float32),
    }, contiguous=False)
    for name, t in rows.items():
        if p > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have contiguous rows, got strides {t.stride()}")
    ld_state = _row_stride(theta)
    if _row_stride(grad) != ld_state or _row_stride(mom) != ld_state:
        raise ValueError(
            "theta, grad and mom must share one row stride; got "
            f"{theta.stride()}, {grad.stride()}, {mom.stride()}"
        )
    _check_disjoint("wire", wire, theta, mom)
    return ld_state, _row_stride(wire)


def gossip_program_update(theta, wire, srcs, weights, grad, mom, *,
                          lr, beta, fault, mix_order="post"):
    """K1 over G stacked nodes; updates ``theta`` and ``mom`` IN PLACE and
    returns them.  Arguments as in ``gossip_program_update_plain``: θ, g
    and m may be column slices of wider buffers with one row stride (a
    bucket of the flat state), the wire has its own row stride; every row
    is contiguous.

    The launch is asynchronous on the current stream; a caller may drop its
    operands right after (the wire, say), because the caching allocator
    hands their memory only to work queued later on the same stream."""
    if mix_order not in ("post", "pre"):
        raise ValueError(f"mix_order must be 'post'|'pre', got {mix_order!r}")
    ld_state, ld_wire = _check(theta, wire, srcs, weights, grad, mom, fault)
    if theta.device.type == "cpu":
        new_t, new_m = gossip_program_update_plain(
            theta, wire, srcs, weights, grad, mom,
            lr=lr, beta=beta, fault=fault, mix_order=mix_order,
        )
        theta.copy_(new_t)
        mom.copy_(new_m)
        return theta, mom
    if theta.device.type != "cuda":
        raise ValueError(f"unsupported device {theta.device}")
    fn = _build.load("gossip_update").repro_gossip_program_update
    g, p = theta.shape
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = fn(
            _DTYPES[theta.dtype], int(mix_order == "pre"), theta.data_ptr(),
            wire.data_ptr(), grad.data_ptr(), mom.data_ptr(), weights.data_ptr(),
            fault.data_ptr(), srcs.data_ptr(), g, p, ld_state, ld_wire, srcs.shape[1],
            ctypes.c_float(float(lr)), ctypes.c_float(float(beta)), stream,
        )
    if err != 0:
        raise RuntimeError(f"gossip_program_update kernel launch failed: CUDA error {err}")
    gossip_program_update.launches += 1
    return theta, mom


gossip_program_update.launches = 0


def gossip_update_plain(theta, nbrs, weights, grad, mom, *, lr, beta, fault,
                        mix_order="post"):
    """The plain twin of K2: returns new (θ', m') and leaves its inputs alone.

    theta/grad (P,); mom (P,) float32; nbrs (deg, P) in θ's dtype;
    weights/fault (deg+1,) float32.  K1's twin on one node whose wire rows
    are the neighbours."""
    deg = nbrs.shape[0]
    srcs = torch.arange(deg, dtype=torch.int32, device=theta.device)[None]
    new_t, new_m = gossip_program_update_plain(
        theta[None], nbrs, srcs, weights[None], grad[None], mom[None],
        lr=lr, beta=beta, fault=fault[None], mix_order=mix_order,
    )
    return new_t[0], new_m[0]


def gossip_update(theta, nbrs, weights, grad, mom, *, lr, beta, fault,
                  mix_order="post"):
    """K2 over one node; updates ``theta`` and ``mom`` IN PLACE and returns
    them.  Arguments as in ``gossip_update_plain``.  Asynchronous on the
    current stream, as K1."""
    if mix_order not in ("post", "pre"):
        raise ValueError(f"mix_order must be 'post'|'pre', got {mix_order!r}")
    if theta.dim() != 1:
        raise ValueError(f"theta must be (P,), got shape {tuple(theta.shape)}")
    if theta.dtype not in _DTYPES:
        raise TypeError(f"theta dtype {theta.dtype} not supported (float32, bfloat16)")
    (p,) = theta.shape
    deg = nbrs.shape[0] if nbrs.dim() == 2 else -1
    _check_operands(theta, {
        "theta": (theta, (p,), theta.dtype),
        "nbrs": (nbrs, (deg, p), theta.dtype),
        "grad": (grad, (p,), theta.dtype),
        "mom": (mom, (p,), torch.float32),
        "weights": (weights, (deg + 1,), torch.float32),
        "fault": (fault, (deg + 1,), torch.float32),
    })
    _check_disjoint("nbrs", nbrs, theta, mom)
    if theta.device.type == "cpu":
        new_t, new_m = gossip_update_plain(
            theta, nbrs, weights, grad, mom,
            lr=lr, beta=beta, fault=fault, mix_order=mix_order,
        )
        theta.copy_(new_t)
        mom.copy_(new_m)
        return theta, mom
    if theta.device.type != "cuda":
        raise ValueError(f"unsupported device {theta.device}")
    fn = _build.load("gossip_update").repro_gossip_update
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = fn(
            _DTYPES[theta.dtype], int(mix_order == "pre"), theta.data_ptr(),
            nbrs.data_ptr(), grad.data_ptr(), mom.data_ptr(), weights.data_ptr(),
            fault.data_ptr(), p, deg,
            ctypes.c_float(float(lr)), ctypes.c_float(float(beta)), stream,
        )
    if err != 0:
        raise RuntimeError(f"gossip_update kernel launch failed: CUDA error {err}")
    gossip_update.launches += 1
    return theta, mom


gossip_update.launches = 0


# ---------------------------------------------------------------------------
# Program-level glue: one decentralized SGD round over flat (G, P) buffers
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _device_tables(program, device):
    """(srcs int32, weights float32, all-ones fault rows, host srcs) on
    ``device``, cached per program: a step uploads nothing (and so never
    waits on a host-to-device copy) once its program is known."""
    tables = program.permute_tables()
    if tables is None:
        raise ValueError(
            f"program {program.name!r} is not an all-PPermute single round; "
            "fused apply supports permute programs only"
        )
    srcs, weights = tables
    return (
        torch.as_tensor(srcs, dtype=torch.int32, device=device),
        torch.as_tensor(weights, dtype=torch.float32, device=device),
        torch.ones(weights.shape, dtype=torch.float32, device=device),
        srcs,
    )


def fault_rows(program, fault, device) -> torch.Tensor:
    """(n, deg+1) float32 kernel fault rows [update, edge_1..deg] of a
    permute program on ``device``, from the runtime masks ``{"update":
    (n,), "alive": (n,), "link": (n, n) or None}`` (``core/faults.py``'s
    ``realization_arrays``): edge k of node i carries alive[i] ·
    alive[srcs[i, k]] (· link[i, srcs[i, k]]), so a float drain boost is
    linear, as in the masked interpreters.  Device ops over the cached
    tables: an engine builds them once per step, never per bucket."""
    srcs_t = _device_tables(program, device)[0]
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    idx = srcs_t.long()
    af = f32(fault["alive"])
    m = af[idx] * af[:, None]
    link = fault.get("link")
    if link is not None:
        rows = torch.arange(program.n, device=device)[:, None]
        m = m * f32(link)[rows, idx]
    u = f32(fault["update"])
    return torch.cat([u[:, None], m], dim=1).contiguous()


def gossip_wire(theta, grad, mom, *, lr, beta, mix_order="post", update=None):
    """The (G, P) buffer every node sends, in θ's dtype and contiguous
    (θ, g and m may be column slices): the senders' post-update
    θ* = θ − lr (β m + g) for ``mix_order="post"`` (a node with ``update``
    0 sends its un-updated θ), a copy of θ for ``"pre"``.  Plain torch in
    column chunks of ``WIRE_CHUNK``, as the reference computes it in plain
    jnp."""
    if mix_order != "post":
        return theta.clone(memory_format=torch.contiguous_format)
    p = theta.shape[1]
    wire = torch.empty(theta.shape, dtype=theta.dtype, device=theta.device)
    for a in range(0, p, WIRE_CHUNK):
        b = min(a + WIRE_CHUNK, p)
        step = mom[:, a:b] * beta
        step.add_(grad[:, a:b])
        if update is not None:
            step.mul_(update)
        wire[:, a:b].copy_(step.mul_(-lr).add_(theta[:, a:b]))
    return wire


def fused_apply_stacked(program, theta, grad, mom, *, lr, beta, fault=None,
                        mix_order: str = "post"):
    """One fused momentum-SGD + gossip round for a compiled PPermute program.

    ``theta``/``grad`` (G, P) and ``mom`` (G, P) float32 — or None when the
    optimizer keeps no momentum (beta == 0) — are flat state buffers;
    ``theta`` and ``mom`` are updated IN PLACE and returned.  ``fault``
    carries runtime masks (``{"update", "alive", "link"}``): straggling or
    dead nodes skip the update and send their un-updated rows, dropped
    edges renormalize onto self inside the kernel.  Raises ``ValueError``
    for programs with non-permute ops.
    """
    srcs_t, weights_t, ones_t, _ = _device_tables(program, theta.device)
    n, p = theta.shape
    had_m = mom is not None
    if not had_m:
        mom = torch.zeros((n, p), dtype=torch.float32, device=theta.device)
    rows = ones_t if fault is None else fault_rows(program, fault, theta.device)
    lr, beta = float(lr), float(beta)
    wire = gossip_wire(theta, grad, mom, lr=lr, beta=beta, mix_order=mix_order,
                       update=None if fault is None else rows[:, :1])
    gossip_program_update(
        theta, wire, srcs_t, weights_t, grad, mom,
        lr=lr, beta=beta, fault=rows, mix_order=mix_order,
    )
    return theta, (mom if had_m else None)


def fused_bucket_update(program, theta_b, grad_b, mom_b, *, lr, beta, fault=None,
                        mix_order: str = "post"):
    """One bucket's fused momentum-SGD + gossip round: K1 launched IN PLACE
    on the bucket's (G, w) column views of the flat θ, g and m buffers.

    The bucket is the kernel's outer dispatch unit: the engines call this
    once per ``BucketLayout`` bucket.  The weight rows and the all-ones
    fault rows are the program's cached device tables (a bucket's width
    never enters them); ``fault``, under faults, is the step's (G, deg+1)
    kernel fault rows (``fault_rows``), built once per step and shared by
    every bucket, since they are per node, not per column: stragglers and
    dead nodes send their un-updated columns.  The bucket's wire, the
    senders' θ* over its columns, is a fresh contiguous (G, w) buffer.
    ``mom_b`` None (a momentum-free optimizer) runs K1 on contiguous copies
    of the bucket with a zero momentum buffer.  Returns ``(theta_b,
    mom_b)``."""
    if mom_b is None:
        theta = theta_b.contiguous()
        mom = torch.zeros(theta.shape, dtype=torch.float32, device=theta.device)
        fused_bucket_update(program, theta, grad_b.contiguous(), mom, lr=lr, beta=beta,
                            fault=fault, mix_order=mix_order)
        theta_b.copy_(theta)
        return theta_b, None
    srcs_t, weights_t, ones_t, _ = _device_tables(program, theta_b.device)
    lr, beta = float(lr), float(beta)
    wire = gossip_wire(theta_b, grad_b, mom_b, lr=lr, beta=beta, mix_order=mix_order,
                       update=None if fault is None else fault[:, :1])
    gossip_program_update(theta_b, wire, srcs_t, weights_t, grad_b, mom_b,
                          lr=lr, beta=beta, fault=ones_t if fault is None else fault,
                          mix_order=mix_order)
    return theta_b, mom_b


def fused_apply_shard(program, theta, grad, mom, comm, *, lr, beta, fault=None,
                      mix_order: str = "post"):
    """The one-rank-per-node twin of ``fused_apply_stacked``: one fused
    momentum-SGD + gossip round on this rank's flat (P,) buffers.

    ``theta``/``grad`` (P,) and ``mom`` (P,) float32 (or None when the
    optimizer keeps no momentum); ``theta`` and ``mom`` are updated IN
    PLACE and returned.  The rank computes its wire (θ* for ``"post"``, θ
    for ``"pre"``) as the reference's glue does, runs one ``comm.permute``
    per compiled permute into a (deg, P) landing buffer (a rank that idles
    in a round receives zeros, matching the zero weight in its row), then
    K2 with its own weight and fault rows.  ``fault`` carries the runtime
    masks ``{"update", "alive", "link"}`` of all nodes; this rank takes its
    row.  Raises ``ValueError`` for programs with non-permute ops."""
    srcs_t, weights_t, ones_t, srcs_np = _device_tables(program, theta.device)
    n, deg = srcs_np.shape
    if comm.world != n:
        raise ValueError(f"program over {n} nodes on a world of {comm.world}")
    i = comm.rank
    (p,) = theta.shape
    had_m = mom is not None
    if not had_m:
        mom = torch.zeros(p, dtype=torch.float32, device=theta.device)
    frow = ones_t[i] if fault is None else fault_rows(program, fault, theta.device)[i]
    lr, beta = float(lr), float(beta)
    if mix_order == "post":
        wire = gossip_wire(theta[None], grad[None], mom[None], lr=lr, beta=beta,
                           update=None if fault is None else frow[None, :1])[0]
    else:
        wire = theta
    landing = torch.empty((deg, p), dtype=theta.dtype, device=theta.device)
    for k, op in enumerate(program.ops):
        comm.permute(wire, op.perm, out=landing[k])
    del wire
    gossip_update(theta, landing, weights_t[i], grad, mom,
                  lr=lr, beta=beta, fault=frow, mix_order=mix_order)
    return theta, (mom if had_m else None)


def mix_in_place(stages, theta, mix) -> None:
    """Run ``stages`` (mixing programs, in order) over the flat (rows, P)
    buffer ``theta`` IN PLACE, ``WIRE_CHUNK`` columns at a time: ``mix(stage,
    x)`` applies one stage to a (rows, k) block (the stacked interpreter,
    or the shard interpreter on a rank).  Mixing is column-wise, so the
    chunks are independent."""
    if not stages:
        return
    p = theta.shape[1]
    for a in range(0, p, WIRE_CHUNK):
        block = theta[:, a:min(a + WIRE_CHUNK, p)]
        x = block
        for stage in stages:
            x = mix(stage, x)
        block.copy_(x)
