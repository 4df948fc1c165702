"""Bucketed gossip execution: the counterpart of ``repro/core/buckets.py``.

The reference partitions the flattened parameter vector into buckets of
about ``bucket_mb`` MiB and runs each mixing step as one update + gossip
dispatch per bucket instead of one monolithic tail, so that bucket i's
collectives can overlap bucket i+1's compute, and it folds each bucket's
share of the consensus distance Ξ² into that dispatch, so that a
closed-loop probe after a bucketed step needs no pass of its own.  In the
port the fold is an eager reduction over each bucket after its mix: it
reads the state once more, as the standalone probe does, and costs about
as much as that probe until a fused fold kernel exists.

``BucketLayout``
    The same deterministic, size-targeted partition as the reference's,
    bounds and segments alike, for the same leaf sizes and ``bucket_mb``
    (float32 accounting, so the layout depends on shapes only).  The
    port's state is flat (``core/flat.py``: (n, P) buffers with the leaves
    in the reference's leaf order), so bucket b is the column range
    ``bounds[b]:bounds[b+1]`` of every buffer: splitting and merging are
    column views (``views``), never copies.

``build_bucket_step``
    The per-bucket step: bucket b's SGD-family update and its mixing
    rounds, IN PLACE on the bucket's column views of θ and m, through the
    program's interpreter or, with ``kernel_split``, through kernel K1
    (``kernels/gossip_update.py::fused_bucket_update``) for the first
    round; then, when the caller asks for it, the bucket's per-node
    partial Σ_c (x_ic − x̄_c)² over its post-mix values, added to a running
    (n,) float32 token.  Summed over the buckets that is Ξ² of the whole
    new state (the consensus distance decomposes per column) up to float32
    rounding, and ``xi_from_folded_sq`` turns it into Ξ with one host read.

``XiFold``
    What both engines share around it: the bucket loop, the decision to
    fold (the controller probes at the next step) and the closed-loop
    probe that reads the fold, or the whole state when no fold is there.

A mixed-dtype state (float32, bf16 leaves beside float32 ones) buckets
too: a bucket's segments give its dtype runs (``BucketLayout.dtype_runs``),
and the bucket step rounds or mixes each narrower run in its own dtype
where the leaf-by-leaf step would.

The simulator's split state (``core/node_split.NodeBlocks``) buckets too:
a bucket is the same column range of every row block, the update runs on
each block's card, the mix through the program's split interpreter, and
the fold's per-bucket Ξ² partial sum over the bucket's rows gathered to
the first card, as unsplit.

On one card every bucket's work goes to one CUDA stream, which orders the
buckets by itself: the engines neither wait for a bucket nor hold a
dispatch window.  Under faults the bucket step gates the update and mixes
with the runtime masks (``build_bucket_step(fault=...)``); the kernel's
fault rows are built once per step, since they are per node, not per
column.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

from repro_torch.core.consensus import consensus_sq_stacked
from repro_torch.core.flat import round_columns_
from repro_torch.core.node_split import as_blocks, blocks_of, cols, like

__all__ = [
    "BucketLayout",
    "MAX_INFLIGHT_BUCKETS",
    "build_bucket_step",
    "bucket_eligible_optimizer",
    "check_bucketable",
    "XiFold",
    "xi_from_folded_sq",
]

_F32_BYTES = 4  # layout accounting is dtype-independent by design

# The reference's dispatch window: a bucket chain whose buckets carry
# collectives (the reference's XLA engines; the ranks engine's overlap, a
# later slice) keeps at most this many buckets in flight.  The port's
# bucketed engines run on one stream and need no window: the constant is
# kept for parity with the reference (its tests read it) until the ranks
# engine's overlap brings a caller.
MAX_INFLIGHT_BUCKETS = 4


def _sizes(tree: Mapping[str, torch.Tensor], lead: int) -> tuple[int, ...]:
    sizes = []
    for leaf in tree.values():
        size = 1
        for d in tuple(leaf.shape)[lead:]:
            size *= int(d)
        sizes.append(size)
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Deterministic size-targeted partition of a flattened parameter tree.

    ``sizes`` is the per-node flat element count of each leaf in leaf
    order; ``bucket_elems`` the target elements per bucket.  The partition
    is contiguous equal-width column ranges of the concatenated [0, P)
    vector: every bucket but the last has exactly ``bucket_elems``
    elements, and buckets cross leaf boundaries freely.
    """

    sizes: tuple[int, ...]
    bucket_elems: int

    def __post_init__(self):
        if self.bucket_elems < 1:
            raise ValueError(f"bucket_elems must be >= 1, got {self.bucket_elems}")
        if any(s < 0 for s in self.sizes):
            raise ValueError(f"negative leaf size in {self.sizes}")

    # -- constructors --------------------------------------------------------
    @staticmethod
    def elems_for_mb(bucket_mb: float) -> int:
        """Target elements per bucket for a MiB budget (float32 accounting)."""
        return max(1, int(float(bucket_mb) * (1 << 20)) // _F32_BYTES)

    @classmethod
    def for_stacked(cls, tree: Mapping[str, torch.Tensor], bucket_mb: float) -> "BucketLayout":
        """Layout for a dict of (n, ...) leaves (shapes only are read), in
        the dict's order, which is the port's leaf order."""
        return cls(_sizes(tree, 1), cls.elems_for_mb(bucket_mb))

    @classmethod
    def for_local(cls, tree: Mapping[str, torch.Tensor], bucket_mb: float) -> "BucketLayout":
        """Layout for one node's (un-stacked) dict of leaves.  Kept for
        parity with the reference; the ranks engine's per-bucket overlap
        (a later slice) is its first caller in the port."""
        return cls(_sizes(tree, 0), cls.elems_for_mb(bucket_mb))

    # -- derived views -------------------------------------------------------
    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def num_buckets(self) -> int:
        p = self.total
        if p == 0:
            return 1
        return -(-p // self.bucket_elems)

    @property
    def bounds(self) -> tuple[int, ...]:
        """Bucket boundaries 0 = b_0 < b_1 < ... < b_B = P."""
        cached = self.__dict__.get("_bounds")
        if cached is None:
            p = self.total
            cuts = list(range(0, p, self.bucket_elems)) + [p]
            if len(cuts) == 1:  # empty tree: one empty bucket
                cuts = [0, 0]
            cached = tuple(cuts)
            object.__setattr__(self, "_bounds", cached)
        return cached

    @property
    def widths(self) -> tuple[int, ...]:
        b = self.bounds
        return tuple(b[i + 1] - b[i] for i in range(len(b) - 1))

    @property
    def segments(self) -> tuple[tuple[tuple[int, int, int], ...], ...]:
        """Per bucket: ``(leaf_index, start, stop)`` slices in leaf-local flat
        coordinates."""
        cached = self.__dict__.get("_segments")
        if cached is None:
            starts, off = [], 0
            for s in self.sizes:
                starts.append(off)
                off += s
            out = []
            b = self.bounds
            for k in range(len(b) - 1):
                lo, hi = b[k], b[k + 1]
                segs = []
                for li, (s0, sz) in enumerate(zip(starts, self.sizes)):
                    s, e = max(lo, s0), min(hi, s0 + sz)
                    if e > s:
                        segs.append((li, s - s0, e - s0))
                out.append(tuple(segs))
            cached = tuple(out)
            object.__setattr__(self, "_segments", cached)
        return cached

    def dtype_runs(self, dtypes) -> tuple[tuple[tuple[int, int, torch.dtype], ...], ...]:
        """Per bucket: ``(start, stop, dtype)`` column ranges, local to the
        bucket, that cover it in order, each of one leaf dtype (``dtypes``:
        each leaf's, in leaf order); adjacent segments of one dtype merge.
        A mixed state's bucket step mixes each run in its own dtype."""
        starts, off = [], 0
        for s in self.sizes:
            starts.append(off)
            off += s
        out = []
        for lo, segs in zip(self.bounds, self.segments):
            runs: list[tuple[int, int, torch.dtype]] = []
            for li, s, e in segs:
                a, b, dt = starts[li] + s - lo, starts[li] + e - lo, dtypes[li]
                if runs and runs[-1][2] == dt and runs[-1][1] == a:
                    runs[-1] = (runs[-1][0], b, dt)
                else:
                    runs.append((a, b, dt))
            out.append(tuple(runs))
        return tuple(out)

    def describe(self) -> str:
        return (
            f"BucketLayout(P={self.total}, target={self.bucket_elems}, "
            f"buckets={self.num_buckets}, widths={self.widths})"
        )

    def views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """Bucket views of a flat buffer whose last axis is [0, P): (..., w_b)
        column slices that share its storage (of a split buffer, each a
        NodeBlocks of its blocks' slices)."""
        if flat.shape[-1] != self.total:
            raise ValueError(
                f"buffer of {flat.shape[-1]} columns does not match layout of {self.total}"
            )
        b = self.bounds
        return [cols(flat, b[i], b[i + 1]) for i in range(len(b) - 1)]


# ---------------------------------------------------------------------------
# The per-bucket step (shared by both engines)
# ---------------------------------------------------------------------------

def bucket_eligible_optimizer(optimizer) -> bool:
    """Can this optimizer's update run independently per bucket?  True for
    the SGD family, whose update is elementwise; AdamW (a global step
    count in its state) and LARS (per-layer trust ratios, which a bucket
    boundary would cut) keep the monolithic path."""
    hyper = optimizer.hyper or {}
    return hyper.get("kind") == "sgd"


def check_bucketable(optimizer, topology) -> None:
    """The engines' ``bucket_mb`` gate: raise unless the optimizer is of
    the SGD family, the topology decentralized and mixing after the
    update."""
    if not bucket_eligible_optimizer(optimizer):
        raise ValueError(
            "bucket_mb requires an SGD-family optimizer (elementwise update; "
            f"got {optimizer.name}): AdamW's global step counter and LARS's "
            "per-layer norms do not bucket"
        )
    if topology.centralized:
        raise ValueError("bucket_mb needs a decentralized topology")
    if topology.mix_order != "post":
        raise ValueError(
            "bucket_mb requires mix_order='post' (pre-mixing must see the full "
            "state before the update: nothing to pipeline behind)"
        )


def xi_from_folded_sq(folded_sq) -> float:
    """Ξ from the folded per-node partial sums: √mean, one host read."""
    sq = torch.as_tensor(folded_sq)
    return float(sq.float().mean().sqrt()) if sq.numel() else 0.0


def build_bucket_step(
    program,
    *,
    hyper: dict,
    has_momentum: bool,
    mix_order: str = "post",
    fault: Optional[dict] = None,
    kernel_split=None,
    engine: str = "stacked",
) -> Callable:
    """The per-bucket step for one program::

        fn(theta_b, mom_b, grad_b, lr, tok, runs=None) -> tok'

    on one bucket's (n, w) column views (``mom_b`` None when
    ``has_momentum`` is False): the SGD-family update of ``hyper`` and the
    program's mixing rounds, written IN PLACE into ``theta_b`` and
    ``mom_b``.  ``runs`` (the bucket's ``BucketLayout.dtype_runs``) is
    given for a mixed-dtype state: each run narrower than ``theta_b``
    holds a narrower leaf's columns, which the interpreter path mixes in
    that dtype (the update's result rounded to it first), as the
    leaf-by-leaf step updates and mixes the leaf, and the kernel path
    rounds after the kernel's round and after each later round, as the
    monolithic fused step does; so the bucketed step is the monolithic
    one bit for bit and the fold reads rounded columns.  ``tok`` is the
    running (n,) float32 Ξ² accumulator, or None when no probe reads the
    fold: ``tok' = tok + partial_b``, the
    bucket's per-node post-mix Σ_c (x_ic − x̄_c)², centred on node 0 first
    (``consensus_sq_stacked``), so identical replicas give exactly 0.

    ``kernel_split=(first, rest)`` runs the update and the first round in
    kernel K1 (``fused_bucket_update``, plain momentum-SGD only) and the
    later rounds through the stacked interpreter; None runs the update
    (the optimizer's own arithmetic, so bit for bit the monolithic step's)
    and the program's ``engine`` interpreter ("stacked" or "dense").
    ``fault`` (the step's runtime masks, ``core/faults.realization_arrays``)
    builds the fault-aware step: a node with ``update`` 0 keeps its θ and
    m, and every round mixes with ``apply_masked``; on the kernel path
    the fault rows are built here, once, for every bucket of the step.
    Only ``mix_order="post"`` buckets: with "pre" the descent must follow
    the whole mix, so the engines keep the monolithic step.
    """
    from repro_torch.kernels.gossip_update import (
        fault_rows, fused_bucket_update, mix_in_place,
    )
    from repro_torch.optim.sgd import sgd

    if mix_order != "post":
        raise ValueError("bucketed execution requires mix_order='post'")
    if hyper.get("kind") != "sgd":
        raise ValueError(f"bucketed execution supports the SGD family only, got {hyper!r}")
    beta = float(hyper.get("momentum", 0.0))
    wd = float(hyper.get("weight_decay", 0.0) or 0.0)
    nesterov = bool(hyper.get("nesterov", False))
    if kernel_split is not None and (wd or nesterov):
        raise ValueError("the fused kernel path supports plain momentum-SGD only")
    update = sgd(momentum=beta, weight_decay=wd, nesterov=nesterov).update
    rows = None
    if fault is None:
        mix = lambda stage, x, eng="stacked": stage.apply(x, engine=eng)
    else:
        mix = lambda stage, x, eng="stacked": stage.apply_masked(
            x, fault["alive"], link_up=fault["link"], engine=eng)
        ucol = torch.as_tensor(fault["update"])[:, None] > 0
        if kernel_split is not None:
            rows = fault_rows(kernel_split[0], fault, ucol.device)

    def bucket_step(theta_b, mom_b, grad_b, lr, tok: Optional[torch.Tensor], runs=None):
        if runs is not None and all(dt == theta_b.dtype for _, _, dt in runs):
            runs = None
        if kernel_split is not None:
            first, rest = kernel_split
            fused_bucket_update(first, theta_b, grad_b, mom_b, lr=lr, beta=beta, fault=rows)
            if runs is None:
                mix_in_place(rest, theta_b, mix)
            else:
                round_columns_(theta_b, runs)
                for stage in rest:
                    mix_in_place((stage,), theta_b, mix)
                    round_columns_(theta_b, runs)
        else:
            # the update on each row block (the whole bucket when unsplit)
            ts, ms = blocks_of(theta_b), blocks_of(mom_b) if has_momentum else None
            ucols = None if fault is None else as_blocks(theta_b).per_node(ucol)
            new_ts, new_ms = [], []
            for j, (tb, gb) in enumerate(zip(ts, blocks_of(grad_b))):
                state = {"b": ms[j]} if has_momentum else ()
                new_p, new_m = update({"b": gb}, state, {"b": tb}, lr)
                new_t = new_p["b"]
                if fault is not None:
                    # stragglers and dead nodes skip their local update
                    new_t = torch.where(ucols[j], new_t, tb)
                    if has_momentum:
                        new_m = {"b": torch.where(ucols[j], new_m["b"], ms[j])}
                new_ts.append(new_t)
                new_ms.append(new_m)
            new_t = like(theta_b, new_ts)
            if runs is None:
                theta_b.copy_(mix(program, new_t, engine))
            else:
                for a, b, dt in runs:
                    cols(theta_b, a, b).copy_(mix(program, cols(new_t, a, b).to(dt), engine))
            if has_momentum:
                for mb, new_m in zip(ms, new_ms):
                    mb.copy_(new_m["b"])
        if tok is None:
            return None
        return tok + consensus_sq_stacked(theta_b)

    return bucket_step


class XiFold:
    """The Ξ² fold of the bucketed step and the closed-loop probe that
    reads it, one per engine.

    ``run`` runs one mixing step's bucket step over every bucket; when
    the controller probes at the next step it adds each bucket's Ξ²
    partial sum to a running (n,) token kept for that probe.  ``probe``
    is the engine's closed-loop probe at a step: Ξ from the fold when the
    last bucketed step left one for this step, else ``standalone()`` (the
    pass over the whole state); a ``xi`` gauge; the controller observes
    it.  The fold re-reads each bucket after its mix, so until a fused
    fold kernel exists it costs about what the standalone probe does.
    """

    def __init__(self):
        self.sq: Optional[torch.Tensor] = None   # the folded (n,) Ξ² token
        self.step = -1                           # the probe it is valid for

    def run(self, fn, layout: BucketLayout, theta, mom, grad, lr, *, controller, telemetry,
            step: int, fold: bool = True, runs=None) -> None:
        """Run the bucket step ``fn`` (``build_bucket_step``) over every
        bucket of the flat (n, P) buffers ``theta``, ``mom`` (None without
        momentum) and ``grad``, in bucket order, with a ``bucket`` span per
        bucket (host dispatch time; nothing waits for the device).  A fault
        run passes ``fold=False``: its probes are over the members only.
        ``runs`` (``layout.dtype_runs``) is given for a mixed-dtype state."""
        fold = fold and controller is not None and controller.should_probe(step + 1)
        tok = torch.zeros(theta.shape[0], dtype=torch.float32, device=theta.device) if fold else None
        moms = layout.views(mom) if mom is not None else [None] * layout.num_buckets
        for b, (tb, mb, gb) in enumerate(zip(layout.views(theta), moms, layout.views(grad))):
            t0 = telemetry.span_start()
            tok = fn(tb, mb, gb, lr, tok) if runs is None else fn(tb, mb, gb, lr, tok, runs[b])
            telemetry.bucket_span(t0, step=step, index=b)
        if fold:
            self.sq, self.step = tok, step + 1

    def state_dict(self) -> Optional[dict]:
        """The pending fold for a checkpoint's ``extra`` (None without one):
        a resumed closed loop reads the very Ξ the uninterrupted run would."""
        if self.sq is None:
            return None
        return {"step": self.step, "sq": [float(x) for x in self.sq.cpu()]}

    def load_state_dict(self, d: Optional[dict], device) -> None:
        if d is not None:
            self.sq = torch.tensor(d["sq"], dtype=torch.float32, device=device)
            self.step = int(d["step"])

    def probe(self, controller, telemetry, step: int, standalone: Callable[[], float]) -> None:
        """The closed-loop probe at ``step``, when ``controller`` (None
        for no controller) probes there; the probe may change the rung,
        and so the step's program."""
        if controller is None or not controller.should_probe(step):
            return
        xi = xi_from_folded_sq(self.sq) if self.step == step else float(standalone())
        if telemetry.active:
            telemetry.gauge("xi", xi, step=step)
        controller.observe(xi, step)
