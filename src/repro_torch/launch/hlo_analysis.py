"""Op accounting of one eagerly run step: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference re-derives a step's costs from its compiled HLO text, with
every ``while`` body scaled by its trip count.  The port runs eagerly, so
there is no HLO to read: this module reads the dispatched op stream
instead, and every loop trip is counted as it runs.  ``analyze_step``
runs a function under one ``TorchDispatchMode`` (with
``torch.utils.flop_counter.FlopCounterMode`` inside it) and returns the
keys of the reference's ``analyze_hlo``:

  * ``dot_flops`` — ``FlopCounterMode``'s formulas (2·|result|·K for the
    matrix products, backward included), plus K4's attention FLOPs;
  * ``traffic_bytes`` — the input plus the output bytes of every aten op
    that moves data; view and metadata ops count 0, as the reference's
    ``_ZERO_TRAFFIC`` does for ``bitcast``, ``reshape`` and the like; the
    hand-written kernels, which a dispatch mode cannot see, bill their own
    bytes at each launch (``kernels/cost.py``);
  * ``wire_bytes``/``coll_counts``/``coll_ops``/``total_wire_bytes`` — from
    the collectives ``Comm`` issues (``launch/comm.py``), mapped to the
    reference's kinds: ``permute`` → ``collective-permute``, ``pmean`` and
    a model group's ``all_reduce`` → ``all-reduce`` (billed 2× on the wire,
    the ring schedule, as the reference bills it), ``all_gather`` →
    ``all-gather`` (its result bytes);

and, beyond the reference's keys, ``kernels`` (launches, bytes and
operations of each of K1–K4), ``op_traffic`` (bytes by aten op, to name
an op whose count differs between two runs) and ``peak_temp_bytes``: the
peak of the bytes of storages the step created and still holds, tracked
from tensor lifetimes (on ``meta`` there is no allocator to ask).

``CollectiveReport``, ``collective_counts`` and ``assert_no_all_gather``
keep the reference's behaviour over this record; ``_dtype_width`` keeps
its table, with torch's float8 dtypes, and its bit-width fallback.
"""
from __future__ import annotations

import re
import time
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import cost

__all__ = [
    "analyze_step",
    "step_record",
    "collective_stats",
    "collective_counts",
    "assert_no_all_gather",
    "CollectiveReport",
    "COLLECTIVE_KINDS",
]

COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# Comm's collectives -> the reference's HLO kinds
_COMM_KINDS = {"permute": "collective-permute", "pmean": "all-reduce",
               "all_reduce": "all-reduce", "all_gather": "all-gather",
               "reduce_scatter": "reduce-scatter"}

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
    "f8e4m3fnuz": 1, "f8e5m2fnuz": 1, "f8e3m4": 1,
    # torch's names: its float8 variants, and the names without a width
    "float8_e4m3fn": 1, "float8_e5m2": 1, "float8_e4m3fnuz": 1,
    "float8_e5m2fnuz": 1, "float8_e8m0fnu": 1, "bool": 1,
}
_WIDTH_RE = re.compile(r"^[a-z]+?(\d+)")


def _dtype_width(dt) -> int:
    """Byte width of a dtype: a ``torch.dtype`` or the reference's HLO
    token.  A name the table misses takes its width from the leading digit
    group (float8_e8m0fnu → 1, s4 → 1: sub-byte rounds up), else 4."""
    name = str(dt).removeprefix("torch.")
    w = _DTYPE_BYTES.get(name)
    if w is not None:
        return w
    m = _WIDTH_RE.match(name)
    if m:
        return max(1, int(m.group(1)) // 8)
    return 4


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * _dtype_width(t.dtype)


_aten = torch.ops.aten
# ops that allocate, alias or describe without moving data (views are
# recognised by their schema)
_ZERO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default,
    _aten.alias.default, _aten.lift_fresh.default, _aten._unsafe_view.default,
    _aten.resize_.default, _aten.set_.source_Storage_storage_offset,
    _aten._local_scalar_dense.default,
}


class _Accounting(TorchDispatchMode):
    """Traffic, live storages and kernel bills of the ops run under it."""

    def __init__(self):
        super().__init__()
        self.traffic = 0.0
        self.op_traffic: dict[str, int] = defaultdict(int)
        self.kernels: dict[str, dict] = {}
        self.collectives: list = []
        self.world = 1
        self.live = 0
        self.peak = 0
        self._storages: dict[int, weakref.ref] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:   # a view's or an in-place op's output is an input's
            self._track(t.untyped_storage(), seen)
        if func in _ZERO_TRAFFIC or getattr(func, "is_view", False):
            return out
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.traffic += nbytes
        self.op_traffic[str(getattr(func, "overloadpacket", func))] += nbytes
        return out

    def _track(self, storage, seen) -> None:
        """Count a storage the op created until its last tensor dies."""
        key = storage._cdata
        if key in seen or key in self._storages:
            return
        size = storage.nbytes()
        self.live += size
        self.peak = max(self.peak, self.live)

        def gone(_, key=key, size=size):
            self.live -= size
            self._storages.pop(key, None)

        self._storages[key] = weakref.ref(storage, gone)

    # hooks of kernels/cost.py
    def bill_kernel(self, kernel: str, nbytes: int, ops: int) -> None:
        k = self.kernels.setdefault(kernel, {"launches": 0, "bytes": 0, "ops": 0})
        k["launches"] += 1
        k["bytes"] += int(nbytes)
        k["ops"] += int(ops)
        self.traffic += nbytes

    def bill_collective(self, op, world: int) -> None:
        self.collectives.append(op)
        self.world = world


def collective_info(ops, world: int = 1) -> dict:
    """The reference's collective keys of a ``Comm`` op record of a world
    of ``world`` ranks: per kind the count, the op names (``"<comm
    kind>:<position>"``) and the wire bytes (a permute its operand, an
    all-reduce twice it, an all-gather its result of the group's operands,
    ``world`` where the op does not carry its group's size);
    host gathers and scatters (checkpoints) are not step collectives and
    are left out."""
    wire, counts, names = defaultdict(int), defaultdict(int), defaultdict(list)
    for i, op in enumerate(ops):
        kind = _COMM_KINDS.get(op.kind)
        if kind is None:
            continue
        wire[kind] += {"all-reduce": 2 * op.nbytes,
                       "all-gather": (op.world or world) * op.nbytes}.get(kind, op.nbytes)
        counts[kind] += 1
        names[kind].append(f"{op.kind}:{i}")
    return {
        "wire_bytes": dict(wire),
        "coll_counts": dict(counts),
        "coll_ops": {k: tuple(v) for k, v in names.items()},
        "total_wire_bytes": int(sum(wire.values())),
    }


def analyze_step(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once under the op accounting and return the
    reference's ``analyze_hlo`` keys (see the module docstring), plus
    ``kernels``, ``op_traffic``, ``peak_temp_bytes`` and ``result`` (what
    ``fn`` returned)."""
    acc = _Accounting()
    cost._ACTIVE.append(acc)
    try:
        with acc, FlopCounterMode(display=False) as flops:
            result = fn(*args, **kw)
    finally:
        cost._ACTIVE.remove(acc)
    dot = float(flops.get_total_flops()) + acc.kernels.get("flash_attention", {}).get("ops", 0)
    return {
        **collective_info(acc.collectives, acc.world),
        "traffic_bytes": float(acc.traffic),
        "dot_flops": dot,
        "kernels": acc.kernels,
        "op_traffic": dict(acc.op_traffic),
        "peak_temp_bytes": int(acc.peak),
        "result": result,
    }


def collective_stats(hlo: dict) -> dict:
    """The dry run's per-kind (count, result bytes, wire bytes) of a
    step's collectives, the reference's ``dryrun.collective_stats`` form,
    from an ``analyze_step`` result."""
    stats: dict = {}
    for kind, count in hlo.get("coll_counts", {}).items():
        wire = hlo["wire_bytes"][kind]
        stats[kind] = {"count": count,
                       "result_bytes": wire // 2 if kind == "all-reduce" else wire,
                       "wire_bytes": wire}
    stats["total_wire_bytes"] = sum(v["wire_bytes"] for v in stats.values())
    return stats


def _storage_bytes(tensors) -> tuple[int, set]:
    """Bytes of the distinct storages the tensors lie in, and their keys."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total, seen


def step_record(fn, *args, arguments, outputs=None, **kw) -> dict:
    """A dry-run record of ``fn(*args, **kw)`` run once under
    ``analyze_step``: the reference's record fields (``memory``, ``cost``,
    ``hlo``, ``collectives``, ``lower_s``).  ``arguments``: the tensors of
    the state the step holds (``memory.argument_bytes``, by storage);
    ``outputs(result)``: the tensors it returns (all of the result's by
    default), of which those in an argument's storage (updated in place,
    the reference's donated buffers) are also ``alias_bytes``.  There is
    no compile, so there is no ``compile_s``."""
    arg_bytes, arg_keys = _storage_bytes(arguments)
    t0 = time.perf_counter()
    info = analyze_step(fn, *args, **kw)
    lower_s = time.perf_counter() - t0
    result = info.pop("result")
    outs = outputs(result) if outputs is not None else [
        t for t in tree_leaves(result) if isinstance(t, torch.Tensor)]
    out_bytes, _ = _storage_bytes(outs)
    alias_bytes, _ = _storage_bytes(t for t in outs if t.untyped_storage()._cdata in arg_keys)
    return {
        "lower_s": round(lower_s, 3),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": info["peak_temp_bytes"], "alias_bytes": alias_bytes},
        "cost": {"flops": info["dot_flops"], "bytes_accessed": info["traffic_bytes"],
                 "transcendentals": 0.0},
        "collectives": collective_stats(info),
        "hlo": info,
    }


class CollectiveReport(dict):
    """Structured collective inventory of one step.

    A dict subclass (``report["collective-permute"]``, ``.get``, equality
    with plain count dicts) that also carries ``op_names``: kind → tuple
    of the names of the ops of that kind in the step's record, and
    ``wire_bytes``: kind → bytes.  The counts are dynamic, as the
    reference's loop-aware ones are: every trip issued its collectives.
    """

    def __init__(self, counts=None, op_names=None, wire_bytes=None):
        super().__init__(counts or {})
        self.op_names: dict[str, tuple[str, ...]] = {
            k: tuple(v) for k, v in (op_names or {}).items()
        }
        self.wire_bytes: dict[str, int] = dict(wire_bytes or {})

    @property
    def total(self) -> int:
        return int(sum(self.values()))

    def offending(self, forbid) -> dict[str, tuple[str, ...]]:
        """kind → op names for every forbidden kind present (count > 0)."""
        return {k: self.op_names.get(k, ()) for k in self if k in forbid and self[k]}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"CollectiveReport({dict(self)!r}, op_names={self.op_names!r})"


def collective_counts(fn_or_info, *args, **kw) -> CollectiveReport:
    """Collective counts of a step: ``fn_or_info`` is a function run here
    under ``analyze_step`` with ``args``/``kw``, an ``analyze_step`` result,
    or a ``Comm`` op record (a list of ``CollectiveOp``; pass ``world=`` for
    an all-gather's result bytes)."""
    if isinstance(fn_or_info, dict):
        info = fn_or_info
    elif isinstance(fn_or_info, (list, tuple)):
        info = collective_info(fn_or_info, kw.get("world", 1))
    else:
        info = analyze_step(fn_or_info, *args, **kw)
    return CollectiveReport(info.get("coll_counts", {}), op_names=info.get("coll_ops", {}),
                            wire_bytes=info.get("wire_bytes", {}))


def assert_no_all_gather(fn_or_info, *args, forbid=("all-gather",), **kw) -> CollectiveReport:
    """Assert the step issues none of the ``forbid`` collectives: a
    colorable graph must mix by collective-permutes only; an all-gather
    means the dense GatherRow fallback leaked back onto the hot path.
    Returns the full ``CollectiveReport``."""
    report = collective_counts(fn_or_info, *args, **kw)
    bad = {k: v for k, v in report.items() if k in forbid and v}
    if bad:
        names = report.offending(forbid)
        raise AssertionError(
            f"forbidden collectives in the step: {bad} "
            f"(ops: {names}, all counts: {dict(report)})"
        )
    return report
