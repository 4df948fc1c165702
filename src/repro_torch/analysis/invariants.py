"""Pass 1 — the mixing-program verifier: the counterpart of
``repro/analysis/invariants.py`` (numpy) over the port's programs.

Every correctness argument rests on properties of the realized mixing
matrix W: consensus control (arXiv:2102.04828) and partial participation
(arXiv:2506.00961) assume W is doubly stochastic under EVERY fault and
membership realization, kernels K1/K2 consume per-node permute tables that
must reconstruct W exactly, and the bucketed step assumes its layout
covers every parameter column exactly once.  This pass checks all of that
statically, on the IR, before any step runs:

  * ``verify_program``  — per-round permute bijectivity, non-negative
    weights, row/column stochasticity to tolerance, symmetry (recorded
    from the base W, never assumed: ``d_exponential`` is doubly stochastic
    but directed), ``permute_tables`` against ``matrix()``, and
    ``FusedProgram`` round-count conservation.
  * ``verify_degraded`` — ``degraded_matrix`` realizations: still row
    stochastic, symmetric bases stay symmetric, dead/ghost/spare ranks an
    EXACT identity row and column, and ``GossipProgram.degrade`` equal to
    the dense oracle.
  * ``verify_bucket_layout`` — bounds partition [0, P), widths sum to P,
    the segment table covers every leaf element exactly once and, given
    the leaves' dtypes, the dtype runs the bucket step rounds by
    (``BucketLayout.dtype_runs``) put every column under its own leaf's
    dtype.
  * ``verify_topology``  — drives the above over everything a
    ``Topology`` can emit: ``distinct_programs`` (controller rungs ×
    degraded folds × elastic sizes) × sampled fault realizations.
  * ``verify_bench_payload`` — the structural gate of a bench section
    before it is merged into a committed artifact: keyable names, dict
    entries, JSON values and, where an entry carries one, the shape of its
    ``MetricsRecorder.provenance`` stamp.

All checks raise
``InvariantViolation`` (an ``AssertionError``) with the offending entry
spelled out.
"""
from __future__ import annotations

import json
import re

import numpy as np

from repro_torch.analysis.report import InvariantViolation

__all__ = [
    "verify_program",
    "verify_degraded",
    "verify_bucket_layout",
    "verify_topology",
    "verify_bench_payload",
]

_TOL = 1e-8


def _fail(subject, message):
    raise InvariantViolation(f"{subject}: {message}")


def _is_symmetric(w, tol=1e-9) -> bool:
    return bool(np.allclose(w, w.T, atol=tol))


def _check_stochastic(w, subject, *, tol, require_cols=True):
    """Row stochasticity always; column stochasticity when required.

    Every *base* program family shipped here is doubly stochastic (the
    directed ``d_exponential`` included), but a degraded realization of an
    asymmetric W is only row stochastic — the dropped edge's mass moves to
    the RECEIVER's diagonal, which lives in a different column — so
    callers relax the column check for ``!dead[...]`` variants.
    """
    if not np.all(np.isfinite(w)):
        _fail(subject, "non-finite entries in mixing matrix")
    if np.min(w) < -tol:
        i, j = np.unravel_index(int(np.argmin(w)), w.shape)
        _fail(subject, f"negative weight W[{i},{j}] = {w[i, j]:.3e}")
    rows = w.sum(axis=1)
    if not np.allclose(rows, 1.0, atol=tol):
        i = int(np.argmax(np.abs(rows - 1.0)))
        _fail(subject, f"row {i} sums to {rows[i]:.12f}, not 1 (±{tol})")
    if require_cols:
        cols = w.sum(axis=0)
        if not np.allclose(cols, 1.0, atol=tol):
            j = int(np.argmax(np.abs(cols - 1.0)))
            _fail(
                subject,
                f"column {j} sums to {cols[j]:.12f}, not 1 — W is not doubly "
                "stochastic, mixing would not preserve the mean",
            )


def _check_ppermute(op, n, subject):
    """One permute round must be a partial bijection with nonneg weights."""
    srcs = [s for s, _ in op.perm]
    dsts = [d for _, d in op.perm]
    if len(set(srcs)) != len(srcs):
        _fail(subject, f"duplicate source in permute round: {sorted(srcs)}")
    if len(set(dsts)) != len(dsts):
        _fail(
            subject,
            f"duplicate destination in permute round: {sorted(dsts)} — two "
            "sends collide at one receiver (not a collective-permute)",
        )
    for s, d in op.perm:
        if not (0 <= s < n and 0 <= d < n):
            _fail(subject, f"permute pair ({s}, {d}) out of range for n={n}")
    wv = op.weight if isinstance(op.weight, tuple) else (float(op.weight),)
    if any(w < -_TOL for w in wv):
        _fail(subject, f"negative permute weight {min(wv)}")
    if op.offset is not None:
        want = tuple(((i + op.offset) % n, i) for i in range(n))
        if tuple(sorted(op.perm)) != tuple(sorted(want)):
            _fail(
                subject,
                f"offset={op.offset} does not match the perm pairs — the "
                "stacked roll and the shard ppermute would disagree",
            )


def _check_tables(program, w, subject, tol):
    """``permute_tables`` must reconstruct ``matrix()`` exactly: these are
    the rows kernels K1 and K2 consume."""
    tables = program.permute_tables()
    if tables is None:
        return
    srcs, weights = tables
    n = program.n
    deg = srcs.shape[1] if srcs.ndim == 2 else 0
    if srcs.shape != (n, deg) or weights.shape != (n, deg + 1):
        _fail(
            subject,
            f"table shapes srcs{srcs.shape} / weights{weights.shape} != "
            f"(({n},{deg}), ({n},{deg + 1}))",
        )
    if srcs.size and (srcs.min() < 0 or srcs.max() >= n):
        _fail(subject, f"src index out of range in permute tables (n={n})")
    if weights.size and weights.min() < -tol:
        _fail(subject, f"negative weight in kernel table: {weights.min():.3e}")
    rows = weights.sum(axis=1)
    if not np.allclose(rows, 1.0, atol=1e-5):  # float32 tables
        i = int(np.argmax(np.abs(rows - 1.0)))
        _fail(subject, f"kernel weight row {i} sums to {rows[i]:.7f}, not 1")
    rec = np.diag(weights[:, 0].astype(np.float64))
    for k in range(deg):
        for i in range(n):
            rec[i, srcs[i, k]] += float(weights[i, k + 1])
    if not np.allclose(rec, w, atol=1e-5):
        d = np.abs(rec - w)
        i, j = np.unravel_index(int(np.argmax(d)), d.shape)
        _fail(
            subject,
            f"permute tables reconstruct W[{i},{j}] = {rec[i, j]:.7f} but "
            f"matrix() says {w[i, j]:.7f} — kernel and interpreter disagree",
        )


def verify_program(program, *, tol: float = _TOL) -> np.ndarray:
    """Statically verify one mixing program; returns its matrix W."""
    from repro_torch.core.schedule import FusedProgram, GatherRow, PPermute

    subject = f"program {program.name!r} (n={program.n})"
    n = program.n
    # degraded variants of an asymmetric base are row- but not
    # column-stochastic (mass moves to the receiver's diagonal)
    degraded = "!dead[" in program.name
    if isinstance(program, FusedProgram):
        concat = tuple(op for p in program.stages for op in p.ops)
        if program.ops != concat:
            _fail(
                subject,
                f"round-count conservation broken: fused ops ({len(program.ops)})"
                f" != concatenated stage ops ({len(concat)}) — collective "
                "counts and comm billing would drift from what executes",
            )
        prod = np.eye(n)
        for p in program.stages:
            verify_program(p, tol=tol)
            prod = p.matrix() @ prod
        w = program.matrix()
        if not np.allclose(w, prod, atol=1e-10):
            _fail(subject, "fused matrix() != product of stage matrices")
        _check_stochastic(w, subject, tol=tol, require_cols=not degraded)
        return w

    w = program.matrix()
    sw = program.self_weight
    sw_t = sw if isinstance(sw, tuple) else (float(sw),)
    if any(v < -tol for v in sw_t):
        _fail(subject, f"negative self weight {min(sw_t)}")
    for k, op in enumerate(program.ops):
        if isinstance(op, PPermute):
            _check_ppermute(op, n, f"{subject} op[{k}]")
        elif isinstance(op, GatherRow):
            gw = np.asarray(op.w, dtype=np.float64)
            if gw.shape != (n, n):
                _fail(subject, f"GatherRow matrix shape {gw.shape} != ({n},{n})")
    _check_stochastic(
        w, subject, tol=tol, require_cols=_is_symmetric(w) or not degraded
    )
    _check_tables(program, w, subject, tol)
    return w


def verify_degraded(program, alive, link_up=None, *, tol: float = _TOL) -> None:
    """Verify one fault/membership realization of ``program``.

    ``alive`` may be bool (crash/ghost masks) or float (drain boosts —
    non-negativity is only required for boolean masks, per the documented
    drain bound).  Checks the dense oracle ``degraded_matrix`` AND, for
    boolean masks without link faults, that the pre-enumerated
    ``GossipProgram.degrade`` program realizes exactly the same matrix.
    """
    from repro_torch.core.schedule import degraded_matrix

    w = program.matrix()
    n = program.n
    alive = np.asarray(alive, dtype=np.float64).reshape(-1)
    if alive.shape[0] != n:
        _fail(f"program {program.name!r}", f"alive mask len {alive.shape[0]} != n={n}")
    subject = (
        f"program {program.name!r} degraded "
        f"(dead={[int(i) for i in np.where(alive == 0)[0]]}"
        f"{', link faults' if link_up is not None else ''})"
    )
    d = degraded_matrix(w, alive, link_up)
    boolean = bool(np.all((alive == 0) | (alive == 1)))

    rows = d.sum(axis=1)
    if not np.allclose(rows, 1.0, atol=tol):
        i = int(np.argmax(np.abs(rows - 1.0)))
        _fail(subject, f"row {i} sums to {rows[i]:.12f}, not 1")
    if boolean and np.min(d) < -tol:
        i, j = np.unravel_index(int(np.argmin(d)), d.shape)
        _fail(subject, f"negative weight W'[{i},{j}] = {d[i, j]:.3e}")
    sym_link = link_up is None or np.allclose(
        np.asarray(link_up, dtype=np.float64),
        np.asarray(link_up, dtype=np.float64).T,
        atol=tol,
    )
    if _is_symmetric(w) and sym_link and not _is_symmetric(d, tol):
        _fail(
            subject,
            "symmetric base W degraded to an ASYMMETRIC matrix — doubly "
            "stochastic mixing is lost under this realization",
        )

    # dead / ghost / spare ranks: exact identity row AND column, so a
    # masked-out rank's parameters are bit-untouched and leak nothing.
    for i in np.where(alive == 0)[0]:
        ei = np.zeros(n)
        ei[i] = 1.0
        if not (np.array_equal(d[i], ei) and np.array_equal(d[:, i], ei)):
            _fail(
                subject,
                f"dead rank {i} row/col is not EXACT identity "
                f"(row error {np.abs(d[i] - ei).max():.3e}, "
                f"col error {np.abs(d[:, i] - ei).max():.3e})",
            )

    if boolean and link_up is None:
        dp = program.degrade(tuple(bool(a) for a in alive))
        if not np.allclose(dp.matrix(), d, atol=1e-9):
            _fail(
                subject,
                "GossipProgram.degrade does not realize degraded_matrix — "
                "the pre-enumerated crash program diverges from the oracle",
            )


def verify_bucket_layout(layout, sizes=None, dtypes=None) -> None:
    """Exact-coverage check of a ``BucketLayout`` segment table; with the
    leaves' ``dtypes`` also of the dtype runs a mixed state's bucket step
    rounds by."""
    sizes = tuple(layout.sizes if sizes is None else sizes)
    p = sum(sizes)
    subject = f"BucketLayout(P={p}, target={layout.bucket_elems})"
    b = layout.bounds
    if b[0] != 0 or b[-1] != p:
        _fail(subject, f"bounds {b[:3]}..{b[-3:]} do not span [0, {p}]")
    if any(b[i + 1] <= b[i] for i in range(len(b) - 1)) and p > 0:
        _fail(subject, f"bounds not strictly increasing: {b}")
    widths = layout.widths
    if sum(widths) != p:
        _fail(subject, f"widths sum {sum(widths)} != P={p} — bytes dropped")
    if len(widths) != layout.num_buckets:
        _fail(subject, f"{len(widths)} widths but num_buckets={layout.num_buckets}")
    segments = layout.segments
    if len(segments) != len(widths):
        _fail(subject, f"{len(segments)} segment rows for {len(widths)} buckets")
    covered = [[] for _ in sizes]
    for k, segs in enumerate(segments):
        seg_total = 0
        for li, start, stop in segs:
            if not (0 <= li < len(sizes)):
                _fail(subject, f"bucket {k} references leaf {li} (have {len(sizes)})")
            if not (0 <= start < stop <= sizes[li]):
                _fail(
                    subject,
                    f"bucket {k} slice leaf[{li}][{start}:{stop}] escapes "
                    f"the leaf (size {sizes[li]})",
                )
            seg_total += stop - start
            covered[li].append((start, stop))
        if seg_total != widths[k]:
            _fail(
                subject,
                f"bucket {k} segments cover {seg_total} elements but its "
                f"width is {widths[k]} — dropped or double-covered bytes",
            )
    for li, ivals in enumerate(covered):
        ivals.sort()
        pos = 0
        for start, stop in ivals:
            if start < pos:
                _fail(
                    subject,
                    f"leaf {li} element {start} double-covered "
                    f"(overlapping segments {ivals})",
                )
            if start > pos:
                _fail(subject, f"leaf {li} elements [{pos}:{start}] uncovered")
            pos = stop
        if pos != sizes[li]:
            _fail(subject, f"leaf {li} tail [{pos}:{sizes[li]}] uncovered")
    if dtypes is not None:
        _check_dtype_runs(layout, sizes, tuple(dtypes), subject)


def _check_dtype_runs(layout, sizes, dtypes, subject) -> None:
    """The runs of each bucket tile it in order, and every column lies in a
    run of its own leaf's dtype: the rounding of a mixed state's bucket
    step reads exactly the narrow leaves' columns."""
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    for k, (lo, runs) in enumerate(zip(layout.bounds, layout.dtype_runs(dtypes))):
        pos = 0
        for a, e, dt in runs:
            if a != pos or e <= a:
                _fail(subject, f"bucket {k} dtype runs {runs} do not tile its "
                               f"{layout.widths[k]} columns")
            ga, ge = lo + a, lo + e
            first = int(np.searchsorted(starts, ga, side="right")) - 1
            last = int(np.searchsorted(starts, ge - 1, side="right")) - 1
            for li in range(first, last + 1):
                if sizes[li] and dtypes[li] != dt:
                    _fail(subject, f"bucket {k} columns [{a}:{e}] run as {dt} but hold "
                                   f"leaf {li} of dtype {dtypes[li]} — the bucket step "
                                   "would round them to the wrong dtype")
            pos = e
        if pos != layout.widths[k]:
            _fail(subject, f"bucket {k} dtype runs end at {pos} of {layout.widths[k]}")


def _realization_masks(model, steps):
    """Distinct (alive, link_up) realizations of ``model`` over ``steps``
    steps, each tagged with the membership size it applies at."""
    seen = set()
    out = []
    for t in range(steps):
        fr = model.at(t)
        alive = np.asarray(fr.alive, dtype=np.float64)
        link = None if fr.link_up is None else np.asarray(fr.link_up)
        key = (alive.tobytes(), None if link is None else link.tobytes())
        if key in seen:
            continue
        seen.add(key)
        out.append((alive, link))
    return out


def verify_topology(topology, *, n_epochs: int = 1, fault_steps: int = 0,
                    tol: float = _TOL) -> int:
    """Verify every program ``topology`` can emit; returns programs checked.

    Covers ``distinct_programs`` (controller rungs × permanent-crash folds
    × elastic sizes) and, when ``fault_steps`` > 0 and the topology carries
    a fault model, every distinct runtime (alive, link) realization the
    model produces over that horizon, applied to every program of the
    matching size.
    """
    if topology.centralized:
        return 0
    programs = [p for _, p in topology.distinct_programs(n_epochs)]
    for p in programs:
        verify_program(p, tol=tol)
    model = topology.fault_model
    if model is not None and fault_steps > 0:
        for alive, link in _realization_masks(model, fault_steps):
            for p in programs:
                if p.n != alive.shape[0]:
                    continue  # elastic fold of a different membership size
                verify_degraded(p, alive, link, tol=tol)
    return len(programs)


_BENCH_KEY_RE = re.compile(r"^[\w.+\-/]+$")


def verify_bench_payload(section: str, payload) -> None:
    """Structural gate for a bench section before it is merged per key into
    a committed artifact: a malformed payload (non-dict entries, unkeyable
    names, non-JSON values) would corrupt the perf trajectory silently."""
    subject = f"bench section {section!r}"
    if not isinstance(section, str) or not _BENCH_KEY_RE.match(section or ""):
        _fail(subject, "section name must be a non-empty [\\w.+-/] string")
    if not isinstance(payload, dict) or not payload:
        _fail(subject, f"payload must be a non-empty dict, got {type(payload).__name__}")
    for key, entry in payload.items():
        if not isinstance(key, str) or not _BENCH_KEY_RE.match(key):
            _fail(subject, f"entry key {key!r} is not a [\\w.+-/] string")
        if not isinstance(entry, dict):
            _fail(subject, f"entry {key!r} is {type(entry).__name__}, not a dict — "
                           "the per-key merge would clobber structure")
        try:
            json.dumps(entry, allow_nan=False)
        except (TypeError, ValueError) as e:
            _fail(subject, f"entry {key!r} is not JSON-serializable: {e}")
        prov = entry.get("provenance")
        if prov is not None:
            _verify_bench_provenance(subject, key, prov)


def _verify_bench_provenance(subject: str, key: str, prov) -> None:
    """A ``provenance`` entry is ``MetricsRecorder.provenance()``: pin its
    shape, so a half-initialized recorder cannot stamp garbage."""
    if not isinstance(prov, dict):
        _fail(subject, f"entry {key!r} provenance must be a dict")
    if prov.get("source") != "telemetry":
        _fail(subject, f"entry {key!r} provenance source must be 'telemetry'")
    if not isinstance(prov.get("schema"), int):
        _fail(subject, f"entry {key!r} provenance schema must be an int")
    counters = prov.get("counters")
    if not isinstance(counters, dict) or not all(
        isinstance(k, str) and isinstance(v, (int, float)) and not isinstance(v, bool)
        for k, v in counters.items()
    ):
        _fail(subject, f"entry {key!r} provenance counters must map str -> number")
    for field in ("rounds", "events"):
        if not isinstance(prov.get(field), int):
            _fail(subject, f"entry {key!r} provenance {field} must be an int")
