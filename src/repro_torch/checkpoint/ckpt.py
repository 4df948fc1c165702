"""Checkpointing: the counterpart of ``repro/checkpoint/ckpt.py``, in the
reference's on-disk format.

A checkpoint is one ``<dir>/step_<n>.npz`` (an uncompressed zip of
``.npy`` members, as ``np.savez`` writes it) plus ``manifest.json``.  Each
member is one leaf of the state tree, keyed by its ``/``-joined tree path
(``p/blocks/ffn/w_down``, ``o/mu/embed``, ``o/t``): dict keys sorted at
each level, depth first, sequence items as ``#i`` — ``jax.tree.leaves``'
order and the reference's ``_flatten``/``_part`` names.  The engines' trees
hold the stacked (G, ...) leaves, so one file carries every replica.  The
reserved member ``__extra__`` holds the JSON run state (``snapshot_extra``)
in the same file as the arrays it belongs to.

The files are the reference's, member for member: a bfloat16 leaf is
written as the reference writes it (its bits as 2-byte void records, descr
``<V2``), an int32 leaf as int32.  A file written by either package loads
in the other.  A leaf wrapped in ``AsDtype`` is written in that dtype (a
mixed-dtype model holds its bfloat16 leaves in a float32 state and writes
them as bfloat16); a member restores into a leaf of another dtype (a
bfloat16 member into a float32 or float64 leaf exactly), cast chunk by
chunk as it streams.

Nothing of a leaf's size is staged anywhere: a member's payload streams
between the zip member (zip64, stored) and the leaf's rows in chunks of
``_CHUNK`` bytes, through two pinned host buffers for a device leaf (the
copy of one chunk overlaps the file transfer of the other), straight into
or out of a host leaf's memory.  A leaf may also be a zero-argument
callable that returns the leaf in host memory, called when the leaf is
written (the ranks engine gathers each leaf to rank 0 that way).  A leaf may be
a ``RowBlocks``, consecutive row blocks that may lie on different cards:
the blocks stream one after the other, each from or into its own card, so
the file is byte for byte the one array they make.  The file is written
under a temporary name and renamed into place, so a crash mid-save leaves
the previous checkpoint and the manifest as they were.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

__all__ = [
    "AsDtype", "RowBlocks", "save_checkpoint", "load_checkpoint", "restore_checkpoint", "load_checkpoint_extra",
    "latest_step", "validate_run_config", "flatten", "map_leaves", "checkpoint_path",
    "read_leaf", "leaf_shapes", "resolve_step",
]

_SEP = "/"
# the member for the JSON "extra" payload (engine run state beyond the
# array tree): a flattened tree path never starts with "_"
_EXTRA_KEY = "__extra__"
# bytes per chunk of a member's payload moved to or from the file
_CHUNK = 64 << 20


@dataclasses.dataclass(frozen=True)
class AsDtype:
    """A tree leaf written as ``dtype``, cast chunk by chunk as it streams
    out; restored, it is ``leaf`` (the member cast to the leaf's dtype)."""
    leaf: Any
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """A leaf held as consecutive row blocks (tensors that agree past the
    first axis, each on its own device): one array in the file, the
    blocks' rows in order; restored, each block in place."""
    blocks: tuple

    @property
    def shape(self) -> tuple:
        return (sum(b.shape[0] for b in self.blocks),) + tuple(self.blocks[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device


def held(leaf: Any) -> Any:
    """The tensor (or callable) a tree leaf holds, ``AsDtype`` unwrapped."""
    return leaf.leaf if isinstance(leaf, AsDtype) else leaf


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs of a nested tree of Mappings, lists and tuples, in
    ``jax.tree.leaves`` order, keyed as the reference keys them."""
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}{_SEP}{k}" if prefix else k)
    return out


def map_leaves(fn: Callable, tree: Any) -> Any:
    """The tree with every leaf replaced by ``fn(leaf)`` (an ``AsDtype``'s
    held leaf, the wrapper kept)."""
    if isinstance(tree, AsDtype):
        return AsDtype(fn(tree.leaf), tree.dtype)
    if isinstance(tree, Mapping):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}.npz")


def _descr(dtype: torch.dtype) -> str:
    """The ``.npy`` descr of a torch dtype; bfloat16 as the reference writes
    it (``np.asarray`` of a bfloat16 array: 2-byte void records)."""
    if dtype == torch.bfloat16:
        return "<V2"
    return np.lib.format.dtype_to_descr(torch.empty((), dtype=dtype).numpy().dtype)


def _member_dtype(file_dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a member's payload: a 2-byte void member is
    bfloat16 (as the reference writes it)."""
    if file_dtype.kind == "V":
        if file_dtype.itemsize != 2:
            raise ValueError(f"a {file_dtype} checkpoint leaf cannot restore")
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, file_dtype)).dtype


def _pieces(t: torch.Tensor) -> list[torch.Tensor]:
    """The leaf's elements, in order, as flat contiguous pieces: the whole
    leaf, or (a strided (G, ...) view of a flat buffer) its rows."""
    pieces = [t] if t.dim() == 0 or t.is_contiguous() else list(t.unbind(0))
    for x in pieces:
        if not x.is_contiguous():
            raise ValueError(f"a leaf of shape {tuple(t.shape)} has non-contiguous rows")
    return [x.reshape(-1) for x in pieces]


def _chunks(t: torch.Tensor, dtype: torch.dtype):
    """(piece, a, b): element ranges of ``t``'s pieces holding at most
    ``_CHUNK`` bytes in ``dtype`` or in ``t``'s own dtype."""
    step = _CHUNK // max(t.element_size(), torch.empty((), dtype=dtype).element_size())
    for x in _pieces(t):
        for a in range(0, x.numel(), step):
            yield x, a, min(a + step, x.numel())


class _Staging:
    """Two pinned host chunks: one chunk's device copy runs while the other
    moves to or from the file."""

    def __init__(self):
        self.bufs = [torch.empty(_CHUNK, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        self.events = [None, None]
        self.k = 0

    def next(self, n: int) -> tuple[torch.Tensor, int]:
        i = self.k % 2
        self.k += 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        return self.bufs[i][:n], i

    def mark(self, i: int) -> None:
        self.events[i] = torch.cuda.Event()
        self.events[i].record()


def _each_block(fn, f, leaf: RowBlocks, dtype: torch.dtype) -> None:
    """``fn(f, block, dtype)`` for the blocks in row order, each with its
    card current (the staging events record on its stream)."""
    for blk in leaf.blocks:
        if blk.device.type == "cuda":
            with torch.cuda.device(blk.device):
                fn(f, blk, dtype)
        else:
            fn(f, blk, dtype)


def _stream_out(f, leaf: torch.Tensor, dtype: torch.dtype) -> None:
    """Write ``leaf``'s elements as ``dtype`` to ``f`` in chunks (each
    chunk cast on the leaf's device when the dtypes differ)."""
    if isinstance(leaf, RowBlocks):
        return _each_block(_stream_out, f, leaf, dtype)
    chunks = ((x[a:b] if x.dtype == dtype else x[a:b].to(dtype)).view(torch.uint8)
              for x, a, b in _chunks(leaf, dtype))
    if leaf.device.type == "cpu":
        for c in chunks:
            f.write(memoryview(c.numpy()))
        return
    stage, pending = _Staging(), None
    for c in chunks:
        buf, i = stage.next(c.numel())
        buf.copy_(c, non_blocking=True)
        stage.mark(i)
        if pending is not None:
            stage.events[pending[1]].synchronize()
            f.write(memoryview(pending[0].numpy()))
        pending = (buf, i)
    if pending is not None:
        stage.events[pending[1]].synchronize()
        f.write(memoryview(pending[0].numpy()))


def _read_exact(f, out: memoryview) -> None:
    got = 0
    while got < len(out):
        n = f.readinto(out[got:])
        if not n:
            raise ValueError("checkpoint member ends early")
        got += n


def _stream_in(f, leaf: torch.Tensor, dtype: torch.dtype) -> None:
    """Fill ``leaf`` (in place) from ``f``'s elements of ``dtype`` in
    chunks, each cast to the leaf's dtype when they differ."""
    if isinstance(leaf, RowBlocks):
        return _each_block(_stream_in, f, leaf, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    if leaf.device.type == "cpu":
        for x, a, b in _chunks(leaf, dtype):
            if x.dtype == dtype:   # straight into the leaf's memory
                _read_exact(f, memoryview(x[a:b].view(torch.uint8).numpy()))
                continue
            raw = torch.empty((b - a) * size, dtype=torch.uint8)
            _read_exact(f, memoryview(raw.numpy()))
            x[a:b].copy_(raw.view(dtype))
        return
    stage = _Staging()
    for x, a, b in _chunks(leaf, dtype):
        buf, i = stage.next((b - a) * size)
        _read_exact(f, memoryview(buf.numpy()))
        x[a:b].copy_(buf.view(dtype), non_blocking=True)
        stage.mark(i)
    torch.cuda.current_stream(leaf.device).synchronize()


def _write_member(zf: zipfile.ZipFile, key: str, leaf) -> None:
    """One ``.npy`` member, as ``np.savez`` writes it (the same header and
    payload bytes), in an ``AsDtype``'s dtype or the leaf's own."""
    dtype = leaf.dtype if isinstance(leaf, AsDtype) else None
    leaf = held(leaf)
    if callable(leaf):
        leaf = leaf()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
    elif not isinstance(leaf, RowBlocks):
        arr = np.require(np.asarray(leaf), requirements="C")   # (ascontiguousarray makes 0-d 1-d)
        leaf = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                if arr.dtype.name == "bfloat16" else torch.from_numpy(arr))
    dtype = dtype or leaf.dtype
    header = {"descr": _descr(dtype), "fortran_order": False, "shape": tuple(leaf.shape)}
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array_header_1_0(f, header)
        _stream_out(f, leaf, dtype)


def save_checkpoint(directory: str, step: int, state: Any, *, keep: int = 3,
                    extra: Optional[dict] = None) -> str:
    """Write ``<dir>/step_<n>.npz`` (and the manifest); prune to ``keep``
    newest.  ``state`` is a tree of tensors, arrays or callables returning
    a host tensor (any of them in an ``AsDtype``); ``extra`` an optional
    JSON-serializable dict that rides in the same file under a reserved key
    (crash-consistent resume needs the engine run state saved with the
    arrays it belongs to)."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, step)
    leaves = flatten(state)
    if any(k == _EXTRA_KEY for k, _ in leaves):
        raise ValueError(f"state tree uses the reserved key {_EXTRA_KEY!r}")
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp")
    with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in leaves:
            _write_member(zf, key, leaf)
        if extra is not None:
            with zf.open(_EXTRA_KEY + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asarray(json.dumps(extra)))
    os.replace(tmp, path)
    manifest = os.path.join(directory, "manifest.json")
    with open(manifest + ".tmp", "w") as f:
        json.dump({"latest_step": step}, f)
    os.replace(manifest + ".tmp", manifest)
    ckpts = sorted(p for p in os.listdir(directory) if p.startswith("step_"))
    for old in ckpts[:-keep]:
        os.remove(os.path.join(directory, old))
    return path


def latest_step(directory: str) -> Optional[int]:
    mf = os.path.join(directory, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["latest_step"]


def resolve_step(directory: str, step: Optional[int] = None) -> int:
    """``step``, or the manifest's latest when it is None."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint manifest in {directory}")
    return step


def _header(f) -> tuple[tuple, np.dtype]:
    """(shape, dtype) of the ``.npy`` member open in ``f``, read from its
    header; the file position is left at the payload."""
    fmt = np.lib.format
    read = fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0) else fmt.read_array_header_2_0
    shape, fortran, dtype = read(f)
    if fortran:
        raise ValueError("checkpoint members are C-ordered")
    return tuple(shape), dtype


def leaf_shapes(zf: zipfile.ZipFile) -> dict[str, tuple]:
    """Every member's shape, read from its ``.npy`` header only."""
    out = {}
    for name in zf.namelist():
        with zf.open(name) as f:
            out[name[:-len(".npy")]] = _header(f)[0]
    return out


def _read_member_into(zf: zipfile.ZipFile, key: str, target: torch.Tensor) -> None:
    """Member ``key`` into ``target`` (same shape), in place, streamed and
    cast chunk by chunk where the member's dtype is not the target's; a
    bfloat16 member restores only into a bfloat16, float32 or float64 leaf
    (exactly)."""
    with zf.open(key + ".npy") as f:
        shape, file_dtype = _header(f)
        if shape != tuple(target.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {shape} != template "
                             f"{tuple(target.shape)}")
        dtype = _member_dtype(file_dtype)
        if dtype == torch.bfloat16 and target.dtype not in (
                torch.bfloat16, torch.float32, torch.float64):
            raise ValueError(f"a bfloat16 checkpoint leaf cannot restore as {target.dtype}")
        _stream_in(f, target, dtype)


def read_leaf(zf: zipfile.ZipFile, key: str, dtype: torch.dtype) -> torch.Tensor:
    """One member as a new host tensor of ``dtype`` (a bfloat16 member
    viewed back through its bits)."""
    with zf.open(key + ".npy") as f:
        shape, _ = _header(f)
    out = torch.empty(shape, dtype=dtype)
    _read_member_into(zf, key, out)
    return out


def _check_shapes(shapes: dict, leaves) -> None:
    for key, leaf in leaves:
        if key not in shapes:
            raise KeyError(f"checkpoint has no leaf {key}")
        if shapes[key] != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {shapes[key]} != template "
                             f"{tuple(leaf.shape)}")


def load_checkpoint(directory: str, template: Any, step: Optional[int] = None
                    ) -> tuple[Any, int]:
    """Restore into the structure of ``template`` (a tree of tensors):
    every shape checked first, every leaf a new tensor of the template
    leaf's dtype on its device.  Returns (tree, step)."""
    out = map_leaves(lambda t: torch.empty(t.shape, dtype=t.dtype, device=t.device), template)
    return out, restore_checkpoint(directory, out, step)


def restore_checkpoint(directory: str, target: Any, step: Optional[int] = None) -> int:
    """Restore IN PLACE into the tensors of ``target`` (e.g. views into an
    engine's flat buffers), one leaf at a time, streamed: the restore
    allocates no second state on the device.  Every shape is checked before
    the first leaf is written.  Returns the step."""
    step = resolve_step(directory, step)
    leaves = [(k, held(t)) for k, t in flatten(target)]
    with zipfile.ZipFile(checkpoint_path(directory, step)) as zf:
        _check_shapes(leaf_shapes(zf), leaves)
        for key, t in leaves:
            _read_member_into(zf, key, t)
    return step


def validate_run_config(
    recorded: dict, *, topology: str, bucket_mb: Optional[float],
    n: Optional[int] = None, n_label: str = "node count",
) -> None:
    """Fail-fast resume: compare a checkpoint's recorded ``run_config``
    against the resuming run's configuration.

    A mismatched resume (different topology, bucket layout, or — for the
    fixed-mesh trainer — gossip size) would otherwise surface as an opaque
    leaf-shape or tree-structure error mid-restore, or worse, silently
    change the mixing semantics.  Raises a ``ValueError`` naming BOTH the
    checkpointed and the configured value.  Checkpoints written before
    ``run_config`` existed (empty dict) skip the check.
    """
    if not recorded:
        return
    ck_topo = recorded.get("topology")
    if ck_topo is not None and str(ck_topo) != str(topology):
        raise ValueError(
            f"resume config mismatch: checkpoint was written with topology "
            f"{ck_topo!r} but this run is configured with {topology!r}"
        )
    if "bucket_mb" in recorded:
        ck_mb = recorded["bucket_mb"]
        ours = None if bucket_mb is None else float(bucket_mb)
        if (ck_mb is None) != (ours is None) or (
            ck_mb is not None and float(ck_mb) != ours
        ):
            raise ValueError(
                f"resume config mismatch: checkpoint was written with "
                f"bucket_mb={ck_mb} but this run is configured with "
                f"bucket_mb={ours}"
            )
    ck_n = recorded.get("n")
    if n is not None and ck_n is not None and int(ck_n) != int(n):
        raise ValueError(
            f"resume config mismatch: checkpoint was written with "
            f"{n_label} {int(ck_n)} but this run is configured with {int(n)}"
        )


def load_checkpoint_extra(directory: str, step: Optional[int] = None) -> Optional[dict]:
    """The ``extra`` payload saved with a checkpoint (None if it has none)."""
    step = resolve_step(directory, step)
    with zipfile.ZipFile(checkpoint_path(directory, step)) as zf:
        if _EXTRA_KEY + ".npy" not in zf.namelist():
            return None
        with zf.open(_EXTRA_KEY + ".npy") as f:
            return json.loads(str(np.lib.format.read_array(f, allow_pickle=False)))
