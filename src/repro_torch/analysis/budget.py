"""Pass 4 — launch budgets of kernels K1-K4 on Hopper: the counterpart of
``repro/analysis/budget.py``.

The reference checks a Pallas grid cell's SMEM and VMEM against the TPU's
before dispatch.  On the H100 what a launch can exceed is the grid (y and
z at most 65535), the threads and registers of a block and its shared
memory (227 KiB a block with the opt-in, 48 KiB without).  A launch over
any of them is refused by the card and never runs, so
``check_kernel_budget`` validates each dispatch signature BEFORE the launch
(cached per signature: the hot path pays one dict lookup), from the
kernels' own launch arithmetic mirrored here:

  * K1 (``gossip_program_update``): grid (blocks a row, G): G ≤ 65535,
    blocks a row ``min(⌈⌈P/8⌉/256⌉, 4096)`` (``kMaxBlocksPerRow``;
    the kernel strides over the rest); its one-pass route (no wire) grid
    (⌈⌈P/8⌉/128⌉,) of 128 threads, each staging 8 columns of all G rows in
    its slot of shared memory, ``k1_one_pass_smem_bytes`` a block within
    the 48 KiB a block takes without the opt-in: G ≤ ``k1_one_pass_rows``
    (8 in bfloat16, 6 in float32; the wrapper takes the two-operand route
    above that);
  * K2 (``gossip_update``): grid (blocks a row, 1);
  * K3 (``segment_l2_norms``): grids (tiles, R) and (segments, R);
  * K4 (``flash_attention``): the float32 route's grid (⌈Sq/64⌉, H, B) and
    ``smem_bytes<D>()``, the bfloat16 route's ⌈Sq/128⌉·B·H blocks and
    ``smem_bytes_tc<D>()``, against the opt-in shared memory.

The 16-byte alignment that selects each kernel's vector path is reported
(``aligned``), not enforced: a misaligned launch runs the scalar path, a
performance finding as the reference treats lane alignment.
``verify_program_budget`` checks the launch a program's tables would make;
``kernel_attributes`` and ``device_limits`` read what the built kernels and
the card report (on the card), and ``verify_kernel_attributes`` holds the
first against these budgets.
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.analysis.report import BudgetViolation

__all__ = [
    "CARD",
    "SMEM_OPTIN_BYTES",
    "SMEM_STATIC_BYTES",
    "MAX_GRID_X",
    "MAX_GRID_YZ",
    "MAX_THREADS_PER_BLOCK",
    "MAX_REGS_PER_THREAD",
    "REGS_PER_BLOCK",
    "K3_TILE",
    "k1_one_pass_smem_bytes",
    "k1_one_pass_rows",
    "k4_smem_bytes",
    "check_kernel_budget",
    "verify_program_budget",
    "kernel_attributes",
    "device_limits",
    "verify_kernel_attributes",
]

# The card the limits are of (NVIDIA's data sheet and CUDA's sm_90 limits).
CARD = "NVIDIA H100 (sm_90)"
SMEM_OPTIN_BYTES = 232448       # 227 KiB of shared memory a block, with the opt-in
SMEM_STATIC_BYTES = 49152       # 48 KiB a block without it
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
MAX_THREADS_PER_BLOCK = 1024
MAX_REGS_PER_THREAD = 255
REGS_PER_BLOCK = 65536

# Launch constants of the kernels (src/repro_torch/kernels/csrc)
K12_THREADS, K12_ELEMS, K12_MAX_BLOCKS_PER_ROW = 256, 8, 4096   # gossip_update.cu
K1_ONE_PASS_THREADS = 128
K3_THREADS, K3_TILE = 256, 1 << 15                              # l2_norms.cu
K4_HEAD_DIMS = (32, 64, 128)                                    # flash_attention.cu
K4_F32_BQ, K4_F32_BK, K4_F32_THREADS = 64, 64, 256
K4_BF16_ROWS, K4_BF16_STAGES, K4_BF16_THREADS = 128, 2, 384

KERNELS = ("gossip_program_update", "gossip_update", "segment_l2_norms", "flash_attention")


def k4_smem_bytes(dtype: str, d: int) -> int:
    """Dynamic shared memory a K4 block asks for: ``smem_bytes<D>()`` of the
    float32 route (Q and a K and V tile at row stride D + 4, P at 68) or
    ``smem_bytes_tc<D>()`` of the bfloat16 route (Q and K4_BF16_STAGES K
    and V tiles of 128 rows, the barriers, 1 KiB of alignment slack)."""
    if dtype == "float32":
        return 4 * ((K4_F32_BQ + 2 * K4_F32_BK) * (d + 4) + K4_F32_BQ * (K4_F32_BK + 4))
    return (1 + 2 * K4_BF16_STAGES) * K4_BF16_ROWS * d * 2 + 64 + 1024


def k1_one_pass_smem_bytes(elem_bytes: int, rows: int) -> int:
    """Dynamic shared memory a block of K1's one-pass route asks for over
    ``rows`` rows: a thread's slot of each row holds the sender's 8 elements
    (16-byte words) and 8 float32 (``one_pass_smem_bytes``)."""
    words = K12_ELEMS * elem_bytes // 16 + 2
    return rows * words * K1_ONE_PASS_THREADS * 16


def k1_one_pass_rows(elem_bytes: int) -> int:
    """The most rows K1's one-pass route stages (``one_pass_max_rows``):
    a block's shared memory without the opt-in over one row's slots."""
    return SMEM_STATIC_BYTES // k1_one_pass_smem_bytes(elem_bytes, 1)


def _blocks_per_row(p: int) -> int:
    return min(-(-(-(-p // K12_ELEMS)) // K12_THREADS), K12_MAX_BLOCKS_PER_ROW)


def _grid(kernel: str, grid: tuple, threads: int, smem: int = 0) -> None:
    """Raise unless ``grid``, ``threads`` and ``smem`` fit the card."""
    x, *yz = grid
    if x > MAX_GRID_X or any(v > MAX_GRID_YZ for v in yz):
        raise BudgetViolation(
            f"{kernel}: grid {grid} exceeds the card's ({MAX_GRID_X}, {MAX_GRID_YZ}, "
            f"{MAX_GRID_YZ}) on {CARD} — the launch would be refused")
    if threads > MAX_THREADS_PER_BLOCK:
        raise BudgetViolation(f"{kernel}: {threads} threads a block > {MAX_THREADS_PER_BLOCK}")
    if smem > SMEM_OPTIN_BYTES:
        raise BudgetViolation(
            f"{kernel}: {smem} B of shared memory a block > {SMEM_OPTIN_BYTES} B "
            f"(227 KiB with the opt-in on {CARD}) — the launch would be refused")


@lru_cache(maxsize=256)
def check_kernel_budget(kernel: str, **dims) -> dict:
    """Validate one dispatch signature; raise ``BudgetViolation`` on a launch
    the card would refuse, else return its launch (``grid``, ``threads``,
    ``smem_bytes``) and whether it takes the vector path (``aligned``).

    ``dims`` per kernel: K1 ``rows``, ``cols``, ``deg``, ``aligned`` and, for
    its one-pass route, ``one_pass_bytes`` (θ's element bytes); K2
    ``cols``, ``deg``, ``aligned``; K3 ``rows``, ``offsets``, ``aligned``;
    K4 ``dtype`` ("float32" | "bfloat16"), ``b``, ``h``, ``sq``, ``d``."""
    if kernel in ("gossip_program_update", "gossip_update"):
        rows = dims.get("rows", 1)
        if dims["deg"] < 0:
            raise BudgetViolation(f"{kernel}: negative program degree {dims['deg']}")
        eb = dims.get("one_pass_bytes")
        if eb is not None:
            if rows > k1_one_pass_rows(eb):
                raise BudgetViolation(
                    f"{kernel}: one pass over {rows} rows > {k1_one_pass_rows(eb)}: the "
                    f"staging would pass the 48 KiB a block takes without the opt-in")
            grid = (-(-(-(-dims["cols"] // K12_ELEMS)) // K1_ONE_PASS_THREADS),)
            smem = k1_one_pass_smem_bytes(eb, rows)
            _grid(kernel, grid, K1_ONE_PASS_THREADS, smem)
            return {"grid": grid, "threads": K1_ONE_PASS_THREADS, "smem_bytes": smem,
                    "aligned": bool(dims["aligned"])}
        grid = (_blocks_per_row(dims["cols"]), rows)   # empty: no launch
        _grid(kernel, grid, K12_THREADS)
        return {"grid": grid, "threads": K12_THREADS, "smem_bytes": 0,
                "aligned": bool(dims["aligned"])}
    if kernel == "segment_l2_norms":
        offs, rows = dims["offsets"], dims["rows"]
        tiles = sum(-(-(b - a) // K3_TILE) for a, b in zip(offs[:-1], offs[1:]))
        grid = (max(tiles, 1), rows)
        _grid(kernel, grid, K3_THREADS)
        _grid(kernel, (len(offs) - 1, rows), K3_THREADS)
        return {"grid": grid, "threads": K3_THREADS, "smem_bytes": 0,
                "aligned": bool(dims["aligned"])}
    if kernel == "flash_attention":
        dtype, b, h, sq, d = (dims[k] for k in ("dtype", "b", "h", "sq", "d"))
        smem = k4_smem_bytes(dtype, d)
        if dtype == "float32":
            grid, threads = (-(-sq // K4_F32_BQ), h, b), K4_F32_THREADS
        else:
            grid, threads = (-(-sq // K4_BF16_ROWS) * b * h,), K4_BF16_THREADS
        _grid(kernel, grid, threads, smem)
        return {"grid": grid, "threads": threads, "smem_bytes": smem, "aligned": True}
    raise BudgetViolation(f"unknown kernel {kernel!r} (one of {KERNELS})")


def verify_program_budget(program, *, cols: int = 1 << 20) -> dict | None:
    """K1's launch for ``program``'s permute tables over ``cols`` columns
    of its n stacked nodes; ``None`` for a program without tables (dense or
    fused), which never reaches the kernel."""
    tables = program.permute_tables()
    if tables is None:
        return None
    srcs, weights = tables
    n, deg = srcs.shape
    if weights.shape != (n, deg + 1):
        raise BudgetViolation(
            f"program {program.name!r}: weight table {weights.shape} does not match "
            f"the ({n}, {deg + 1}) row layout the kernel reads")
    return check_kernel_budget("gossip_program_update", rows=n, cols=cols, deg=deg,
                               aligned=cols % K12_ELEMS == 0)


_ATTRS = ("regs_per_thread", "static_smem_bytes", "dynamic_smem_bytes",
          "max_threads_per_block", "threads", "local_bytes_per_thread")


def kernel_attributes() -> dict:
    """What the built kernels report (``cudaFuncGetAttributes`` through the
    bindings; on the card, after the build): per kernel and route, registers
    a thread, static and dynamic shared bytes a block, the most threads a
    block can take, the threads it launches with, spill bytes a thread."""
    import ctypes

    from repro_torch.kernels import _build

    def read(fn, *args):
        out = (ctypes.c_int * 6)()
        err = fn(*args, out)
        if err != 0:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
        return dict(zip(_ATTRS, out))

    gu, l2, fa = (_build.load(n) for n in ("gossip_update", "l2_norms", "flash_attention"))
    out = {}
    for dt, name in ((0, "float32"), (1, "bfloat16")):
        out[f"gossip_program_update {name}"] = read(gu.repro_gossip_update_attributes, 0, dt)
        out[f"gossip_program_update one-pass {name}"] = read(
            gu.repro_gossip_update_attributes, 2, dt)
        out[f"gossip_update {name}"] = read(gu.repro_gossip_update_attributes, 1, dt)
        out[f"segment_l2_norms pass 1 {name}"] = read(l2.repro_l2_norms_attributes, 0, dt)
        for d in K4_HEAD_DIMS:
            out[f"flash_attention {name} D={d}"] = read(fa.repro_flash_attention_attributes,
                                                        dt, d)
    out["segment_l2_norms pass 2"] = read(l2.repro_l2_norms_attributes, 1, 0)
    return out


def device_limits() -> dict:
    """The current card's launch limits as the CUDA runtime reports them."""
    import ctypes

    from repro_torch.kernels import _build

    out = (ctypes.c_int * 7)()
    err = _build.load("gossip_update").repro_device_limits(out)
    if err != 0:
        raise RuntimeError(f"repro_device_limits: CUDA error {err}")
    return dict(zip(("max_grid_x", "max_grid_y", "max_grid_z", "smem_optin_bytes",
                     "smem_bytes", "max_threads_per_block", "regs_per_block"), out))


def verify_kernel_attributes(attrs: dict) -> None:
    """Each built kernel within budget: registers a thread ≤ 255 and a
    block's registers ≤ 65536, static shared memory ≤ 48 KiB, static plus
    dynamic ≤ 227 KiB, its launch's threads ≤ what it can take; K4's dynamic
    request equal to ``k4_smem_bytes``; K1's one-pass route at its most
    rows asking for ``k1_one_pass_smem_bytes`` and spilling nothing (its G
    limit assumes the staging is all in shared memory).  Other local
    (spill) bytes are reported, not held."""
    for name, a in attrs.items():
        if a["regs_per_thread"] > MAX_REGS_PER_THREAD \
                or a["regs_per_thread"] * a["threads"] > REGS_PER_BLOCK:
            raise BudgetViolation(f"{name}: {a['regs_per_thread']} registers a thread × "
                                  f"{a['threads']} threads exceed the block's {REGS_PER_BLOCK}")
        if a["static_smem_bytes"] > SMEM_STATIC_BYTES \
                or a["static_smem_bytes"] + a["dynamic_smem_bytes"] > SMEM_OPTIN_BYTES:
            raise BudgetViolation(f"{name}: shared memory {a['static_smem_bytes']} static + "
                                  f"{a['dynamic_smem_bytes']} dynamic B over {CARD}'s budget")
        if a["threads"] > a["max_threads_per_block"]:
            raise BudgetViolation(f"{name}: launches {a['threads']} threads, takes "
                                  f"{a['max_threads_per_block']}")
        if name.startswith("gossip_program_update one-pass"):
            eb = 4 if name.endswith("float32") else 2
            want = k1_one_pass_smem_bytes(eb, k1_one_pass_rows(eb))
            if a["dynamic_smem_bytes"] != want or a["local_bytes_per_thread"]:
                raise BudgetViolation(
                    f"{name}: asks for {a['dynamic_smem_bytes']} B (the budget reckons "
                    f"{want} B) and spills {a['local_bytes_per_thread']} B a thread")
        if name.startswith("flash_attention"):
            _, dtype, dd = name.split()
            want = k4_smem_bytes(dtype, int(dd[2:]))
            if a["dynamic_smem_bytes"] != want:
                raise BudgetViolation(f"{name}: the kernel asks for {a['dynamic_smem_bytes']} B, "
                                      f"the budget reckons {want} B")
