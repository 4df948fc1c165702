"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into
``build/repro_torch/`` at the root of the checkout.  The library's file
name carries a hash of its source, so an edited kernel is rebuilt and a
built one is reused.  ``load_all`` starts one nvcc per source, all at once,
and waits for every one of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch.analysis import recompile

__all__ = ["load", "load_all", "SOURCES", "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE.parents[2] / "build" / "repro_torch"
SOURCES = ("gossip_update", "l2_norms", "flash_attention", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: the memory-bound kernels round every
    # product and sum as their plain twins do (FMA buys them nothing);
    # flash_attention and ssd_scan, held to tolerances, call fmaf explicitly
    # (flash_attention's f32 products and bf16 scaled exponent, ssd_scan's
    # tile products)
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_VP, _LL, _INT, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
# source -> {C function: argument types}
_SIGNATURES = {
    "gossip_update": {
        "repro_gossip_program_update":
            [_INT, _INT, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _INT, _F, _F,
             _VP],
        "repro_gossip_update":
            [_INT, _INT, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _INT, _F, _F, _VP],
        "repro_gossip_update_attributes": [_INT, _INT, _VP],
        "repro_device_limits": [_VP],
    },
    "l2_norms": {
        "repro_segment_l2_norms":
            [_INT, _VP, _LL, _LL, _VP, _VP, _INT, _VP, _INT, _VP, _VP, _INT, _VP],
        "repro_l2_norms_attributes": [_INT, _INT, _VP],
    },
    "flash_attention": {
        "repro_flash_attention":
            [_INT, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VP],
        "repro_flash_attention_attributes": [_INT, _INT, _VP],
    },
    "ssd_scan": {
        "repro_ssd_scan_forward": [_VP] * 8 + [_INT] * 4 + [_VP],
        "repro_ssd_scan_backward": [_VP] * 14 + [_INT] * 4 + [_VP],
        "repro_ssd_scan_attributes": [_INT, _VP],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns the
    (process, temporary output, final path) or None."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    recompile.note("builds")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _bind(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_all() -> dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every kernel library."""
    with _lock:
        missing = [n for n in SOURCES if n not in _libs]
        jobs = {n: _start(n) for n in missing}
        errors = []
        for name, job in jobs.items():
            if job is None:
                continue
            proc, tmp, out = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in missing:
            _libs[name] = _bind(name)
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel (building all of them on first use)."""
    if name not in _libs:
        load_all()
    return _libs[name]
