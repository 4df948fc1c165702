"""The benchmark's command: one run of one cell on the card it starts on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds ``BENCHMARK.json``,
``perfbench/`` and the program (``src/repro_torch``).  It prints its
set-up split, its counters and, as its last lines on standard error, each
number the correctness check compared beside its limit; its last line on
standard output is the result's JSON.  It exits with 2, printing no
result, without a CUDA card or with fewer cards than the cell asks for,
and with 3 if a JAX module (``jax``, ``jaxlib``, ``flax``) or the JAX
package (``repro``) is loaded once the window has closed.  It writes
nothing but the program's kernel build in the checkout
(``build/repro_torch/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _err(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import manifest

    wl = manifest.workload(manifest.load(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        _err(f"{args.workload} needs {wl['chips']} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from perfbench.cell import run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root=ROOT,
                      t_start=T_START)
    _err(f"card {_card()}")
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        _err(f"modules of JAX or of the JAX package were loaded: {loaded}")
        return 3
    for k, v in result["checks"].items():
        _err(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
