"""The readings a cell's correctness limits are set from, on the card at
the cell's own size (not run by the benchmark's runs):

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--controls 3] [--out chiprun_out/calibrate_<name>.json]

For every seed: the program's readings of its checked steps against the
plain reference's (the lower readings).  For the first ``--controls``
seeds also the control, the reference computed in float8 in the
program's place, and the faults a run must catch, each planted in the
reference put in the program's place (``reference.FAULTS``; the state
left unchanged reads 1 on the gradient and the change by construction and
is not run).  Prints one line per side and seed, and a summary: per
number the largest sound reading and the least control and fault
readings.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check, generator, manifest, program, reference  # noqa: E402
from perfbench.cell import program_readings  # noqa: E402

PLANTED = ("half_batch", "no_mix", "probe_shift")


def calibrate(workload: str, seeds, controls: int, device="cuda", root: Path = ROOT) -> dict:
    man = manifest.load(root)
    wl = manifest.workload(man, workload)
    cfg = manifest.config(man, wl["config"], root)
    traffic = manifest.traffic(wl["traffic"], root)
    device = torch.device(device)
    nodes, lr, beta = cfg["nodes"], cfg["optimizer"]["lr"], cfg["optimizer"]["momentum"]
    if device.type == "cuda":
        program.build_kernels()
    sizes = reference.leaf_sizes(cfg, root)
    rows = []

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        weights = reference.draw_weights(cfg, seed, device, root=root)
        trainer, state = program.build(cfg, traffic, weights, device, root)
        del weights
        pool = generator.make_pool(traffic, vocab=cfg["vocab"], nodes=nodes, seed=seed,
                                   device=device)
        state, prog = program_readings(trainer, state, pool, lr)
        batches = pool[:check.CHECKED_STEPS]
        del trainer, state, pool
        free()
        weights = reference.draw_weights(cfg, seed, device, root=root)
        kw = dict(nodes=nodes, lr=lr, beta=beta, topology=traffic["topology"], root=root)
        ref = reference.run_reference(cfg, weights, batches, **kw)
        free()
        raw = lambda r: {k: np.asarray(v).tolist() for k, v in r.items()}
        row = {"seed": seed, "program": check.gaps(prog, ref, sizes),
               "readings": {"program": raw(prog), "reference": raw(ref)}}
        print(json.dumps({"seed": seed, "side": "program", **row["program"],
                          "losses": prog["losses"].tolist(),
                          "seconds": time.perf_counter() - t}), flush=True)
        if i < controls:
            sides = [("control_fp8", dict(quant="fp8"))] + [(f, dict(fault=f)) for f in PLANTED]
            for name, extra in sides:
                got = reference.run_reference(cfg, weights, batches, **kw, **extra)
                free()
                row[name] = check.gaps(got, ref, sizes)
                row["readings"][name] = raw(got)
                print(json.dumps({"seed": seed, "side": name, **row[name]}), flush=True)
        del weights, batches, ref
        free()
        rows.append(row)
    summary = {}
    for n in check.NUMBERS:
        lower = max(r["program"][n] for r in rows)
        reads = {s: min(r[s][n] for r in rows if s in r)
                 for s in ["control_fp8", *PLANTED] if any(s in r for r in rows)}
        summary[n] = {"lower": lower, "least": reads}
    return {"workload": workload, "seeds": list(seeds), "rows": rows, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = calibrate(args.workload, seeds, args.controls)
    print(json.dumps({"summary": out["summary"]}, indent=1), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
