"""One run of one cell: set-up, the measured window (or the traced
stretches), the correctness check, and the result line's dict.

Set-up builds one trainer and its state from the seed's weights, builds the
seed's batch pool, and drives the trainer through its first
``CHECKED_STEPS`` steps through the window's own call and feed; those steps
are the warm-up of every shape the window uses, and what they read is
what the check compares once the window has closed.  Set-up ends when the
first timed step is enqueued.

With ``trace`` 0 the window runs steps back to back for ``seconds``,
dispatched ahead with no host synchronize, a CUDA event recorded on the
stream at every step boundary, and closes at the synchronize after the
last step.  With ``trace`` 1 three stretches follow set-up instead: steps
back to back with the profiler off (the step time ``mfu.step_pct`` reads),
steps each started on an idle device (the host's time inside
``train_step``), and steps under the profiler (``trace.py``).

After the window: the peak memory is read, the program's state freed, and
the plain reference (``reference.py`` over the model module the
configuration names, ``reference.model``) runs the checked steps from the
same weights and batches; ``check.py`` compares the two sides.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from perfbench import check, generator, manifest, reference
from perfbench.check import CHECKED_STEPS

__all__ = ["run_cell", "program_readings", "TRACE_OFF_STEPS", "TRACE_HOST_STEPS",
           "TRACE_STEPS"]

TRACE_OFF_STEPS = 20    # profiler off, back to back
TRACE_HOST_STEPS = 5    # each after a synchronize
TRACE_STEPS = 5         # under the profiler (one more leads in)


def _log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


class _Clock:
    """Step boundaries: CUDA events on the stream, or the host clock on
    the CPU (the CPU tests' runs)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def program_readings(trainer, state, pool, lr: float, times=None):
    """Drive the trainer through its first ``CHECKED_STEPS`` steps on the
    pool's first batches; returns (state, the program's ``Readings``).
    ``times`` collects each step's seconds, its readings included."""
    offsets = trainer.layout.offsets
    theta0 = state.theta[0].clone()
    out = reference.Readings(losses=[], probe=[])
    for k in range(CHECKED_STEPS):
        t = time.perf_counter()
        state, loss, norms = trainer.train_step(state, pool[k], lr)
        out["losses"].append(loss.float().cpu().numpy().astype(np.float64))
        out["probe"].append(norms.float().cpu().numpy().astype(np.float64))
        if k == 0:
            out["grad"] = reference.leaf_norms(state.mom, offsets)
        if times is not None:
            times.append(time.perf_counter() - t)
    out["change"] = reference.leaf_norms(state.theta, offsets, minus=theta0)
    del theta0
    out["losses"], out["probe"] = np.array(out["losses"]), np.array(out["probe"])
    return state, out


def _window(trainer, state, pool, lr, seconds, first, clock):
    """Steps back to back until ``seconds`` have passed on the host."""
    losses, marks = [], [clock.mark()]
    t0 = time.perf_counter()
    k = 0
    while True:
        state, loss, _ = trainer.train_step(state, pool[(first + k) % len(pool)], lr)
        losses.append(loss)
        marks.append(clock.mark())
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    clock.sync()
    wall = time.perf_counter() - t0
    step_ms = [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
    return state, {"steps": k, "seconds": wall, "step_ms": step_ms, "losses": losses}


def _traced(trainer, state, pool, lr, first, clock):
    """The three stretches of a traced run; returns (state, trace dict,
    the losses of every step)."""
    from perfbench import trace

    k = first
    losses = []

    def step(_=None):
        nonlocal state, k
        state, loss, _n = trainer.train_step(state, pool[k % len(pool)], lr)
        losses.append(loss)
        k += 1

    a = clock.mark()
    for _ in range(TRACE_OFF_STEPS):
        step()
    b = clock.mark()
    clock.sync()
    off_ms = clock.ms(a, b) / TRACE_OFF_STEPS
    host_ms = []
    for _ in range(TRACE_HOST_STEPS):
        clock.sync()
        t = time.perf_counter()
        step()
        host_ms.append((time.perf_counter() - t) * 1e3)
    clock.sync()
    out = trace.profile_steps(step, TRACE_STEPS)
    out.update(untraced_step_ms=off_ms, host_step_ms=host_ms)
    return state, out, losses


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = manifest.ROOT, device=None, t_start: Optional[float] = None,
             fault: Optional[Callable] = None, log: Callable = _log) -> dict:
    """One run of ``workload``; returns the result line's dict.  ``fault``
    (tests only) wraps the built trainer, to break the timed path
    underneath the harness."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest.load(root)
    wl = manifest.workload(man, workload)
    cfg = manifest.config(man, wl["config"], root)
    traffic = manifest.traffic(wl["traffic"], root)
    limits = manifest.limits(workload, root)
    device = torch.device(device or "cuda")
    clock = _Clock(device)
    nodes, lr = cfg["nodes"], cfg["optimizer"]["lr"]
    split = {}

    def lap(name: str, t: float) -> float:
        clock.sync()
        now = time.perf_counter()
        split[name] = now - t
        return now

    t = time.perf_counter()
    split["start_s"] = t - t_start    # the interpreter, torch and the driver
    from perfbench import program    # the system under test

    program.import_program()
    t = lap("imports_s", t)
    if device.type == "cuda":
        program.build_kernels()
    t = lap("kernels_s", t)
    weights = reference.draw_weights(cfg, seed, device, root=root)
    trainer, state = program.build(cfg, traffic, weights, device, root)
    del weights
    if fault is not None:
        trainer = fault(trainer)
    t = lap("state_s", t)
    pool = generator.make_pool(traffic, vocab=cfg["vocab"], nodes=nodes, seed=seed,
                               device=device)
    t = lap("pool_s", t)
    steps_s = []
    state, prog = program_readings(trainer, state, pool, lr, steps_s)
    lap("warmup_s", t)
    gc.collect()
    setup_peak = program.peak_bytes(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = program.counters()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    log("set-up " + " ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" total {setup_s:.3f} s; checked steps {np.round(steps_s, 3).tolist()} s")
    with program.watch_rebuilds("window") as rebuilt:
        if trace:
            state, traced, losses = _traced(trainer, state, pool, lr, CHECKED_STEPS, clock)
            window = None
        else:
            state, window = _window(trainer, state, pool, lr, seconds, CHECKED_STEPS, clock)
            traced, losses = None, window.pop("losses")
    peak = program.peak_bytes(device)
    if window is not None:
        ms = np.asarray(window["step_ms"])
        pct = np.percentile(ms, [50, 75, 90, 95, 99]).round(3).tolist()
        log(f"window {window['steps']} steps in {window['seconds']:.3f} s; step ms first "
            f"{np.round(ms[:3], 3).tolist()} p50/75/90/95/99 {pct} max {ms.max():.3f}; "
            f"{int((ms > 1.01 * pct[0]).sum())} steps over 1.01 x the median")
    launches = {k: v - launches0[k] for k, v in program.counters().items()}
    log(f"in the window: launches {launches}, rebuilds {program.stats_dict(rebuilt)}")
    bad = int((~torch.isfinite(torch.stack(losses).float())).any(dim=1).sum())
    attempted = len(losses)

    batches = pool[:CHECKED_STEPS]
    del trainer, state, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    weights = reference.draw_weights(cfg, seed, device, root=root)
    ref = reference.run_reference(cfg, weights, batches, nodes=nodes, lr=lr,
                                  beta=cfg["optimizer"]["momentum"],
                                  topology=traffic["topology"], root=root)
    del weights
    sizes = reference.leaf_sizes(cfg, root)
    numbers = check.gaps(prog, ref, sizes)
    ok, table = check.judge(numbers, limits)
    log(f"reference {time.perf_counter() - t:.3f} s; not compared: "
        + (", ".join(f"{k} {v!r}" for k, v in numbers.items() if k not in limits) or "none"))

    ctx = {"cfg": cfg, "traffic": traffic, "nodes": nodes, "setup_s": setup_s,
           "peak_bytes": peak, "window": window, "trace": traced,
           "params": sum(sizes), "n_leaves": len(sizes),
           "param_bytes": reference.param_bytes(cfg, root),
           "model_flops_per_step": reference.model(cfg, root).model_flops_per_step(
               cfg, nodes=nodes, per_node_batch=traffic["per_node_batch"],
               seq=traffic["seq_len"]),
           "tokens_per_step": generator.tokens_per_step(traffic, nodes)}
    metrics = {}
    for m in manifest.cell_metrics(man, workload, "per_layer" if trace else "end_to_end"):
        value = manifest.reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(max(setup_peak, peak))}
    result = {"correct": bool(ok and bad == 0), "attempted": attempted, "failed": bad,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = table
    return result
