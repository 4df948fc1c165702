#!/usr/bin/env python3
"""Drive the PyTorch port's training path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, in parallel);
  2. K1 (fused gossip update) against its plain twin on one full-width
     granite-8b leaf (G = 4 × the 58,720,256-element ``w_up``, bfloat16):
     post and pre order, all-ones rows and a masked row;
  3. K3 (segmented L2 norms) against its twin over a (4, 838,881,280)
     bfloat16 buffer cut into granite-8b's leaf segments;
  4. the main path: ``SPMDTrainer`` at granite-8b width (d_model 4096,
     32 heads, 8 KV heads, d_ff 14336, vocab 49152, bfloat16), depth cut to
     2 layers, G = 4 nodes on the card, d_ring, fused apply and DBench norms
     on, seq 512, per-node batch 2, lr 1e-2, 4 steps; the launch counters
     are zeroed just before and read just after;
  5. one step from the main path's state before its last step, with every
     node's θ offset by its own noise so that the mix is visible, through
     the fused trainer and through one with ``fused_apply=False``,
     compared element by element (θ' within 2 bfloat16 ulps plus float32
     rounding at the scale of the mixed terms, m' within 1e-6 relative);
  6. where one fused step's time goes (CUDA events around the per-node
     forward/backward and the wire; device time by kernel group from one
     step under torch.profiler); K1 against its twin on the main path's
     full (4, 838,881,280) state, gradients and wire, as phase 2 checks it
     on one leaf; then each kernel timed with CUDA events at the main
     path's shapes, beside its plain twin, its bound and (where one exists)
     a PyTorch library call;
  7. the CLI, ``main(["--reduced", "--steps", "3", "--fused-apply"])``.

The last three lines of standard output are the card's name and power
limit as nvidia-smi reports them, the per-kernel JSON, and the result
``{"ok": true, "device": {...}}``.  TF32 is off throughout.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores

G, SEQ, BATCH, LR, STEPS = 4, 512, 2, 1e-2, 4
# columns per comparison chunk: bounds the float32 temporaries of a check
# over a full (G, P) buffer to a few GiB beside the state
TWIN_CHUNK = 1 << 26


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=1):
    """Mean milliseconds of ``fn()`` by CUDA events over ``iters`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x):
    import torch

    mag = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def ring_tables(dev):
    """d_ring's (srcs int32, weights float32) on ``dev``."""
    import torch
    from repro_torch.core.dsgd import make_topology

    srcs_np, w_np = make_topology("d_ring", G).program_at().permute_tables()
    return torch.as_tensor(srcs_np, device=dev), torch.as_tensor(w_np, device=dev)


def k1_against_twin(label, theta0, wire, srcs, w, grad, mom0):
    """Launch K1 on clones of (theta0, mom0) over the whole (G, P) buffer,
    then hold each 2^26-column chunk of its output against the plain twin
    on the same inputs: post and pre order, all-ones and masked fault rows;
    m' within 1e-6 relative, theta' within 2 bfloat16 ulps.  Returns the
    max abs error."""
    import torch
    from repro_torch.kernels.gossip_update import (
        gossip_program_update, gossip_program_update_plain,
    )

    ones = torch.ones_like(w)
    masked = ones.clone()
    masked[1, 0] = 0.0   # node 1 skips its update
    masked[2, 1] = 0.0   # node 2 drops its first edge
    p = theta0.shape[1]
    worst = 0.0
    for order, fault in (("post", ones), ("pre", ones), ("post", masked), ("pre", masked)):
        kw = dict(lr=LR, beta=0.9, fault=fault, mix_order=order)
        theta, mom = theta0.clone(), mom0.clone()
        gossip_program_update(theta, wire, srcs, w, grad, mom, **kw)
        err_t_max = err_m_max = 0.0
        for a in range(0, p, TWIN_CHUNK):
            b = min(a + TWIN_CHUNK, p)
            want_t, want_m = gossip_program_update_plain(
                theta0[:, a:b], wire[:, a:b], srcs, w, grad[:, a:b], mom0[:, a:b], **kw)
            err_m = (mom[:, a:b] - want_m).abs()
            if not bool((err_m <= 1e-6 * want_m.abs()).all()):
                fail(f"K1 {label} {order}: m' differs from the twin by "
                     f"{float(err_m.max()):.3e} in columns {a}:{b}")
            err_t = (theta[:, a:b].float() - want_t.float()).abs()
            if not bool((err_t <= 2 * bf16_ulp(want_t)).all()):
                fail(f"K1 {label} {order}: theta' differs from the twin by more than "
                     f"2 bf16 ulps in columns {a}:{b} (max abs {float(err_t.max()):.3e})")
            err_t_max = max(err_t_max, float(err_t.max()))
            err_m_max = max(err_m_max, float(err_m.max()))
            del want_t, want_m, err_m, err_t
        del theta, mom
        worst = max(worst, err_t_max, err_m_max)
        log(f"K1 {label} {order} {'masked' if fault is masked else 'all-ones'}: "
            f"max|dtheta|={err_t_max:.3e} max|dm|={err_m_max:.3e} ok")
    return worst


def phase_k1_twin(dev):
    """K1 against its twin on G × one w_up leaf; returns the max abs error."""
    import torch

    p = 4096 * 14336
    srcs, w = ring_tables(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    theta0 = (torch.randn((G, p), generator=gen, device=dev) * 0.02).bfloat16()
    grad = torch.randn((G, p), generator=gen, device=dev).bfloat16()
    wire = (torch.randn((G, p), generator=gen, device=dev) * 0.02).bfloat16()
    mom0 = torch.randn((G, p), generator=gen, device=dev)
    return k1_against_twin("w_up leaf", theta0, wire, srcs, w, grad, mom0)


def phase_fused_vs_interpreter(trainer, plain_trainer, start, batch):
    """One step from the same state through K1 (``trainer``) and through the
    optimizer and program interpreter (``plain_trainer``), compared element
    by element.  ``start`` is consumed.

    Every node's θ is first offset by its own noise (σ = 0.01, half a
    weight's scale), so that the mix moves θ by far more than the
    tolerance: a wrong neighbour table or a lost neighbour term fails.
    θ' agrees within 2 bfloat16 ulps of the larger of |θ*| (the node's own
    θ − lr·m') and |θ'| (the interpreter rounds θ* to bfloat16 before
    mixing, the kernel after: ≤ w0/2 ulp of θ*, plus one rounding each),
    plus 2^-20 of Σ_k w_k |θ*_k| over the node and its senders (16 float32
    roundings of the sums, which matter where the terms cancel); m' within
    1e-6 relative.  Returns (the fused state after the step, worst θ' error
    in bfloat16 ulps and as a share of its tolerance, worst m' relative
    error, share of elements the mix moved by more than the tolerance)."""
    import torch

    dev = start.theta.device
    srcs_np, w_np = trainer.topology.program_at().permute_tables()
    srcs = torch.as_tensor(srcs_np, dtype=torch.long, device=dev)
    w = torch.as_tensor(w_np, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    p = start.theta.shape[1]
    for a in range(0, p, TWIN_CHUNK):
        b = min(a + TWIN_CHUNK, p)
        noise = torch.randn((G, b - a), generator=gen, device=start.theta.device)
        start.theta[:, a:b] += (noise * 0.01).to(start.theta.dtype)
        del noise
    theta0 = start.theta.clone()
    fused = start.clone()
    fused, loss_f, _ = trainer.train_step(fused, batch, LR)
    ref, loss_r, _ = plain_trainer.train_step(start, batch, LR)
    if not torch.allclose(loss_f, loss_r, rtol=1e-5, atol=0):
        fail(f"fused and interpreter losses differ: {loss_f.tolist()} vs {loss_r.tolist()}")
    worst_ulps = worst_tol = worst_m = 0.0
    moved = 0
    for a in range(0, p, TWIN_CHUNK):
        b = min(a + TWIN_CHUNK, p)
        tf, tr = fused.theta[:, a:b].float(), ref.theta[:, a:b].float()
        mf, mr = fused.mom[:, a:b], ref.mom[:, a:b]
        own = theta0[:, a:b].float() - LR * mr   # every node's own θ*
        ulp = bf16_ulp(torch.maximum(own.abs(), tr.abs()))
        # the scale of the mixed terms: where they cancel, both sides'
        # float32 sums round at this scale, not at θ''s
        terms = w[:, :1] * own.abs()
        for k in range(srcs.shape[1]):
            terms += w[:, k + 1:k + 2] * own.abs().index_select(0, srcs[:, k])
        tol = 2 * ulp + 2.0 ** -20 * terms
        err = (tf - tr).abs()
        if not bool((err <= tol).all()):
            bad = float((err / tol).max())
            fail(f"fused vs interpreter step: theta' differs by {bad:.2f}x its "
                 f"tolerance in columns {a}:{b}")
        worst_ulps = max(worst_ulps, float((err / ulp).max()))
        worst_tol = max(worst_tol, float((err / tol).max()))
        moved += int(((tr - own).abs() > tol).sum())
        err_m = (mf - mr).abs()
        if not bool((err_m <= 1e-6 * mr.abs()).all()):
            fail(f"fused vs interpreter step: m' differs by {float(err_m.max()):.3e} "
                 f"in columns {a}:{b}")
        worst_m = max(worst_m, float((err_m / mr.abs().clamp_min(1e-30)).max()))
        del tf, tr, mf, mr, own, ulp, terms, tol, err, err_m
    moved_share = moved / fused.theta.numel()
    if moved_share < 0.9:
        fail(f"the mix moved only {moved_share:.3f} of the elements past the "
             "tolerance: the comparison cannot see a wrong mix")
    del theta0, ref
    return fused, worst_ulps, worst_tol, worst_m, moved_share


def kernel_group(name):
    """Coarse group of a device kernel's name for the step breakdown."""
    if "program_update_kernel" in name:
        return "K1 gossip_program_update"
    if "partial_kernel" in name or "finish_kernel" in name:
        return "K3 segment_l2_norms"
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


def profile_step(trainer, state, batch):
    """One fused step under torch.profiler: (wall ms, {group: device ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        trainer.train_step(state, batch, LR)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    busy = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        group = kernel_group(e.key)
        busy[group] = busy.get(group, 0.0) + us / 1e3
    return wall, busy


def granite_layout():
    from repro_torch.configs import get_config
    from repro_torch.core.flat import FlatLayout
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=2)
    defs = tfm.model_defs(cfg)
    return cfg, FlatLayout.from_shapes({k: d.shape for k, d in defs.items()})


def phase_k3_twin(dev, layout):
    """K3 against its twin over granite's leaf segments; returns max abs error."""
    import torch
    from repro_torch.kernels.stats import segment_l2_norms, segment_l2_norms_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((G, layout.size), generator=gen, device=dev, dtype=torch.bfloat16)
    want = segment_l2_norms_plain(x, layout.offsets)
    got = segment_l2_norms(x, layout.offsets)
    torch.cuda.synchronize()
    again = segment_l2_norms(x, layout.offsets)
    if not torch.equal(got, again):
        fail("K3 is not deterministic")
    err = (got - want).abs()
    if not bool((err <= 1e-5 * want.abs()).all()):
        fail(f"K3 differs from the twin by {float((err / want.abs()).max()):.3e} relative")
    log(f"K3 over {len(layout.names)} leaf segments: max rel err "
        f"{float((err / want.abs()).max()):.3e} ok")
    return float(err.max())


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.dsgd import make_topology
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gossip_update import (
        gossip_program_update, gossip_program_update_plain, gossip_wire,
    )
    from repro_torch.kernels.stats import segment_l2_norms, segment_l2_norms_plain
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim.sgd import sgd

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    _build.load_all()
    log(f"phase 1: built {list(_build.SOURCES)} in {time.perf_counter() - t0:.1f}s "
        f"into {_build.BUILD_DIR}")

    # 2-3. kernels against their twins
    err_k1 = phase_k1_twin(dev)
    torch.cuda.empty_cache()
    cfg, layout = granite_layout()
    err_k3 = phase_k3_twin(dev, layout)
    torch.cuda.empty_cache()
    log("phases 2-3: kernels agree with their twins")

    # 4. the main path at granite-8b width
    topo = make_topology("d_ring", G)
    trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True,
                          fused_apply=True)
    params = sum(layout.sizes)
    log(f"phase 4: {cfg.name} x{cfg.n_layers} layers, {params:,} params/node, "
        f"G={G}, {topo.describe()}")
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in src.stacked(G, t, BATCH).items()}
               for t in range(STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms, losses, snap, peak = [], [], None, 0
    for t in range(STEPS):
        if t == STEPS - 1:
            peak = torch.cuda.max_memory_allocated()
            snap = state.clone()   # the state phase 5 restarts from
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss, norms = trainer.train_step(state, batches[t], LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.tolist())
        if not bool(torch.isfinite(loss).all()) or not bool(torch.isfinite(norms).all()):
            fail(f"step {t}: non-finite loss {loss.tolist()} or norms")
        if tuple(norms.shape) != (G, len(layout.names)):
            fail(f"norms shape {tuple(norms.shape)}")
        log(f"  step {t}: {step_ms[-1]:.1f} ms  loss {[round(x, 4) for x in loss.tolist()]}")
    counts = ops.launch_counts()
    if counts != {"gossip_program_update": STEPS, "segment_l2_norms": STEPS}:
        fail(f"main path launch counts {counts}, expected {STEPS} each")
    log(f"phase 4: launches {counts}; peak allocated {peak / 2**30:.2f} GiB over "
        f"{STEPS - 1} steps")

    # 5. the same step without the fused kernel, from the main path's state
    # before its last step (launches from here on are not the main path's)
    del state, loss, norms
    torch.cuda.empty_cache()
    plain_trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True,
                                fused_apply=False)
    torch.cuda.reset_peak_memory_stats()
    state, ulps5, tol5, rel_m5, moved5 = phase_fused_vs_interpreter(
        trainer, plain_trainer, snap, batches[-1])
    del snap, plain_trainer
    peak5 = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    log(f"phase 5: fused step == interpreter step: theta' within {ulps5:.3f} bf16 "
        f"ulps ({tol5:.3f} of its tolerance), m' within {rel_m5:.3e} relative; the "
        f"mix moved {moved5:.4f} of the elements past the tolerance; peak "
        f"allocated {peak5 / 2**30:.2f} GiB")

    # 6. where one fused step's time goes, K1 against its twin at the main
    # path's shape, then kernel times at the main path's shapes
    grad = torch.empty_like(state.theta)
    fwd_bwd_ms = cuda_ms(lambda: trainer._grads_into(state.theta, grad, batches[0]), 2)
    wire_ms = cuda_ms(lambda: gossip_wire(state.theta, grad, state.mom, lr=LR, beta=0.9), 3)
    try:
        prof_wall, busy = profile_step(trainer, state, batches[0])
    except Exception:  # the profiler is a measurement aid, not a phase
        import traceback

        traceback.print_exc()
        prof_wall, busy = None, {}
        log("phase 6: torch.profiler failed; breakdown from CUDA events only")
    busy_ms = sum(busy.values())
    breakdown = {
        "fwd_bwd_4_nodes_ms": fwd_bwd_ms, "wire_ms": wire_ms,
        "profiled_step_wall_ms": prof_wall,
        "device_busy_ms_by_group": busy, "device_busy_ms": busy_ms,
        "idle_share_of_profiled_step": (
            1.0 - busy_ms / prof_wall if prof_wall and busy_ms else None
        ),
    }
    log("phase 6: breakdown " + json.dumps(breakdown))
    theta, mom = state.theta, state.mom
    p_cols = theta.shape[1]
    srcs, w = ring_tables(dev)
    ones = torch.ones_like(w)
    wire = gossip_wire(theta, grad, mom, lr=LR, beta=0.9)
    # the trainer's K1 launch spans the whole flat buffer, where row offsets
    # i·P pass 2^31: check it there, on the main path's state and gradients
    err_k1 = max(err_k1, k1_against_twin("main-path state", theta, wire, srcs, w,
                                         grad, mom))
    deg = srcs.shape[1]
    k1 = dict(lr=LR, beta=0.9, fault=ones, mix_order="post")
    k1_ms = cuda_ms(lambda: gossip_program_update(theta, wire, srcs, w, grad, mom, **k1), 5)

    def k1_plain():
        for a in range(0, p_cols, TWIN_CHUNK):
            b = min(a + TWIN_CHUNK, p_cols)
            gossip_program_update_plain(theta[:, a:b], wire[:, a:b], srcs, w,
                                        grad[:, a:b], mom[:, a:b], **k1)

    k1_plain_ms = cuda_ms(k1_plain, 2)
    n_el = theta.numel()
    eb = theta.element_size()
    k1_bytes = n_el * (eb + eb + 4 + eb) + n_el * (eb + 4)   # θ g m wire in; θ' m' out
    k1_ops = n_el * (8 + 2 * deg)
    k1_bound = 1e3 * max(k1_bytes / HBM_BYTES_PER_S, k1_ops / F32_OPS_PER_S)

    offs = layout.offsets
    k3_ms = cuda_ms(lambda: segment_l2_norms(theta, offs), 10)
    k3_plain_ms = cuda_ms(lambda: segment_l2_norms_plain(theta, offs), 2)
    k3_lib_ms = cuda_ms(lambda: [
        torch.linalg.vector_norm(theta[:, a:b], dim=1, dtype=torch.float32)
        for a, b in zip(offs[:-1], offs[1:])
    ], 3)
    k3_bytes = n_el * eb + G * len(layout.names) * 4
    k3_ops = 2 * n_el
    k3_bound = 1e3 * max(k3_bytes / HBM_BYTES_PER_S, k3_ops / F32_OPS_PER_S)
    log(f"phase 6: K1 {k1_ms:.3f} ms (bound {k1_bound:.3f}, plain {k1_plain_ms:.3f}); "
        f"K3 {k3_ms:.3f} ms (bound {k3_bound:.3f}, plain {k3_plain_ms:.3f}, "
        f"library {k3_lib_ms:.3f})")
    del theta, mom, grad, wire, state, trainer
    torch.cuda.empty_cache()

    # 7. the CLI
    before = ops.launch_counts()
    out = train_main(["--reduced", "--steps", "3", "--fused-apply"])
    after = ops.launch_counts()
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"CLI losses {out['losses']}")
    if any(after[k] - before[k] != 3 for k in after):
        fail(f"CLI launch counts {before} -> {after}")
    log(f"phase 7: CLI ran 3 steps, losses {[round(x, 4) for x in out['losses']]}")

    summary = {
        "card": smi,
        "model": f"{cfg.name} x{cfg.n_layers} layers, bf16, G={G}, seq {SEQ}, "
                 f"per-node batch {BATCH}, d_ring, fused_apply, collect_norms",
        "step_ms": [round(x, 3) for x in step_ms],
        "peak_allocated_bytes": int(peak),
        "losses": losses,
        "breakdown": breakdown,
    }
    log("summary " + json.dumps(summary))
    kernels = [
        {
            "name": "gossip_program_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gossip_update.cu",
            "replaces": "src/repro/kernels/gossip_update.py:254",
            "launches": counts["gossip_program_update"], "max_abs_err": err_k1,
            "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
            "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / F32_OPS_PER_S
            else "operations",
            "library_ms": None,
        },
        {
            "name": "segment_l2_norms", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/l2_norms.cu",
            "replaces": "src/repro/kernels/stats.py:38",
            "launches": counts["segment_l2_norms"], "max_abs_err": err_k3,
            "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
            "bound_by": "bytes" if k3_bytes / HBM_BYTES_PER_S >= k3_ops / F32_OPS_PER_S
            else "operations",
            "library_ms": k3_lib_ms,
        },
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception as exc:  # any phase's error fails the run
        import traceback

        traceback.print_exc()
        fail(f"{type(exc).__name__}: {exc}")
