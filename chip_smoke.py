#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one CUDA card and check them.

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
  7. the CLI, ``main(["--reduced", "--steps", "3", "--fused-apply"])``;
  8. K2 (the one-node fused gossip update of the ranks engine) against its
     plain twin on one full-width row (P = 838,881,280, bfloat16 θ, g and
     (2, P) landing buffer, float32 m): post and pre order, all-ones and
     masked fault rows; then timed beside its twin and its bound;
  9. the ranks engine: G = 4 ranks spawned on this machine (file-store
     rendezvous) run phase 4's configuration for its first 3 steps from
     the same seed-0 weights and batches, with NCCL and a card per rank on
     a machine with ≥ 4 cards, else over gloo through pinned host buffers
     on the one card.  Each rank's per-step losses and norms, and θ and m
     on a seeded sample of 2^20 columns per leaf, are held against phase
     4's row for that node (phase 5's tolerances); each rank zeroes its
     launch counters just before its steps and must launch K2 once per
     step;
 10. K4 (flash attention) against its plain twin on the reference kernel's
     own sweep (``tests/test_kernels.py``: four shapes, causal and not,
     64-blocks; windows 32 and 96), a fully masked case (Sq 256, Sk 128,
     causal, window 32: rows 159.. exactly 0) and two ragged ones (Sq =
     Sk = 96; Sq 200, Sk 328, which tile by neither 64 nor 128), each in
     float32 (the CUDA-core route) and bfloat16 (the tensor-core route), at
     the reference's bars (2e-5 float32, 2e-2 bfloat16); then bfloat16 at
     large magnitudes (q ×8, v ×8, (1, 8, 2, 512, 128) causal) at phase
     12's bar;
 11. serving granite-8b at full width and depth (36 layers, bfloat16,
     seed-0 weights): ``ServeEngine.prefill_fn()`` on 4 prompts of 4096
     tokens (time, peak memory), ``generate`` on 4 prompts of 128 tokens
     with 32 new tokens, twice, with equal tokens (and ms per decode step
     timed apart), then the ``decode_step`` chain over 32 tokens against
     ``forward``'s logits at full width in float32 with depth cut to 2
     (atol 3e-3, rtol 1e-3); no K1-K4 launch may happen here;
 12. K4 at full width on the model's own attention: layer 0's q, k, v after
     RoPE from phase 11's weights and prompts, (B, H, KV, S, D) =
     (4, 32, 8, 4096, 128) bfloat16, causal and with window 1024, held
     against the plain twin and the layer's ``impl="chunked"`` attention
     (atol 2e-2 plus one bfloat16 rounding step of the element; the
     largest difference in bfloat16 ulps of its row's largest element is
     reported), and at
     B = 1, S = 32768 on seeded inputs against the twin.  The launch
     counters are zeroed just before these three calls and read just
     after.  Then K4, the twin and the library yardstick
     ``scaled_dot_product_attention`` (which the port never calls) are
     timed, and K4's float32 route at the prefill shape.

The last three lines of standard output are the card's name and power
limit as nvidia-smi reports them, the per-kernel JSON (K1-K4, each with its
launches on its path, error against its twin, ms, plain ms, bound and
library ms) and the result ``{"ok": true, "device": {...}}``.  TF32 is off
throughout.
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
BF16_TC_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)

G, SEQ, BATCH, LR, STEPS = 4, 512, 2, 1e-2, 4
# phase 9: the ranks engine repeats the main path's first 3 steps; each rank
# returns θ and m on up to SAMPLE seeded columns of every leaf
RANK_STEPS, SAMPLE, RANK_TIMEOUT = STEPS - 1, 1 << 20, 600
# columns per comparison chunk: bounds the float32 temporaries of a check
# over a full (G, P) buffer to a few GiB beside the state
TWIN_CHUNK = 1 << 26
# phases 11-12: serving granite-8b at full width and depth
SERVE_B, SERVE_S = 4, 4096          # prefill batch and prompt length
GEN_PROMPT, GEN_NEW = 128, 32       # generate: prompt length and new tokens
DEC_B, DEC_S, DEC_LAYERS = 2, 32, 2  # decode-vs-forward check, float32
ATTN_WINDOW, LONG_S = 1024, 32768    # K4's window case; prefill_32k's length


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


def against_twin(label, run, twin, p, theta, mom, variants):
    """For each (order, fault name, kwargs) of ``variants``: ``run(kw)``
    launches the kernel on ``theta``/``mom`` (clones of the inputs, updated
    in place); ``twin(a, b, kw)`` gives the plain twin's (θ', m') for
    columns a:b (the last axis), held against the kernel's chunk by chunk
    (2^26 columns): m' within 1e-6 relative, θ' within 2 bfloat16 ulps.
    Returns the max abs error."""
    worst = 0.0
    for order, fname, kw in variants:
        t_out, m_out = theta(), mom()
        run(t_out, m_out, kw)
        err_t_max = err_m_max = 0.0
        for a in range(0, p, TWIN_CHUNK):
            b = min(a + TWIN_CHUNK, p)
            want_t, want_m = twin(a, b, kw)
            err_m = (m_out[..., a:b] - want_m).abs()
            if not bool((err_m <= 1e-6 * want_m.abs()).all()):
                fail(f"{label} {order} {fname}: m' differs from the twin by "
                     f"{float(err_m.max()):.3e} in columns {a}:{b}")
            err_t = (t_out[..., a:b].float() - want_t.float()).abs()
            if not bool((err_t <= 2 * bf16_ulp(want_t)).all()):
                fail(f"{label} {order} {fname}: theta' differs from the twin by more "
                     f"than 2 bf16 ulps in columns {a}:{b} (max abs {float(err_t.max()):.3e})")
            err_t_max = max(err_t_max, float(err_t.max()))
            err_m_max = max(err_m_max, float(err_m.max()))
            del want_t, want_m, err_m, err_t
        del t_out, m_out
        worst = max(worst, err_t_max, err_m_max)
        log(f"{label} {order} {fname}: max|dtheta|={err_t_max:.3e} "
            f"max|dm|={err_m_max:.3e} ok")
    return worst


def k1_against_twin(label, theta0, wire, srcs, w, grad, mom0):
    """K1 over the whole (G, P) buffer against its plain twin on the same
    inputs: post and pre order, all-ones and masked fault rows."""
    import torch
    from repro_torch.kernels.gossip_update import (
        gossip_program_update, gossip_program_update_plain,
    )

    ones = torch.ones_like(w)
    masked = ones.clone()
    masked[1, 0] = 0.0   # node 1 skips its update
    masked[2, 1] = 0.0   # node 2 drops its first edge
    variants = [(order, fname, dict(lr=LR, beta=0.9, fault=fault, mix_order=order))
                for fname, fault in (("all-ones", ones), ("masked", masked))
                for order in ("post", "pre")]
    return against_twin(
        f"K1 {label}",
        lambda t, m, kw: gossip_program_update(t, wire, srcs, w, grad, m, **kw),
        lambda a, b, kw: gossip_program_update_plain(
            theta0[:, a:b], wire[:, a:b], srcs, w, grad[:, a:b], mom0[:, a:b], **kw),
        theta0.shape[1], theta0.clone, mom0.clone, variants,
    )


def k2_inputs(dev, p):
    """One full-width node: θ, g (P,) and the (2, P) landing buffer in
    bfloat16, m (P,) float32, and d_ring's weight row of node 0."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    theta0 = (torch.randn(p, generator=gen, device=dev) * 0.02).bfloat16()
    grad = torch.randn(p, generator=gen, device=dev).bfloat16()
    nbrs = (torch.randn((2, p), generator=gen, device=dev) * 0.02).bfloat16()
    mom0 = torch.randn(p, generator=gen, device=dev)
    w = ring_tables(dev)[1][0].contiguous()
    return theta0, grad, nbrs, mom0, w


def k2_against_twin(theta0, grad, nbrs, mom0, w):
    """K2 on one full-width row against its plain twin: post and pre
    order, the all-ones fault row and a masked one (u = 0, one edge
    down).  Returns the max abs error."""
    import torch
    from repro_torch.kernels.gossip_update import gossip_update, gossip_update_plain

    ones = torch.ones_like(w)
    masked = ones.clone()
    masked[0] = 0.0   # the node skips its update
    masked[1] = 0.0   # and drops its first edge
    variants = [(order, fname, dict(lr=LR, beta=0.9, fault=fault, mix_order=order))
                for fname, fault in (("all-ones", ones), ("masked", masked))
                for order in ("post", "pre")]
    return against_twin(
        "K2 full-width row",
        lambda t, m, kw: gossip_update(t, nbrs, w, grad, m, **kw),
        lambda a, b, kw: gossip_update_plain(
            theta0[a:b], nbrs[:, a:b], w, grad[a:b], mom0[a:b], **kw),
        theta0.shape[0], theta0.clone, mom0.clone, variants,
    )


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
    if "flash_fwd_kernel" in name:
        return "K4 flash_attention"
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


def profile_step(trainer, state, batch):
    """One fused step under torch.profiler: (wall ms, {group: device ms})."""
    return profile_call(lambda: trainer.train_step(state, batch, LR))


def profile_call(fn):
    """``fn()`` once under torch.profiler: (wall ms, {group: device ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
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


def sample_columns(layout, seed=4):
    """Flat column indices of a fixed seeded sample of up to 2^20 columns
    of every leaf."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = [off + np.sort(rng.choice(size, min(SAMPLE, size), replace=False))
           for off, size in zip(layout.offsets[:-1], layout.sizes)]
    return np.concatenate(idx)


def rank_run(comm, sample, steps):
    """Phase 9 on one rank: the main path's trainer, engine ``ranks``, from
    the same seed-0 weights and batches; the launch counters are zeroed
    just before the steps and read just after.  Returns this rank's losses,
    norms, θ and m on the sampled columns, step times, peak allocation and
    launch counts."""
    import numpy as np
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, _ = granite_layout()
    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=True, device=comm.device)
    if trainer.engine != "ranks":
        raise RuntimeError(f"rank {comm.rank} runs the {trainer.engine} engine")
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    batches = [src.stacked(G, t, BATCH) for t in range(steps)]
    torch.cuda.synchronize(comm.device)
    torch.cuda.reset_peak_memory_stats(comm.device)
    ops.reset_launch_counts()
    step_ms, losses, norms = [], [], []
    for t in range(steps):
        t1 = time.perf_counter()
        state, loss, nrm = trainer.train_step(state, batches[t], LR)
        torch.cuda.synchronize(comm.device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss[0]))
        norms.append(nrm[0].cpu().numpy())
    counts = ops.launch_counts()
    idx = torch.as_tensor(sample, device=comm.device)
    theta_s, mom_s = state.theta[0, idx].float().cpu().numpy(), state.mom[0, idx].cpu().numpy()
    # where a rank's step goes: its forward/backward (all ranks at once on
    # the card, as in a step), and one permute of a full-width row
    own = {k: torch.as_tensor(v[comm.rank:comm.rank + 1], device=comm.device)
           for k, v in batches[0].items()}
    grad = torch.empty_like(state.theta)
    t1 = time.perf_counter()
    trainer._grads_into(state.theta, grad, own)
    torch.cuda.synchronize(comm.device)
    fwd_bwd_ms = (time.perf_counter() - t1) * 1e3
    del grad
    landing = torch.empty_like(state.theta[0])
    perm = trainer.topology.program_at().ops[0].perm
    t1 = time.perf_counter()
    comm.permute(state.theta[0], perm, out=landing)
    torch.cuda.synchronize(comm.device)
    permute_ms = (time.perf_counter() - t1) * 1e3
    return {
        "transport": comm.transport, "device": str(comm.device), "step_ms": step_ms,
        "fwd_bwd_ms": fwd_bwd_ms, "permute_ms": permute_ms,
        "losses": np.array(losses), "norms": np.stack(norms),
        "theta": theta_s, "mom": mom_s,
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(comm.device),
        "launches": counts,
    }


def phase_ranks(layout, ref, sample):
    """Spawn G ranks of the ranks engine (NCCL with a card per rank, else
    gloo through pinned host chunks on the one card) and hold each rank's
    per-step losses (rtol 1e-5), norms (rtol 1e-5), θ (2 bfloat16 ulps plus
    2^-20 of the mixed terms Σ_k w_k |θ_k| over the node and its senders)
    and m (1e-6 relative) on the sampled columns against the stacked run's
    row for that node.  Any rank's failure, or a world that outlives
    RANK_TIMEOUT, fails the phase.  Returns the phase's numbers."""
    import numpy as np
    import torch
    from repro_torch.launch.comm import spawn_world

    t0 = time.perf_counter()
    res = spawn_world(rank_run, G, (sample, RANK_STEPS), timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    srcs, w = (a.cpu().numpy() for a in ring_tables(torch.device("cpu")))
    ref_t = ref["theta"]
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref_t), 2.0 ** -126))) - 7)
    worst_ulps = worst_m = worst_loss = worst_norm = 0.0
    for i, r in enumerate(res):
        lrel = np.abs(r["losses"] - ref["losses"][:, i]) / np.abs(ref["losses"][:, i])
        nrel = np.abs(r["norms"] - ref["norms"][:, i]) / np.abs(ref["norms"][:, i])
        if not (lrel <= 1e-5).all() or not (nrel <= 1e-5).all():
            fail(f"rank {i}: losses {r['losses'].tolist()} vs {ref['losses'][:, i].tolist()} "
                 f"(rel {lrel.max():.3e}), norms rel {nrel.max():.3e}")
        terms = w[i, 0] * np.abs(ref_t[i])
        for k in range(srcs.shape[1]):
            terms = terms + w[i, k + 1] * np.abs(ref_t[srcs[i, k]])
        err_t = np.abs(r["theta"] - ref_t[i])
        if not (err_t <= 2 * ulp[i] + 2.0 ** -20 * terms).all():
            fail(f"rank {i}: theta differs from the stacked row by up to "
                 f"{(err_t / ulp[i]).max():.2f} bf16 ulps")
        err_m = np.abs(r["mom"] - ref["mom"][i])
        if not (err_m <= 1e-6 * np.abs(ref["mom"][i])).all():
            fail(f"rank {i}: m differs from the stacked row by {err_m.max():.3e}")
        want = {"gossip_program_update": 0, "gossip_update": RANK_STEPS,
                "segment_l2_norms": RANK_STEPS, "flash_attention": 0}
        if r["launches"] != want:
            fail(f"rank {i}: launch counts {r['launches']}, expected {want}")
        worst_ulps = max(worst_ulps, float((err_t / ulp[i]).max()))
        worst_m = max(worst_m, float(err_m.max()))
        worst_loss = max(worst_loss, float(lrel.max()))
        worst_norm = max(worst_norm, float(nrel.max()))
    out = {
        "ranks": G, "transport": res[0]["transport"],
        "devices": [r["device"] for r in res],
        "cards": torch.cuda.device_count(),
        "step_ms": [r["step_ms"] for r in res],
        "fwd_bwd_ms": [r["fwd_bwd_ms"] for r in res],
        "permute_one_row_ms": [r["permute_ms"] for r in res],
        "peak_allocated_bytes": [int(r["peak_allocated_bytes"]) for r in res],
        "launches": {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]},
        "max_theta_err_bf16_ulps": worst_ulps, "max_mom_abs_err": worst_m,
        "max_loss_rel_err": worst_loss, "max_norm_rel_err": worst_norm,
        "sampled_columns": int(sample.size), "wall_s": wall,
    }
    log(f"phase 9: {G} ranks over {out['transport']} on {out['cards']} card(s) "
        f"({'one card per rank' if out['transport'] == 'nccl' else 'all ranks on one card; the transport is gloo through pinned host buffers, not NVLink'}): "
        f"{RANK_STEPS} steps equal the stacked rows (theta within {worst_ulps:.3f} bf16 ulps, "
        f"m within {worst_m:.3e}, losses {worst_loss:.3e}, norms {worst_norm:.3e} relative); "
        f"K2 launches {out['launches']['gossip_update']}; step ms per rank "
        f"{[[round(x, 1) for x in ms] for ms in out['step_ms']]} (forward/backward "
        f"{[round(x, 1) for x in out['fwd_bwd_ms']]}, one permute of a full row "
        f"{[round(x, 1) for x in out['permute_one_row_ms']]}); peak allocated per rank "
        f"{[round(b / 2**30, 2) for b in out['peak_allocated_bytes']]} GiB; {wall:.1f}s")
    return out


def attention_pairs(sq, sk, *, causal, window):
    """Allowed (q, k) pairs of one head under the mask (positions are the
    row indices): the least work of any tiling, 4·D FLOPs each."""
    import numpy as np

    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.maximum(q - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_bound(b, h, kv, sq, sk, d, elem_bytes, *, causal, window):
    """K4's least time on the card: (ms, "bytes" or "operations", FLOPs,
    bytes).  FLOPs = 4·D·B·H × allowed pairs at the dense bf16 tensor-core
    rate (products of bf16 values are exact in float32); bytes = q, k, v
    read and the output written once each, at the memory rate."""
    flops = 4 * d * b * h * attention_pairs(sq, sk, causal=causal, window=window)
    nbytes = (2 * b * h * sq * d + 2 * b * kv * sk * d) * elem_bytes
    t_ops, t_bytes = flops / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def attention_inputs(dev, b, h, kv, sq, sk, d, dtype, seed):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_k4_sweep(dev):
    """K4 against its twin on the reference kernel's sweep, windows, a fully
    masked and two ragged cases, each in float32 (the CUDA-core route) and
    bfloat16 (the tensor-core route), and on one bfloat16 case at large
    magnitudes.  Returns {case: max abs error}."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    b64 = dict(block_q=64, block_k=64)
    shapes = [(f"sweep {s} causal={c}", s, dict(causal=c, **b64))
              for s in ((1, 2, 1, 128, 128, 64), (2, 4, 2, 128, 256, 64),
                        (1, 8, 8, 256, 256, 32), (1, 6, 2, 128, 128, 128))
              for c in (True, False)]
    shapes += [("dtype", (1, 2, 2, 128, 128, 64), dict(b64))]
    shapes += [(f"window {w}", (1, 2, 2, 256, 256, 64), dict(window=w, **b64)) for w in (32, 96)]
    shapes += [("fully masked rows", (1, 2, 1, 256, 128, 64), dict(causal=True, window=32))]
    shapes += [("ragged 96", (2, 4, 2, 96, 96, 128), dict(causal=True))]
    shapes += [("ragged 200x328", (1, 4, 2, 200, 328, 128),
                dict(causal=True, window=40, block_q=200, block_k=328))]
    cases = [(f"{name} {str(dt)[6:]}", shape, dt, kw)
             for name, shape, kw in shapes for dt in (torch.float32, torch.bfloat16)]
    errs = {}
    for i, (name, shape, dtype, kw) in enumerate(cases):
        q, k, v = attention_inputs(dev, *shape, dtype, seed=100 + i)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, causal=kw.get("causal", True),
                                     window=kw.get("window"))
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        if not bool(torch.isfinite(got).all()) or not err <= tol:
            fail(f"K4 {name}: differs from its twin by {err:.3e} (bar {tol:g})")
        if name.startswith("fully masked rows") and not (
                bool((got[:, :, 159:] == 0).all()) and bool((got[:, :, :159] != 0).any())):
            fail(f"K4 {name}: rows 159.. are not exactly 0")
        errs[name] = err
    # q ×8, v ×8 (outputs reach |x| >= 8): phase 12's bar, 2e-2 plus one
    # bfloat16 rounding step of the element
    q, k, v = attention_inputs(dev, 1, 8, 2, 512, 512, 128, torch.float32, seed=99)
    q, k, v = (8 * q).bfloat16(), k.bfloat16(), (8 * v).bfloat16()
    got = flash_attention(q, k, v, causal=True).float()
    want = flash_attention_plain(q, k, v, causal=True).float()
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or not bool((err <= 2e-2 + bf16_ulp(want)).all()):
        fail(f"K4 large magnitudes bfloat16: differs from its twin by {float(err.max()):.3e}")
    errs["large magnitudes bfloat16"] = float(err.max())
    log(f"phase 10: K4 agrees with its twin on {len(errs)} cases; max abs err "
        f"f32 {max(e for n, e in errs.items() if n.endswith('float32')):.3e}, bf16 "
        f"{max(e for n, e in errs.items() if n.endswith('bfloat16') and 'large' not in n):.3e}"
        f", bf16 at large magnitudes {errs['large magnitudes bfloat16']:.3e}")
    return errs


def phase_serve(dev):
    """Phase 11: granite-8b at 36 layers in bfloat16 served by the port's
    ServeEngine, then decode against forward in float32 at depth 2.
    Returns (params, prompts, numbers) for phase 12."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import transformer as tfm

    cfg = get_config("granite-8b")
    eng = ServeEngine(cfg, dev)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    params = eng.init_params(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.values())
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    gen = torch.Generator(device=dev).manual_seed(11)
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_S), generator=gen, device=dev)
    prefill = eng.prefill_fn()
    prefill_s, peak = [], 0
    for _ in range(2):   # the first call includes cuBLAS's start-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last, state = prefill(params, prompts)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
        k_cache = state.kv[0]
        if tuple(last.shape) != (SERVE_B, cfg.vocab) or not bool(torch.isfinite(last).all()):
            fail(f"prefill: last logits {tuple(last.shape)} not finite or misshaped")
        if tuple(k_cache.shape) != (cfg.n_layers, SERVE_B, SERVE_S, cfg.n_kv, cfg.head_dim):
            fail(f"prefill: cache k {tuple(k_cache.shape)}")
        del last, state, k_cache
    torch.cuda.empty_cache()
    prefill_prof = profile_breakdown(lambda: prefill(params, prompts))
    torch.cuda.empty_cache()
    log(f"phase 11: {cfg.name} x{cfg.n_layers} layers bf16, {n_params:,} params "
        f"({weight_bytes / 1e9:.2f} GB) made in {init_s:.1f}s; prefill "
        f"{SERVE_B}x{SERVE_S}: {[round(x, 3) for x in prefill_s]} s, peak allocated "
        f"{peak / 2**30:.2f} GiB")

    p128 = prompts[:, :GEN_PROMPT].contiguous()
    gen_s, toks = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks.append(eng.generate(params, p128, n_new=GEN_NEW))
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    if not torch.equal(toks[0], toks[1]):
        fail("generate: two greedy runs gave different tokens")
    if tuple(toks[0].shape) != (SERVE_B, GEN_NEW) or not bool(
            ((toks[0] >= 0) & (toks[0] < cfg.vocab)).all()):
        fail(f"generate: tokens {tuple(toks[0].shape)} outside the vocabulary")
    # ms per decode step, timed apart: the prompt replay and the new tokens,
    # one decode_step each for all SERVE_B sequences
    step = eng.decode_fn(None)
    state = tfm.init_decode_state(cfg, SERVE_B, GEN_PROMPT + GEN_NEW, device=dev)
    feed = torch.cat([p128, toks[0]], dim=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(feed.shape[1]):
        _, state = step(params, feed[:, t:t + 1], t, state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / feed.shape[1]
    last_t = feed.shape[1] - 1   # rewrites the last slot with the same token
    step_prof = profile_breakdown(lambda: step(params, feed[:, last_t:], last_t, state))
    del state
    log(f"phase 11: generate {SERVE_B}x{GEN_PROMPT} + {GEN_NEW} new, twice, same tokens: "
        f"{[round(x, 3) for x in gen_s]} s; decode step {step_ms:.2f} ms "
        f"(all {SERVE_B} sequences, one token each); profiled prefill "
        f"{json.dumps(prefill_prof)}; profiled decode step {json.dumps(step_prof)}")

    # decode == forward at full width in float32, depth cut to DEC_LAYERS
    cfg32 = dataclasses.replace(cfg, n_layers=DEC_LAYERS, dtype=torch.float32)
    eng32 = ServeEngine(cfg32, dev)
    params32 = eng32.init_params(seed=0)
    tokens = torch.randint(0, cfg.vocab, (DEC_B, DEC_S), generator=gen, device=dev)
    with torch.no_grad():
        full = tfm.forward(params32, cfg32, tokens)
    step32 = eng32.decode_fn(None)
    state = tfm.init_decode_state(cfg32, DEC_B, DEC_S, device=dev)
    dec = []
    for t in range(DEC_S):
        lg, state = step32(params32, tokens[:, t:t + 1], t, state)
        dec.append(lg)
    dec = torch.stack(dec, dim=1)
    err = (dec - full).abs()
    if not bool((err <= 3e-3 + 1e-3 * full.abs()).all()):
        fail(f"decode chain differs from forward by {float(err.max()):.3e}")
    dec_err = float(err.max())
    del params32, full, dec, state, err
    torch.cuda.empty_cache()
    after = ops.launch_counts()
    if after != before:
        fail(f"serving launched kernels: {before} -> {after}")
    log(f"phase 11: decode chain == forward ({cfg.name} width, {DEC_LAYERS} layers, f32, "
        f"{DEC_B}x{DEC_S}): max abs err {dec_err:.3e}; no kernel launches")
    numbers = {
        "model": f"{cfg.name} x{cfg.n_layers} layers, bf16, seed-0 weights",
        "params": n_params, "weight_bytes": weight_bytes, "init_s": init_s,
        "prefill_batch": SERVE_B, "prefill_len": SERVE_S, "prefill_s": prefill_s,
        "prefill_peak_allocated_bytes": int(peak),
        "generate": f"{SERVE_B} x {GEN_PROMPT} prompt + {GEN_NEW} new, greedy",
        "generate_s": gen_s, "decode_step_ms": step_ms,
        "prefill_profile": prefill_prof, "decode_step_profile": step_prof,
        "decode_vs_forward_max_abs_err": dec_err,
    }
    return cfg, params, prompts, numbers


def profile_breakdown(fn):
    """``fn()`` under torch.profiler: its wall ms, device busy ms by kernel
    group and the idle share (1 - busy / wall) of that profiled call."""
    wall, busy = profile_call(fn)
    total = sum(busy.values())
    return {"wall_ms": wall, "device_busy_ms_by_group": busy, "device_busy_ms": total,
            "idle_share": 1.0 - total / wall if wall else None}


def layer0_qkv(cfg, params, prompts):
    """Layer 0's q, k, v after RoPE for ``prompts``, (B, S, heads, D)."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import apply_rope, rope

    lp = {name[len("blocks."):]: t[0] for name, t in params.items() if name.startswith("blocks.")}
    b, s = prompts.shape
    with torch.no_grad():
        h = params["embed"][prompts.long()]
        q, k, v = tfm._qkv(lp, cfg, tfm._apply_norm(cfg, lp, "ln1", h))
        pos = torch.arange(s, dtype=torch.int32, device=prompts.device)[None].expand(b, s)
        sin, cos = rope(pos, cfg.head_dim, cfg.rope_theta)
        return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v, pos


def phase_k4_model(dev, cfg, params, prompts):
    """Phase 12: K4 on layer 0's attention at (4, 32, 8, 4096, 128), causal
    and windowed, and at B = 1, S = 32768; each held against the twin (and
    the first two against the layer's chunked attention), then timed
    beside the twin and SDPA.  Returns (launches, numbers)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.models.attention import multihead_attention

    q, k, v, pos = layer0_qkv(cfg, params, prompts)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ql, kl, vl = attention_inputs(dev, 1, cfg.n_heads, cfg.n_kv, LONG_S, LONG_S,
                                  cfg.head_dim, torch.bfloat16, seed=12)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = {None: flash_attention(qt, kt, vt, causal=True),
            ATTN_WINDOW: flash_attention(qt, kt, vt, causal=True, window=ATTN_WINDOW)}
    out_long = flash_attention(ql, kl, vl, causal=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches != {"gossip_program_update": 0, "gossip_update": 0, "segment_l2_norms": 0,
                    "flash_attention": 3}:
        fail(f"phase 12 launch counts {launches}, expected 3 of K4")

    numbers = {"shape": [SERVE_B, cfg.n_heads, cfg.n_kv, SERVE_S, cfg.head_dim]}
    for w, got in outs.items():
        case = "causal" if w is None else f"window{w}"
        with torch.no_grad():
            chunk = multihead_attention(q, k, v, q_positions=pos, k_positions=pos, causal=True,
                                        window=w, impl="chunked", chunk_size=cfg.attn_chunk)
        chunk = chunk.transpose(1, 2)
        want = flash_attention_plain(qt, kt, vt, causal=True, window=w)
        for name, ref in (("twin", want), ("chunked", chunk)):
            # bar: 2e-2 plus one rounding step of the bfloat16 output (a step
            # is 0.03125 at |x| >= 4, where the layer's outputs reach; two
            # float32 results a hair apart may round either way); ulps are
            # counted at the scale of the row's largest element
            err = (got.float() - ref.float()).abs()
            ulps = float((err / bf16_ulp(ref.float().abs().amax(-1, keepdim=True))).max())
            if not bool(torch.isfinite(got).all()) or not bool((err <= 2e-2 + bf16_ulp(ref)).all()):
                fail(f"K4 layer 0 {case}: differs from the {name} attention by "
                     f"{float(err.max()):.3e}")
            numbers[f"max_abs_err_vs_{name}_{case}"] = float(err.max())
            numbers[f"max_err_row_bf16_ulps_vs_{name}_{case}"] = ulps
        del chunk, want, err
    # the 32k case against the twin, which works in q-row chunks
    want = flash_attention_plain(ql, kl, vl, causal=True)
    err_long = float((out_long.float() - want.float()).abs().max())
    if not bool(torch.isfinite(out_long).all()) or not err_long <= 2e-2:
        fail(f"K4 at S={LONG_S}: differs from its twin by {err_long:.3e}")
    numbers[f"max_abs_err_vs_twin_s{LONG_S}"] = err_long
    del want, out_long
    torch.cuda.empty_cache()
    log("phase 12: K4 on layer 0 agrees: " + json.dumps(numbers))

    sdpa = lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                                          enable_gqa=True)
    err_sdpa = float((sdpa(qt, kt, vt).float() - outs[None].float()).abs().max())
    eb = qt.element_size()
    shape = (SERVE_B, cfg.n_heads, cfg.n_kv, SERVE_S, SERVE_S, cfg.head_dim)
    bound, bound_by, flops, nbytes = attention_bound(*shape, eb, causal=True, window=None)
    bound_w, _, flops_w, _ = attention_bound(*shape, eb, causal=True, window=ATTN_WINDOW)
    lshape = (1, cfg.n_heads, cfg.n_kv, LONG_S, LONG_S, cfg.head_dim)
    bound_l, bound_by_l, flops_l, _ = attention_bound(*lshape, eb, causal=True, window=None)
    t = {
        "k4_ms": cuda_ms(lambda: flash_attention(qt, kt, vt, causal=True), 5),
        "k4_window_ms": cuda_ms(
            lambda: flash_attention(qt, kt, vt, causal=True, window=ATTN_WINDOW), 5),
        "plain_ms": cuda_ms(lambda: flash_attention_plain(qt, kt, vt, causal=True), 2),
        "sdpa_ms": cuda_ms(lambda: sdpa(qt, kt, vt), 10),
        "k4_s32k_ms": cuda_ms(lambda: flash_attention(ql, kl, vl, causal=True), 3),
        "sdpa_s32k_ms": cuda_ms(lambda: sdpa(ql, kl, vl), 3),
    }
    del ql, kl, vl
    torch.cuda.empty_cache()
    # the float32 route (PR 13's CUDA-core kernel) at the same shape
    qf, kf, vf = qt.float(), kt.float(), vt.float()
    t["k4_f32_ms"] = cuda_ms(lambda: flash_attention(qf, kf, vf, causal=True), 3)
    del qf, kf, vf
    numbers.update(t)
    numbers.update({
        "bound_ms": bound, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
        "f32_cuda_core_floor_ms": 1e3 * flops / F32_OPS_PER_S,
        "bound_window_ms": 1e3 * max(flops_w / BF16_TC_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S),
        "bound_s32k_ms": bound_l, "bound_by_s32k": bound_by_l,
        "f32_cuda_core_floor_s32k_ms": 1e3 * flops_l / F32_OPS_PER_S,
        "sdpa_vs_k4_max_abs": err_sdpa,
    })
    log(f"phase 12: K4 {t['k4_ms']:.3f} ms (window {ATTN_WINDOW}: {t['k4_window_ms']:.3f}; "
        f"bound {bound:.3f}, {bound_by}; plain {t['plain_ms']:.3f}; SDPA {t['sdpa_ms']:.3f}); "
        f"S={LONG_S}: K4 {t['k4_s32k_ms']:.3f} ms, SDPA {t['sdpa_s32k_ms']:.3f}, bound "
        f"{bound_l:.3f}; float32 route at S={SERVE_S}: {t['k4_f32_ms']:.3f} ms")
    del q, k, v, qt, kt, vt, outs
    torch.cuda.empty_cache()
    return launches["flash_attention"], numbers


def main():
    import numpy as np
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
        gossip_program_update, gossip_program_update_plain, gossip_update,
        gossip_update_plain, gossip_wire,
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
    step_ms, losses, norm_hist, snap, peak = [], [], [], None, 0
    for t in range(STEPS):
        if t == STEPS - 1:
            peak = torch.cuda.max_memory_allocated()
            snap = state.clone()   # the state phases 5 and 9 restart from / check
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss, norms = trainer.train_step(state, batches[t], LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.tolist())
        norm_hist.append(norms.cpu().numpy())
        if not bool(torch.isfinite(loss).all()) or not bool(torch.isfinite(norms).all()):
            fail(f"step {t}: non-finite loss {loss.tolist()} or norms")
        if tuple(norms.shape) != (G, len(layout.names)):
            fail(f"norms shape {tuple(norms.shape)}")
        log(f"  step {t}: {step_ms[-1]:.1f} ms  loss {[round(x, 4) for x in loss.tolist()]}")
    counts = ops.launch_counts()
    if counts != {"gossip_program_update": STEPS, "gossip_update": 0,
                  "segment_l2_norms": STEPS, "flash_attention": 0}:
        fail(f"main path launch counts {counts}, expected {STEPS} of K1 and K3")
    log(f"phase 4: launches {counts}; peak allocated {peak / 2**30:.2f} GiB over "
        f"{STEPS - 1} steps")

    # what phase 9's ranks must reproduce: the first RANK_STEPS steps
    sample = sample_columns(layout)
    idx = torch.as_tensor(sample, device=dev)
    ref9 = {"losses": np.array(losses[:RANK_STEPS]), "norms": np.stack(norm_hist[:RANK_STEPS]),
            "theta": snap.theta[:, idx].float().cpu().numpy(),
            "mom": snap.mom[:, idx].cpu().numpy()}
    del idx

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
    prof_wall, busy = profile_step(trainer, state, batches[0])
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
    if {k: after[k] - before[k] for k in after} != {
            "gossip_program_update": 3, "gossip_update": 0, "segment_l2_norms": 3,
            "flash_attention": 0}:
        fail(f"CLI launch counts {before} -> {after}")
    log(f"phase 7: CLI ran 3 steps, losses {[round(x, 4) for x in out['losses']]}")
    del out
    torch.cuda.empty_cache()

    # 8. K2 against its twin on one full-width row, then timed
    p_cols = layout.size
    theta0, grad1, nbrs, mom0, w_row = k2_inputs(dev, p_cols)
    err_k2 = k2_against_twin(theta0, grad1, nbrs, mom0, w_row)
    k2 = dict(lr=LR, beta=0.9, fault=torch.ones_like(w_row), mix_order="post")
    theta1, mom1 = theta0.clone(), mom0.clone()
    k2_ms = cuda_ms(lambda: gossip_update(theta1, nbrs, w_row, grad1, mom1, **k2), 10)

    def k2_plain():
        for a in range(0, p_cols, TWIN_CHUNK):
            b = min(a + TWIN_CHUNK, p_cols)
            gossip_update_plain(theta1[a:b], nbrs[:, a:b], w_row, grad1[a:b], mom1[a:b], **k2)

    k2_plain_ms = cuda_ms(k2_plain, 2)
    deg2 = nbrs.shape[0]
    k2_bytes = p_cols * (eb + eb + 4 + deg2 * eb) + p_cols * (eb + 4)  # θ g m nbrs in; θ' m' out
    k2_ops = p_cols * (8 + 2 * deg2)
    k2_bound = 1e3 * max(k2_bytes / HBM_BYTES_PER_S, k2_ops / F32_OPS_PER_S)
    log(f"phase 8: K2 {k2_ms:.3f} ms (bound {k2_bound:.3f}, plain {k2_plain_ms:.3f})")
    del theta0, grad1, nbrs, mom0, theta1, mom1
    torch.cuda.empty_cache()

    # 9. the ranks engine: G ranks on this machine, against phase 4's rows
    ranks9 = phase_ranks(layout, ref9, sample)
    torch.cuda.empty_cache()

    # 10. K4 against its twin on the reference kernel's sweep
    errs10 = phase_k4_sweep(dev)
    torch.cuda.empty_cache()

    # 11. serving granite-8b at full width and depth; 12. K4 on its attention
    t11 = time.perf_counter()
    serve_cfg, serve_params, prompts, serve11 = phase_serve(dev)
    serve11["wall_s"] = time.perf_counter() - t11
    t12 = time.perf_counter()
    k4_launches, attn12 = phase_k4_model(dev, serve_cfg, serve_params, prompts)
    attn12["wall_s"] = time.perf_counter() - t12
    attn12["sweep_max_abs_err"] = errs10
    del serve_params, prompts
    torch.cuda.empty_cache()

    summary = {
        "card": smi,
        "model": f"{cfg.name} x{cfg.n_layers} layers, bf16, G={G}, seq {SEQ}, "
                 f"per-node batch {BATCH}, d_ring, fused_apply, collect_norms",
        "step_ms": [round(x, 3) for x in step_ms],
        "peak_allocated_bytes": int(peak),
        "losses": losses,
        "breakdown": breakdown,
        "ranks": ranks9,
        "serve": serve11,
        "attention": attn12,
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
            "name": "gossip_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gossip_update.cu",
            "replaces": "src/repro/kernels/gossip_update.py:184",
            "launches": ranks9["launches"]["gossip_update"], "max_abs_err": err_k2,
            "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
            "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / F32_OPS_PER_S
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
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:90",
            "launches": k4_launches,
            "max_abs_err": attn12["max_abs_err_vs_twin_causal"],
            "ms": attn12["k4_ms"], "plain_ms": attn12["plain_ms"],
            "bound_ms": attn12["bound_ms"], "bound_by": attn12["bound_by"],
            "library_ms": attn12["sdpa_ms"],
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
