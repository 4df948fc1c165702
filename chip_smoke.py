#!/usr/bin/env python3
"""Drive the port's trainer, simulator, serving and model zoo on one CUDA card; check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, in parallel);
  2. K1 (fused gossip update) against its plain twin on one full-width
     granite-8b leaf (G = 4 × the 58,720,256-element ``w_up``, bfloat16):
     post and pre order, all-ones rows, a masked row and the rows of a
     real realization (a drain boost of 1.5 and a ghost's all-zero row),
     these bit for bit; then K1's one-pass route (no wire: the kernel
     computes the senders' rows) against the plain wire and the
     two-operand K1 on the same variants, bit for bit;
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
     on one leaf, and the one-pass route (the step's) bit for bit the wire
     and the two-operand K1 there; then each kernel timed with CUDA events
     at the main path's shapes, beside its plain twin, its bound and (where
     one exists) a PyTorch library call, K1 by both routes;
  7. the CLI, ``main(["--reduced", "--steps", "3", "--fused-apply"])``;
  8. K2 (the one-node fused gossip update of the ranks engine) against its
     plain twin on one full-width row (P = 838,881,280, bfloat16 θ, g and
     (2, P) landing buffer, float32 m): post and pre order, all-ones,
     masked, boost and ghost fault rows (the last two bit for bit); then
     timed beside its twin and its bound;
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
     tokens (time, peak memory), ``generate`` on 4 prompts of 32 tokens
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
     timed, and K4's float32 route at the prefill shape;
 13. ``DecentralizedSimulator`` (the DBench engine) at phase 4's width and
     configuration with dense mixing, 3 steps from the seed-0 weights and
     batches, one node's gradients at a time: K3 once per step, K1 and K2
     never; each node's losses, norms, and θ and m on phase 9's sampled
     columns held against ``SPMDTrainer`` with ``fused_apply=False`` on the
     same inputs (phase 9's tolerances); ms per step and peak memory;
 14. the trainer at the same width with multi-round gossip: d_one_peer_exp
     with 2 rounds and d_star with 3 hub-balanced rounds, fused apply (K1
     runs the update and round 1 once per step, the interpreter the later
     rounds), 3 steps each, then one step from each run's state against
     ``fused_apply=False`` (phase 5's comparison with its bound carried
     through the later rounds; offset σ = 0.1); closed-loop d_ada (target
     0.7, probe every step, one-peer floor) for 6 steps from replicas
     offset by σ = 0.01, so that gossip shrinks Ξ and the rung moves: each
     probe's Ξ against a leaf-by-leaf float64 recomputation (rtol 1e-5)
     and the rung walk, which must take a transition;
 15. the paper's configurations through the simulator: closed-loop Ada
     on the mini ResNet (``benchmarks/ada.py``: 16 channels, depth 2, 10
     classes, 16 × 16 images, 8 per node, N = 16, k0 12, one-peer floor,
     target 0.7, a probe per 5-step epoch, lr 0.1) and the LSTM variance
     run (``benchmarks/variance.py``: vocab 128, d 64, seq 24, 4 per node,
     d_ring, N = 16, lr 0.5), each 20 steps on the card and on the CPU from
     the same weights and batches (losses, norms, Ξ trace rtol 1e-4, Gini
     series rtol 1e-4 plus 1e-6, identical transitions), then 120 and 50
     steps on the card alone;
 16. bucketed gossip: phase 4's trainer with ``bucket_mb`` 4, 64 and 256
     (K1 launched once per bucket, in place on the bucket's column slice
     of the flat state), 3 steps each, bit for bit phase 4's first 3 steps
     (losses, norms, θ and m on phase 9's sampled columns and on every
     bucket size's tail in full); step ms and peak memory per size; then
     one more step under ``torch.cuda.set_sync_debug_mode("error")`` (the
     inert recorder must not synchronize; phase 6 runs the monolithic step
     under the same check and records what it finds); then K1 launched on
     the run's own state, in place on the column slices of an interior and
     the tail bucket (at 4 MiB also a slice off the 16-byte alignment, the
     scalar path) with the wire built for the slice, against its plain
     twin on the same slices: post and pre order, all-ones and masked
     fault rows, bit for bit, the columns beside the slice untouched.
     Then the bucketed trainer without fused apply (the optimizer and the
     dense program per bucket) at 64 MiB, bit for bit phase 13's
     monolithic ``fused_apply=False`` trainer;
 17. the folded Ξ probe: phase 14's closed-loop d_ada (offset replicas
     included) through the bucketed trainer at 4 MiB, whose buckets do not
     line up with the standalone probe's chunks: one standalone probe
     (step 0), folded ones after, each within rtol 1e-5 of the standalone
     probe, of float64 and of phase 14's Ξ, with phase 14's rung walk and
     transitions; then the simulator with ``bucket_mb=64`` bit for bit
     phase 13's run;
 18. run telemetry: phase 4's trainer for 6 steps with telemetry off, with
     a ``JsonlSink`` (metrics every 5 steps) and with ``record_spans``
     (every record through the schema; ``comm_bytes`` equal to
     ``program_comm_bytes`` summed offline; the streamed variance equal to
     ``variance_report`` of the step's norms), then phase 15's ResNet run
     (20 steps) with a sink on the card and on the CPU: the same stream,
     spans aside (phase 15's bars), its comm counters equal to the offline
     replay of the rung walk.  The streams are written under
     ``build/repro_torch/telemetry``.
     Each run of phases 13-26 zeroes the launch counters just before its
     steps and reads them just after; each of phases 16-26 prints its
     prediction before its measurements.
 19. faults: phase 4's fused trainer for 6 steps under each of four fault
     models (``FAULT_RUNS``: a crash with a degraded program and a rejoin,
     a preemption drain with boost 1.5 and its handoff, a spare pool with
     a ghost rank over link failures, stragglers), from the seed-0
     replicas, each node pushed apart by its own noise (σ = 0.01) before
     every step so that every mix shows; K1 once per step on the realized fault
     rows, and each step held against the trainer without fused apply run
     in lockstep from the same state (the masked interpreter; phase 5's
     tolerances); the crash model's fault-free step 0 bit for bit phase
     4's step 0;
 20. the same runs at ``bucket_mb`` 64: K1 once per bucket, the fault rows
     built once a step, the final state bit for bit phase 19's;
 21. the simulator under the same models (stacked mixing, one node's
     gradients at a time) bit for bit the trainer without fused apply;
 22. 4 ranks (as phase 9) under a crash at step 1 with a rejoin at step 2,
     3 steps: each rank bit for bit its stacked row, K2 once per step on
     every rank;
 23. checkpoint and resume, stacked: phase 4's trainer on phase 14's
     closed-loop d_ada from offset replicas, 4 steps with a checkpoint
     after step 2 (``save_checkpoint``, keep=1, under ``build/``, removed
     after; the disk's free space checked first), then a fresh trainer
     restores it in place and runs steps 2-3: losses, norms, θ, m and the
     extra payload (controller, telemetry) bit for bit the uninterrupted
     run's; the file's size, save and load seconds and GB/s, the device
     peak above the live state during each;
 24. the same for 4 ranks (as phase 9): 2 steps, a checkpoint after
     step 1 (every leaf gathered to rank 0's host memory, column chunk by
     column chunk), a fresh trainer per rank restores it (rank 0 reads,
     each rank receives its row) and runs step 1, bit for bit its
     uninterrupted row; the file has phase 23's members and, on phase 9's
     sampled columns, θ and m of phase 4's state after step 0 bit for bit;
 25. the simulator: phase 15's ResNet closed loop, 120 steps, checkpointed
     after step 60 and resumed in a fresh simulator (cuDNN deterministic):
     losses, norms, θ, m and the controller's log bit for bit;
 26. the trainer's knobs: phase 4's trainer for 3 steps with accum_steps 1
     and 2 (within the bar of ``accum_bar``) and with remat on (bit for bit
     remat off), ms a step and peak memory each; then ``python -m
     repro_torch.examples.quickstart`` (its loss must fall) and
     ``dbench_whitebox --steps 5`` on the card (quickstart at 10 steps),
     each run as ``-m`` runs it, in this process (``run_example``).
 27. the model zoo, MoE: ``SPMDTrainer`` on phi3.5-moe at its published
     width (d_model 4096, 32 heads, 8 KV heads, 16 experts top-2 of d_ff
     6400, vocab 32064), bfloat16, depth cut to 1 layer (1.563e9
     parameters a node), G = 4 when its θ, gradient, wire and m fit in
     75 GiB, d_ring, fused apply, seq 512, per-node batch 2, 3 steps
     (K1 and K3 once a step, the counters zeroed just before and read just
     after); K1 against its twin on a misaligned strided column slice of
     the run's own state (post and pre order, all-ones and masked rows;
     the whole-state launch is phase 6's) and K3 over the whole state;
     both timed beside their twins and bounds;
     serving 2 prompts of 512 tokens (prefill twice) and 16 decode tokens;
     the assignments dropped at capacity factor 1.25; the decode chain
     against ``forward`` in float32 at the reference test's bar (atol 3e-3,
     rtol 1e-3; capacity factor 16);
 28. the same for rwkv6 (d_model 2048, 32 heads, d_ff 7168, vocab 65536):
     training at 4 layers (0.487e9 a node), serving 8 of the 24 layers
     (prefill 4 × 2048, 32 decode tokens), decode against forward at 2;
 29. the same for zamba2 (d_model 3584, 32 heads, d_ff 14336, state 64,
     vocab 32000) at 7 layers (one group of 5 Mamba2 blocks and the shared
     attention block, one tail block; 0.903e9 a node), bfloat16 with
     float32 ``a_log``/``d_skip``: the mixed-dtype flat state (float32,
     the bfloat16 leaves rounded after every update); K1 and K3 on it
     against their twins (its fused step against the interpreter is phase
     31's rejoin step, on the same pushed-apart replicas); the
     reduced bf16 model's fused step on the card against the CPU's on the
     same gradients (float32 leaves within 1e-6, bfloat16 within one
     ulp); serving prefill 2 × 2048 and 32 decode tokens;
 30. internvl2 (d_model 2048, 16 heads, 8 KV heads, d_ff 8192, vocab
     92553) served at its full 24 layers with 1024 patch embeddings
     (prefill 2 × (1024 + 512), 16 decode tokens after them), trained one
     step at 2 layers, G = 4, with patch_embeds in the batch; then the ten
     reduced archs in float32: loss, gradients and one decode step on the
     card against the CPU port within 5e-5 (for ssm and hybrid plus both
     sides' float32 rounding against their float64 runs).
     Each of phases 27-30 prints its prediction first, and its step ms,
     peak GiB, prefill s and decode ms a token with the card's name and
     power limit.
 31. the mixed-dtype state bucketed and under faults: phase 29's zamba2 (7
     layers, bf16 with float32 a_log/d_skip, G = 4, d_ring, fused apply)
     for 2 steps from pushed-apart replicas monolithic and at bucket_mb 64,
     bit for bit the monolithic run (θ, m, losses, norms; the
     monolithic θ and m wait in host memory), K1 once per bucket, every
     narrow leaf a bfloat16 value after each step; then a crash-and-rejoin
     step (node 2 back at step 2) on the same replicas: the handoff timed
     and its narrow rows rounded, the fused step within phase 19's bound
     of the masked interpreter;
 32. the simulator on the mixed model: zamba2 at published width, 7
     layers (what the simulator holds on one card beside the trainer's
     depth), bf16, stacked mixing, one node's gradients at a time, 3 steps
     bit for bit ``SPMDTrainer`` without fused apply; then zamba2-reduced
     bf16 on a quadratic loss (the same gradients on both) card == CPU;
 33. the analysis pipeline on the card: ``python -m repro_torch.analysis
     --all`` passes; the card's limits equal the budget's constants and
     every built kernel's registers a thread and static and dynamic shared
     memory a block (``cudaFuncGetAttributes`` through the bindings) are
     printed and within budget; the rebuild guard over phase 4's trainer
     and a closed-loop d_ada run (device tables built up front from
     ``precompile_programs``): 0 nvcc builds and 0 new device tables after
     the first step; ``python -m repro_torch.examples.serve_decode`` (in
     this process, as phase 26's examples).
 34. the dry run on the card's machine: ``launch/dryrun.run_one`` for
     granite-8b, phi3.5-moe and kimi-k2 at full width over the four
     ``SHAPES`` on the ``single`` mesh (16 data × 16 model), granite-8b's
     and phi3.5-moe's training also on ``multi`` (2 × 16 × 16), and the
     five archs of ``tests/spmd_dryrun_script.py`` at its mini shapes, all
     on ``meta``: the card's allocated and peak bytes must not move,
     ``is_suspect`` may flag only MoE decodes whose experts compute at the
     capacity floor; a training record is rank (0, 0, 0)'s step, so its
     ``argument_bytes``/``temp_bytes`` are a card's (kimi-k2 on ``single``
     the G = 1 placement: FSDP over 16 data ranks × EP over 16 model
     ranks); the dry-run and roofline tables and each training record's
     bytes a card are printed;
 35. phase 4's configuration against its roofline: the trainer's init
     measured for its device bytes, the median of 5 warm steps timed with
     no accounting, one step under ``launch/hlo_analysis.analyze_step`` on
     the card and ``lower_step`` on meta: dot FLOPs equal, traffic within
     0.1 %, K1's and K3's billed bytes at the memory rate phase 6's bounds
     (K1's of its one-pass route, the step's), ``argument_bytes`` within
     2 MiB of the init's bytes; the measured step,
     the compute, memory and wire terms, the dominant term, the useful FLOP
     ratio, the share bound / measured, and ``temp_bytes`` beside the
     step's measured peak above the state, with the card's name and limit;
 36. ``shard_nodes``, the simulator's node split into row blocks: 4
     blocks on the one card (the reference's rule over the real cards
     where there are two or more) against the unsplit run.  Phase 15's
     mini-ResNet closed-loop Ada (N 16) for 3 steps with dense mixing
     (within 1e-6 relative, bit for bit where the card gives it), with
     shift mixing one node's gradients at a time (bit for bit: θ, m,
     losses, norms, Ξ trace) and under vmap (within 1e-6); phase 13's
     granite-8b (G 4, 2 layers, bf16, shift mixing, one node's gradients
     at a time) for 2 steps, θ exactly and by the SHA-1 of its sampled
     columns, m on them, losses and norms exactly; K3 once per block a
     step; both runs' step times and peak allocation per card (every card
     of the split synchronized around a timed step).  Then the ops that
     reduce over every node on a 16-node leaf of 2·SPLIT_CHUNK + 99
     columns, by column chunks gathered to the first card: AllReduce and
     the centralized mean bit for bit the unsplit ops, GatherRow and a
     masked program that is not all-PPermute (matrix products) within
     1e-6 relative.
 37. tensor parallelism at full width: phase 4's granite-8b (2 layers) on
     a (2 data × 2 model) world of 4 ranks (NCCL with a card per rank,
     else gloo through pinned host buffers on the one card), d_ring, fused
     apply, norms, seq 512, per-node batch 2, seed-0 weights: rank (i, j)
     holds shard j of node i.  First in float32 for 3 steps against the
     stacked engine at G = 2 on the same weights and batches (losses, θ
     and m on phase 9's sampled columns within 5e-5, norms within rtol
     1e-5), the replicated leaves bit for bit across each node's model
     ranks, K2 and K3 once a step on every rank; then bfloat16 for 3 steps,
     timed (rank step ms, the model group's all-reduces a step, one
     activation all-reduce's ms, peak a rank); K2 on one rank's shard row
     against its twin;
 38. expert parallelism at phi3.5-moe's width, in phase 37's world: one
     MoE layer (d_model 4096, 16 experts of d_ff 6400, top-2, 1024
     tokens) on each node's 2 model ranks (8 experts each), forward and
     backward in float32, against ``apply_moe`` on one rank (output atol
     1e-5, aux 1e-6, the reference's manual-EP bars; every expert a
     nonzero gradient) (phi3.5-moe ×1 trains on this world in phase 42);
 39. ``repro_torch.examples.train_100m`` at its 100m preset (float32) on
     (4 data × 2 model) ranks (K2 fused apply): 4 steps uninterrupted and
     2 steps that end in a checkpoint, then, in the same world, a fresh
     run of the example resumed from step 2 to 4, every rank's shard row
     bit for bit the uninterrupted run's; step ms and the Gini line
     printed.
 40. the ssm and hybrid families on the tensor-parallel ranks engine, in
     phase 37's world: rwkv6-1.6b ×2 and zamba2-7b ×7 (its mixed state in
     bf16) at published width, phase 4's d_ring, fused apply and norms,
     seq 512, per-node batch 2, seed-0 weights.  Float32 for 3 steps
     against the stacked engine at G = 2 on the same weights and batches:
     the first step's loss and norms, and θ and m on the sampled columns
     after it, within 5e-5 (norms rtol 1e-5) plus twice the stacked
     engine's own float32 rounding of them (its run with a float64 forward
     and backward); after 3 steps, where free-running float32 runs of
     these families part (their group norms), the distance is printed
     beside the stacked engine's own float32-float64 spread; the
     replicated leaves bit for bit across each node's model ranks (zamba2's
     float32 a_log and d_skip included) after every run; K2 and K3 once a
     step a rank; then bfloat16 for 2 steps,
     timed (rank step ms, the model group's all-reduces a step, one
     activation all-reduce's ms, peak a rank);
 41. serving on the mesh, in the same world: granite-8b ×2, rwkv6-1.6b ×2
     and zamba2-7b ×7 in float32 through ``ServeEngine(cfg, mesh=...)`` on
     (2 data × 2 model), prompts 4 × 64 (2 a data rank), 16 new greedy
     tokens: the prefill's logits and every decode step's within 5e-5 of
     the largest logit's magnitude of the single-card engine's (rwkv6 and
     zamba2 plus twice the single card's own float32 rounding against its
     float64 chain), the tokens (its chain's and ``generate``'s) equal,
     every rank the same bits, no kernel launch; then granite-8b ×36 in
     bf16 on (1 × 2) (the first model group): prefill 2 × 512 timed
     twice, 32 decode tokens from its state, ms a token, peak a rank;
 42. kimi-k2's G = 1 placement, in the same world: phi3.5-moe's published
     widths at 1 layer (1,562,980,352 parameters a node) named
     kimi-k2-1t-a32b, so that ``gossip_axes_for`` gives () and the (2 data
     × 2 model) world is one gossip node; ``moe_shard_ff`` on: every leaf
     FSDP-sharded over "data" and gathered at use (one layer at a time),
     its gradient reduce-scattered back, the experts over "model", the
     global batch 4 × 512 split over the data ranks and each MoE layer
     routing the tokens of the whole batch.  The first float32 step against
     the stacked engine at G = 1 on the whole batch on one card: loss, θ
     and m on the sampled columns within 5e-5, norms rtol 1e-5, the
     dropped assignments equal, leaves whole on a group (the model axis,
     the data axis) bit for bit across its ranks; K3 once a step a rank,
     no K1 or K2 (no gossip at G = 1); then bfloat16 for 2 steps, timed
     (rank step ms, the data group's all-gather and reduce-scatter bytes
     and ms a step, peak a rank);
 43. faults on a model axis, in the same world: granite-8b ×1 at
     published width on (2 × 2) ranks, G = 2, d_ring, fused (K2 on shard
     rows with the node's fault row), a crash of node 1 at step 1 that
     rejoins at step 2 (each of its model ranks rebuilding its own shard
     row from its neighbour's), float32 for 3 steps within 5e-5 of the
     stacked engine (K1 with fault rows) under the same model, norms rtol
     1e-5, replicated leaves bit for bit; the fault step and the rejoin
     step timed on the ranks;
 44. K5, Zamba2's grouped SSD scan (``kernels/ssd_scan.py``), at the
     zamba2-7b-g4-b4x1024 cell's scan (B 4, L 1,024, H 112, P 64, G 2,
     N 64) with a non-zero h0: y, the final state and the gradients of x,
     dt, B, C, a and h0 against the eager ``_ssd_groups`` in float64 within
     the float32 bars of ``tests/test_torch_ssd_kernel.py``; the launches
     alone timed beside ``ssd_scan.scan_cost``'s bounds, forward +
     backward through autograd beside the eager float32 scan; then one
     training step of the cell's published block (its configuration file,
     6 layers) on 2 nodes, which must launch the pair and count
     ``ssd_kernel`` once a mixer and node (12).

``python3 chip_smoke.py --phases 34,37,38,39,40,41,42,43,44`` builds the
kernels and runs only the chosen ones of those (40 and 41 together; no
kernels line, no result line).

The last three lines of standard output are the card's name and power
limit as nvidia-smi reports them, the per-kernel JSON (K1-K5, each with its
launches on its paths, in all and by phase, error against its twin, ms,
plain ms, bound and library ms; K5's error relative, against float64) and the result ``{"ok": true, "device": {...}}``.  TF32 is off
throughout.
"""
import contextlib
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
GEN_PROMPT, GEN_NEW = 32, 32        # generate: prompt length and new tokens
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


# fault rows of a real realization, held bit for bit against the twins:
# node 1 draining (alive 1.5: its edges, and its neighbours' edges to it,
# boosted) and node 3 a ghost (alive 0, update 0: an all-zero row)
EXACT_ROWS = ("boost+ghost",)


def boost_ghost_rows(dev):
    """d_ring's (G, 3) kernel fault rows for alive (1, 1.5, 1, 0) and
    update (1, 1, 1, 0), as ``fault_rows`` builds them in a step."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.kernels.gossip_update import fault_rows

    masks = {"alive": torch.tensor([1.0, 1.5, 1.0, 0.0], device=dev),
             "update": torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev), "link": None}
    return fault_rows(make_topology("d_ring", G).program_at(), masks, dev)


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
    (2^26 columns): m' within 1e-6 relative, θ' within 2 ulps of its
    dtype (bfloat16, or float32 for a mixed model's state), and bit for
    bit for the fault rows of a real realization (names in EXACT_ROWS).
    Returns the max abs error."""
    import torch

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
            ulp_of = f32_ulp if want_t.dtype == torch.float32 else bf16_ulp
            if not bool((err_t <= 2 * ulp_of(want_t)).all()):
                fail(f"{label} {order} {fname}: theta' differs from the twin by more "
                     f"than 2 {want_t.dtype} ulps in columns {a}:{b} (max abs "
                     f"{float(err_t.max()):.3e})")
            err_t_max = max(err_t_max, float(err_t.max()))
            err_m_max = max(err_m_max, float(err_m.max()))
            if fname in EXACT_ROWS and max(err_t_max, err_m_max) != 0.0:
                fail(f"{label} {order} {fname}: not bit for bit the twin in columns {a}:{b} "
                     f"(theta {err_t_max:.3e}, m {err_m_max:.3e})")
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
    rows = boost_ghost_rows(w.device)
    variants = [(order, fname, dict(lr=LR, beta=0.9, fault=fault, mix_order=order))
                for fname, fault in (("all-ones", ones), ("masked", masked),
                                     ("boost+ghost", rows))
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
    rows = boost_ghost_rows(w.device)
    variants = [(order, fname, dict(lr=LR, beta=0.9, fault=fault, mix_order=order))
                for fname, fault in (("all-ones", ones), ("masked", masked),
                                     ("boost+ghost", rows[1].contiguous()),
                                     ("boost+ghost", rows[3].contiguous()))
                for order in ("post", "pre")]
    return against_twin(
        "K2 full-width row",
        lambda t, m, kw: gossip_update(t, nbrs, w, grad, m, **kw),
        lambda a, b, kw: gossip_update_plain(
            theta0[a:b], nbrs[:, a:b], w, grad[a:b], mom0[a:b], **kw),
        theta0.shape[0], theta0.clone, mom0.clone, variants,
    )


def k1_one_pass_against_wire(label, theta0, grad, mom0, srcs, w):
    """K1's one-pass route (no wire operand) against the plain wire
    followed by the two-operand K1 on the same inputs, bit for bit: post
    and pre order, all-ones (the wire as the fault-free step built it),
    masked and boost+ghost fault rows."""
    import torch
    from repro_torch.kernels.gossip_update import gossip_program_update, gossip_wire

    ones = torch.ones_like(w)
    masked = ones.clone()
    masked[1, 0] = 0.0   # node 1 skips its update
    masked[2, 1] = 0.0   # node 2 drops its first edge
    for fname, fault in (("all-ones", ones), ("masked", masked),
                         ("boost+ghost", boost_ghost_rows(w.device))):
        for order in ("post", "pre"):
            kw = dict(lr=LR, beta=0.9, fault=fault, mix_order=order)
            wire = gossip_wire(theta0, grad, mom0, lr=LR, beta=0.9, mix_order=order,
                               update=None if fname == "all-ones" else fault[:, :1])
            want_t, want_m = theta0.clone(), mom0.clone()
            gossip_program_update(want_t, wire, srcs, w, grad, want_m, **kw)
            del wire
            got_t, got_m = theta0.clone(), mom0.clone()
            gossip_program_update(got_t, None, srcs, w, grad, got_m, **kw)
            if not (torch.equal(got_t, want_t) and torch.equal(got_m, want_m)):
                fail(f"K1 one pass {label} {order} {fname}: not bit for bit the wire + K1")
            del want_t, want_m, got_t, got_m
            log(f"K1 one pass {label} {order} {fname}: bit for bit the wire + K1 ok")


def phase_k1_twin(dev):
    """K1 against its twin on G × one w_up leaf, then its one-pass route
    against the wire and the two-operand route; returns the max abs error."""
    import torch

    p = 4096 * 14336
    srcs, w = ring_tables(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    theta0 = (torch.randn((G, p), generator=gen, device=dev) * 0.02).bfloat16()
    grad = torch.randn((G, p), generator=gen, device=dev).bfloat16()
    wire = (torch.randn((G, p), generator=gen, device=dev) * 0.02).bfloat16()
    mom0 = torch.randn((G, p), generator=gen, device=dev)
    err = k1_against_twin("w_up leaf", theta0, wire, srcs, w, grad, mom0)
    del wire
    k1_one_pass_against_wire("w_up leaf", theta0, grad, mom0, srcs, w)
    return err


def program_stages(trainer, step):
    """The mixing rounds of ``trainer``'s program at ``step``, in order."""
    from repro_torch.core.schedule import FusedProgram

    prog = trainer._program_at(step // trainer.mix_every, 0)
    return prog.stages if isinstance(prog, FusedProgram) else (prog,)


def offset_nodes(theta, noise, seed=3):
    """Offset every node's row of the flat (G, P) ``theta`` in place by its
    own seeded Gaussian noise of σ = ``noise``, chunk by chunk."""
    import torch

    gen = torch.Generator(device=theta.device).manual_seed(seed)
    g, p = theta.shape
    for a in range(0, p, TWIN_CHUNK):
        b = min(a + TWIN_CHUNK, p)
        offset = torch.randn((g, b - a), generator=gen, device=theta.device)
        theta[:, a:b] += (offset * noise).to(theta.dtype)
        del offset


def phase_fused_vs_interpreter(trainer, plain_trainer, start, batch, noise=0.01):
    """One step from the same state through K1 (``trainer``) and through the
    optimizer and program interpreter (``plain_trainer``), compared element
    by element.  ``start`` is consumed.

    Every node's θ is first offset by its own noise (σ = ``noise``; 0.01
    is half a weight's scale), so that the mix moves θ by far more than the
    tolerance: a wrong neighbour table or a lost neighbour term fails.
    The comparison is ``check_step_against_interpreter``'s.  Returns (the
    fused state after the step, worst θ' error in bfloat16 ulps and as a
    share of its tolerance, worst m' relative error, share of elements the
    mix moved by more than the tolerance)."""
    import numpy as np
    import torch

    dev = start.theta.device
    rounds = [(st.apply_stacked,
               torch.as_tensor(np.abs(st.matrix()), dtype=torch.float32, device=dev))
              for st in program_stages(trainer, start.step)]
    offset_nodes(start.theta, noise)
    theta0 = start.theta.clone()
    fused = start.clone()
    fused, loss_f, _ = trainer.train_step(fused, batch, LR)
    ref, loss_r, _ = plain_trainer.train_step(start, batch, LR)
    if not torch.allclose(loss_f, loss_r, rtol=1e-5, atol=0):
        fail(f"fused and interpreter losses differ: {loss_f.tolist()} vs {loss_r.tolist()}")
    worst_ulps, worst_tol, worst_m, moved_share = check_step_against_interpreter(
        "fused vs interpreter step", theta0, fused, ref, rounds)
    del theta0, ref
    return fused, worst_ulps, worst_tol, worst_m, moved_share


def f32_ulp(x):
    import torch

    mag = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 23)


def state_chunks(p, dtype, layout=None):
    """(a, b, dtype, ulp) column chunks of a (G, P) state: TWIN_CHUNK
    columns of ``dtype``, or, for a mixed layout, chunks inside each leaf
    with the leaf's own dtype (its bfloat16 or float32 ulp)."""
    import torch

    if layout is None or not layout.mixed:
        for a in range(0, p, TWIN_CHUNK):
            yield a, min(a + TWIN_CHUNK, p), dtype, bf16_ulp
        return
    for off, size, dt in zip(layout.offsets[:-1], layout.sizes, layout.dtypes):
        for a in range(off, off + size, TWIN_CHUNK):
            yield (a, min(a + TWIN_CHUNK, off + size), dt,
                   bf16_ulp if dt == torch.bfloat16 else f32_ulp)


def check_step_against_interpreter(label, theta0, fused, ref, rounds, update=None,
                                   rows=None, layout=None):
    """The fused step (``fused``: K1 on round 1) against the interpreter's
    (``ref``) from the same θ (``theta0``, after any membership handoff),
    element by element; ``rounds`` holds per mixing round (the
    interpreter's mix of a (G, k) block, |W| of the round as a (G, G)
    float32 tensor), under faults the masked mix and |W'| of the degraded
    matrix.  ``update`` ((G, 1) float32, None for all ones) marks the
    nodes that took their local step; ``rows`` the nodes whose first-round
    row is not the identity (default all), over which the mix must move θ.

    After the first round θ' agrees within 2 bfloat16 ulps of the larger of
    |θ*| (the node's own θ − lr·u·m') and |θ'| (the interpreter rounds θ* to
    bfloat16 before mixing, the kernel after: ≤ w0/2 ulp of θ*, plus one
    rounding each), plus 2^-20 of Σ_k |w_k| |θ*_k| over the node and its
    senders (16 float32 roundings of the sums, which matter where the terms
    cancel).  A multi-round program (``mix_rounds``) runs its later rounds
    through the interpreter on both sides, so each round s carries the
    bound on: |W_s| times the bound before it, plus 2 ulps of the round's
    output and 2^-20 of |W_s| |input|; the interpreter's rounds are
    recomputed from θ* and must give its θ' bit for bit.  m' within 1e-6
    relative.  With a mixed ``layout`` (a float32 state whose bfloat16
    leaves the fused step rounds after its float32 kernel, and the
    interpreter updates and mixes in bfloat16) each leaf's columns take
    their own dtype's ulps and θ* is rounded to that dtype; since the
    kernel's wire carries the senders' θ* in float32 (as the reference's
    fused step does) where the interpreter rounds each, the first round's
    bound adds Σ_k |w_k| ulp(θ*_k).  ``theta0``
    and ``fused`` may wait in host memory; each chunk moves to the card.
    Returns (worst θ' error in ulps and as a share of its tolerance, worst
    m' relative error, share of the moving rows' elements the mix moved by
    more than the tolerance, None when no row mixes)."""
    import torch

    p = theta0.shape[1]
    dev = ref.theta.device
    rows = slice(None) if rows is None else rows
    mix = lambda w, x: torch.einsum("ij,jc->ic", w, x)
    worst_ulps = worst_tol = worst_m = 0.0
    moved = counted = 0
    for a, b, dt, ulp_of in state_chunks(p, theta0.dtype, layout):
        tf, tr = fused.theta[:, a:b].to(dev).float(), ref.theta[:, a:b].float()
        mf, mr = fused.mom[:, a:b].to(dev), ref.mom[:, a:b]
        step = LR * mr if update is None else LR * update * mr
        own = theta0[:, a:b].to(dev).float() - step   # every node's own θ*
        # round 1: the kernel's; later rounds carry its bound
        x = rounds[0][0](own.to(dt))
        tol = 2 * ulp_of(torch.maximum(own.abs(), x.float().abs())) + 2.0 ** -20 * mix(
            rounds[0][1], own.abs())
        if layout is not None and layout.mixed:
            # the kernel's wire carries every sender's θ* in float32, the
            # interpreter's each rounded to the leaf's dtype
            tol = tol + mix(rounds[0][1], ulp_of(own))
        for st_mix, w in rounds[1:]:
            y = st_mix(x)
            tol = mix(w, tol) + 2 * ulp_of(y.float()) + 2.0 ** -20 * mix(w, x.float().abs())
            x = y
        if not torch.equal(x.float(), tr):
            fail(f"{label}: the interpreter's rounds recomputed from theta* differ from "
                 f"its step in columns {a}:{b}")
        # ulps at the scale of the node's own θ* and θ'; after several
        # rounds, at the scale of the terms they mixed as well
        scale = torch.maximum(own.abs(), tr.abs())
        if len(rounds) > 1:
            mag = own.abs()
            for _, w in rounds:
                mag = mix(w, mag)
            scale = torch.maximum(scale, mag)
        ulp = ulp_of(scale)
        err = (tf - tr).abs()
        if not bool((err <= tol).all()):
            bad = float((err / tol).max())
            fail(f"{label}: theta' differs by {bad:.2f}x its tolerance in columns {a}:{b}")
        worst_ulps = max(worst_ulps, float((err / ulp).max()))
        worst_tol = max(worst_tol, float((err / tol).max()))
        moved_el = (tr - own).abs() > tol
        moved += int(moved_el[rows].sum())
        counted += moved_el[rows].numel()
        err_m = (mf - mr).abs()
        if not bool((err_m <= 1e-6 * mr.abs()).all()):
            fail(f"{label}: m' differs by {float(err_m.max()):.3e} in columns {a}:{b}")
        worst_m = max(worst_m, float((err_m / mr.abs().clamp_min(1e-30)).max()))
        del tf, tr, mf, mr, own, x, scale, ulp, tol, err, err_m, moved_el
    if counted == 0:   # every row is the identity this step: nothing to move
        return worst_ulps, worst_tol, worst_m, None
    moved_share = moved / counted
    if moved_share < 0.9:
        fail(f"{label}: the mix moved only {moved_share:.3f} of the elements past the "
             "tolerance: the comparison cannot see a wrong mix")
    return worst_ulps, worst_tol, worst_m, moved_share


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

    # remat off, as phases 1-22 ran before the model honoured it; phase 26
    # holds remat on against it
    cfg = dataclasses.replace(get_config("granite-8b"), n_layers=2, remat=False)
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


def compare_rows(label, rows, ref):
    """Hold each node's run (``rows[i]``: per-step ``losses`` and ``norms``,
    θ and m on the sampled columns) against row i of the reference run
    ``ref`` (d_ring, stacked): losses and norms within rtol 1e-5, θ within
    2 bfloat16 ulps plus 2^-20 of the mixed terms Σ_k w_k |θ_k| over the
    node and its senders, m within 1e-6 relative.  Returns the worst θ
    error in ulps, m abs error, loss and norm relative errors."""
    import numpy as np
    from repro_torch.core.dsgd import make_topology

    absw = np.abs(make_topology("d_ring", G).program_at().matrix())
    ref_t = ref["theta"]
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref_t), 2.0 ** -126))) - 7)
    terms = absw @ np.abs(ref_t)
    worst_ulps = worst_m = worst_loss = worst_norm = 0.0
    for i, r in enumerate(rows):
        lrel = np.abs(r["losses"] - ref["losses"][:, i]) / np.abs(ref["losses"][:, i])
        nrel = np.abs(r["norms"] - ref["norms"][:, i]) / np.abs(ref["norms"][:, i])
        if not (lrel <= 1e-5).all() or not (nrel <= 1e-5).all():
            fail(f"{label} {i}: losses {r['losses'].tolist()} vs {ref['losses'][:, i].tolist()} "
                 f"(rel {lrel.max():.3e}), norms rel {nrel.max():.3e}")
        err_t = np.abs(r["theta"] - ref_t[i])
        if not (err_t <= 2 * ulp[i] + 2.0 ** -20 * terms[i]).all():
            fail(f"{label} {i}: theta differs from the reference row by up to "
                 f"{(err_t / ulp[i]).max():.2f} bf16 ulps")
        err_m = np.abs(r["mom"] - ref["mom"][i])
        if not (err_m <= 1e-6 * np.abs(ref["mom"][i])).all():
            fail(f"{label} {i}: m differs from the reference row by {err_m.max():.3e}")
        worst_ulps = max(worst_ulps, float((err_t / ulp[i]).max()))
        worst_m = max(worst_m, float(err_m.max()))
        worst_loss = max(worst_loss, float(lrel.max()))
        worst_norm = max(worst_norm, float(nrel.max()))
    return worst_ulps, worst_m, worst_loss, worst_norm


def phase_ranks(layout, ref, sample, done):
    """Phase 9's check: ``done``, the results and seconds of G ranks of the
    ranks engine (``rank_world``: NCCL with a card per rank, else gloo
    through pinned host chunks on the one card).  Holds each rank's
    per-step losses (rtol 1e-5), norms (rtol 1e-5), θ (2 bfloat16 ulps plus
    2^-20 of the mixed terms Σ_k w_k |θ_k| over the node and its senders)
    and m (1e-6 relative) on the sampled columns against the stacked run's
    row for that node.  Any rank's failure, or a world that outlives
    RANK_TIMEOUT, fails the phase.  Returns the phase's numbers."""
    import numpy as np
    import torch

    res, wall = done
    want = {"gossip_program_update": 0, "gossip_update": RANK_STEPS,
            "segment_l2_norms": RANK_STEPS, "flash_attention": 0}
    for i, r in enumerate(res):
        if r["launches"] != want:
            fail(f"rank {i}: launch counts {r['launches']}, expected {want}")
    worst_ulps, worst_m, worst_loss, worst_norm = compare_rows("rank", res, ref)
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
    row indices): the least work of any tiling (``kernels/cost.py``)."""
    from repro_torch.kernels import cost

    return cost.attention_pairs(sq, sk, causal=causal, window=window)


def attention_bound(b, h, kv, sq, sk, d, elem_bytes, *, causal, window):
    """K4's least time on the card: (ms, "bytes" or "operations", FLOPs,
    bytes).  FLOPs = 4·D·B·H × allowed pairs at the dense bf16 tensor-core
    rate (products of bf16 values are exact in float32); bytes = q, k, v
    read and the output written once each, at the memory rate
    (``kernels/cost.py::k4_cost``)."""
    from repro_torch.kernels import cost

    nbytes, flops = cost.k4_cost(b, h, kv, sq, sk, d, elem_bytes, causal=causal, window=window)
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

    gen_prompts = prompts[:, :GEN_PROMPT].contiguous()
    gen_s, toks = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks.append(eng.generate(params, gen_prompts, n_new=GEN_NEW))
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
    feed = torch.cat([gen_prompts, toks[0]], dim=1)
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


SIM_STEPS = 3


def sampled_run(state_theta, state_mom, idx, losses, norms):
    """A run's numbers in ``compare_rows``' form: per node, per-step losses
    and norms and θ, m on the sampled columns ``idx``."""
    import numpy as np

    losses, norms = np.stack(losses), np.stack(norms)
    theta = state_theta[:, idx].float().cpu().numpy()
    mom = state_mom[:, idx].cpu().numpy()
    rows = [{"losses": losses[:, i], "norms": norms[:, i], "theta": theta[i], "mom": mom[i]}
            for i in range(theta.shape[0])]
    return rows, {"losses": losses, "norms": norms, "theta": theta, "mom": mom}


def simulator_run(cfg, batches, idx, **kw):
    """SIM_STEPS steps of ``DecentralizedSimulator`` at granite-8b width
    (d_ring, dense mixing, momentum-SGD, DBench norms on K3, one node's
    gradients at a time) from the seed-0 weights; ``kw`` goes to the
    simulator.  The launch counters are zeroed just before the steps and
    read just after.  Returns (rows in ``sampled_run``'s form, step ms,
    peak allocated bytes, launches)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.sgd import sgd

    dev = batches[0]["tokens"].device
    sim = DecentralizedSimulator(lambda p, b: tfm.loss_fn(p, cfg, b), sgd(momentum=0.9),
                                 make_topology("d_ring", G), mixing="dense",
                                 collect_norms=True, node_loop=True, **kw)
    params = tfm.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = sim.init(params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms, losses, norms = [], [], []
    for t in range(SIM_STEPS):
        t1 = time.perf_counter()
        state, loss, nrm = sim.train_step(state, batches[t], LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if not bool(torch.isfinite(loss).all()) or not bool(torch.isfinite(nrm).all()):
            fail(f"simulator step {t}: non-finite loss {loss.tolist()} or norms")
        losses.append(loss.cpu().numpy())
        norms.append(nrm.cpu().numpy())
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rows, _ = sampled_run(state.theta, state.opt["mom"], idx, losses, norms)
    del state, sim
    torch.cuda.empty_cache()
    return rows, step_ms, peak, launches


def phase_simulator(cfg, batches, sample):
    """Phase 13: ``DecentralizedSimulator`` at granite-8b width (the main
    path's configuration: d_ring, dense mixing, momentum-SGD, DBench norms
    on K3), SIM_STEPS steps from the seed-0 weights, held node by node
    against ``SPMDTrainer`` with ``fused_apply=False`` and the dense
    program on the same inputs (``compare_rows``: phase 5's tolerances on
    the sampled columns).  The simulator takes one node's gradients at a
    time (``node_loop``), as the trainer does.  The launch counters are
    zeroed just before the simulator's steps and read just after: K3 once
    per step, K1 and K2 never.  Returns (launches, numbers, the
    simulator's rows for phase 17, the trainer's numbers with its columns
    from INTERP_MB's tail bucket on for phase 16)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    dev = batches[0]["tokens"].device
    idx = torch.as_tensor(sample, device=dev)
    rows, step_ms, peak, launches = simulator_run(cfg, batches, idx)
    if launches != {"gossip_program_update": 0, "gossip_update": 0,
                    "segment_l2_norms": SIM_STEPS, "flash_attention": 0}:
        fail(f"simulator launch counts {launches}, expected {SIM_STEPS} of K3 only")
    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          collect_norms=True, mixing="dense", fused_apply=False)
    tstate = trainer.init_state(seed=0)
    losses, norms = [], []
    for t in range(SIM_STEPS):
        tstate, loss, nrm = trainer.train_step(tstate, batches[t], LR)
        losses.append(loss.cpu().numpy())
        norms.append(nrm.cpu().numpy())
    _, ref = sampled_run(tstate.theta, tstate.mom, idx, losses, norms)
    tail0 = tail_start(trainer.layout, INTERP_MB)
    ref_interp = dict(ref, tail_start=tail0, theta_tail=tstate.theta[:, tail0:].clone(),
                      mom_tail=tstate.mom[:, tail0:].clone())
    del tstate, trainer
    torch.cuda.empty_cache()
    ulps, err_m, err_l, err_n = compare_rows("simulator node", rows, ref)
    numbers = {
        "config": f"{cfg.name} x{cfg.n_layers} layers, bf16, G={G}, d_ring, dense mixing, "
                  f"sgd(0.9), lr {LR}, seq {SEQ}, per-node batch {BATCH}, node_loop",
        "step_ms": step_ms, "peak_allocated_bytes": int(peak),
        "losses": [r["losses"].tolist() for r in rows],
        "max_theta_err_bf16_ulps": ulps, "max_mom_abs_err": err_m,
        "max_loss_rel_err": err_l, "max_norm_rel_err": err_n, "launches": launches,
    }
    log(f"phase 13: simulator {SIM_STEPS} steps at granite width == the trainer (theta "
        f"within {ulps:.3f} bf16 ulps, m {err_m:.3e}, losses {err_l:.3e}, norms {err_n:.3e} "
        f"relative); step ms {[round(x, 1) for x in step_ms]}; peak allocated "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    return launches, numbers, rows, ref_interp


ROUND_STEPS, ROUND_NOISE, ADA_STEPS, ADA_TARGET = 3, 0.1, 6, 0.7
# the closed loop's nodes start apart by this much (σ, half a weight's
# scale), so that gossip shrinks Ξ and the rung moves within ADA_STEPS
ADA_NOISE = 0.01


def xi_float64(theta, layout):
    """Ξ of a flat (G, P) state recomputed leaf by leaf in float64."""
    import torch

    total = torch.zeros(theta.shape[0], dtype=torch.float64, device=theta.device)
    for a0, b0 in zip(layout.offsets[:-1], layout.offsets[1:]):
        for a in range(a0, b0, TWIN_CHUNK // 4):
            x = theta[:, a:min(a + TWIN_CHUNK // 4, b0)].double()
            total += (x - x.mean(dim=0, keepdim=True)).square().sum(dim=1)
            del x
    return float(total.mean().sqrt())


def ada_before(xi64, layout):
    """The closed loop's hook before step t: at t = 0 every node's θ is
    offset by its own noise (ADA_NOISE); then Ξ of the state in float64
    goes to ``xi64[t]``."""
    def before(t, state):
        if t == 0:
            offset_nodes(state.theta, ADA_NOISE)
        xi64[t] = xi_float64(state.theta, layout)
    return before


def phase_rounds(cfg, layout, batches):
    """Phase 14: the trainer at granite-8b width (fused apply, DBench norms
    on) with multi-round gossip — d_one_peer_exp with 2 rounds per step and
    d_star with 3 hub-balanced rounds — ROUND_STEPS steps each from the
    seed-0 weights, K1 running the update and round 1 once per step and
    the interpreter the later rounds; then one more step from each run's
    state held against ``fused_apply=False`` (phase 5's comparison, its
    bound carried through the later rounds).  Then closed-loop d_ada
    (target ADA_TARGET, probe every step, one-peer floor) for ADA_STEPS
    steps from replicas offset by ADA_NOISE: each probe's Ξ against a
    float64 recomputation (rtol 1e-5) and the rung walk, which must move.  Each run's launch counters are zeroed just before its
    steps and read just after.  Returns (launches summed, numbers)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    total = {}
    numbers = {}

    def run(trainer, steps, before=None):
        state = trainer.init_state(seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        step_ms, losses = [], []
        for t in range(steps):
            if before is not None:
                before(t, state)
            t1 = time.perf_counter()
            state, loss, nrm = trainer.train_step(state, batches[t], LR)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            if not bool(torch.isfinite(loss).all()) or not bool(torch.isfinite(nrm).all()):
                fail(f"phase 14 step {t}: non-finite loss {loss.tolist()} or norms")
            losses.append(loss.tolist())
        counts = ops.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return state, counts, step_ms, losses, torch.cuda.max_memory_allocated()

    for label, name, kw in (("d_one_peer_exp rounds 2", "d_one_peer_exp", {"mix_rounds": 2}),
                            ("d_star rounds 3 hub-balanced", "d_star",
                             {"mix_rounds": 3, "hub_balance": True})):
        topo = make_topology(name, G)
        trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True,
                              fused_apply=True, **kw)
        state, counts, step_ms, losses, peak = run(trainer, ROUND_STEPS)
        if counts != {"gossip_program_update": ROUND_STEPS, "gossip_update": 0,
                      "segment_l2_norms": ROUND_STEPS, "flash_attention": 0}:
            fail(f"phase 14 {label}: launch counts {counts}, expected {ROUND_STEPS} of K1 and K3")
        stages = [st.name for st in program_stages(trainer, state.step)]
        plain = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True,
                            fused_apply=False, **kw)
        # a larger offset than phase 5's: the bound grows by ~2 ulps a round,
        # and a hub-balanced leaf moves by only w = 1/4 of its difference
        after, ulps, tol_share, rel_m, moved = phase_fused_vs_interpreter(
            trainer, plain, state, batches[ROUND_STEPS], noise=ROUND_NOISE)
        del after, state, trainer, plain
        torch.cuda.empty_cache()
        numbers[label] = {"stages": stages, "step_ms": step_ms, "losses": losses,
                          "peak_allocated_bytes": int(peak), "launches": counts,
                          "fused_vs_interpreter": {"theta_bf16_ulps": ulps,
                                                   "share_of_tolerance": tol_share,
                                                   "mom_rel_err": rel_m,
                                                   "moved_share": moved}}
        log(f"phase 14: {label} (stages {stages}): step ms {[round(x, 1) for x in step_ms]}, "
            f"peak {peak / 2**30:.2f} GiB, launches {counts}; the fused step == the "
            f"interpreter's (theta within {ulps:.3f} bf16 ulps, {tol_share:.3f} of its "
            f"tolerance; m {rel_m:.3e} relative; mix moved {moved:.4f})")

    topo = make_topology("d_ada", G, k_floor="one_peer", consensus_target=ADA_TARGET,
                         consensus_probe_every=1)
    trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True, fused_apply=True)
    xi64 = {}
    state, counts, step_ms, losses, peak = run(trainer, ADA_STEPS, before=ada_before(xi64, layout))
    del state, trainer
    torch.cuda.empty_cache()
    ctl = topo.controller
    if [s for s, _, _ in ctl.trace] != list(range(ADA_STEPS)):
        fail(f"phase 14 closed loop: probes at {[s for s, _, _ in ctl.trace]}")
    if not ctl.transitions:
        fail(f"phase 14 closed loop: no transition in {ADA_STEPS} steps (trace {ctl.trace})")
    worst = 0.0
    for s, xi, _ in ctl.trace:
        err = abs(xi - xi64[s])
        if not err <= 1e-5 * abs(xi64[s]):
            fail(f"phase 14 closed loop: Xi at step {s} is {xi!r}, float64 {xi64[s]!r}")
        worst = max(worst, err / abs(xi64[s]) if xi64[s] else 0.0)
    if counts["gossip_program_update"] != ADA_STEPS or counts["segment_l2_norms"] != ADA_STEPS:
        fail(f"phase 14 closed loop: launch counts {counts}")
    walk = " -> ".join(str(ctl.ladder[r]) for _, r in [(0, 0)] + ctl.transitions)
    numbers["d_ada closed loop"] = {
        "target": ADA_TARGET, "noise": ADA_NOISE, "ladder": [str(r) for r in ctl.ladder],
        "trace": [[s, xi, r] for s, xi, r in ctl.trace], "xi_float64": xi64,
        "max_xi_rel_err": worst, "transitions": ctl.transitions, "rung_walk": walk,
        "step_ms": step_ms, "losses": losses, "peak_allocated_bytes": int(peak),
        "launches": counts,
    }
    log(f"phase 14: closed-loop d_ada, probes (step, Xi, rung) "
        f"{[(s, round(xi, 6), r) for s, xi, r in ctl.trace]} == float64 within {worst:.3e} "
        f"relative; rung walk {walk}; step ms {[round(x, 1) for x in step_ms]}")
    return total, numbers


PAPER_N, PAPER_CHECK_STEPS = 16, 20
PAPER_RUNS = {
    # benchmarks/ada.py's closed-loop Ada: mini ResNet, k0 12, one-peer
    # floor, target 0.7, a probe per 5-step epoch, lr 0.1
    "resnet closed-loop Ada": dict(steps=120, lr=0.1),
    # benchmarks/variance.py's LSTM run on d_ring, lr 0.5
    "lstm variance d_ring": dict(steps=50, lr=0.5),
}


def paper_inputs(name, steps):
    """Seeded weights (on the CPU) and numpy batches of a phase-15 run."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models.common import init_params
    from repro_torch.models.paper_models import lstm_defs, mini_resnet_defs, synthetic_images

    n = PAPER_N
    if name.startswith("resnet"):
        params = init_params(mini_resnet_defs(channels=16, n_classes=10, depth=2),
                             torch.Generator().manual_seed(0), "cpu")
        batches = []
        for t in range(steps):
            b = synthetic_images(torch.Generator().manual_seed(1000 + t), n_classes=10,
                                 batch=8 * n, size=16)
            batches.append({"images": b["images"].reshape(n, 8, 16, 16, 3).numpy(),
                            "labels": b["labels"].reshape(n, 8).numpy()})
        return params, batches
    params = init_params(lstm_defs(vocab=128, d=64), torch.Generator().manual_seed(1), "cpu")
    src = SyntheticLM(vocab=128, seq_len=24, seed=0)
    return params, [src.stacked(n, t, 4) for t in range(steps)]


def paper_run(name, device, params, batches, telemetry=None):
    """One phase-15 run through ``DecentralizedSimulator`` (dense mixing,
    momentum-SGD 0.9, DBench norms on; gradients under vmap over the 16
    nodes) on ``device``, with the run telemetry ``telemetry`` (phase 18):
    per-step losses, norms and Gini series, the controller's trace and
    transitions, ms per step, the topology and the per-node parameter
    bytes."""
    import numpy as np
    import torch
    from repro_torch.core.dbench import DBenchRecorder
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.models.paper_models import lstm_loss, mini_resnet_loss
    from repro_torch.optim.sgd import sgd

    if name.startswith("resnet"):
        topo = make_topology("d_ada", PAPER_N, k0=12, k_floor="one_peer",
                             consensus_target=0.7, consensus_probe_every=5)
        loss_fn = mini_resnet_loss
    else:
        topo = make_topology("d_ring", PAPER_N)
        loss_fn = lstm_loss
    sim = DecentralizedSimulator(loss_fn, sgd(momentum=0.9), topo, collect_norms=True,
                                 device=device, telemetry=telemetry)
    state = sim.init(params)
    rec = DBenchRecorder(impl=name, n_nodes=PAPER_N)
    cuda = torch.device(device).type == "cuda"
    step_ms = []
    for t, b in enumerate(batches):
        t1 = time.perf_counter()
        state, loss, norms = sim.train_step(state, b, PAPER_RUNS[name]["lr"], epoch=t // 5)
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        rec.record(t, loss.cpu().numpy(), norms.cpu().numpy())
    ctl = topo.controller
    losses = np.stack(rec.losses)
    if not np.isfinite(losses).all():
        fail(f"phase 15 {name} on {device}: non-finite losses")
    return {
        "losses": losses, "norms": np.stack(rec.norms), "gini": rec.metric_series("gini"),
        "trace": None if ctl is None else list(ctl.trace),
        "transitions": None if ctl is None else list(ctl.transitions),
        "ladder": None if ctl is None else [str(r) for r in ctl.ladder],
        "step_ms": step_ms, "final_loss": float(losses[-1].mean()),
        "topology": topo, "param_bytes": state.theta.shape[1] * state.theta.element_size(),
    }


def phase_paper(dev):
    """Phase 15: the paper's configurations through the simulator.  Each
    runs PAPER_CHECK_STEPS steps on the card and on the CPU from the same
    weights and batches: losses and norms within rtol 1e-4, the Gini series
    within rtol 1e-4 plus 1e-6 (its float32 floor: each norm carries ~1e-7
    relative rounding, and the Gini of nearly equal norms is their relative
    spread), the Ξ trace within rtol 1e-4 and identical transitions.  Then
    the full run on the card alone.  The launch counters are zeroed just
    before each card run and read just after: K3 once per step.  Returns
    (launches summed, numbers)."""
    import numpy as np
    from repro_torch.kernels import ops

    total, numbers = {}, {}
    for name, spec in PAPER_RUNS.items():
        params, batches = paper_inputs(name, spec["steps"])
        runs = {}
        for label, device, steps in (("card", dev, PAPER_CHECK_STEPS),
                                     ("cpu", "cpu", PAPER_CHECK_STEPS),
                                     ("card long", dev, spec["steps"])):
            if label != "cpu":
                ops.reset_launch_counts()
            runs[label] = paper_run(name, device, params, batches[:steps])
            if label != "cpu":
                counts = ops.launch_counts()
                if counts != {"gossip_program_update": 0, "gossip_update": 0,
                              "segment_l2_norms": steps, "flash_attention": 0}:
                    fail(f"phase 15 {name} {label}: launch counts {counts}")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
        card, cpu = runs["card"], runs["cpu"]
        errs = {}
        for key, atol in (("losses", 0.0), ("norms", 0.0), ("gini", 1e-6)):
            a, b = card[key], cpu[key]
            if not np.allclose(a, b, rtol=1e-4, atol=atol):
                fail(f"phase 15 {name}: {key} on the card differ from the CPU's by "
                     f"{np.abs(a - b).max():.3e}")
            # the Gini's error is absolute (it is 0 at the first step); the
            # others relative, where the CPU's value is not 0 (a zero bias)
            errs[key] = float(np.abs(a - b).max() if key == "gini" else
                              (np.abs(a - b) / np.where(b == 0, 1.0, np.abs(b))).max())
        if card["transitions"] != cpu["transitions"]:
            fail(f"phase 15 {name}: transitions {card['transitions']} on the card, "
                 f"{cpu['transitions']} on the CPU")
        if card["trace"] is not None:
            xa = np.array([x for _, x, _ in card["trace"]])
            xb = np.array([x for _, x, _ in cpu["trace"]])
            if [(s, r) for s, _, r in card["trace"]] != [(s, r) for s, _, r in cpu["trace"]] \
                    or not np.allclose(xa, xb, rtol=1e-4, atol=0.0):
                fail(f"phase 15 {name}: Xi trace {card['trace']} vs {cpu['trace']}")
            errs["xi"] = float((np.abs(xa - xb) / np.where(xb == 0, 1.0, np.abs(xb))).max())
        long = runs["card long"]
        gini = long["gini"].mean(axis=1)
        numbers[name] = {
            "check_steps": PAPER_CHECK_STEPS, "card_vs_cpu_max_rel_err": errs,
            "steps": spec["steps"], "ladder": long["ladder"], "transitions": long["transitions"],
            "trace": long["trace"], "final_loss": long["final_loss"],
            "first_loss": float(long["losses"][0].mean()),
            "step_ms_median": float(np.median(long["step_ms"][1:])),
            "first_step_ms": long["step_ms"][0],
            "cpu_step_ms_median": float(np.median(cpu["step_ms"][1:])),
            "gini_mean_early": float(gini[:15].mean()), "gini_mean_late": float(gini[-10:].mean()),
        }
        log(f"phase 15: {name}: {PAPER_CHECK_STEPS} steps card == CPU (max err, Gini abs, "
            f"others rel: "
            f"{json.dumps(errs)}); {spec['steps']} steps on the card: loss "
            f"{numbers[name]['first_loss']:.4f} -> {long['final_loss']:.4f}, transitions "
            f"{long['transitions']} on ladder {long['ladder']}, median step "
            f"{numbers[name]['step_ms_median']:.2f} ms (CPU "
            f"{numbers[name]['cpu_step_ms_median']:.2f} ms)")
    return total, numbers


# phases 16-18: buckets and telemetry at phase 4's configuration
BUCKET_MBS, BUCKET_STEPS = (4, 64, 256), RANK_STEPS
# phase 16's run through the interpreter (fused_apply=False) against phase
# 13's monolithic trainer; phase 17's closed loop, whose 2^20-column
# buckets do not line up with the standalone probe's 2^24-column chunks,
# and its simulator
INTERP_MB, FOLD_MB, SIM_BUCKET_MB = 64, 4, 64
# columns checked on each side of a bucket K1 ran on
EDGE = 4096
TEL_STEPS, TEL_EVERY = 6, 5


def tail_start(layout, bucket_mb):
    """First column of the last bucket of ``bucket_mb`` over ``layout``."""
    from repro_torch.core.buckets import BucketLayout

    return BucketLayout(layout.sizes, BucketLayout.elems_for_mb(bucket_mb)).bounds[-2]


def sync_error(trainer, state, batch):
    """One step of ``trainer`` under ``torch.cuda.set_sync_debug_mode("error")``:
    None when it ran with no synchronizing call, else the error's text."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(state, batch, LR)
        err = None
    except RuntimeError as exc:
        err = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return err


def k1_slice_against_twin(label, theta, mom, grad, srcs, w, a, b):
    """K1 launched in place on the column slice a:b of the flat (G, P)
    buffers (row stride P, as the bucketed step hands it a bucket), with
    the wire ``gossip_wire`` builds for the slice as the bucketed step
    does, against the plain twin on the same strided slices: post and pre
    order, all-ones and masked fault rows, bit for bit (θ', m'); the
    EDGE columns on each side of the slice must stay as they were.  The
    slice is restored after each variant.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.gossip_update import (
        gossip_program_update, gossip_program_update_plain, gossip_wire,
    )

    tv, mv, gv = theta[:, a:b], mom[:, a:b], grad[:, a:b]
    t_saved, m_saved = tv.clone(), mv.clone()
    lo, hi = max(a - EDGE, 0), min(b + EDGE, theta.shape[1])
    edges = [(x, c, d, x[:, c:d].clone()) for x in (theta, mom) for c, d in ((lo, a), (b, hi))]
    ones = torch.ones_like(w)
    masked = ones.clone()
    masked[1, 0] = 0.0   # node 1 skips its update
    masked[2, 1] = 0.0   # node 2 drops its first edge
    worst = 0.0
    for fname, fault in (("all-ones", ones), ("masked", masked)):
        for order in ("post", "pre"):
            kw = dict(lr=LR, beta=0.9, fault=fault, mix_order=order)
            wire = gossip_wire(tv, gv, mv, lr=LR, beta=0.9, mix_order=order,
                               update=fault[:, :1])
            want = [(c, min(c + TWIN_CHUNK, b - a)) for c in range(0, b - a, TWIN_CHUNK)]
            want = [(c, d) + gossip_program_update_plain(
                tv[:, c:d], wire[:, c:d], srcs, w, gv[:, c:d], mv[:, c:d], **kw)
                for c, d in want]
            gossip_program_update(tv, wire, srcs, w, gv, mv, **kw)
            for c, d, want_t, want_m in want:
                err = max(float((tv[:, c:d].float() - want_t.float()).abs().max()),
                          float((mv[:, c:d] - want_m).abs().max()))
                if err != 0.0:
                    fail(f"K1 {label} {order} {fname}: the slice {a}:{b} differs from the "
                         f"twin by {err:.3e} in its columns {c}:{d}")
                worst = max(worst, err)
            for x, c, d, saved in edges:
                if not torch.equal(x[:, c:d], saved):
                    fail(f"K1 {label} {order} {fname}: columns {c}:{d} beside the slice "
                         f"{a}:{b} changed")
            tv.copy_(t_saved)
            mv.copy_(m_saved)
            del wire, want
    log(f"K1 {label} (columns {a}:{b} of {theta.shape[1]}, row stride "
        f"{theta.stride(0)}): post and pre, all-ones and masked == the twin bit for bit")
    return worst


def check_equal(label, got, want):
    """Bit-for-bit equality of two dicts of arrays (numpy or tensors)."""
    import numpy as np

    for key in want:
        a, b = got[key], want[key]
        a = a.float().cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        b = b.float().cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            diff = np.abs(a - b).max() if a.shape == b.shape else "shape"
            fail(f"{label}: {key} differs from the monolithic run (max abs {diff})")


def bucketed_run(trainer, batches, label):
    """BUCKET_STEPS steps of a bucketed trainer from the seed-0 weights;
    the launch counters are zeroed just before the steps and read just
    after.  Returns (state, losses, norms, step ms, peak bytes, launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms, losses, norms = [], [], []
    for t in range(BUCKET_STEPS):
        t1 = time.perf_counter()
        state, loss, nrm = trainer.train_step(state, batches[t], LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if not bool(torch.isfinite(loss).all()) or not bool(torch.isfinite(nrm).all()):
            fail(f"{label} step {t}: non-finite loss {loss.tolist()} or norms")
        losses.append(loss.cpu().numpy())
        norms.append(nrm.cpu().numpy())
    counts = ops.launch_counts()
    return (state, np.stack(losses), np.stack(norms), step_ms,
            torch.cuda.max_memory_allocated(), counts)


def check_against(label, state, losses, norms, ref, idx, a):
    """A bucketed run bit for bit a monolithic one (``ref``: losses, norms,
    θ and m on the sampled columns ``idx`` and from column
    ``ref["tail_start"]`` on): losses, norms, the sampled columns and the
    columns from ``a`` (the run's tail bucket) on."""
    b = a - ref["tail_start"]
    if b < 0:
        fail(f"{label}: tail {a} lies outside the saved columns")
    check_equal(label, {
        "losses": losses, "norms": norms,
        "theta": state.theta[:, idx], "mom": state.mom[:, idx],
        "theta_tail": state.theta[:, a:], "mom_tail": state.mom[:, a:],
    }, {
        "losses": ref["losses"], "norms": ref["norms"], "theta": ref["theta"],
        "mom": ref["mom"], "theta_tail": ref["theta_tail"][:, b:],
        "mom_tail": ref["mom_tail"][:, b:],
    })


def phase_buckets(cfg, layout, batches, ref, sample, ref_interp):
    """Phase 16: the bucketed trainer (fused apply, d_ring) at bucket_mb in
    BUCKET_MBS, BUCKET_STEPS steps each from the seed-0 weights, against
    phase 4's monolithic run after the same steps (``ref``: its losses and
    norms, θ and m on the sampled columns and on the columns from the
    largest bucket size's tail on, which hold every size's tail): all
    bit for bit.  K1 launches once per bucket per step.  Then one more
    step under ``set_sync_debug_mode("error")``, and K1 on the run's own
    state, on the column slices of an interior and the tail bucket (at
    4 MiB also a slice off the 16-byte alignment: the scalar path), with
    a gradient of that state, against its plain twin (``k1_slice_against_twin``).
    Then the bucketed trainer without fused apply (the optimizer and the
    interpreter per bucket, dense mixing) at INTERP_MB against phase 13's
    monolithic ``fused_apply=False`` trainer (``ref_interp``), bit for
    bit.  Returns (launches summed, numbers, K1's max abs error against
    its twin)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    dev = batches[0]["tokens"].device
    idx = torch.as_tensor(sample, device=dev)
    srcs, w = ring_tables(dev)
    total, numbers, err_k1 = {}, {}, 0.0
    log("phase 16 prediction (PERF.md §6): theta and m equal phase 4's bit for bit; "
        "K1 once per bucket per step; peak allocated ~25-26 GiB (phase 4's 31.81 less its "
        "whole-state wire); step ms within 15% of phase 4's at 64 and 256 MiB, slower at "
        "4 MiB (host dispatch of ~800 buckets); K1 on bucket slices == its twin bit for bit; "
        f"the interpreter's bucketed run at {INTERP_MB} MiB == phase 13's trainer bit for bit")
    for mb in BUCKET_MBS:
        trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                              collect_norms=True, fused_apply=True, bucket_mb=mb)
        bl = trainer._bucket_layout
        n_buckets = bl.num_buckets
        label = f"phase 16 bucket_mb {mb}"
        state, losses, norms, step_ms, peak, counts = bucketed_run(trainer, batches, label)
        want = {"gossip_program_update": n_buckets * BUCKET_STEPS, "gossip_update": 0,
                "segment_l2_norms": BUCKET_STEPS, "flash_attention": 0}
        if counts != want:
            fail(f"{label}: launch counts {counts}, expected {want}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        a = tail_start(layout, mb)
        check_against(label, state, losses, norms, ref, idx, a)
        err = sync_error(trainer, state, batches[BUCKET_STEPS])
        if err is not None:
            fail(f"{label}: a step with the inert recorder synchronizes: {err}")
        # K1 on this run's state, bucket by bucket as the step hands it over
        grad = torch.empty_like(state.theta)
        trainer._grads_into(state.theta, grad, batches[0])
        mid = n_buckets // 2
        slices = [(f"interior bucket {mid}", bl.bounds[mid], bl.bounds[mid + 1]),
                  (f"tail bucket {n_buckets - 1}", bl.bounds[-2], bl.bounds[-1])]
        if mb == min(BUCKET_MBS):
            slices.append(("misaligned slice (scalar path)", bl.bounds[mid] + 3,
                           bl.bounds[mid + 1] - 2))
        for what, c, d in slices:
            err_k1 = max(err_k1, k1_slice_against_twin(f"{label} {what}", state.theta,
                                                       state.mom, grad, srcs, w, c, d))
        del grad
        numbers[f"{mb} MiB"] = {"buckets": n_buckets, "step_ms": step_ms,
                                "peak_allocated_bytes": int(peak), "launches": counts,
                                "tail_columns": layout.size - a}
        log(f"{label} ({n_buckets} buckets): {BUCKET_STEPS} steps == phase "
            f"4 bit for bit (losses, norms, theta and m on {idx.numel()} sampled columns and "
            f"the {layout.size - a} tail columns); step ms {[round(x, 1) for x in step_ms]}; "
            f"peak allocated {peak / 2**30:.2f} GiB; launches {counts}; a step with the inert "
            "recorder runs under set_sync_debug_mode('error')")
        del state, trainer
        torch.cuda.empty_cache()
    # the per-bucket interpreter: the optimizer and the dense program per bucket
    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          collect_norms=True, mixing="dense", fused_apply=False,
                          bucket_mb=INTERP_MB)
    label = f"phase 16 bucket_mb {INTERP_MB} without fused apply"
    state, losses, norms, step_ms, peak, counts = bucketed_run(trainer, batches, label)
    if counts != {"gossip_program_update": 0, "gossip_update": 0,
                  "segment_l2_norms": BUCKET_STEPS, "flash_attention": 0}:
        fail(f"{label}: launch counts {counts}, expected {BUCKET_STEPS} of K3 only")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    a = tail_start(layout, INTERP_MB)
    check_against(label, state, losses, norms, ref_interp, idx, a)
    numbers[f"{INTERP_MB} MiB interpreter"] = {
        "buckets": trainer._bucket_layout.num_buckets, "step_ms": step_ms,
        "peak_allocated_bytes": int(peak), "launches": counts}
    log(f"{label} (dense mixing): {BUCKET_STEPS} steps == phase 13's monolithic trainer "
        f"bit for bit (losses, norms, theta and m on the sampled columns and the "
        f"{layout.size - a} tail columns); step ms {[round(x, 1) for x in step_ms]}; peak "
        f"allocated {peak / 2**30:.2f} GiB")
    del state, trainer
    torch.cuda.empty_cache()
    return total, numbers, err_k1


def phase_folded_probe(cfg, layout, batches, ref14, rows13, sample):
    """Phase 17: closed-loop d_ada (phase 14's settings, its offset
    replicas included) through the bucketed trainer at FOLD_MB, whose
    buckets do not line up with the standalone probe's chunks: Ξ after a
    bucketed step is folded into its buckets (one standalone probe in
    all, at step 0).  Each probe's Ξ within rtol 1e-5 of the standalone
    probe and of float64 on the same state and of phase 14's monolithic
    Ξ; phase 14's rung walk, transitions included.  Then the simulator at
    SIM_BUCKET_MB against phase 13's rows, bit for bit.  Returns
    (launches summed, numbers)."""
    import torch
    from repro_torch.core.consensus import consensus_distance_stacked
    from repro_torch.core.dsgd import make_topology
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    dev = batches[0]["tokens"].device
    log("phase 17 prediction (PERF.md §6): the same transitions as phase 14 (2 -> one_peer "
        "at step 1); folded Xi over 4 MiB buckets within 1e-5 of the standalone probe and of "
        "float64, not equal to the probe's bits; a step slower than phase 14's closed loop "
        "by the host dispatch of ~800 buckets (phase 16's 4 MiB cost, +30-80 ms); the "
        "bucketed simulator equals phase 13 bit for bit at 190-250 ms a step and a lower "
        "peak (30-34 GiB)")
    if not ref14["transitions"]:
        fail("phase 17: phase 14's closed loop took no transition, nothing to compare")
    topo = make_topology("d_ada", G, k_floor="one_peer", consensus_target=ADA_TARGET,
                         consensus_probe_every=1)
    trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True, fused_apply=True,
                          bucket_mb=FOLD_MB)
    n_buckets = trainer._bucket_layout.num_buckets
    standalone = trainer.consensus_distance
    probes = []
    trainer.consensus_distance = lambda st, *a: (probes.append(st.step), standalone(st, *a))[1]
    state = trainer.init_state(seed=0)
    xi64, xi_alone = {}, {}
    before = ada_before(xi64, layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms = []
    for t in range(ADA_STEPS):
        before(t, state)
        xi_alone[t] = float(consensus_distance_stacked(state.theta))
        t1 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, batches[t], LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del state, trainer
    torch.cuda.empty_cache()
    if probes != [0]:
        fail(f"phase 17: standalone probes at steps {probes}, expected [0] (folds after)")
    want = {"gossip_program_update": n_buckets * ADA_STEPS, "gossip_update": 0,
            "segment_l2_norms": ADA_STEPS, "flash_attention": 0}
    if counts != want:
        fail(f"phase 17: launch counts {counts}, expected {want}")
    ctl = topo.controller
    ref_trace = ref14["trace"]
    if ctl.transitions != ref14["transitions"] or [(s, r) for s, _, r in ctl.trace] != [
            (s, r) for s, _, r in ref_trace]:
        fail(f"phase 17: rung walk {ctl.trace} vs phase 14's {ref_trace}")
    worst = {"standalone": 0.0, "float64": 0.0, "phase 14": 0.0}
    for (s, xi, _), (_, xi14, _) in zip(ctl.trace, ref_trace):
        for key, other in (("standalone", xi_alone[s]), ("float64", xi64[s]),
                           ("phase 14", xi14)):
            err = abs(xi - other)
            if not err <= 1e-5 * abs(other):
                fail(f"phase 17: Xi at step {s} is {xi!r}, {key} {other!r}")
            worst[key] = max(worst[key], err / abs(other) if other else 0.0)
    idx = torch.as_tensor(sample, device=dev)
    rows, sim_ms, sim_peak, sim_counts = simulator_run(cfg, batches, idx,
                                                       bucket_mb=SIM_BUCKET_MB)
    if sim_counts != {"gossip_program_update": 0, "gossip_update": 0,
                      "segment_l2_norms": SIM_STEPS, "flash_attention": 0}:
        fail(f"phase 17 simulator: launch counts {sim_counts}, expected {SIM_STEPS} of K3")
    for i, (r, r13) in enumerate(zip(rows, rows13)):
        check_equal(f"phase 17 simulator node {i}", r, r13)
    for k, v in sim_counts.items():
        counts[k] += v
    walk = " -> ".join(str(ctl.ladder[r]) for _, r in [(0, 0)] + ctl.transitions)
    numbers = {
        "bucket_mb": FOLD_MB, "buckets": n_buckets, "step_ms": step_ms,
        "peak_allocated_bytes": int(peak), "trace": [[s, xi, r] for s, xi, r in ctl.trace],
        "transitions": ctl.transitions, "rung_walk": walk, "max_xi_rel_err": worst,
        "standalone_probes_at": probes,
        "simulator": {"bucket_mb": SIM_BUCKET_MB, "step_ms": sim_ms, "peak_allocated_bytes": int(sim_peak),
                      "launches": sim_counts},
    }
    log(f"phase 17: bucketed closed loop ({n_buckets} buckets of {FOLD_MB} MiB) took phase "
        f"14's rung walk {walk}; folded Xi within {json.dumps(worst)} relative; step ms "
        f"{[round(x, 1) for x in step_ms]}; peak {peak / 2**30:.2f} GiB; the bucketed simulator "
        f"== phase 13 bit for bit, step ms {[round(x, 1) for x in sim_ms]}, peak "
        f"{sim_peak / 2**30:.2f} GiB ({SIM_BUCKET_MB} MiB buckets)")
    return counts, numbers


def compare_streams(label, got, want, *, rtol, atol=0.0):
    """Two record streams, manifests and spans aside: the same sequence of
    (kind, name, step); counters exactly; events equal; gauges and
    variance metrics (mean and per layer) within ``rtol`` plus ``atol``."""
    key = lambda r: (r["kind"], r.get("name"), r.get("step"))
    got = [r for r in got if r["kind"] not in ("manifest", "span")]
    want = [r for r in want if r["kind"] not in ("manifest", "span")]
    if [key(r) for r in got] != [key(r) for r in want]:
        fail(f"{label}: record sequences differ: {[key(r) for r in got]} vs "
             f"{[key(r) for r in want]}")

    def close(a, b):
        return (a is None and b is None) or (
            a is not None and b is not None and abs(a - b) <= atol + rtol * abs(b))

    for g, w in zip(got, want):
        if g["kind"] in ("counter", "event"):
            ok = g == w
        elif g["kind"] == "gauge":
            ok = close(g["value"], w["value"])
        else:  # variance
            ok = all(close(g["metrics"][m], w["metrics"][m]) and all(
                close(a, b) for a, b in zip(g["per_layer"][m], w["per_layer"][m]))
                for m in w["metrics"])
        if not ok:
            fail(f"{label}: {g} differs from {w}")


def phase_telemetry(cfg, layout, batches, dev):
    """Phase 18: run telemetry on the card.  Phase 4's trainer for
    TEL_STEPS steps with telemetry off, with a ``JsonlSink`` (metrics
    every TEL_EVERY steps) and with ``record_spans=True``: every record
    passes the schema, ``comm_bytes`` equals ``program_comm_bytes`` summed
    offline, the streamed variance equals ``variance_report`` of the
    step's own norms.  Then phase 15's ResNet closed-loop run (20 steps)
    with a ``JsonlSink`` on the card and on the CPU: the same stream
    (phase 15's bars), its comm counters equal to the offline replay of
    the realized rung walk.  Returns (launches summed, numbers)."""
    import numpy as np
    import torch
    from repro_torch.core.dbench import variance_report
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.schedule import program_comm_bytes
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd
    from repro_torch.telemetry import JsonlSink, MetricsRecorder, read_jsonl

    out_dir = _build.BUILD_DIR / "telemetry"
    log("phase 18 prediction (PERF.md §6): every record valid; comm_bytes == the offline "
        "sum; streamed variance == variance_report of the same norms; the card's ResNet "
        "stream == the CPU's; step ms with telemetry off, on and with spans within 5% of "
        "each other (the loop synchronizes every step anyway)")
    total, numbers, paths = {}, {}, {}
    for label, kw in (("off", None), ("on", {}), ("spans", {"record_spans": True})):
        rec = None
        if kw is not None:
            paths[label] = out_dir / f"trainer_{label}.jsonl"
            rec = MetricsRecorder(sinks=[JsonlSink(str(paths[label]))],
                                  metrics_every=TEL_EVERY, **kw)
            rec.manifest({"engine": "stacked", "phase": 18, "telemetry": label})
        topo = make_topology("d_ring", G)
        trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True,
                              fused_apply=True, telemetry=rec)
        state = trainer.init_state(seed=0)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step_ms, norms = [], []
        for t in range(TEL_STEPS):
            t1 = time.perf_counter()
            state, _, nrm = trainer.train_step(state, batches[t], LR)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            norms.append(nrm.cpu().numpy())
        counts = ops.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        numbers[f"trainer {label}"] = {"step_ms": step_ms, "launches": counts}
        del state, trainer
        torch.cuda.empty_cache()
        if rec is None:
            continue
        rec.close()
        records = read_jsonl(str(paths[label]))   # every record through the schema
        prog = topo.program_at()
        want = TEL_STEPS * program_comm_bytes(prog, layout.size * 2)
        got = [r for r in records if r["kind"] == "counter" and r["name"] == "comm_bytes"]
        if not got or got[-1]["total"] != want:
            fail(f"phase 18 trainer {label}: comm_bytes {got[-1:]} != offline {want}")
        var = [r for r in records if r["kind"] == "variance"]
        if [r["step"] for r in var] != list(range(0, TEL_STEPS, TEL_EVERY)):
            fail(f"phase 18 trainer {label}: variance records at {[r['step'] for r in var]}")
        for r in var:
            for m, per_leaf in variance_report(norms[r["step"]]).items():
                if not np.allclose(r["per_layer"][m], per_leaf, rtol=1e-12, atol=0):
                    fail(f"phase 18 trainer {label}: streamed {m} differs at step {r['step']}")
        spans = [r["step"] for r in records if r["kind"] == "span"]
        if spans != (list(range(TEL_STEPS)) if label == "spans" else []):
            fail(f"phase 18 trainer {label}: round spans at steps {spans}")
        numbers[f"trainer {label}"]["records"] = len(records)
    # the ResNet closed-loop run, card against CPU
    name = "resnet closed-loop Ada"
    params, paper_batches = paper_inputs(name, PAPER_CHECK_STEPS)
    runs = {}
    for label, device in (("card", dev), ("cpu", "cpu")):
        paths[label] = out_dir / f"resnet_{label}.jsonl"
        rec = MetricsRecorder(sinks=[JsonlSink(str(paths[label]))], metrics_every=TEL_EVERY,
                              record_spans=True)
        if label == "card":
            ops.reset_launch_counts()
        runs[label] = paper_run(name, device, params, paper_batches, telemetry=rec)
        if label == "card":
            for k, v in ops.launch_counts().items():
                total[k] = total.get(k, 0) + v
        rec.close()
        runs[label]["records"] = read_jsonl(str(paths[label]))
    compare_streams("phase 18 resnet card vs CPU", runs["card"]["records"],
                    runs["cpu"]["records"], rtol=1e-4, atol=1e-6)
    card = runs["card"]
    topo, ctl = card["topology"], card["topology"].controller
    want = 0
    for t in range(PAPER_CHECK_STEPS):
        with ctl.pinned(ctl.rung_at(t)):
            want += program_comm_bytes(topo.fused_program_at(step=t, epoch=t // 5),
                                       card["param_bytes"])
    got = [r for r in card["records"] if r["kind"] == "counter" and r["name"] == "comm_bytes"]
    if got[-1]["total"] != want:
        fail(f"phase 18 resnet: comm_bytes {got[-1]['total']} != offline replay {want}")
    numbers[name] = {"records": len(card["records"]),
                     "step_ms_median": float(np.median(card["step_ms"][1:])),
                     "cpu_step_ms_median": float(np.median(runs["cpu"]["step_ms"][1:])),
                     "transitions": card["transitions"]}
    numbers["paths"] = {k: str(v) for k, v in paths.items()}
    log(f"phase 18: trainer step ms off {[round(x, 1) for x in numbers['trainer off']['step_ms']]}, "
        f"on {[round(x, 1) for x in numbers['trainer on']['step_ms']]}, spans "
        f"{[round(x, 1) for x in numbers['trainer spans']['step_ms']]}; every record valid, "
        f"comm_bytes == offline, streamed variance == variance_report; the ResNet stream "
        f"({len(card['records'])} records, median step {numbers[name]['step_ms_median']:.2f} ms) "
        f"on the card == the CPU's; streams under {out_dir}")
    return total, numbers


# phases 19-22: faults and elastic membership at phase 4's configuration
FAULT_STEPS, FAULT_NOISE, FAULT_BUCKET_MB, FAULT_RANK_STEPS = 6, 0.01, 64, RANK_STEPS
# name -> (kind, make_fault_model kwargs) at G = 4 on d_ring; together they
# realize a degraded program, a rejoin, a drain with boost > 1 and its
# handoff, ghost rows, dropped edges and stragglers
FAULT_RUNS = {
    # node 2 dies at step 1 (its degraded program runs at steps 1-2) and
    # rejoins at step 3 with its neighbours' average
    "crash": ("crash", dict(rate=0.5, seed=2, down_steps=2)),
    # node 2 drains at steps 1-2 (its edges ×1.5), hands off and departs at
    # step 3; the degraded program from then on
    "preempt": ("preempt", dict(rate=0.5, seed=2, drain_steps=2)),
    # rank 3 rides as a ghost (all-zero fault row); links among the active
    # ranks fail at steps 1-5
    "spare-link": ("link", dict(rate=0.3, seed=0, spare_ranks=1)),
    # stragglers skip their update at steps 0, 4 and 5
    "straggler": ("straggler", dict(rate=0.3, seed=0)),
}
# phase 22: node 2 dies at step 1 and rejoins at step 2
FAULT_RANK_MODEL = ("crash", dict(rate=0.5, seed=2, down_steps=1))


def sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def fault_trainer(cfg, name, **kw):
    """Phase 4's trainer (d_ring, momentum-SGD, DBench norms) under the
    fault model of FAULT_RUNS[name]; ``kw`` goes to the trainer."""
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.faults import make_fault_model
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    kind, fkw = FAULT_RUNS[name] if name in FAULT_RUNS else FAULT_RANK_MODEL
    fm = make_fault_model(kind, G, **fkw)
    return SPMDTrainer(cfg, make_topology("d_ring", G, fault_model=fm), sgd(momentum=0.9),
                       collect_norms=True, **kw)


def equal_in_chunks(label, other, got, want):
    """Each (G, P) buffer of ``got`` bit for bit ``want``'s (on the card or
    in host memory), TWIN_CHUNK columns at a time."""
    import torch

    for what, a in got.items():
        b = want[what]
        for c in range(0, a.shape[1], TWIN_CHUNK):
            d = min(c + TWIN_CHUNK, a.shape[1])
            if not torch.equal(a[:, c:d].to(b.device), b[:, c:d]):
                fail(f"{label} {what} differs from {other} in columns {c}:{d}")


def push_apart(theta, step):
    """Before step ``step`` of every run of phases 19-21: each node's θ
    offset by its own noise (σ FAULT_NOISE, seeded by the step), so that
    the step's mix and handoffs move θ past the comparison's tolerance
    (gossip shrinks the disagreement about 3× a step on d_ring)."""
    offset_nodes(theta, FAULT_NOISE, seed=1000 + step)


def fault_rounds(trainer, step):
    """Step ``step``'s mixing rounds under its realization, as
    ``check_step_against_interpreter`` takes them (the masked interpreter
    and |W'| of the degraded matrix per round), the (G, 1) update mask and
    the rows whose first-round row is not the identity (less the nodes
    rejoining at this step)."""
    import numpy as np
    import torch
    from repro_torch.core.faults import degraded_matrix

    fr = trainer.fault_model.at(step)
    stages = program_stages(trainer, step)
    sel = fr.selection_mask()
    if not sel.all():
        stages = [st.degrade(sel) for st in stages]
    dev = trainer.device
    alive = torch.as_tensor(np.asarray(fr.alive, np.float32), device=dev)
    link = None if fr.link_up is None else torch.as_tensor(
        fr.link_up.astype(np.float32), device=dev)
    rounds = []
    for st in stages:
        wd = degraded_matrix(st.matrix(), fr.alive, fr.link_up)
        rounds.append((lambda x, st=st: st.apply_masked(x, alive, link_up=link),
                       torch.as_tensor(np.abs(wd), dtype=torch.float32, device=dev)))
    first = degraded_matrix(stages[0].matrix(), fr.alive, fr.link_up)
    # a rejoining node holds its neighbours' average: its own mix hardly moves it
    moving = [i for i in range(G)
              if not np.array_equal(first[i], np.eye(G)[i]) and i not in fr.rejoin]
    update = torch.as_tensor(np.asarray(fr.update, np.float32), device=dev)[:, None]
    return fr, rounds, update, torch.as_tensor(moving, dtype=torch.long, device=dev)


def after_handoffs(trainer, theta, fr, step):
    """A copy of θ after the step's membership handoffs, as the trainer
    makes them before its update (``faults.membership_events``)."""
    from repro_torch.core.faults import membership_events

    theta0 = theta.clone()
    membership_events(fr, [theta0], trainer.topology, None, step=step, epoch=0,
                      narrow=trainer.layout.narrow_leaves())
    return theta0


def realized_events(fm, steps):
    """What a fault model realizes over ``steps`` steps, for the logs."""
    import numpy as np

    out = {"degraded_program_steps": [], "rejoin_steps": [], "depart_steps": [],
           "boost_steps": [], "dropped_edge_steps": [], "straggler_steps": [],
           "ghost_rows": []}
    for t in range(steps):
        fr = fm.at(t)
        alive = np.asarray(fr.alive, np.float64)
        if not fr.selection_mask().all():
            out["degraded_program_steps"].append(t)
        if fr.rejoin:
            out["rejoin_steps"].append(t)
        if fr.depart:
            out["depart_steps"].append(t)
        if (alive > 1).any():
            out["boost_steps"].append(t)
        if fr.link_up is not None and not fr.link_up.all():
            out["dropped_edge_steps"].append(t)
        if ((np.asarray(fr.update) == 0) & (alive != 0)).any():
            out["straggler_steps"].append(t)
        ghosts = [i for i in range(len(alive)) if alive[i] == 0 and not fr.update[i]
                  and not fr.program_alive[i]]
        if ghosts and t == 0:
            out["ghost_rows"] = ghosts
    return out


PREDICT_19 = (
    "phase 19 prediction (PERF.md §6): K1 once per step on the realized fault rows; every "
    "step within phase 5's tolerances of the masked interpreter (boost, ghost, dead and "
    "straggling rows included); the fault-free step 0 == phase 4's bit for bit; step ms "
    "near phase 4's (139-163) plus ~0-10 ms of mask work; a rejoin or departure step adds "
    "its handoff (~10-40 ms); peak as phase 4's (31.81 GiB) plus the plain trainer's state "
    "(~20 GiB) held for the lockstep comparison")
PREDICT_20 = (
    f"phase 20 prediction (PERF.md §6): each run at {FAULT_BUCKET_MB} MiB == phase 19's bit "
    "for bit; K1 once per bucket per step, the fault rows built once a step; step ms within "
    "15% of phase 19's, peak below it (no whole-state wire, no plain state)")


def phase_fault_run(cfg, batches, name):
    """Phase 19 for one model of FAULT_RUNS: the fused trainer (K1 on the
    realized fault rows) for FAULT_STEPS steps from phase 4's seed-0
    replicas, with the trainer without fused apply in
    lockstep: before each step the nodes are pushed apart (``push_apart``),
    the plain trainer takes the fused run's state, both run the step, and
    ``check_step_against_interpreter`` holds
    K1's step against the masked interpreter's (phase 5's tolerances).  K1
    launches once per step; the launch counters are zeroed just before
    each fused step and read just after.  Returns (launches of the fused
    steps, numbers, the run's final state for phase 20)."""
    import torch
    from repro_torch.kernels import ops

    dev = batches[0]["tokens"].device
    fused = fault_trainer(cfg, name, fused_apply=True)
    plain = fault_trainer(cfg, name, fused_apply=False)
    state = fused.init_state(seed=0)
    ref = plain.init_state(seed=0)
    events = realized_events(fused.fault_model, FAULT_STEPS)
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    step_ms, worst = [], {"ulps": 0.0, "share_of_tolerance": 0.0, "m_rel": 0.0,
                          "moved_share_min": 1.0}
    counts = dict.fromkeys(ops.launch_counts(), 0)
    for t in range(FAULT_STEPS):
        push_apart(state.theta, t)
        ref.theta.copy_(state.theta)
        ref.mom.copy_(state.mom)
        ref.step = t
        fr, rounds, update, moving = fault_rounds(fused, t)
        theta0 = after_handoffs(fused, state.theta, fr, t)
        sync(dev)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        state, loss, nrm = fused.train_step(state, batches[t], LR)
        sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        c = ops.launch_counts()
        counts = {k: counts[k] + c[k] for k in c}
        if c["gossip_program_update"] != 1:
            fail(f"phase 19 {name} step {t}: K1 launched {c['gossip_program_update']} "
                 "times, expected once")
        if not bool(torch.isfinite(loss).all()) or not bool(torch.isfinite(nrm).all()):
            fail(f"phase 19 {name} step {t}: non-finite loss {loss.tolist()} or norms")
        ref, loss_r, _ = plain.train_step(ref, batches[t], LR)
        if not torch.allclose(loss, loss_r, rtol=1e-5, atol=0):
            fail(f"phase 19 {name} step {t}: losses {loss.tolist()} vs {loss_r.tolist()}")
        ulps, share, m_rel, moved = check_step_against_interpreter(
            f"phase 19 {name} step {t}", theta0, state, ref, rounds, update=update,
            rows=moving)
        worst = {"ulps": max(worst["ulps"], ulps),
                 "share_of_tolerance": max(worst["share_of_tolerance"], share),
                 "m_rel": max(worst["m_rel"], m_rel),
                 "moved_share_min": min(worst["moved_share_min"],
                                        1.0 if moved is None else moved)}
        del theta0
    peak = torch.cuda.max_memory_allocated()
    numbers = {"model": fused.fault_model.describe(), "realized": events, "step_ms": step_ms,
               "peak_allocated_bytes": int(peak), "launches": counts,
               "fused_vs_interpreter": worst}
    log(f"phase 19 {name} ({numbers['model']}; realized {events}): {FAULT_STEPS} steps, each "
        f"within phase 5's tolerances of the masked interpreter (theta {worst['ulps']:.3f} "
        f"bf16 ulps, {worst['share_of_tolerance']:.3f} of its tolerance; m "
        f"{worst['m_rel']:.3e} relative; moved share >= {worst['moved_share_min']:.4f}); "
        f"step ms {[round(x, 1) for x in step_ms]}; peak allocated {peak / 2**30:.2f} GiB; "
        f"launches {counts}")
    del ref, plain, fused
    torch.cuda.empty_cache()
    return counts, numbers, state


def phase_fault_free_step(cfg, batches, step0, sample):
    """Phase 19's last check: one step from the seed-0 weights (no offset)
    under the crash model, whose step 0 realizes no fault (all-ones fault
    rows): bit for bit phase 4's first step (``step0``: losses, norms, θ and
    m on the sampled columns)."""
    import torch

    trainer = fault_trainer(cfg, "crash", fused_apply=True)
    if trainer.fault_model.at(0).faulty:
        fail("phase 19: the crash model realizes a fault at step 0")
    state = trainer.init_state(seed=0)
    state, loss, nrm = trainer.train_step(state, batches[0], LR)
    idx = torch.as_tensor(sample, device=state.theta.device)
    check_equal("phase 19 fault-free step 0 under the crash model", {
        "losses": loss, "norms": nrm, "theta": state.theta[:, idx], "mom": state.mom[:, idx],
    }, step0)
    log("phase 19: the crash model's step 0 (all-ones fault rows) == phase 4's step 0 bit "
        f"for bit (losses, norms, theta and m on {idx.numel()} sampled columns)")
    del state, trainer
    torch.cuda.empty_cache()


def phase_fault_bucket_run(cfg, batches, name, final):
    """Phase 20 for one model: phase 19's fused run at bucket_mb
    FAULT_BUCKET_MB: K1 once per bucket per step on the step's fault rows,
    built once a step (``fault_rows`` counted), and the final θ and m
    equal to phase 19's (``final``) bit for bit over the whole state.
    Returns (launches, numbers)."""
    import torch
    from repro_torch.kernels import gossip_update as gu
    from repro_torch.kernels import ops

    dev = batches[0]["tokens"].device
    real, built = gu.fault_rows, []

    def counting(*args, **kw):
        built.append(1)
        return real(*args, **kw)

    trainer = fault_trainer(cfg, name, fused_apply=True, bucket_mb=FAULT_BUCKET_MB)
    n_buckets = trainer._bucket_layout.num_buckets
    state = trainer.init_state(seed=0)
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms = []
    gu.fault_rows = counting
    try:
        for t in range(FAULT_STEPS):
            push_apart(state.theta, t)
            t1 = time.perf_counter()
            state, _, _ = trainer.train_step(state, batches[t], LR)
            sync(dev)
            step_ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        gu.fault_rows = real
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"gossip_program_update": n_buckets * FAULT_STEPS, "gossip_update": 0,
            "segment_l2_norms": FAULT_STEPS, "flash_attention": 0}
    if counts != want:
        fail(f"phase 20 {name}: launch counts {counts}, expected {want}")
    if len(built) != FAULT_STEPS:
        fail(f"phase 20 {name}: fault rows built {len(built)} times in {FAULT_STEPS} steps, "
             "expected once a step")
    equal_in_chunks(f"phase 20 {name}", "phase 19's", {"theta": state.theta, "mom": state.mom},
                    {"theta": final.theta, "mom": final.mom})
    numbers = {"buckets": n_buckets, "step_ms": step_ms, "peak_allocated_bytes": int(peak),
               "launches": counts, "fault_rows_built": len(built)}
    log(f"phase 20 {name} ({n_buckets} buckets): {FAULT_STEPS} steps == phase 19 bit for bit "
        f"(whole state); fault rows built {len(built)} times; step ms "
        f"{[round(x, 1) for x in step_ms]}; peak allocated {peak / 2**30:.2f} GiB; launches "
        f"{counts}")
    del state, trainer
    torch.cuda.empty_cache()
    return counts, numbers


def phase_fault_simulator(cfg, batches):
    """Phase 21: ``DecentralizedSimulator`` (stacked mixing, one node's
    gradients at a time) under each model of FAULT_RUNS from phase 19's
    start, against the trainer without fused apply on the same inputs: θ
    and m bit for bit over the whole state, losses and norms equal.  K3
    once per step, K1 and K2 never.  Returns (launches, numbers)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.faults import make_fault_model
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.sgd import sgd

    dev = batches[0]["tokens"].device
    log("phase 21 prediction (PERF.md §6): the simulator == the unfused trainer bit for bit "
        "under each model; K3 once per step; step ms near phase 13's (204-221) plus the "
        "masked tables; peak near phase 13's 41 GiB plus the trainer's final state "
        "(18.75 GiB, kept on the card for the comparison)")
    total, numbers = {}, {}
    for name, (kind, fkw) in FAULT_RUNS.items():
        trainer = fault_trainer(cfg, name, fused_apply=False)
        tstate = trainer.init_state(seed=0)
        t_losses, t_norms = [], []
        for t in range(FAULT_STEPS):
            push_apart(tstate.theta, t)
            tstate, loss, nrm = trainer.train_step(tstate, batches[t], LR)
            t_losses.append(loss)
            t_norms.append(nrm)
        # the trainer's final θ and m stay on the card beside the simulator's
        # run (18.75 GiB beside its 43.4 GiB peak)
        want = {"theta": tstate.theta, "mom": tstate.mom}
        del trainer, tstate
        torch.cuda.empty_cache()
        sim = DecentralizedSimulator(
            lambda p, b: tfm.loss_fn(p, cfg, b), sgd(momentum=0.9),
            make_topology("d_ring", G, fault_model=make_fault_model(kind, G, **fkw)),
            mixing="shift", collect_norms=True, node_loop=True, device=dev)
        params = tfm.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        state = sim.init(params)
        del params
        sync(dev)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        step_ms = []
        for t in range(FAULT_STEPS):
            push_apart(state.theta, t)
            t1 = time.perf_counter()
            state, loss, nrm = sim.train_step(state, batches[t], LR)
            sync(dev)
            step_ms.append((time.perf_counter() - t1) * 1e3)
            if not torch.equal(loss, t_losses[t]) or not torch.equal(nrm, t_norms[t]):
                fail(f"phase 21 {name} step {t}: simulator losses or norms differ from the "
                     "trainer's")
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if counts != {"gossip_program_update": 0, "gossip_update": 0,
                      "segment_l2_norms": FAULT_STEPS, "flash_attention": 0}:
            fail(f"phase 21 {name}: launch counts {counts}, expected {FAULT_STEPS} of K3 only")
        equal_in_chunks(f"phase 21 {name}: the simulator's", "the trainer's",
                        {"theta": state.theta, "mom": state.opt["mom"]}, want)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        numbers[name] = {"step_ms": step_ms, "peak_allocated_bytes": int(peak),
                         "launches": counts}
        log(f"phase 21 {name}: simulator {FAULT_STEPS} steps == the unfused trainer bit for "
            f"bit (whole state, losses, norms); step ms {[round(x, 1) for x in step_ms]}; "
            f"peak allocated {peak / 2**30:.2f} GiB; launches {counts}")
        del state, sim, want, t_losses, t_norms
        torch.cuda.empty_cache()
    return total, numbers


PREDICT_22 = (
    "phase 22 prediction (PERF.md §6): each rank == its stacked row bit for bit; K2 3 per "
    "rank; rank step near phase 9's (2.9-5.2 s over gloo-host), the rejoin step longer by "
    "the gathers of theta and m (~4 full-row transfers per rank)")


def fault_rank_run(comm, sample, steps):
    """Phase 22 on one rank: the fused trainer, engine ``ranks``, under
    FAULT_RANK_MODEL from the seed-0 weights and batches; the launch
    counters are zeroed just before the steps and read just after.
    Returns this rank's losses, norms, θ and m on the sampled columns, step
    times, peak allocation and launch counts."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops

    if comm.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = fault_rank_cfg(comm.device)
    trainer = fault_trainer(cfg, "ranks", fused_apply=True, device=comm.device)
    if trainer.engine != "ranks":
        raise RuntimeError(f"rank {comm.rank} runs the {trainer.engine} engine")
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=fault_rank_seq(comm.device), seed=0)
    sync(comm.device)
    if comm.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(comm.device)
    ops.reset_launch_counts()
    step_ms, losses, norms = [], [], []
    for t in range(steps):
        t1 = time.perf_counter()
        state, loss, nrm = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
        sync(comm.device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.cpu().numpy())
        norms.append(nrm.cpu().numpy())
    counts = ops.launch_counts()
    idx = torch.as_tensor(sample, device=comm.device)
    return {
        "transport": comm.transport, "step_ms": step_ms,
        "losses": np.concatenate(losses), "norms": np.concatenate(norms),
        "theta": state.theta[0, idx].float().cpu().numpy(),
        "mom": state.mom[0, idx].cpu().numpy(),
        "peak_allocated_bytes": (torch.cuda.max_memory_allocated(comm.device)
                                 if comm.device.type == "cuda" else 0),
        "launches": counts,
    }


def fault_rank_cfg(dev):
    """Phase 4's configuration on the card; the reduced one on the CPU."""
    import torch
    from repro_torch.configs import get_config

    if torch.device(dev).type == "cuda":
        return granite_layout()[0]
    return dataclasses.replace(get_config("granite-8b-reduced"), dtype=torch.bfloat16)


def fault_rank_seq(dev):
    import torch

    return SEQ if torch.device(dev).type == "cuda" else 16


def stacked_fault_reference(dev, sample, steps):
    """Phase 22's reference: the stacked fused trainer under the same model
    and inputs as the ranks: per node, losses, norms, θ and m on the
    sampled columns."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM

    cfg = fault_rank_cfg(dev)
    trainer = fault_trainer(cfg, "ranks", fused_apply=True, device=dev)
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=fault_rank_seq(dev), seed=0)
    losses, norms = [], []
    for t in range(steps):
        state, loss, nrm = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
        losses.append(loss.cpu().numpy())
        norms.append(nrm.cpu().numpy())
    idx = torch.as_tensor(sample, device=dev)
    ref = {"losses": np.stack(losses, 1), "norms": np.stack(norms, 1),
           "theta": state.theta[:, idx].float().cpu().numpy(),
           "mom": state.mom[:, idx].cpu().numpy()}
    del state, trainer
    return ref


def compare_rows_exact(label, rows, ref):
    """Each rank's losses, norms, θ and m on the sampled columns equal to
    its row of the stacked run (``ref``) bit for bit."""
    import numpy as np

    for i, r in enumerate(rows):
        for key in ("losses", "norms", "theta", "mom"):
            if not np.array_equal(r[key], ref[key][i]):
                fail(f"{label} {i}: {key} differs from the stacked row (max abs "
                     f"{np.abs(r[key] - ref[key][i]).max():.3e})")


def phase_fault_ranks(sample, done, device=None):
    """Phase 22: G ranks of the ranks engine (as phase 9) under a crash at
    step 1 with a rejoin at step 2 (FAULT_RANK_MODEL), FAULT_RANK_STEPS
    steps: every rank computes the realization itself, the dead rank
    joins every permute, gather and mean, the rejoin gathers its
    neighbours' rows across ranks; each rank equal to its stacked row bit
    for bit, K2 once per step on every rank (on the dead rank its row of
    the degraded program is the identity).  ``done``: the stacked
    reference, the ranks' results and their seconds from ``rank_world``
    (``device``: its ranks' device, None for the card).  Returns the
    phase's numbers."""
    import torch

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    ref, res, wall = done
    # the wrappers count CUDA launches; on the CPU (the tests) they take the twins
    per_rank = FAULT_RANK_STEPS if dev.type == "cuda" else 0
    want = {"gossip_program_update": 0, "gossip_update": per_rank,
            "segment_l2_norms": per_rank, "flash_attention": 0}
    for i, r in enumerate(res):
        if r["launches"] != want:
            fail(f"phase 22 rank {i}: launch counts {r['launches']}, expected {want}")
    compare_rows_exact("phase 22 rank", res, ref)
    out = {
        "model": FAULT_RANK_MODEL[0] + " " + json.dumps(FAULT_RANK_MODEL[1]),
        "ranks": G, "transport": res[0]["transport"],
        "step_ms": [r["step_ms"] for r in res],
        "peak_allocated_bytes": [int(r["peak_allocated_bytes"]) for r in res],
        "launches": {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]},
        "sampled_columns": int(len(sample)), "wall_s": wall,
    }
    log(f"phase 22: {G} ranks over {out['transport']} under {out['model']}: "
        f"{FAULT_RANK_STEPS} steps == the stacked rows bit for bit (losses, norms, theta and "
        f"m on {out['sampled_columns']} sampled columns); K2 launches "
        f"{out['launches']['gossip_update']}; step ms per rank "
        f"{[[round(x, 1) for x in ms] for ms in out['step_ms']]}; peak allocated per rank "
        f"{[round(b / 2**30, 2) for b in out['peak_allocated_bytes']]} GiB")
    return out


# phases 23-26: checkpoints and the trainer's knobs at phase 4's configuration
RESUME_STEPS, RESUME_CUT = 4, 2          # phase 23: 4 steps, the checkpoint after step 2
RANK_RESUME_STEPS, RANK_RESUME_CUT = 2, 1  # phase 24
SIM_RESUME_STEPS, SIM_RESUME_CUT = 120, 60  # phase 25
KNOB_STEPS = 3                           # phase 26
EXAMPLE_STEPS = 5                        # phase 26: dbench_whitebox's short --steps
QUICK_STEPS = 10                         # phase 26: the quickstart's short --steps
# checkpoints are written here and removed by the phase that wrote them
CKPT_DIR = ROOT / "build" / "repro_torch" / "ckpt"

PREDICT_23 = (
    "phase 23 prediction (PERF.md §6): the resumed steps 2-3 == the uninterrupted run bit "
    "for bit (losses, norms, theta, m, the extra payload); file 20.1 GB (4 x 838,881,280 "
    "bf16 theta and f32 m); save and load 10-40 s each (disk-bound); the peak during save "
    "and load gains at most one leaf's host-copy staging on the card over the live state")
PREDICT_24 = (
    "phase 24 prediction (PERF.md §6): each rank's resumed step 1 == its uninterrupted "
    "row bit for bit; the ranks engine's file == the stacked engine's (member names; theta "
    "and m on the sampled columns == phase 4's state after step 0); K2 3 per rank; "
    "gather-and-write and read-and-scatter 20-60 s each through gloo-host")
PREDICT_25 = (
    "phase 25 prediction (PERF.md §6): the ResNet closed loop resumed at step 60 == the "
    "uninterrupted 120 steps bit for bit (losses, norms, final parameters and momentum, the "
    "controller's log); K3 180; a few seconds")
PREDICT_26 = (
    "phase 26 prediction (PERF.md §6): remat == no remat bit for bit; accum_steps 2 within "
    "its bar of accum_steps 1 (losses within 2 bf16 ulps of the loss; per leaf, theta within "
    "2 bf16 ulps a step of the leaf's largest |theta|, m within 2^-6 a step of its largest "
    "|m|); remat step +20-40 % (one more "
    "forward), peak lower by most of the activations; accum 2 step +0-30 %; both examples "
    "finish and the quickstart's loss falls")


def checkpoint_dir(need_bytes):
    """A fresh directory under CKPT_DIR, after checking that its disk holds
    ``need_bytes`` with room to spare."""
    import shutil
    import tempfile

    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_DIR).free
    if free < 1.05 * need_bytes + (2 << 30):
        fail(f"a checkpoint of {need_bytes / 1e9:.2f} GB needs more disk than the "
             f"{free / 1e9:.2f} GB free under {CKPT_DIR}")
    return Path(tempfile.mkdtemp(dir=CKPT_DIR))


def state_bytes(layout):
    """Bytes of a G-node momentum-SGD checkpoint: bfloat16 θ, float32 m."""
    return G * layout.size * (2 + 4)


def resume_trainer(cfg):
    """Phase 23's trainer: phase 4's (fused, DBench norms) on phase 14's
    closed-loop d_ada (a probe every step, one-peer floor)."""
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    topo = make_topology("d_ada", G, k_floor="one_peer", consensus_target=ADA_TARGET,
                         consensus_probe_every=1)
    return SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True, fused_apply=True)


def timed(fn):
    """(fn's result, seconds, peak device bytes allocated during it beyond
    what was allocated before it)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base


def phase_stacked_resume(cfg, layout, batches, peak4):
    """Phase 23: phase 4's trainer on phase 14's closed loop, from replicas
    offset by ADA_NOISE (so the controller's rung walk depends on the
    restored phase peak), RESUME_STEPS steps with a checkpoint after step
    RESUME_CUT (keep=1); then a fresh trainer restores the file in place
    and runs the remaining steps.  Its losses, norms, θ and m and the
    extra payload must equal the uninterrupted run's bit for bit.  The
    launch counters are zeroed before the first run and read after the
    second.  Returns (launches, numbers, the file's member names)."""
    import os
    import shutil
    import zipfile

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import TrainState

    log(PREDICT_23)
    need = state_bytes(layout)
    d = checkpoint_dir(need)
    try:
        a = resume_trainer(cfg)
        state = a.init_state(seed=0)
        offset_nodes(state.theta, ADA_NOISE)
        ops.reset_launch_counts()
        losses, norms, step_ms = [], [], []
        for t in range(RESUME_STEPS):
            t1 = time.perf_counter()
            state, loss, nrm = a.train_step(state, batches[t], LR)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(loss.clone())
            norms.append(nrm.clone())
            if state.step == RESUME_CUT:
                saved_extra = a.snapshot_extra()
                path, save_s, save_peak = timed(lambda: a.save_checkpoint(str(d), state,
                                                                          keep=1))
        size = os.path.getsize(path)
        with zipfile.ZipFile(path) as zf:
            members = zf.namelist()
        want_extra = a.snapshot_extra()
        want = {"theta": state.theta, "mom": state.mom}
        del a
        torch.cuda.empty_cache()
        b = resume_trainer(cfg)
        fresh = b.init_state(seed=0)
        step, load_s, load_peak = timed(lambda: b.restore_checkpoint(str(d), fresh))
        if step != RESUME_CUT:
            fail(f"phase 23: restored step {step}, expected {RESUME_CUT}")
        resumed = TrainState(fresh.theta, fresh.opt, step)
        for t in range(step, RESUME_STEPS):
            resumed, loss, nrm = b.train_step(resumed, batches[t], LR)
            if not (torch.equal(loss, losses[t]) and torch.equal(nrm, norms[t])):
                fail(f"phase 23: resumed step {t}: losses {loss.tolist()} vs "
                     f"{losses[t].tolist()} or norms differ from the uninterrupted run")
        counts = ops.launch_counts()
        equal_in_chunks("phase 23 resumed", "the uninterrupted run",
                        {"theta": resumed.theta, "mom": resumed.mom}, want)
        got_extra = b.snapshot_extra()
        if got_extra != want_extra:
            fail(f"phase 23: extra payload {got_extra} != {want_extra}")
        ctl = saved_extra.get("controller") or {}
        if len(ctl.get("trace", [])) != RESUME_CUT or not want_extra["controller"]["transitions"]:
            fail(f"phase 23: the checkpoint's controller state {ctl} or the run's transitions "
                 f"{want_extra['controller']['transitions']} are not what the phase needs")
        runs = RESUME_STEPS + RESUME_STEPS - RESUME_CUT
        if counts != {"gossip_program_update": runs, "gossip_update": 0,
                      "segment_l2_norms": runs, "flash_attention": 0}:
            fail(f"phase 23: launch counts {counts}, expected {runs} of K1 and K3")
        del b, resumed, fresh, want
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    numbers = {
        "file_bytes": size, "expected_bytes": need, "members": len(members),
        "save_s": save_s, "load_s": load_s, "save_gb_per_s": size / save_s / 1e9,
        "load_gb_per_s": size / load_s / 1e9,
        "save_peak_above_live_bytes": int(save_peak), "load_peak_above_live_bytes": int(load_peak),
        "phase4_peak_bytes": int(peak4), "step_ms": step_ms, "launches": counts,
        "transitions": want_extra["controller"]["transitions"],
    }
    log(f"phase 23: resumed at step {RESUME_CUT} == the uninterrupted run bit for bit "
        f"(losses, norms, theta, m, extra payload); file {size / 1e9:.3f} GB "
        f"({len(members)} members); save {save_s:.1f} s ({numbers['save_gb_per_s']:.2f} GB/s), "
        f"load {load_s:.1f} s ({numbers['load_gb_per_s']:.2f} GB/s); device peak above the "
        f"live state: save {save_peak / 2**30:.3f} GiB, load {load_peak / 2**30:.3f} GiB "
        f"(phase 4's peak {peak4 / 2**30:.2f} GiB); launches {counts}")
    return counts, numbers, members


def resume_rank_run(comm, ckpt_dir, steps, cut):
    """Phase 24 on one rank: phase 9's trainer (engine ``ranks``) for
    ``steps`` steps from the seed-0 weights, a checkpoint after step
    ``cut`` (every rank gathers to rank 0, which writes); then a fresh
    trainer restores it (rank 0 reads, every rank receives its row) and
    runs the remaining steps.  Returns whether the resumed losses, norms,
    θ and m equal the uninterrupted run's, the save and load seconds and
    the launch counts of both runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.dsgd import make_topology
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SPMDTrainer, TrainState
    from repro_torch.optim.sgd import sgd

    if comm.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = fault_rank_cfg(comm.device)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=fault_rank_seq(comm.device), seed=0)
    batches = [src.stacked(G, t, BATCH) for t in range(steps)]

    def trainer():
        tr = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                         collect_norms=True, fused_apply=True, device=comm.device)
        if tr.engine != "ranks":
            raise RuntimeError(f"rank {comm.rank} runs the {tr.engine} engine")
        return tr

    def timed_rank(fn):
        sync(comm.device)
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        sync(comm.device)
        dist.barrier()
        return out, time.perf_counter() - t0

    a = trainer()
    state = a.init_state(seed=0)
    ops.reset_launch_counts()
    losses, norms = [], []
    for t in range(steps):
        state, loss, nrm = a.train_step(state, batches[t], LR)
        losses.append(loss.clone())
        norms.append(nrm.clone())
        if state.step == cut:
            _, save_s = timed_rank(lambda: a.save_checkpoint(ckpt_dir, state, keep=1))
    want = {"theta": state.theta.cpu(), "mom": state.mom.cpu()}
    del a, state
    if comm.device.type == "cuda":
        torch.cuda.empty_cache()
    b = trainer()
    fresh = b.init_state(seed=0)
    step, load_s = timed_rank(lambda: b.restore_checkpoint(ckpt_dir, fresh))
    resumed = TrainState(fresh.theta, fresh.opt, step)
    same = step == cut
    for t in range(step, steps):
        resumed, loss, nrm = b.train_step(resumed, batches[t], LR)
        same = same and torch.equal(loss, losses[t]) and torch.equal(nrm, norms[t])
    counts = ops.launch_counts()
    for key, buf in (("theta", resumed.theta), ("mom", resumed.mom)):
        for c in range(0, buf.shape[1], TWIN_CHUNK):
            d = min(c + TWIN_CHUNK, buf.shape[1])
            same = same and torch.equal(buf[:, c:d].cpu(), want[key][:, c:d])
    return {"transport": comm.transport, "equal": bool(same), "save_s": save_s,
            "load_s": load_s, "launches": counts}


def stored_member(path, zf, key):
    """A read-only memory map of the payload of the stored (uncompressed)
    ``.npy`` member ``key`` of the zip ``zf`` at ``path`` (a bfloat16
    member's 2-byte voids as uint16): the pages a reader touches are read,
    without the zip reader's CRC pass over the whole member."""
    import struct
    import zipfile

    import numpy as np

    info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        fail(f"checkpoint member {key} is compressed")
    with open(path, "rb") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + name_len + extra_len)
        fmt = np.lib.format
        read = (fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0)
                else fmt.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if fortran:
        fail(f"checkpoint member {key} is not C-ordered")
    if dtype.kind == "V":
        dtype = np.dtype(np.uint16)
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=tuple(shape))


def file_rows(path, layout, sample):
    """θ and m of a trainer checkpoint on the sampled columns (G, n)."""
    import zipfile

    import numpy as np
    import torch

    out = {"theta": [], "mom": []}
    with zipfile.ZipFile(path) as zf:
        for name, off, size in zip(layout.names, layout.offsets[:-1], layout.sizes):
            local = sample[(sample >= off) & (sample < off + size)] - off
            key = name.replace(".", "/")
            for what, prefix, dtype in (("theta", "p/", torch.bfloat16),
                                        ("mom", "o/", torch.float32)):
                leaf = stored_member(path, zf, prefix + key)
                rows = np.ascontiguousarray(leaf.reshape(leaf.shape[0], -1)[:, local])
                if rows.dtype == np.uint16:
                    rows = rows.view(np.int16)
                out[what].append(torch.from_numpy(rows).view(dtype))
                del leaf
    return {k: torch.cat(v, dim=1) for k, v in out.items()}


def ranks_resume_file(d, layout, sample):
    """Phase 24's file in ``d``: (its member names, θ and m on the sampled
    columns, its bytes, the seconds the sampled read took)."""
    import zipfile

    path = d / f"step_{RANK_RESUME_CUT:010d}.npz"
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
    t1 = time.perf_counter()
    rows = file_rows(path, layout, sample)
    return names, rows, path.stat().st_size, time.perf_counter() - t1


def phase_ranks_resume(layout, sample, step0, members23, done, device=None):
    """Phase 24: G ranks (as phase 9) run RANK_RESUME_STEPS steps with a
    checkpoint after step RANK_RESUME_CUT, then restore it and resume
    (``resume_rank_run``): every rank bit for bit its uninterrupted row,
    K2 once per step on every rank.  The ranks engine's file holds the
    stacked engine's members (phase 23's names) and, on the sampled
    columns, θ and m of phase 4's state after step 0 (``step0``) bit for
    bit.  ``done``: the ranks' results, the file's (``ranks_resume_file``)
    and the ranks' seconds from ``rank_world``, the file removed
    (``device``: its ranks' device, None for the card).  Returns the
    phase's numbers."""
    import torch

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    res, (names, rows, size, read_s), wall = done
    per_rank = RANK_RESUME_STEPS + RANK_RESUME_STEPS - RANK_RESUME_CUT
    per_rank = per_rank if dev.type == "cuda" else 0
    want = {"gossip_program_update": 0, "gossip_update": per_rank,
            "segment_l2_norms": per_rank, "flash_attention": 0}
    for i, r in enumerate(res):
        if r["launches"] != want:
            fail(f"phase 24 rank {i}: launch counts {r['launches']}, expected {want}")
        if not r["equal"]:
            fail(f"phase 24 rank {i}: the resumed run differs from the uninterrupted one")
    if names != members23:
        fail(f"phase 24: the ranks engine's members {names[:4]}... differ from the stacked "
             f"engine's {members23[:4]}...")
    for what in ("theta", "mom"):
        ref = step0[what].cpu()
        if not torch.equal(rows[what], ref):
            diff = (rows[what].float() - ref.float()).abs().max()
            fail(f"phase 24: the file's {what} differs from phase 4's state after step 0 "
                 f"on the sampled columns (max abs {float(diff):.3e})")
    out = {
        "ranks": G, "transport": res[0]["transport"], "file_bytes": size,
        "gather_and_write_s": res[0]["save_s"], "read_and_scatter_s": res[0]["load_s"],
        "save_s_per_rank": [r["save_s"] for r in res],
        "load_s_per_rank": [r["load_s"] for r in res],
        "launches": {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]},
        "sampled_file_read_s": read_s, "wall_s": wall,
    }
    log(f"phase 24: {G} ranks over {out['transport']}: resumed at step {RANK_RESUME_CUT} == "
        f"each rank's uninterrupted row bit for bit; the file ({size / 1e9:.3f} GB) holds the "
        f"stacked engine's members and phase 4's state after step 0 on {len(sample)} sampled "
        f"columns; gather-and-write {out['gather_and_write_s']:.1f} s, read-and-scatter "
        f"{out['read_and_scatter_s']:.1f} s; K2 launches {out['launches']['gossip_update']}; "
        f"{wall:.1f} s")
    return out


def phase_sim_resume(dev):
    """Phase 25: phase 15's ResNet closed loop (N = 16) for
    SIM_RESUME_STEPS steps with a checkpoint after SIM_RESUME_CUT, then a
    fresh simulator restores the run state and the arrays and runs the
    rest: losses, norms, final θ and m and the controller's log bit for
    bit the uninterrupted run's.  cuDNN runs its deterministic algorithms
    here (a bit-exact replay needs a reproducible convolution backward).
    Returns (launches, numbers)."""
    import shutil

    import torch
    from repro_torch.checkpoint import (
        load_checkpoint_extra, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.simulator import DecentralizedSimulator, SimState
    from repro_torch.kernels import ops
    from repro_torch.models.paper_models import mini_resnet_loss
    from repro_torch.optim.sgd import sgd

    log(PREDICT_25)
    name = "resnet closed-loop Ada"
    params, batches = paper_inputs(name, SIM_RESUME_STEPS)
    lr = PAPER_RUNS[name]["lr"]

    def simulator():
        topo = make_topology("d_ada", PAPER_N, k0=12, k_floor="one_peer",
                             consensus_target=0.7, consensus_probe_every=5)
        return DecentralizedSimulator(mini_resnet_loss, sgd(momentum=0.9), topo,
                                      collect_norms=True, device=dev)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    d = checkpoint_dir(1 << 20)
    try:
        ops.reset_launch_counts()
        a = simulator()
        state = a.init(params)
        losses, norms = [], []
        for t, b in enumerate(batches):
            state, loss, nrm = a.train_step(state, b, lr, epoch=t // 5)
            losses.append(loss.clone())
            norms.append(nrm.clone())
            if state.step == SIM_RESUME_CUT:
                save_checkpoint(str(d), state.step, a.checkpoint_tree(state), keep=1,
                                extra=a.snapshot_extra())
        want = {"theta": state.theta, "mom": state.opt["mom"]}
        want_extra = a.snapshot_extra()
        t0 = time.perf_counter()
        b_sim = simulator()
        b_sim.restore_extra(load_checkpoint_extra(str(d)))
        fresh = b_sim.init(params)
        step = restore_checkpoint(str(d), b_sim.checkpoint_tree(fresh))
        load_s = time.perf_counter() - t0
        resumed = SimState(fresh.theta, fresh.opt, fresh.layout, step)
        for t in range(step, SIM_RESUME_STEPS):
            resumed, loss, nrm = b_sim.train_step(resumed, batches[t], lr, epoch=t // 5)
            if not (torch.equal(loss, losses[t]) and torch.equal(nrm, norms[t])):
                fail(f"phase 25: resumed step {t}: losses or norms differ from the "
                     "uninterrupted run")
        counts = ops.launch_counts()
        equal_in_chunks("phase 25 resumed", "the uninterrupted run",
                        {"theta": resumed.theta, "mom": resumed.opt["mom"]}, want)
        got_extra = b_sim.snapshot_extra()
        if got_extra != want_extra:
            fail(f"phase 25: the run state {got_extra} != {want_extra}")
        runs = 2 * SIM_RESUME_STEPS - SIM_RESUME_CUT
        if counts != {"gossip_program_update": 0, "gossip_update": 0,
                      "segment_l2_norms": runs, "flash_attention": 0}:
            fail(f"phase 25: launch counts {counts}, expected {runs} of K3")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(d, ignore_errors=True)
    ctl = want_extra["controller"]
    numbers = {"steps": SIM_RESUME_STEPS, "cut": SIM_RESUME_CUT, "probes": len(ctl["trace"]),
               "transitions": ctl["transitions"], "restore_s": load_s, "launches": counts}
    log(f"phase 25: the ResNet closed loop resumed at step {SIM_RESUME_CUT} == the "
        f"uninterrupted {SIM_RESUME_STEPS} steps bit for bit (losses, norms, theta, m, the "
        f"controller's log of {len(ctl['trace'])} probes, transitions {ctl['transitions']}); "
        f"restore {load_s:.2f} s; launches {counts}")
    return counts, numbers


def knob_run(cfg, batches, **kw):
    """KNOB_STEPS steps of phase 4's trainer (``kw`` to the trainer) from
    the seed-0 weights: (state, losses, norms, ms a step, the run's peak
    bytes above what was allocated before it)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=True, **kw)
    state = trainer.init_state(seed=0)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    for t in range(KNOB_STEPS):
        t1 = time.perf_counter()
        state, loss, nrm = trainer.train_step(state, batches[t], LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.clone())
        norms.append(nrm.clone())
    return state, torch.stack(losses), torch.stack(norms), step_ms, \
        torch.cuda.max_memory_allocated() - before


def accum_bar(layout, base, other):
    """``other`` (accum_steps 2) against ``base`` (accum_steps 1) after
    KNOB_STEPS steps, leaf by leaf.  Microbatch summation rounds each
    gradient's partial sums to bfloat16 (where two microbatches' gradients
    cancel, the element's sum can change sign) and runs the matrix products
    at another row count, so the bar is set at the scale of the leaf, not
    of the element: losses within 2 bfloat16 ulps of the loss; θ within 2
    bfloat16 ulps a step of the leaf's largest |θ|; m within 2^-6 a step
    of the leaf's largest |m| (about two bfloat16 roundings of a gradient
    a step).  Returns the worst θ error in bfloat16 ulps of its leaf's
    scale, the worst share of a bar (θ or m), the share of θ elements that
    differ, the worst loss error in bfloat16 ulps and the worst m error
    relative to its leaf's scale."""
    import torch

    (sa, la), (sb, lb) = base, other
    loss_ulps = float(((la - lb).abs() / bf16_ulp(la)).max())
    if loss_ulps > 2:
        fail(f"phase 26: accum_steps 2 losses {lb.tolist()} vs {la.tolist()}: "
             f"{loss_ulps:.2f} bf16 ulps")
    worst_ulps = worst_share = worst_m = 0.0
    differ = 0
    for name, off, size in zip(layout.names, layout.offsets[:-1], layout.sizes):
        err_t = err_m = scale_t = scale_m = 0.0
        for a in range(off, off + size, TWIN_CHUNK):
            b = min(a + TWIN_CHUNK, off + size)
            ta, tb = sa.theta[:, a:b].float(), sb.theta[:, a:b].float()
            ma, mb = sa.mom[:, a:b], sb.mom[:, a:b]
            d = (ta - tb).abs()
            err_t = max(err_t, float(d.max()))
            differ += int((d > 0).sum())
            err_m = max(err_m, float((ma - mb).abs().max()))
            scale_t = max(scale_t, float(ta.abs().max()), float(tb.abs().max()))
            scale_m = max(scale_m, float(ma.abs().max()), float(mb.abs().max()))
            del ta, tb, ma, mb, d
        ulp = float(bf16_ulp(torch.tensor(scale_t)))
        share = max(err_t / (2 * KNOB_STEPS * ulp),
                    err_m / (KNOB_STEPS * 2.0 ** -6 * scale_m) if scale_m else 0.0)
        if share > 1:
            fail(f"phase 26: accum_steps 2 differs in {name} by {err_t:.3e} (theta) and "
                 f"{err_m:.3e} (m): {share:.2f}x the bar")
        worst_ulps = max(worst_ulps, err_t / ulp)
        worst_share = max(worst_share, share)
        worst_m = max(worst_m, err_m / scale_m if scale_m else 0.0)
    return worst_ulps, worst_share, differ / sa.theta.numel(), loss_ulps, worst_m


def run_example(args):
    """``python -m <args>`` on the card, run as ``-m`` runs it (``runpy``
    with the module as ``__main__`` and ``args`` as its command line) in
    this process, whose interpreter and card context it shares: (stdout,
    seconds)."""
    import contextlib
    import io
    import runpy

    t0 = time.perf_counter()
    out, argv = io.StringIO(), sys.argv
    try:
        sys.argv = [args[0]] + list(args[1:])
        with contextlib.redirect_stdout(out):
            runpy.run_module(args[0], run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (None, 0):
            fail(f"python -m {' '.join(args)} exited {e.code}: {out.getvalue()[-2000:]}")
    finally:
        sys.argv = argv
    return out.getvalue(), time.perf_counter() - t0


def phase_knobs(cfg, layout, batches):
    """Phase 26: phase 4's trainer for KNOB_STEPS steps with accum_steps 1
    and 2 (``accum_bar``) and with remat on (bit for bit remat off), ms a
    step and peak per variant; then the two examples as modules on the
    card (the quickstart's loss must fall).  The launch counters are zeroed
    before the three runs and read after them.  Returns (launches,
    numbers)."""
    import re

    import torch
    from repro_torch.kernels import ops

    log(PREDICT_26)
    ops.reset_launch_counts()
    base = knob_run(cfg, batches)
    accum = knob_run(cfg, batches, accum_steps=2)
    ulps, share, differ, loss_ulps, m_rel = accum_bar(layout, base[:2], accum[:2])
    accum_numbers = {"step_ms": accum[3], "peak_bytes": int(accum[4])}
    del accum
    torch.cuda.empty_cache()
    remat = knob_run(dataclasses.replace(cfg, remat=True), batches)
    counts = ops.launch_counts()
    if not (torch.equal(remat[1], base[1]) and torch.equal(remat[2], base[2])):
        fail("phase 26: remat losses or norms differ from the run without remat")
    equal_in_chunks("phase 26 remat", "the run without remat",
                    {"theta": remat[0].theta, "mom": remat[0].mom},
                    {"theta": base[0].theta, "mom": base[0].mom})
    runs = 3 * KNOB_STEPS
    if counts != {"gossip_program_update": runs, "gossip_update": 0,
                  "segment_l2_norms": runs, "flash_attention": 0}:
        fail(f"phase 26: launch counts {counts}, expected {runs} of K1 and K3")
    variants = {
        "accum_steps 1": {"step_ms": base[3], "peak_bytes": int(base[4])},
        "accum_steps 2": accum_numbers,
        "remat": {"step_ms": remat[3], "peak_bytes": int(remat[4])},
    }
    del base, remat
    torch.cuda.empty_cache()
    quick, quick_s = run_example(["repro_torch.examples.quickstart", "--steps",
                                  str(QUICK_STEPS)])
    m = re.search(r"final mean-replica loss: ([0-9.]+) \(from ([0-9.]+)\)", quick)
    if m is None or not float(m.group(1)) < float(m.group(2)):
        fail(f"phase 26: the quickstart's loss did not fall: {quick[-500:]}")
    white, white_s = run_example(["repro_torch.examples.dbench_whitebox", "--steps",
                                  str(EXAMPLE_STEPS)])
    if "variance-rank integration" not in white:
        fail(f"phase 26: dbench_whitebox printed no rank table: {white[-500:]}")
    numbers = {
        "variants": variants, "launches": counts,
        "accum": {"theta_bf16_ulps": ulps, "share_of_bar": share, "theta_differing_share": differ,
                  "loss_bf16_ulps": loss_ulps, "mom_rel_err": m_rel},
        "quickstart": {"loss_from": float(m.group(2)), "loss_to": float(m.group(1)),
                       "seconds": quick_s},
        "dbench_whitebox": {"steps": EXAMPLE_STEPS, "seconds": white_s},
    }
    log(f"phase 26: remat == no remat bit for bit; accum_steps 2 within its bar (theta "
        f"{ulps:.2f} bf16 ulps of its leaf's scale, {differ:.4f} of the elements differ; m "
        f"{m_rel:.3e} of its leaf's scale; {share:.3f} of the bar; losses {loss_ulps:.2f} "
        f"bf16 ulps); ms a step / peak GiB: "
        + "; ".join(f"{k} {[round(x, 1) for x in v['step_ms']]} / {v['peak_bytes'] / 2**30:.2f}"
                    for k, v in variants.items())
        + f"; quickstart loss {m.group(2)} -> {m.group(1)} ({quick_s:.1f} s), dbench_whitebox "
          f"--steps {EXAMPLE_STEPS} ({white_s:.1f} s); launches {counts}")
    return counts, numbers


# ---------------------------------------------------------------------------
# phases 27-30: the model zoo at published widths, depth cut
# ---------------------------------------------------------------------------

ZOO_STEPS = 3                     # training steps of each zoo phase
ZOO_BUDGET = 75 * 2 ** 30         # phase 27 runs G = 4 if its bytes fit here
ZOO_DEC_B, ZOO_DEC_S = 2, 32      # decode-vs-forward batch and length (float32)
MOE_CAPACITY_DEC = 16.0           # the reference test's capacity factor there
# (arch, layers trained, layers served, prefill batch, prompt length,
#  new tokens); the VLM's prompts carry its n_patches patch embeddings first
ZOO = {
    27: ("phi3.5-moe-42b-a6.6b", 1, 1, 2, 512, 16),
    28: ("rwkv6-1.6b", 4, 8, 4, 2048, 32),
    29: ("zamba2-7b", 7, 7, 2, 2048, 32),
    30: ("internvl2-2b", 2, 24, 2, 512, 16),
}
ZOO_NOISE = 0.03                  # phase 31: replicas pushed apart for the mix check

PREDICT_27 = (
    "phase 27 prediction (PERF.md §6): phi3.5-moe x1 layer bf16, 1.563e9 params/node: "
    "G = 4 fits (theta, grad, wire bf16, m f32: 62.5 GB = 58.2 GiB), peak 59-64 GiB; "
    "step 250-450 ms (K1 ~38 ms of a 30 ms bound, the plain wire 60-100 ms); K3 ~4 ms; "
    "prefill 2x512 0.02-0.1 s, decode 2-8 ms a token (host-bound); 0-3 % of the top-2 "
    "assignments dropped at capacity factor 1.25; decode == forward in f32")
PREDICT_28 = (
    "phase 28 prediction (PERF.md §6): rwkv6 x4 layers bf16, 0.487e9 params/node, G = 4: "
    "state 19.5 GB, step 250-600 ms (the chunked WKV, eager); K1 ~12 ms; serving x24: "
    "prefill 4x2048 0.5-2 s, decode 10-20 ms a token; decode == forward")
PREDICT_29 = (
    "phase 29 prediction (PERF.md §6): zamba2 x7 layers bf16, 0.903e9 params/node, mixed "
    "dtypes: float32 state (16 B a parameter a node: 57.8 GB = 53.8 GiB), peak 55-62 GiB, "
    "step 300-600 ms (K1 on f32 theta ~34 ms of a 26 ms bound, the bf16 leaves' rounding "
    "20-30 ms); the reduced card step == the CPU's; prefill 2x2048 0.3-1.5 s, decode "
    "5-15 ms a token")
PREDICT_30 = (
    "phase 30 prediction (PERF.md §6): internvl2 x24 bf16 serving with 1024 patches: "
    "prefill 2x(1024+512) 0.1-0.4 s, decode 6-15 ms a token; x2 training G = 4 with "
    "patch_embeds: step 150-300 ms; the ten reduced archs' loss, gradients and one decode "
    "step == the CPU port within 5e-5 (+ their float32 rounding for ssm/hybrid)")


def zoo_cfg(arch, layers, dtype=None, **kw):
    """``arch`` at its published width with the depth cut to ``layers``."""
    import torch
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=layers, remat=False,
                               dtype=dtype or torch.bfloat16, **kw)


def zoo_batches(cfg, g, steps, dev):
    """``steps`` seeded (G, BATCH, SEQ) batches; a VLM's with seeded
    (G, BATCH, n_patches, D) patch embeddings."""
    import torch
    from repro_torch.data import SyntheticLM

    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    out = []
    for t in range(steps):
        b = {k: torch.as_tensor(v, device=dev) for k, v in src.stacked(g, t, BATCH).items()}
        if cfg.input_kind == "vlm":
            gen = torch.Generator(device=dev).manual_seed(100 + t)
            b["patch_embeds"] = (0.1 * torch.randn((g, BATCH, cfg.n_patches, cfg.d_model),
                                                   generator=gen, device=dev)).to(cfg.dtype)
        out.append(b)
    return out


def zoo_state_bytes(layout, g):
    """θ, gradient and wire in the state's dtype and m in float32, G nodes."""
    import torch

    eb = torch.empty((), dtype=layout.state_dtype).element_size()
    return g * layout.size * (3 * eb + 4)


def zoo_train(label, cfg, g, dev, steps=None):
    """``steps`` (ZOO_STEPS) fused steps of ``cfg`` on d_ring with G = ``g`` from the
    seed-0 weights, the launch counters zeroed just before and read just
    after.  Returns (trainer, state, batches, numbers)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    steps = ZOO_STEPS if steps is None else steps
    trainer = SPMDTrainer(cfg, make_topology("d_ring", g), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=True)
    layout = trainer.layout
    need = zoo_state_bytes(layout, g)
    log(f"{label}: {cfg.name} x{cfg.n_layers} layers {cfg.dtype}, {layout.size:,} "
        f"params/node, G={g}, state dtype {layout.state_dtype}"
        f"{' (mixed leaf dtypes)' if layout.mixed else ''}: theta, grad, wire and m "
        f"{need / 2**30:.2f} GiB")
    state = trainer.init_state(seed=0)
    batches = zoo_batches(cfg, g, steps, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms, losses = [], []
    for t in range(steps):
        t1 = time.perf_counter()
        state, loss, norms = trainer.train_step(state, batches[t], LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.tolist())
        if not bool(torch.isfinite(loss).all()) or not bool(torch.isfinite(norms).all()):
            fail(f"{label} step {t}: non-finite loss {loss.tolist()} or norms")
        if tuple(norms.shape) != (g, len(layout.names)):
            fail(f"{label}: norms shape {tuple(norms.shape)}")
    counts = ops.launch_counts()
    want = {"gossip_program_update": steps, "gossip_update": 0,
            "segment_l2_norms": steps, "flash_attention": 0}
    if counts != want:
        fail(f"{label}: launch counts {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: steps {[round(x, 1) for x in step_ms]} ms, losses "
        f"{[[round(x, 4) for x in l] for l in losses]}, peak {peak / 2**30:.2f} GiB, "
        f"launches {counts}")
    return trainer, state, batches, {
        "model": f"{cfg.name} x{cfg.n_layers} layers, {cfg.dtype}, G={g}, d_ring, seq {SEQ}, "
                 f"per-node batch {BATCH}, fused_apply, collect_norms",
        "params_per_node": layout.size, "state_dtype": str(layout.state_dtype),
        "mixed_leaf_dtypes": layout.mixed, "predicted_state_bytes": need,
        "step_ms": step_ms, "losses": losses, "peak_allocated_bytes": int(peak),
        "launches": counts,
    }


def zoo_kernel_twins(label, trainer, state, batch):
    """K1 against its twin on the run's state: on a column slice off the
    16-byte alignment in the middle of it (a strided view, row stride P:
    ``k1_slice_against_twin``, bit for bit, post and pre, all-ones and
    masked; the whole-state launch, row offsets past 2^31, is phase 6's);
    K3 over the whole state against its twin (1e-5 relative).  Returns
    {k1_err, k3_err (max abs), the checks' peak allocated bytes}."""
    import torch
    from repro_torch.kernels.stats import segment_l2_norms, segment_l2_norms_plain

    theta, mom = state.theta, state.mom
    torch.cuda.reset_peak_memory_stats()
    grad = torch.empty_like(theta)
    trainer._grads_into(theta, grad, batch)
    srcs, w = ring_tables(theta.device)
    p = theta.shape[1]
    a = p // 2 + 3
    err1 = k1_slice_against_twin(f"{label} misaligned", theta, mom, grad, srcs, w,
                                 a, a + min(TWIN_CHUNK, p // 4))
    del grad
    offs = trainer.layout.offsets
    want = segment_l2_norms_plain(theta, offs)
    got = segment_l2_norms(theta, offs)
    err = (got - want).abs()
    if not bool((err <= 1e-5 * want.abs()).all()):
        fail(f"{label}: K3 differs from its twin by {float((err / want.abs()).max()):.3e}")
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: K1 == twin on a misaligned strided slice of the {tuple(theta.shape)} "
        f"state (max abs {err1:.3e}); K3 == twin over {len(offs) - 1} leaves "
        f"(max rel {float((err / want.abs().clamp_min(1e-30)).max()):.3e}); peak "
        f"{peak / 2**30:.2f} GiB")
    return {"k1_err": err1, "k3_err": float(err.max()), "twin_check_peak_allocated_bytes": peak}


def zoo_kernel_times(trainer, state, batch):
    """K1 and K3 timed at the run's shapes (CUDA events) beside their twins,
    with the bound of each from this state's bytes and operations; then
    one more step under torch.profiler: device time by kernel group and
    the idle share (the state takes the step)."""
    import torch
    from repro_torch.kernels import cost
    from repro_torch.kernels.gossip_update import (
        gossip_program_update, gossip_program_update_plain, gossip_wire,
    )
    from repro_torch.kernels.stats import segment_l2_norms, segment_l2_norms_plain

    theta, mom = state.theta, state.mom
    grad = torch.empty_like(theta)
    trainer._grads_into(theta, grad, batch)
    wire = gossip_wire(theta, grad, mom, lr=LR, beta=0.9)
    srcs, w = ring_tables(theta.device)
    kw = dict(lr=LR, beta=0.9, fault=torch.ones_like(w), mix_order="post")
    k1_ms = cuda_ms(lambda: gossip_program_update(theta, wire, srcs, w, grad, mom, **kw), 3)
    p = theta.shape[1]

    def plain():
        for a in range(0, p, TWIN_CHUNK):
            b = min(a + TWIN_CHUNK, p)
            gossip_program_update_plain(theta[:, a:b], wire[:, a:b], srcs, w, grad[:, a:b],
                                        mom[:, a:b], **kw)

    k1_plain = cuda_ms(plain, 1)
    n_el, eb, deg = theta.numel(), theta.element_size(), srcs.shape[1]
    k1_bytes, k1_ops = cost.k1_cost(theta.shape[0], theta.shape[1], eb, deg)
    del grad, wire
    offs = trainer.layout.offsets
    k3_ms = cuda_ms(lambda: segment_l2_norms(theta, offs), 5)
    k3_plain = cuda_ms(lambda: segment_l2_norms_plain(theta, offs), 1)
    k3_bytes, k3_ops = cost.k3_cost(theta.shape[0], offs, eb)
    bound = lambda by, op: 1e3 * max(by / HBM_BYTES_PER_S, op / F32_OPS_PER_S)
    prof = profile_breakdown(lambda: trainer.train_step(state, batch, LR))
    return {"step_profile": prof,
            "k1_ms": k1_ms, "k1_plain_ms": k1_plain, "k1_bound_ms": bound(k1_bytes, k1_ops),
            "k3_ms": k3_ms, "k3_plain_ms": k3_plain, "k3_bound_ms": bound(k3_bytes, k3_ops),
            "state_elements": n_el, "state_element_bytes": eb}


def zoo_serve(label, cfg, b, s, n_new, dev, patches=False):
    """Serving ``cfg`` (bf16, seed-0 weights): prefill of b prompts of s
    tokens (a VLM's n_patches patch embeddings first), twice (the first
    includes the libraries' start-up), then n_new greedy decode steps
    after the prompt, in a decode state grown to hold them.  No K1-K4
    launch may happen.  Returns numbers."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeEngine, grow_caches
    from repro_torch.models import transformer as tfm

    eng = ServeEngine(cfg, dev)
    params = eng.init_params(seed=0)
    n_params = sum(t.numel() for t in params.values())
    gen = torch.Generator(device=dev).manual_seed(12)
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    pe = None
    if patches:
        pe = (0.1 * torch.randn((b, cfg.n_patches, cfg.d_model), generator=gen,
                                device=dev)).to(cfg.dtype)
    n_prompt = s + (cfg.n_patches if pe is not None else 0)
    before = ops.launch_counts()
    prefill = eng.prefill_fn()
    prefill_s, peak = [], 0
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last, state = prefill(params, prompts, pe)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
        if tuple(last.shape) != (b, cfg.vocab) or not bool(torch.isfinite(last).all()):
            fail(f"{label}: prefill logits {tuple(last.shape)} not finite or misshaped")
    state = grow_caches(state, n_prompt + n_new)
    step = eng.decode_fn(None)
    toks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n_new):
        tok = torch.argmax(last, dim=-1)[:, None]
        toks.append(tok)
        last, state = step(params, tok, n_prompt + t, state)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_new
    toks = torch.cat(toks, dim=1)
    if not bool(torch.isfinite(last).all()) or not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"{label}: decode gave non-finite logits or tokens outside the vocabulary")
    after = ops.launch_counts()
    if after != before:
        fail(f"{label}: serving launched kernels: {before} -> {after}")
    log(f"{label}: serving {cfg.name} x{cfg.n_layers} layers bf16 ({n_params:,} params): "
        f"prefill {b}x{n_prompt} {[round(x, 3) for x in prefill_s]} s, peak "
        f"{peak / 2**30:.2f} GiB; {n_new} decode steps {decode_ms:.2f} ms a token")
    del params, state, last
    return {"model": f"{cfg.name} x{cfg.n_layers} layers, bf16, seed-0 weights",
            "params": n_params, "prefill_batch": b, "prefill_len": n_prompt,
            "prefill_s": prefill_s, "prefill_peak_allocated_bytes": int(peak),
            "decode_tokens": n_new, "decode_ms_per_token": decode_ms}


def zoo_decode_vs_forward(label, cfg, dev):
    """``cfg`` in float32 (TF32 off; MoE at capacity factor 16): the decode
    chain over ZOO_DEC_S tokens against ``forward``'s logits at the
    reference test's bar (atol 3e-3, rtol 1e-3).  Returns the max abs err."""
    import torch
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import transformer as tfm

    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CAPACITY_DEC)
    eng = ServeEngine(cfg, dev)
    params = eng.init_params(seed=0)
    tokens = torch.randint(0, cfg.vocab, (ZOO_DEC_B, ZOO_DEC_S),
                           generator=torch.Generator(device=dev).manual_seed(13), device=dev)
    with torch.no_grad():
        full = tfm.forward(params, cfg, tokens)
        state = tfm.init_decode_state(cfg, ZOO_DEC_B, ZOO_DEC_S, device=dev)
        dec = torch.stack([tfm.decode_step(params, cfg, tokens[:, t:t + 1], t, state)[0]
                           for t in range(ZOO_DEC_S)], dim=1)
    err = (dec - full).abs()
    if not bool((err <= 3e-3 + 1e-3 * full.abs()).all()):
        fail(f"{label}: decode chain differs from forward by {float(err.max()):.3e}")
    log(f"{label}: decode chain == forward ({cfg.name} width, {cfg.n_layers} layers, f32, "
        f"{ZOO_DEC_B}x{ZOO_DEC_S}): max abs err {float(err.max()):.3e}")
    return float(err.max())


def moe_dropped(cfg, dev, b, s):
    """Assignments past the expert capacity (capacity factor
    ``cfg.capacity_factor``) in every layer's MoE over a forward of b
    seeded prompts of s tokens: (dropped, assignments)."""
    import torch
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import moe, transformer as tfm

    eng = ServeEngine(cfg, dev)
    params = eng.init_params(seed=0)
    tokens = torch.randint(0, cfg.vocab, (b, s),
                           generator=torch.Generator(device=dev).manual_seed(12), device=dev)
    seen = [0, 0]
    orig = moe.dispatch_slots

    def counting(ids, n_experts, capacity):
        out = orig(ids, n_experts, capacity)
        seen[0] += int((~out[3]).sum())
        seen[1] += out[3].numel()
        return out

    moe.dispatch_slots = counting
    try:
        with torch.no_grad():
            tfm.forward(params, cfg, tokens)
    finally:
        moe.dispatch_slots = orig
    del params
    return seen[0], seen[1]


def phase_moe(dev):
    """Phase 27: phi3.5-moe at its published width, 1 layer, bf16."""
    import torch

    from repro_torch.core.flat import FlatLayout
    from repro_torch.models import transformer as tfm

    arch, layers, serve_layers, pb, ps, n_new = ZOO[27]
    cfg = zoo_cfg(arch, layers)
    layout = FlatLayout.of_defs(tfm.model_defs(cfg))
    g = 4 if zoo_state_bytes(layout, 4) <= ZOO_BUDGET else 2
    if g != G:
        fail(f"phase 27: G = {g}: the d_ring tables of the twin checks are G = {G}'s")
    trainer, state, batches, out = zoo_train("phase 27", cfg, g, dev)
    out.update(zoo_kernel_twins("phase 27", trainer, state, batches[0]))
    out.update(zoo_kernel_times(trainer, state, batches[0]))
    del trainer, state, batches
    torch.cuda.empty_cache()
    out["serve"] = zoo_serve("phase 27", zoo_cfg(arch, serve_layers), pb, ps, n_new, dev)
    dropped, total = moe_dropped(zoo_cfg(arch, serve_layers), dev, pb, ps)
    out["dropped_assignments"] = {"dropped": dropped, "assignments": total,
                                  "capacity_factor": cfg.capacity_factor}
    log(f"phase 27: {dropped} of {total} top-{cfg.top_k} assignments dropped at capacity "
        f"factor {cfg.capacity_factor} over {pb}x{ps} tokens")
    torch.cuda.empty_cache()
    out["decode_vs_forward_max_abs_err"] = zoo_decode_vs_forward(
        "phase 27", zoo_cfg(arch, layers, torch.float32), dev)
    torch.cuda.empty_cache()
    return out


def phase_ssm(dev):
    """Phase 28: rwkv6 at its published width: training at 4 layers, serving
    at the full 24."""
    import torch

    arch, layers, serve_layers, pb, ps, n_new = ZOO[28]
    trainer, state, batches, out = zoo_train("phase 28", zoo_cfg(arch, layers), G, dev)
    out.update(zoo_kernel_twins("phase 28", trainer, state, batches[0]))
    out.update(zoo_kernel_times(trainer, state, batches[0]))
    del trainer, state, batches
    torch.cuda.empty_cache()
    out["serve"] = zoo_serve("phase 28", zoo_cfg(arch, serve_layers), pb, ps, n_new, dev)
    torch.cuda.empty_cache()
    out["decode_vs_forward_max_abs_err"] = zoo_decode_vs_forward(
        "phase 28", zoo_cfg(arch, 2, torch.float32), dev)
    torch.cuda.empty_cache()
    return out


def mixed_start(trainer, seed=0):
    """The seed-0 replicas pushed apart by ZOO_NOISE, each leaf rounded
    back to its dtype: a state whose mix moves every element."""
    state = trainer.init_state(seed=seed)
    offset_nodes(state.theta, ZOO_NOISE)
    trainer.layout.round_leaves_(state.theta)
    return state


def phase_hybrid_cpu(dev):
    """zamba2-reduced in bfloat16 (mixed leaf dtypes): one fused trainer step
    on the card (K1) and on the CPU (its twin) from the same seed-0 weights
    on the same gradients (the CPU's): the float32 leaves (a_log, d_skip) stay
    float32 and equal the CPU's within 1e-6 relative, the bfloat16 leaves
    within one bfloat16 ulp (plus float32 rounding at the leaf's scale)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.dsgd import make_topology
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_config("zamba2-7b-reduced"), dtype=torch.bfloat16,
                              remat=False)
    params = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0).stacked(G, 0, 2)
    runs, grads = {}, {}
    for where in ("cpu", dev):
        trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                              fused_apply=True, device=where)
        own = trainer._grads_into

        def grads_into(theta, grad, b, own=own):
            losses = own(theta, grad, b)
            if "cpu" in grads:
                grad.copy_(grads["cpu"])
            else:
                grads["cpu"] = grad.clone()
            return losses

        trainer._grads_into = grads_into
        state, _, _ = trainer.train_step(trainer.init_state(params=params), batch, LR)
        runs[str(where)] = (trainer, state)
    (tc, sc), (tg, sg) = runs["cpu"], runs[str(dev)]
    worst = {}
    for (name, a), b, dt in zip(tc.stacked_params(sc).items(),
                                tg.stacked_params(sg).values(), tc.layout.dtypes):
        want, got = a.float(), b.float().cpu()
        scale = float(want.abs().max())
        err = (got - want).abs()
        if dt == torch.float32:
            if b.dtype != torch.float32 or not bool((err <= 1e-6 * scale).all()):
                fail(f"phase 29: reduced {name} (float32) on the card off the CPU's by "
                     f"{float(err.max()):.3e}")
        elif not bool((err <= bf16_ulp(want) + 1e-6 * scale).all()):
            fail(f"phase 29: reduced {name} (bfloat16) on the card off the CPU's by "
                 f"{float(err.max()):.3e}")
        worst[str(dt)] = max(worst.get(str(dt), 0.0), float(err.max()))
    f32 = [n for n, dt in zip(tc.layout.names, tc.layout.dtypes) if dt == torch.float32]
    log(f"phase 29: zamba2-reduced bf16 (float32 leaves {f32}), one fused step on the card "
        f"== the CPU's on the same gradients: max abs err by dtype {worst}")
    return {"f32_leaves": f32, "max_abs_err_by_dtype": worst}


def phase_hybrid(dev):
    """Phase 29: zamba2 at its published width, 7 layers (one group of 5
    Mamba2 blocks and the shared attention block, one tail block), bf16
    with float32 a_log/d_skip: the mixed-dtype flat state."""
    import torch

    arch, layers, serve_layers, pb, ps, n_new = ZOO[29]
    cfg = zoo_cfg(arch, layers)
    trainer, state, batches, out = zoo_train("phase 29", cfg, G, dev)
    views = trainer.layout.leaf_views(state.theta[0])
    f32 = sorted(k for k, v in views.items() if v.dtype == torch.float32)
    if state.theta.dtype != torch.float32 or f32 != sorted(
            ["mamba_groups.a_log", "mamba_groups.d_skip", "tail_mamba.a_log",
             "tail_mamba.d_skip"]):
        fail(f"phase 29: state {state.theta.dtype}, float32 leaves {f32}")
    narrow = torch.cat([state.theta[:, a:b] for a, b, _ in trainer.layout.narrow_leaves()],
                       dim=1)
    if not torch.equal(narrow, narrow.bfloat16().float()):
        fail("phase 29: a bfloat16 leaf holds a value that is not a bfloat16")
    del narrow, views
    out["f32_leaves"] = f32
    out.update(zoo_kernel_twins("phase 29", trainer, state, batches[0]))
    out.update(zoo_kernel_times(trainer, state, batches[0]))
    # the fused step against the interpreter on this mixed state: phase 31's
    # crash-and-rejoin step (K1 with fault rows, the same replicas)
    del state, trainer, batches
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = phase_hybrid_cpu(dev)
    out["serve"] = zoo_serve("phase 29", zoo_cfg(arch, serve_layers), pb, ps, n_new, dev)
    torch.cuda.empty_cache()
    out["decode_vs_forward_max_abs_err"] = zoo_decode_vs_forward(
        "phase 29", zoo_cfg(arch, layers, torch.float32), dev)
    torch.cuda.empty_cache()
    return out


def reduced_parity(dev):
    """The ten reduced archs (float32, seed-0 weights): loss, every gradient
    and one decode step on the card against the CPU port on the same
    inputs, within 5e-5; for ssm and hybrid plus twice the CPU's own
    float32 rounding against its float64 run (heads whose variance sits
    near the group norm's epsilon amplify rounding, as on the CPU against
    the reference), a bar the card's run cannot widen.  Their float64
    runs (the port computes everything in float64 there) are held to each
    other within 1e-9 of each array's scale.  Returns {arch: {dtype:
    worst errors}}."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models import transformer as tfm

    def run(cfg, params, batch, where, dtype):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = {k: v.to(where, dtype).requires_grad_() for k, v in params.items()}
        b = {k: (v.to(where, dtype) if v.is_floating_point() else v.to(where))
             for k, v in batch.items()}
        loss = tfm.loss_fn(p, c, b)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            pd = {k: v.detach() for k, v in p.items()}
            state = tfm.init_decode_state(c, 2, 4, device=where)
            logits, _ = tfm.decode_step(pd, c, b["tokens"][:, :1], 0, state)
        return (np.float64(loss.detach().cpu()),
                {k: g.double().cpu().numpy() for k, g in zip(p, grads)},
                logits.double().cpu().numpy())

    worst = {}
    for arch in ARCH_NAMES:
        cfg = dataclasses.replace(get_config(arch + "-reduced"), remat=False)
        params = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen),
                 "targets": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
        if cfg.input_kind == "vlm":
            batch["patch_embeds"] = 0.1 * torch.randn((2, cfg.n_patches, cfg.d_model),
                                                      generator=gen)
        cpu = {torch.float32: run(cfg, params, batch, "cpu", torch.float32)}
        # bar(want, the CPU's float32 rounding of it): float32 runs 5e-5 plus
        # twice that rounding, float64 runs 1e-9 of the array's scale
        bars = {torch.float32: lambda want, r: 5e-5 + 2 * r}
        rounding = (0.0, {k: 0.0 for k in cpu[torch.float32][1]}, 0.0)
        if cfg.family in ("ssm", "hybrid"):
            cpu[torch.float64] = run(cfg, params, batch, "cpu", torch.float64)
            bars[torch.float64] = lambda want, r: 1e-9 * float(np.abs(want).max())
            (_, g32, d32), (_, g64, d64) = cpu[torch.float32], cpu[torch.float64]
            rounding = (0.0, {k: float(np.abs(g32[k] - g64[k]).max()) for k in g32},
                        float(np.abs(d32 - d64).max()))
        worst[arch] = {}
        for dt, (lc, gc, dc) in cpu.items():
            lg, gg, dg = run(cfg, params, batch, dev, dt)
            bar = bars[dt]
            name = str(dt).replace("torch.", "")
            if abs(lc - lg) > bar(lc, rounding[0]):
                fail(f"phase 30: {arch}-reduced {name} loss on the card {lg} vs the CPU's {lc}")
            share, err, at, at_bar = -1.0, 0.0, None, None
            for k in gc:
                e, b = float(np.abs(gg[k] - gc[k]).max()), bar(gc[k], rounding[1][k])
                if e > b:
                    fail(f"phase 30: {arch}-reduced {name} gradient {k} on the card off the "
                         f"CPU's by {e:.3e} (bar {b:.3e})")
                if b > 0 and e / b > share:   # the leaf nearest its bar
                    share, err, at, at_bar = e / b, e, k, b
            e_dec, b_dec = float(np.abs(dg - dc).max()), bar(dc, rounding[2])
            if e_dec > b_dec:
                fail(f"phase 30: {arch}-reduced {name} decode step on the card off the CPU's "
                     f"by {e_dec:.3e} (bar {b_dec:.3e})")
            worst[arch][name] = {"loss": float(abs(lc - lg)), "grad": err, "grad_leaf": at,
                                 "grad_bar": at_bar, "decode": e_dec, "decode_bar": b_dec}
    log(f"phase 30: ten reduced archs, card == CPU (loss, gradients, one decode step): "
        f"{json.dumps(worst)}")
    return worst


def phase_vlm(dev):
    """Phase 30: internvl2 served at its full 24 layers with 1024 patch
    embeddings, trained one step at 2 layers with patch_embeds in the
    batch; then the ten reduced archs, card against CPU."""
    import torch

    arch, layers, serve_layers, pb, ps, n_new = ZOO[30]
    out = {"serve": zoo_serve("phase 30", zoo_cfg(arch, serve_layers), pb, ps, n_new, dev,
                              patches=True)}
    torch.cuda.empty_cache()
    # one step with patch embeddings in the batch
    trainer, state, batches, train = zoo_train("phase 30", zoo_cfg(arch, layers), G, dev,
                                               steps=1)
    train.update(zoo_kernel_twins("phase 30", trainer, state, batches[0]))
    out["train"] = train
    del trainer, state, batches
    torch.cuda.empty_cache()
    out["decode_vs_forward_max_abs_err"] = zoo_decode_vs_forward(
        "phase 30", zoo_cfg(arch, layers, torch.float32), dev)
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = reduced_parity(dev)
    return out


MIXED_BUCKET_MBS = (64,)          # phase 31: bucket sizes on the mixed state
MIXED_STEPS = 2                   # phase 31: steps of each run
REJOIN_STEP = 2                   # FAULT_RANK_MODEL's rejoin: node 2 back at step 2
SIM_MIXED_LAYERS = 7              # phase 32: the simulator holds zamba2 at the trainer's depth

PREDICT_31 = (
    "phase 31 prediction (PERF.md §6): zamba2 x7 bf16 mixed float32 state, G = 4, "
    "fused: bucket_mb 256 and 64 bit for bit the monolithic step (theta, m, losses, norms), "
    "K1 once per bucket (14 and 54 buckets a step); step 700-1200 ms monolithic, "
    "+0-10 % at 256 MiB, +5-25 % at 64 MiB (host dispatch and the runs' rounding per "
    "bucket); peak 54-58 GiB monolithic, 40-48 GiB bucketed (no whole-state wire); every "
    "narrow leaf a bf16 value after each step; a crash-and-rejoin step within phase 19's "
    "bound of the masked interpreter, its handoff (theta and m) 60-200 ms")
PREDICT_32 = (
    "phase 32 prediction (PERF.md §6): the simulator on zamba2 x7 bf16 (mixed float32 "
    "state, stacked mixing, one node's gradients at a time), 3 steps bit for bit the "
    "trainer's interpreter steps; step 1.0-2.0 s, peak 50-65 GiB; K3 once a step; the "
    "reduced bf16 simulator on the card bit for bit the CPU's")
PREDICT_33 = (
    "phase 33 prediction (PERF.md §6): python -m repro_torch.analysis --all passes on "
    "cuda (10-40 s, 8 ranks over gloo-host for the collectives); the card's limits are the "
    "budget's (grid 2^31-1 x 65535 x 65535, 232448 B opt-in, 1024 threads); K1/K2 16-40 "
    "registers a thread, no shared memory; K3 16-40 registers, 32 B static; K4 f32 "
    "64-128 registers and 118784 B at D = 128, bf16 <= 168 registers and 164928 B; 0 nvcc "
    "builds and 0 new device tables after warm-up over phase 4's trainer and a closed "
    "loop; serve_decode runs")


def narrow_exact(label, theta, layout):
    """Fail unless every narrower leaf's columns of the (rows, P) ``theta``
    hold values of the leaf's dtype, TWIN_CHUNK columns at a time."""
    import torch

    for a, b, dt in layout.narrow_leaves():
        for c in range(a, b, TWIN_CHUNK):
            d = min(c + TWIN_CHUNK, b)
            x = theta[:, c:d].to(theta.device)
            if not torch.equal(x, x.to(dt).float()):
                fail(f"{label}: columns {c}:{d} ({dt} leaf) hold values that are not {dt}")


def host(x):
    """A copy of ``x`` in host memory."""
    import torch

    return torch.empty(x.shape, dtype=x.dtype, device="cpu").copy_(x)


def mixed_run(cfg, batches, **kw):
    """MIXED_STEPS fused steps of ``cfg`` on d_ring (G = 4) from
    ``mixed_start``'s replicas with ``kw`` for the trainer, every narrow
    leaf checked after each step; the launch counters zeroed just before
    the steps and read just after.  Returns (trainer, state, losses, norms,
    numbers)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=True, **kw)
    state = mixed_start(trainer)
    dev = state.theta.device
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_ms, losses, norms = [], [], []
    for t in range(MIXED_STEPS):
        t1 = time.perf_counter()
        state, loss, nrm = trainer.train_step(state, batches[t], LR)
        sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
        norms.append(nrm)
        narrow_exact(f"phase 31 {kw} step {t}", state.theta, trainer.layout)
    buckets = 1 if trainer._bucket_layout is None else trainer._bucket_layout.num_buckets
    return trainer, state, torch.stack(losses), torch.stack(norms), {
        "step_ms": step_ms, "peak_allocated_bytes": int(torch.cuda.max_memory_allocated()),
        "launches": ops.launch_counts(), "buckets": buckets}


def phase_mixed_buckets(dev):
    """Phase 31: zamba2 at its published width (phase 29's 7 layers, bf16
    with float32 a_log/d_skip: the mixed float32 state), G = 4, d_ring,
    fused apply, seq 512, per-node batch 2.  MIXED_STEPS steps from
    ``mixed_start``'s replicas monolithic and at each of MIXED_BUCKET_MBS:
    θ, m, losses and norms bit for bit the monolithic run's (which waits
    in host memory), K1 once per bucket and step, every narrow leaf a
    value of its dtype after each step.  Then a crash-and-rejoin step
    (FAULT_RANK_MODEL's rejoin at REJOIN_STEP) on the same replicas: the
    handoff's rows rounded, the fused step within phase 19's bound of the
    masked interpreter (both from host memory): the fused step against the
    interpreter on the mixed state."""
    import torch

    arch, layers = ZOO[29][:2]
    cfg = zoo_cfg(arch, layers)
    batches = zoo_batches(cfg, G, MIXED_STEPS, dev)
    out, ref = {}, None
    counts = {}
    for mb in (None,) + MIXED_BUCKET_MBS:
        trainer, state, losses, norms, numbers = mixed_run(cfg, batches, bucket_mb=mb)
        want_k1 = MIXED_STEPS * numbers["buckets"]
        if numbers["launches"] != {"gossip_program_update": want_k1, "gossip_update": 0,
                                   "segment_l2_norms": MIXED_STEPS, "flash_attention": 0}:
            fail(f"phase 31 bucket_mb={mb}: launches {numbers['launches']}, expected "
                 f"{want_k1} of K1 and {MIXED_STEPS} of K3")
        counts = {k: counts.get(k, 0) + v for k, v in numbers["launches"].items()}
        if ref is None:
            ref = {"theta": host(state.theta), "mom": host(state.mom), "losses": losses,
                   "norms": norms}
        else:
            if not (torch.equal(losses, ref["losses"]) and torch.equal(norms, ref["norms"])):
                fail(f"phase 31 bucket_mb={mb}: losses or norms differ from the monolithic run")
            equal_in_chunks(f"phase 31 bucket_mb={mb}", "the monolithic run",
                            {"theta": state.theta, "mom": state.mom}, ref)
        out[f"bucket_mb={mb}"] = numbers
        log(f"phase 31 bucket_mb={mb}: {numbers['buckets']} bucket(s), step ms "
            f"{[round(x, 1) for x in numbers['step_ms']]}, peak "
            f"{numbers['peak_allocated_bytes'] / 2**30:.2f} GiB, launches {numbers['launches']}"
            + ("" if mb is None else ", bit for bit the monolithic run"))
        del trainer, state
        torch.cuda.empty_cache()
    del ref
    out["rejoin"] = mixed_rejoin_step(cfg, batches[0], dev)
    out["launches"] = counts
    return out


def mixed_rejoin_step(cfg, batch, dev):
    """Phase 31's crash-and-rejoin step (see ``phase_mixed_buckets``)."""
    import torch
    from repro_torch.core.faults import membership_events
    from repro_torch.launch.train import TrainState

    fused = fault_trainer(cfg, "rejoin", fused_apply=True)
    layout = fused.layout
    fr, rounds, update, moving = fault_rounds(fused, REJOIN_STEP)
    if list(fr.rejoin) != [2]:
        fail(f"phase 31: FAULT_RANK_MODEL rejoins {list(fr.rejoin)} at step {REJOIN_STEP}")
    state = mixed_start(fused)
    state.step = REJOIN_STEP
    # the handoff alone, timed, on copies of θ and m: its rows rounded
    theta0, mom0 = state.theta.clone(), state.mom.clone()
    sync(dev)
    t1 = time.perf_counter()
    membership_events(fr, [theta0, mom0], fused.topology, None, step=REJOIN_STEP, epoch=0,
                      narrow=layout.narrow_leaves())
    sync(dev)
    handoff_ms = (time.perf_counter() - t1) * 1e3
    narrow_exact("phase 31 the rejoin's handoff", theta0, layout)
    del mom0
    theta0 = host(theta0)
    torch.cuda.empty_cache()
    sync(dev)
    t1 = time.perf_counter()
    state, loss_f, _ = fused.train_step(state, batch, LR)
    sync(dev)
    step_ms = (time.perf_counter() - t1) * 1e3
    narrow_exact("phase 31 the rejoin step", state.theta, layout)
    fused_host = TrainState(host(state.theta), {"mom": host(state.mom)}, REJOIN_STEP + 1)
    del state, fused
    torch.cuda.empty_cache()
    plain = fault_trainer(cfg, "rejoin", fused_apply=False)
    ref = mixed_start(plain)
    ref.step = REJOIN_STEP
    ref, loss_r, _ = plain.train_step(ref, batch, LR)
    if not torch.allclose(loss_f, loss_r, rtol=1e-5, atol=0):
        fail(f"phase 31 rejoin: losses {loss_f.tolist()} vs {loss_r.tolist()}")
    ulps, tol, rel_m, moved = check_step_against_interpreter(
        "phase 31 the rejoin step", theta0, fused_host, ref, rounds, update=update,
        rows=moving, layout=layout)
    log(f"phase 31: a crash-and-rejoin step (node 2 back at step {REJOIN_STEP}): handoff "
        f"{handoff_ms:.1f} ms, step {step_ms:.1f} ms, within {tol:.3f} of its tolerance of "
        f"the masked interpreter (m {rel_m:.3e}); the handoff's narrow rows rounded")
    del ref, plain, theta0, fused_host
    torch.cuda.empty_cache()
    return {"handoff_ms": handoff_ms, "step_ms": step_ms, "share_of_tolerance": tol,
            "ulps": ulps, "m_rel": rel_m, "moved_share": moved}


def quad_loss(params, batch):
    """A loss whose gradient is ``x - batch[leaf]`` in float32, rounded to
    each leaf's dtype: the same gradients on the card and on the CPU."""
    return 0.5 * sum(((x.float() - batch[k]) ** 2).sum() for k, x in params.items())


def sim_steps(sim, state, batches, steps):
    """``steps`` simulator steps; returns (state, losses, norms, step ms)."""
    import torch

    losses, norms, step_ms = [], [], []
    for t in range(steps):
        t1 = time.perf_counter()
        state, loss, nrm = sim.train_step(state, batches[t], LR)
        sync(sim.device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
        norms.append(nrm)
    return state, torch.stack(losses), torch.stack(norms), step_ms


def phase_mixed_simulator(dev):
    """Phase 32: ``DecentralizedSimulator`` on zamba2 at its published
    width in bf16 (mixed float32 state), depth SIM_MIXED_LAYERS, G = 4,
    d_ring, stacked mixing, one node's gradients at a time: SIM_STEPS steps
    (K3 once a step) bit for bit ``SPMDTrainer`` without fused apply on the
    same inputs (θ and m wait in host memory); then zamba2-reduced bf16 on
    ``quad_loss`` (the same gradients on both) bit for bit the CPU's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.kernels import ops
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.sgd import sgd

    cfg = zoo_cfg(ZOO[29][0], SIM_MIXED_LAYERS)
    batches = zoo_batches(cfg, G, SIM_STEPS, dev)
    sim = DecentralizedSimulator(lambda p, b: tfm.loss_fn(p, cfg, b), sgd(momentum=0.9),
                                 make_topology("d_ring", G), mixing="shift", collect_norms=True,
                                 node_loop=True, device=dev)
    state = sim.init(tfm.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    layout = state.layout
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, losses, norms, step_ms = sim_steps(sim, state, batches, SIM_STEPS)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != {"gossip_program_update": 0, "gossip_update": 0,
                    "segment_l2_norms": SIM_STEPS, "flash_attention": 0}:
        fail(f"phase 32: simulator launches {launches}, expected {SIM_STEPS} of K3")
    narrow_exact("phase 32 simulator", state.theta, layout)
    rows = {"theta": host(state.theta), "mom": host(state.opt["mom"])}
    del state, sim
    torch.cuda.empty_cache()
    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=False)
    tstate = trainer.init_state(seed=0)
    if trainer.layout != layout:
        fail("phase 32: the simulator's layout is not the trainer's")
    t_losses, t_norms = [], []
    for t in range(SIM_STEPS):
        tstate, loss, nrm = trainer.train_step(tstate, batches[t], LR)
        t_losses.append(loss)
        t_norms.append(nrm)
    if not (torch.equal(losses, torch.stack(t_losses))
            and torch.equal(norms, torch.stack(t_norms))):
        fail("phase 32: the simulator's losses or norms differ from the trainer's")
    equal_in_chunks("phase 32 simulator", "the trainer's interpreter steps",
                    {"theta": tstate.theta, "mom": tstate.mom}, rows)
    del tstate, trainer, rows
    torch.cuda.empty_cache()
    log(f"phase 32: simulator on {cfg.name} x{cfg.n_layers} bf16 (mixed float32 state, "
        f"{layout.size:,} params/node) {SIM_STEPS} steps == the trainer's interpreter bit for "
        f"bit; step ms {[round(x, 1) for x in step_ms]}, peak {peak / 2**30:.2f} GiB")
    # the reduced bf16 model on the quadratic loss: the card against the CPU
    red = dataclasses.replace(get_config("zamba2-7b-reduced"), dtype=torch.bfloat16, remat=False)
    params = tfm.init_model(red, torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(5)
    targets = [{k: (0.1 * r.standard_normal((G,) + tuple(v.shape))).astype(np.float32)
                for k, v in params.items()} for _ in range(SIM_STEPS)]
    runs = {}
    for where in ("cpu", dev):
        s = DecentralizedSimulator(quad_loss, sgd(momentum=0.9), make_topology("d_ring", G),
                                   mixing="shift", device=where)
        st, ls, _, _ = sim_steps(s, s.init(params), targets, SIM_STEPS)
        runs[str(where)] = (st.theta.cpu(), st.opt["mom"].cpu(), ls.cpu())
    (tc, mc, lc), (tg, mg, lg) = runs["cpu"], runs[str(dev)]
    # the losses are sums taken in another order on the card
    if not (torch.equal(tc, tg) and torch.equal(mc, mg)
            and torch.allclose(lc, lg, rtol=1e-6, atol=0)):
        fail("phase 32: the reduced bf16 simulator on the card differs from the CPU's")
    log("phase 32: zamba2-reduced bf16 simulator (quadratic loss) on the card == the CPU's "
        "bit for bit")
    return {"model": f"{cfg.name} x{cfg.n_layers} layers bf16, mixed float32 state, G={G}, "
                     "d_ring, stacked mixing, node_loop",
            "params_per_node": layout.size, "step_ms": step_ms,
            "peak_allocated_bytes": int(peak), "launches": launches,
            "reduced_card_equals_cpu": True}


def rebuild_guard(cfg, batches, dev):
    """Phase 33's rebuild guard: phase 4's trainer with ``debug_no_retrace``
    (a warm step that builds anything raises), then a closed-loop d_ada
    run (phase 14's, offset replicas) whose programs' device tables are
    built up front from ``precompile_programs``: after the first step, 0
    nvcc builds and 0 new device tables.  Returns the counts."""
    import torch
    from repro_torch.analysis.recompile import watch_retrace
    from repro_torch.core.dsgd import make_topology
    from repro_torch.kernels import gossip_update as gu
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    out = {}
    for label, topo, steps in (
            ("phase 4's trainer", make_topology("d_ring", G), STEPS),
            ("closed-loop d_ada", make_topology("d_ada", G, k_floor="one_peer",
                                                consensus_target=ADA_TARGET,
                                                consensus_probe_every=1), ADA_STEPS)):
        trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True,
                              fused_apply=True, debug_no_retrace=True)
        for p in trainer.precompile_programs():
            split = trainer._fused_split(p)
            if split is not None:
                gu._device_tables(split[0], trainer.device)
        state = trainer.init_state(seed=0)
        offset_nodes(state.theta, ADA_NOISE)
        state, _, _ = trainer.train_step(state, batches[0], LR)
        with watch_retrace(label) as seen:
            for t in range(1, steps):
                state, _, _ = trainer.train_step(state, batches[t], LR)
        if seen.builds or seen.tables:
            fail(f"phase 33 {label}: {seen.builds} nvcc build(s) and {seen.tables} device "
                 "table(s) after warm-up")
        out[label] = {"steps": steps, "nvcc_builds": seen.builds, "device_tables": seen.tables,
                      "new_program_keys": seen.programs,
                      "transitions": None if topo.controller is None
                      else topo.controller.transitions}
        del state, trainer
        torch.cuda.empty_cache()
    return out


def phase_analysis(dev, cfg, batches):
    """Phase 33: ``python -m repro_torch.analysis --all`` on the card; the
    card's limits against the budget's constants and each built kernel's
    registers and shared memory, printed and held to the budget; the
    rebuild guard; ``python -m repro_torch.examples.serve_decode``."""
    import contextlib
    import io

    import torch
    from repro_torch.analysis import budget
    from repro_torch.analysis.__main__ import main as analysis_main

    t1 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(["--all"], device=dev)
    report = buf.getvalue()
    log("phase 33: python -m repro_torch.analysis --all on the card:\n" + report.rstrip())
    if rc != 0:
        fail("phase 33: the analysis pipeline reported findings on the card")
    analysis_s = time.perf_counter() - t1
    props = torch.cuda.get_device_properties(dev)
    limits = budget.device_limits()
    attrs = budget.kernel_attributes()
    budget.verify_kernel_attributes(attrs)
    for name, a in attrs.items():
        log(f"phase 33: {name}: {a['regs_per_thread']} registers a thread, "
            f"{a['static_smem_bytes']} B static + {a['dynamic_smem_bytes']} B dynamic shared "
            f"memory a block, {a['threads']} threads (takes {a['max_threads_per_block']}), "
            f"{a['local_bytes_per_thread']} B local")
    guard = rebuild_guard(cfg, batches, dev)
    log(f"phase 33: rebuild guard {guard}")
    stdout, serve_s = run_example(["repro_torch.examples.serve_decode", "--new", "16"])
    if "greedy:" not in stdout:
        fail(f"phase 33: serve_decode printed no timing: {stdout[-500:]}")
    log(f"phase 33: serve_decode ran in {serve_s:.1f} s: {stdout.strip().splitlines()[-1]}")
    return {"analysis_report": report.splitlines(), "analysis_s": analysis_s,
            "smem_optin_bytes_props": getattr(props, "shared_memory_per_block_optin", None),
            "device_limits": limits, "kernel_attributes": attrs, "rebuild_guard": guard,
            "serve_decode_s": serve_s}


# phases 34-36: the dry run, one step against its roofline, shard_nodes
DRY_FULL_ARCHS = ("granite-8b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")
DRY_TP_ARCHS = ("granite-8b", "phi3.5-moe-42b-a6.6b")   # also trained on the multi mesh
DRY_MINI_ARCHS = ("granite-8b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "zamba2-7b",
                  "kimi-k2-1t-a32b")
ROOF_STEPS, SHARD_STEPS = 5, 3
# phase 34's full-width records build in worker processes (the dry run is
# single-threaded host work; none of them initialises CUDA), started in the
# background while phases 10-33 run on the card
DRY_WORKERS = 4
PREDICT_34 = (
    "phase 34 prediction (PERF.md §6): 14 full-width records (granite-8b, phi3.5-moe, "
    "kimi-k2 x 4 SHAPES on single = 16 data x 16 model; granite-8b and phi3.5-moe train_4k "
    "on multi) and 15 mini ones build on meta in 40-120 s with 0 device bytes allocated; "
    "a training record is rank (0, 0)'s: granite-8b 2.9 GiB and phi3.5-moe 14.6 GiB of "
    "state a card (46.13 and 233.98 / 16), kimi-k2 about 24 GB (G = 1: FSDP x EP); "
    "is_suspect flags only the MoE decodes whose experts compute at the capacity floor "
    "(phi3.5-moe long_500k, kimi-k2 decode_32k and long_500k)")
PREDICT_35 = (
    "phase 35 prediction (PERF.md §6): phase 4's trainer (granite-8b x2, G = 4, d_ring, "
    "fused, norms): median step 130-220 ms; roofline compute 14-18 ms, memory 50-110 ms, "
    "wire 0 (stacked, no collective), dominant memory, useful FLOP ratio 0.6-0.75, bound / "
    "measured 0.3-0.7; card dot_flops == meta, traffic within 0.1 %; temp_bytes within 30 % "
    "of the measured peak above the state")
PREDICT_36 = (
    "phase 36 prediction (PERF.md §6): split into 4 row blocks on the card, the mini-ResNet "
    "closed-loop Ada (N 16, 3 steps, a node's gradients at a time) bit for bit the unsplit "
    "run with shift mixing and within 1e-6 relative with dense mixing (bit for bit if cuBLAS "
    "keeps one reduction order for 4 rows and for 16), under vmap with shift mixing within "
    "1e-6 (cuDNN's grouped convolution of 4 groups against 16 may round apart), granite-8b x2 bf16 G 4 with shift mixing bit for bit over 2 "
    "steps; K3 once per block a step (4 x 3 x 3 + 4 x 2 = 44 launches); the granite split "
    "step within 10 % of the unsplit one (row copies of a few GB at HBM rate, ~10 ms); peak "
    "allocated within 10 % of the unsplit run's on one card; 30-70 s in all")


def moe_capacity_floor(rec):
    """Why ``is_suspect`` may flag a MoE decode record: with the reference's
    capacity rule (``models/moe.py::capacity_of``, at least 4 slots an
    expert) a decode of T tokens computes E·C expert slots for k·T
    assignments.  Returns that slot ratio when it alone passes
    ``is_suspect``'s 8× bar, else None."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import record_shape
    from repro_torch.models.moe import capacity_of

    cfg = get_config(rec["arch"])
    if rec.get("kind") != "decode" or not cfg.n_experts:
        return None
    t = record_shape(rec).global_batch // rec["replicas"]   # one token a sequence
    ratio = cfg.n_experts * capacity_of(t, cfg.top_k, cfg.n_experts,
                                        cfg.capacity_factor) / (cfg.top_k * t)
    return ratio if ratio > 8.0 else None


def dry_record(task):
    """One of phase 34's records, in a worker process: (the record, its
    build seconds, whether the worker initialised CUDA)."""
    import torch
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_one(*task)
    return rec, time.perf_counter() - t0, torch.cuda.is_initialized()


def start_dryrun():
    """Phase 34's full-width records started in DRY_WORKERS worker
    processes: (the pool, the tasks, their pending results), or None
    without any."""
    import multiprocessing

    from repro_torch.configs.base import SHAPES

    # the long prefills first, so that the workers finish together; the
    # tensor-parallel archs' training also on the multi-pod mesh
    full = [(a, n, "single") for n in ("prefill_32k", "train_4k", "decode_32k", "long_500k")
            for a in DRY_FULL_ARCHS if n in SHAPES]
    full += [(a, "train_4k", "multi") for a in DRY_FULL_ARCHS if a in DRY_TP_ARCHS]
    if not full:
        return None
    pool = multiprocessing.get_context("spawn").Pool(DRY_WORKERS)
    return pool, full, pool.map_async(dry_record, full, chunksize=1)


def phase_dryrun(dev, started=None):
    """Phase 34: ``launch/dryrun.run_one`` on the card's machine: granite-8b,
    phi3.5-moe and kimi-k2 at full width over the four SHAPES on the
    ``single`` mesh (in DRY_WORKERS worker processes, each of which must
    end without having initialised CUDA; ``started``: ``start_dryrun``'s
    pool, started earlier, else started here), and the five archs of
    ``tests/spmd_dryrun_script.py`` at its mini shapes in this process; the
    card's allocated and peak bytes must not move; ``is_suspect`` flags
    nothing but MoE decodes at the capacity floor (``moe_capacity_floor``);
    the dry-run and roofline tables printed, the records written under
    ``build/repro_torch/dryrun``."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.validate_dryrun import is_suspect

    minis = (InputShape("mini_train", 64, 8, "train"),
             InputShape("mini_prefill", 256, 4, "prefill"),
             InputShape("mini_decode", 256, 8, "decode"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    records, build_s = [], {}
    started = started or start_dryrun()
    if started is not None:
        pool, full, pending = started
        try:
            done = pending.get()
        finally:
            pool.terminate()
            pool.join()
        for (arch, name, mesh), (rec, secs, touched) in zip(full, done):
            if touched:
                fail(f"phase 34: the worker building {arch} {name} initialised CUDA")
            records.append(rec)
            build_s[f"{arch} {name} {mesh}"] = round(secs, 2)
    for arch, shape in [(a + "-reduced", m) for a in DRY_MINI_ARCHS for m in minis]:
        t0 = time.perf_counter()
        records.append(dryrun.run_one(arch, shape, "mini"))
        build_s[f"{arch} {shape.name} mini"] = round(time.perf_counter() - t0, 2)
    torch.cuda.synchronize()
    after = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    if after != before:
        fail(f"phase 34: the dry run moved the card's allocated/peak bytes {before} -> {after}")
    flagged = {}
    for rec in records:
        why = is_suspect(rec)
        if why is None:
            continue
        floor = moe_capacity_floor(rec)
        if floor is None:
            fail(f"phase 34: is_suspect flags {rec['arch']} {rec['shape']} {rec['mesh']}: {why}")
        flagged[f"{rec['arch']} {rec['shape']}"] = f"{why}; expert slots / assignments {floor:.1f}"
    out = ROOT / "build" / "repro_torch" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "phase34.json"
    path.write_text(json.dumps(records, indent=1))
    rows = roofline.analyze(str(path))
    for mesh in ("single", "mini"):
        log(f"phase 34: dry-run table, mesh {mesh}\n" + roofline.dryrun_markdown(rows, mesh))
    log("phase 34: roofline table\n" + roofline.to_markdown(rows))
    summary = {
        "records": len(records), "build_s": build_s, "device_bytes_before_after": [before, after],
        "flagged_capacity_floor": flagged,
        "node_state_bytes": {f"{r['arch']} {r['shape']}": r["memory"]["argument_bytes"]
                             for r in records if r["mesh"] == "single"},
        # a training record is rank (0, 0)'s step: bytes a card
        "train_bytes_a_card": {
            f"{r['arch']} {r['mesh']}": {"mesh_shape": r["mesh_shape"],
                                         "argument_bytes": r["memory"]["argument_bytes"],
                                         "temp_bytes": r["memory"]["temp_bytes"]}
            for r in records if r["kind"] == "train" and r["mesh"] != "mini"},
    }
    for key, b in summary["train_bytes_a_card"].items():
        log(f"phase 34: {key} train_4k on {b['mesh_shape']}: argument "
            f"{b['argument_bytes'] / 2**30:.3f} GiB, temp {b['temp_bytes'] / 2**30:.3f} GiB a "
            f"card")
    log(f"phase 34: {len(records)} records on meta, 0 device bytes; flagged (capacity floor "
        f"only): {json.dumps(flagged)}")
    return summary


def phase_roofline_step(dev, k1_bound, k3_bound, smi):
    """Phase 35: phase 4's configuration, one step against its roofline.
    The trainer's init is measured for its device bytes; the median of
    ROOF_STEPS warm steps is timed with no accounting (and the peak above
    the state read); one step runs under ``analyze_step`` on the card, and
    ``lower_step`` builds the same trainer's step on meta.  The card's
    ``dot_flops`` must equal the meta record's, its traffic within 0.1 %
    (any op that differs is named); K1's and K3's billed bytes over the
    memory rate must give phase 6's bounds (K1's one-pass bound: the step
    passes no wire); ``argument_bytes`` within 2 MiB of the init's device
    bytes.  Returns (launches, numbers)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core.dsgd import make_topology
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    cfg, _ = granite_layout()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    trainer = SPMDTrainer(cfg, make_topology("d_ring", G), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=True)
    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    init_bytes = torch.cuda.memory_allocated() - a0
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in src.stacked(G, t, BATCH).items()}
               for t in range(ROOF_STEPS + 2)]
    ops.reset_launch_counts()
    state, _, _ = trainer.train_step(state, batches[0], LR)   # warm-up
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for t in range(1, ROOF_STEPS + 1):
        t1 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, batches[t], LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak_above = torch.cuda.max_memory_allocated() - live
    if not bool(torch.isfinite(loss).all()):
        fail(f"phase 35: non-finite losses {loss.tolist()}")
    card = analyze_step(trainer.train_step, state, batches[-1], LR)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    card.pop("result")
    shape = InputShape("phase35", SEQ, G * BATCH, "train")
    rec = trainer.lower_step(shape, step=state.step)
    meta = rec["hlo"]
    if card["dot_flops"] != meta["dot_flops"]:
        fail(f"phase 35: dot_flops on the card {card['dot_flops']} != meta {meta['dot_flops']}")
    rel = abs(card["traffic_bytes"] - meta["traffic_bytes"]) / meta["traffic_bytes"]
    differ = {k: (card["op_traffic"].get(k, 0), meta["op_traffic"].get(k, 0))
              for k in set(card["op_traffic"]) | set(meta["op_traffic"])
              if card["op_traffic"].get(k, 0) != meta["op_traffic"].get(k, 0)}
    if rel > 1e-3:
        fail(f"phase 35: traffic on the card {card['traffic_bytes']} vs meta "
             f"{meta['traffic_bytes']} ({rel:.2e} relative); ops that differ {differ}")
    bounds = {}
    for kernel, want in (("gossip_program_update", k1_bound), ("segment_l2_norms", k3_bound)):
        billed = (card["kernels"][kernel]["bytes"], meta["kernels"][kernel]["bytes"])
        got = 1e3 * (billed[0] / roofline.HBM_BW)
        if billed[0] != billed[1] or got != want:
            fail(f"phase 35: {kernel} billed {billed} B: {got} ms against phase 6's bound {want}")
        bounds[kernel] = got
    arg = rec["memory"]["argument_bytes"]
    if abs(arg - init_bytes) > 2 << 20:
        fail(f"phase 35: argument_bytes {arg} vs the init's device bytes {init_bytes}")
    terms = roofline.roofline_terms(
        {**rec, "arch": cfg.name, "shape": shape.name,
         "input_shape": dataclasses.asdict(shape), "mesh_shape": {"data": 1, "model": 1}},
        cfg=cfg)
    measured = float(np.median(step_ms))
    numbers = {
        "card": smi, "step_ms": step_ms, "median_step_ms": measured,
        "compute_ms": 1e3 * terms["compute_s"], "memory_ms": 1e3 * terms["memory_s"],
        "wire_ms": 1e3 * terms["collective_s"], "transport": terms["transport"],
        "dominant": terms["dominant"], "useful_flop_ratio": terms["useful_ratio"],
        "bound_ms": 1e3 * terms["bound_s"], "share_bound_over_measured":
            1e3 * terms["bound_s"] / measured,
        "dot_flops": meta["dot_flops"], "traffic_bytes_card": card["traffic_bytes"],
        "traffic_bytes_meta": meta["traffic_bytes"], "traffic_rel_diff": rel,
        "ops_that_differ": differ, "kernel_bounds_ms": bounds,
        "argument_bytes": arg, "init_device_bytes": init_bytes,
        "temp_bytes": rec["memory"]["temp_bytes"], "measured_peak_above_state": peak_above,
        "card_peak_temp_bytes": card["peak_temp_bytes"], "lower_s": rec["lower_s"],
        "launches": launches,
    }
    log(f"phase 35: {smi}: median step {measured:.3f} ms over {ROOF_STEPS}; roofline compute "
        f"{numbers['compute_ms']:.3f} ms, memory {numbers['memory_ms']:.3f} ms, wire "
        f"{numbers['wire_ms']:.3f} ms ({terms['transport']}), dominant {terms['dominant']}, "
        f"useful FLOP ratio {terms['useful_ratio']:.3f}, bound / measured "
        f"{numbers['share_bound_over_measured']:.3f}; dot_flops {meta['dot_flops']:.6e} on "
        f"both, traffic {card['traffic_bytes']:.6e} (card) vs {meta['traffic_bytes']:.6e} "
        f"(meta); K1 and K3 billed bounds {bounds}; argument_bytes {arg} vs init {init_bytes}; "
        f"temp_bytes {rec['memory']['temp_bytes']} vs measured peak above the state "
        f"{peak_above}")
    del trainer, state, batches
    return launches, numbers


SHARD_BLOCKS, SHARD_GRANITE_STEPS = 4, 2
# phase 36's mini-ResNet runs: (mixing, one node's gradients at a time)
SHARD_RESNET_RUNS = (("shift", True), ("dense", True), ("shift", False))


@contextlib.contextmanager
def node_split_as(dev, blocks=SHARD_BLOCKS):
    """The split phase 36 runs: the reference's rule over the real cards
    where there are two or more, else ``blocks`` row blocks on ``dev``
    (``split_devices`` replaced for the duration)."""
    import torch
    from repro_torch.core import node_split

    real = node_split.split_devices
    if torch.device(dev).type == "cuda" and torch.cuda.device_count() >= 2:
        yield "cards"
        return
    node_split.split_devices = lambda n, device: [torch.device(dev)] * blocks
    try:
        yield f"{blocks} blocks on one {torch.device(dev).type} device"
    finally:
        node_split.split_devices = real


def _full(x):
    from repro_torch.core.node_split import as_blocks

    return as_blocks(x).to_full()


def _sync_cards(sim):
    """Wait for every card the simulator's state lies on."""
    import torch

    for d in dict.fromkeys(sim.devices):
        torch.cuda.synchronize(d)


def _rel_err(a, b):
    """max |a - b| / max |b| in float64 (0 for equal tensors)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def shard_resnet(dev, mixing, node_loop):
    """Phase 15's mini-ResNet closed-loop Ada (N 16) for SHARD_STEPS steps
    unsplit and split (``node_split_as``) with ``mixing``, the gradients
    one node at a time (``node_loop``) or under vmap over each block's
    nodes: (the split run's launches, its numbers, the split)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.kernels import ops
    from repro_torch.models.paper_models import mini_resnet_loss
    from repro_torch.optim.sgd import sgd

    name = "resnet closed-loop Ada"
    params, batches = paper_inputs(name, SHARD_STEPS)
    runs, where = {}, None
    for split in (False, True):
        topo = make_topology("d_ada", PAPER_N, k0=12, k_floor="one_peer",
                             consensus_target=0.7, consensus_probe_every=5)
        with node_split_as(dev) as where_:
            sim = DecentralizedSimulator(mini_resnet_loss, sgd(momentum=0.9), topo,
                                         mixing=mixing, collect_norms=True, device=dev,
                                         node_loop=node_loop, shard_nodes=split)
            state = sim.init(params)
            if split:
                where = where_
            ops.reset_launch_counts()
            losses, norms = [], []
            for t, b in enumerate(batches):
                state, loss, nrm = sim.train_step(state, b, PAPER_RUNS[name]["lr"],
                                                  epoch=t // 5)
                losses.append(loss)
                norms.append(nrm)
            _sync_cards(sim)
            runs[split] = {"theta": _full(state.theta), "mom": _full(state.opt["mom"]),
                           "losses": torch.stack(losses), "norms": torch.stack(norms),
                           "trace": list(topo.controller.trace),
                           "blocks": len(getattr(state.theta, "blocks", [state.theta])),
                           "launches": ops.launch_counts()}
    errs = {key: _rel_err(runs[True][key], runs[False][key])
            for key in ("theta", "mom", "losses", "norms")}
    exact = all(torch.equal(runs[False][k], runs[True][k])
                for k in ("theta", "mom", "losses", "norms"))
    # shift mixing with one node's gradients at a time is held bit for bit;
    # dense mixing's per-block product (node_split.split_matmul) and vmap's
    # batched convolutions over a block's n/d nodes (a grouped convolution
    # of another group count) within 1e-6 relative where they are not
    label = f"{mixing}, {'node loop' if node_loop else 'vmap'}"
    bar = 0.0 if mixing == "shift" and node_loop else 1e-6
    for key, err in errs.items():
        if err > bar:
            fail(f"phase 36 ({label}): {key} split differ from unsplit by {err:.3e} relative "
                 f"(bar {bar:g})")
    if runs[False]["trace"] != runs[True]["trace"]:
        fail(f"phase 36 ({label}): controller traces {runs[False]['trace']} vs "
             f"{runs[True]['trace']}")
    launches = runs[True]["launches"]
    blocks = runs[True]["blocks"]
    if blocks < 2 or launches != {"gossip_program_update": 0, "gossip_update": 0,
                                  "segment_l2_norms": blocks * SHARD_STEPS,
                                  "flash_attention": 0}:
        fail(f"phase 36 ({label}): {blocks} blocks, launch counts {launches}")
    return launches, {"mixing": mixing, "node_loop": node_loop, "blocks": blocks,
                      "bit_for_bit": exact, "max_rel_err": errs}, where


def shard_granite(dev, cfg, steps=SHARD_GRANITE_STEPS):
    """Phase 13's granite-8b simulator (G nodes, shift mixing, momentum-SGD,
    norms on K3, one node's gradients at a time) for ``steps`` steps
    unsplit, then split: θ compared exactly against the unsplit θ kept on
    the card (and by SHA-1 of its sampled columns), m on the sampled
    columns, losses and norms exactly; K3 once per block a step.  Returns
    (the split run's launches, numbers)."""
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.flat import FlatLayout
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.sgd import sgd

    cuda = torch.device(dev).type == "cuda"
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in src.stacked(G, t, BATCH).items()}
               for t in range(steps)]
    layout = FlatLayout.of_defs(tfm.model_defs(cfg))
    idx = torch.as_tensor(sample_columns(layout), device=dev)
    out, keep = {}, None
    for split in (False, True):
        with node_split_as(dev) as where:
            sim = DecentralizedSimulator(lambda p, b: tfm.loss_fn(p, cfg, b), sgd(momentum=0.9),
                                         make_topology("d_ring", G), mixing="shift",
                                         collect_norms=True, node_loop=True, device=dev,
                                         shard_nodes=split)
            params = tfm.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
            state = sim.init(params)
            del params
            if cuda:
                _sync_cards(sim)
                for d in sim.devices:
                    torch.cuda.reset_peak_memory_stats(d)
            ops.reset_launch_counts()
            step_ms, losses, norms = [], [], []
            for t in range(steps):
                t1 = time.perf_counter()
                state, loss, nrm = sim.train_step(state, batches[t], LR)
                if cuda:
                    _sync_cards(sim)
                step_ms.append((time.perf_counter() - t1) * 1e3)
                if not bool(torch.isfinite(loss).all()):
                    fail(f"phase 36 granite step {t}: non-finite losses {loss.tolist()}")
                losses.append(loss)
                norms.append(nrm)
            launches = ops.launch_counts()
            devs = list(dict.fromkeys(sim.devices))
            peaks = ({str(d): int(torch.cuda.max_memory_allocated(d)) for d in devs} if cuda
                     else {})
            theta = state.theta
            blocks = len(getattr(theta, "blocks", [theta]))
            rows = (torch.cat([b[:, idx.to(b.device)].to(dev) for b in theta.blocks])
                    if split else theta[:, idx])
            mom = state.opt["mom"]
            mrows = (torch.cat([b[:, idx.to(b.device)].to(dev) for b in mom.blocks])
                     if split else mom[:, idx])
            out[split] = {"losses": torch.stack(losses), "norms": torch.stack(norms),
                          "theta_cols": rows.clone(), "mom_cols": mrows.clone(),
                          "sha1": _digest(rows.float().cpu().numpy()), "step_ms": step_ms,
                          "peaks": peaks, "blocks": blocks, "launches": launches,
                          "where": where}
            if split:
                exact_theta = all(torch.equal(b, keep[a:c].to(b.device))
                                  for (a, c), b in zip(theta.ranges, theta.blocks))
            else:
                keep = theta   # the unsplit θ stays on the card; m and the grads go
            del state, sim, theta, mom
            if cuda:
                torch.cuda.empty_cache()
    del keep
    plain, split = out[False], out[True]
    if not exact_theta or plain["sha1"] != split["sha1"]:
        fail("phase 36 granite: split theta differs from the unsplit run")
    for key in ("mom_cols", "losses", "norms"):
        if not torch.equal(plain[key], split[key]):
            fail(f"phase 36 granite: split {key} differ from the unsplit run by "
                 f"{_rel_err(split[key], plain[key]):.3e} relative")
    launches = split["launches"]
    if split["blocks"] < 2 or launches != {"gossip_program_update": 0, "gossip_update": 0,
                                           "segment_l2_norms": split["blocks"] * steps,
                                           "flash_attention": 0}:
        fail(f"phase 36 granite: {split['blocks']} blocks, launch counts {launches}")
    numbers = {
        "config": f"{cfg.name} x{cfg.n_layers} layers, {cfg.dtype}, G={G}, d_ring, shift "
                  f"mixing, sgd(0.9), lr {LR}, seq {SEQ}, per-node batch {BATCH}, node_loop",
        "split": split["where"], "blocks": split["blocks"], "steps": steps,
        "bit_for_bit": True, "theta_sha1_sampled": split["sha1"],
        "step_ms_unsplit": plain["step_ms"], "step_ms_split": split["step_ms"],
        "peak_allocated_unsplit": plain["peaks"], "peak_allocated_split": split["peaks"],
        "losses": plain["losses"].tolist(),
    }
    return launches, numbers


def shard_reductions(dev):
    """The ops that reduce over every node, on a float32 leaf of PAPER_N
    nodes and 2·SPLIT_CHUNK + 99 columns: AllReduce, GatherRow (the dense
    ring), a masked program that is not all-PPermute (AllReduce with a
    dead node) and the centralized mean (bf16).  Split (column chunks of
    SPLIT_CHUNK gathered to the first card, the last taking the rest)
    against unsplit (one chunk of every column), each block's rows: the
    mean and AllReduce (sums down each column) bit for bit; GatherRow and
    the masked program (matrix products, whose kernel the card picks by
    the chunk's shape) within 1e-6 relative, as the dense interpreter.
    Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.core import node_split
    from repro_torch.core.graphs import Ring
    from repro_torch.core.node_split import NodeBlocks
    from repro_torch.core.schedule import AllReduce, GossipProgram, dense_program
    from repro_torch.core.simulator import _centralized_mean

    n, width = PAPER_N, 2 * node_split.SPLIT_CHUNK + 99
    x = torch.randn((n, width), generator=torch.Generator(device=dev).manual_seed(36),
                    device=dev)
    alive = np.ones(n, np.float32)
    alive[3] = 0.0
    allreduce = GossipProgram("allreduce", n, (AllReduce(),), 0.0)
    gather = dense_program(Ring(n))
    # name -> (op, bar on the relative difference)
    checks = {"allreduce": (allreduce.apply_stacked, 0.0),
              "centralized mean": (lambda v: _centralized_mean(v, torch.bfloat16), 0.0),
              "gatherrow": (gather.apply_stacked, 1e-6),
              "masked allreduce": (lambda v: allreduce.apply_masked(v, alive), 1e-6)}
    with node_split_as(dev) as where:
        devices = node_split.split_devices(n, dev)
    t0 = time.perf_counter()
    exact, errs = [], {}
    for name, (op, bar) in checks.items():
        want, got = op(x), op(NodeBlocks.split(x, devices))
        pairs = [(b, want[a:c].to(b.device)) for (a, c), b in zip(got.ranges, got.blocks)]
        errs[name] = max(_rel_err(b, w) for b, w in pairs)
        if all(torch.equal(b, w) for b, w in pairs):
            exact.append(name)
        elif errs[name] > bar or bar == 0.0:
            fail(f"phase 36 reductions: {name} split over {len(devices)} blocks differs from "
                 f"the unsplit op by {errs[name]:.3e} relative (bar {bar:g})")
        del want, got, pairs
    return {"nodes": n, "columns": width, "chunk": node_split.SPLIT_CHUNK, "split": where,
            "blocks": len(devices), "bit_for_bit": exact, "max_rel_err": errs,
            "s": time.perf_counter() - t0}


def phase_shard_nodes(dev, granite_cfg=None):
    """Phase 36: the simulator split into row blocks (``shard_nodes``; 4
    blocks on the one card, or the reference's rule over real cards where
    there are two or more) against the unsplit run: phase 15's mini-ResNet
    closed-loop Ada (N 16) for SHARD_STEPS steps, one node's gradients at a
    time, with shift mixing (bit for bit: θ, m, losses, norms, the
    controller's trace) and dense mixing (phase 15's; bit for bit where the
    card gives it, else within 1e-6 relative), and with shift mixing under
    vmap (phase 15's gradients; within 1e-6); then phase 13's granite-8b
    simulator (G 4, 2 layers, bf16, shift mixing) for SHARD_GRANITE_STEPS
    steps bit for bit.  K3 once per block a step.  Then the reductions over
    every node by column chunks (``shard_reductions``).  Returns (the split
    runs' launches summed, numbers)."""
    from repro_torch.kernels import ops

    cfg = granite_cfg if granite_cfg is not None else granite_layout()[0]
    launches = {k: 0 for k in ops.launch_counts()}
    numbers = {"resnet": {}}
    for mixing, node_loop in SHARD_RESNET_RUNS:
        key = f"{mixing}, {'node loop' if node_loop else 'vmap'}"
        got, numbers["resnet"][key], where = shard_resnet(dev, mixing, node_loop)
        launches = {k: launches[k] + got[k] for k in launches}
        r = numbers["resnet"][key]
        log(f"phase 36: resnet closed loop ({key}), split as {where}: "
            f"{'bit for bit' if r['bit_for_bit'] else 'within 1e-6 of'} the unsplit run over "
            f"{SHARD_STEPS} steps (max relative {r['max_rel_err']}); launches {got}")
    got, numbers["granite"] = shard_granite(dev, cfg)
    launches = {k: launches[k] + got[k] for k in launches}
    g = numbers["granite"]
    log(f"phase 36: {g['config']}, split as {g['split']}: bit for bit the unsplit run over "
        f"{g['steps']} steps (theta sampled SHA-1 {g['theta_sha1_sampled'][:12]}); step ms "
        f"unsplit {[round(x, 1) for x in g['step_ms_unsplit']]}, split "
        f"{[round(x, 1) for x in g['step_ms_split']]}; peak allocated unsplit "
        f"{g['peak_allocated_unsplit']}, split {g['peak_allocated_split']}; launches {got}")
    numbers["reductions"] = r = shard_reductions(dev)
    log(f"phase 36: reductions over {r['nodes']} nodes of {r['columns']} columns, split as "
        f"{r['split']} in chunks of {r['chunk']}: bit for bit the unsplit ops: "
        f"{r['bit_for_bit']}; max relative {r['max_rel_err']} ({r['s']:.1f} s)")
    numbers.update({"steps": SHARD_STEPS, "launches": launches})
    return launches, numbers


# ---------------------------------------------------------------------------
# Phases 37-39: tensor and expert parallelism inside a node
# ---------------------------------------------------------------------------

TP_G, TP_M, TP_STEPS = 2, 2, 3    # phase 37: a (2 data x 2 model) world, 3 steps a run
TP_TIMEOUT = 900
TP_ALLREDUCE_ITERS = 5
EP_ARCH = "phi3.5-moe-42b-a6.6b"
EP_B, EP_S = 2, 512               # phase 38: the MoE layer's tokens
P39_STEPS, P39_CUT = 4, 2         # phase 39: train_100m's steps and its checkpoint
PREDICT_37 = (
    "phase 37 prediction (PERF.md §6): granite-8b x2 on a (2 data x 2 model) world of 4 "
    "ranks on the card over gloo-host: float32 3 steps within 5e-5 of the stacked engine "
    "at G = 2 (norms rtol 1e-5), the replicated leaves (the norms' gains) bit for bit "
    "across each node's model ranks, K2 and K3 once a step a rank; bf16 rank step 2.9-5.2 "
    "s (phase 9's: half the row crosses gloo-host, plus 4 activation all-reduces a layer "
    "and a step, 10-40 ms each), peak per rank about half of phase 9's (7-9 GiB)")
PREDICT_38 = (
    "phase 38 prediction (PERF.md §6): one phi3.5-moe MoE layer (16 experts, 8 a rank) "
    "forward and backward in float32 on 2 ranks within atol 1e-5 of apply_moe (aux 1e-6), "
    "every expert with a gradient (phi3.5-moe x1 trains on these ranks in phase 42)")
PREDICT_39 = (
    "phase 39 prediction (PERF.md §6): train_100m's 100m preset (153.0M parameters, "
    "float32) on (4 x 2) ranks over gloo-host: 1-2.5 s a step, 4 steps and a run resumed "
    "from a step-2 checkpoint in a fresh world bit for bit (theta and m, by their SHA-1); "
    "the Gini of the norms printed; 75-100 s in two worlds (88.3-118.9 s when the ranks "
    "sent back their rows)")


def tp_granite_cfg(dtype):
    """Phase 4's granite-8b (published width, 2 layers, remat off) in ``dtype``."""
    cfg, _ = granite_layout()
    return dataclasses.replace(cfg, dtype=dtype)


def tp_trainer(cfg, dev, **kw):
    """The (TP_G x TP_M) trainer of phases 37-38: d_ring, fused apply, norms."""
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    return SPMDTrainer(cfg, make_topology("d_ring", TP_G), sgd(momentum=0.9),
                       collect_norms=True, fused_apply=True, device=dev,
                       mesh=make_mesh((TP_G, TP_M), ("data", "model")), **kw)


def leaf_samples(layout, sample):
    """name -> the sampled flat columns that fall in the leaf, as indices
    into it (phase 9's sample, in leaf order)."""
    return {name: sample[(sample >= off) & (sample < off + size)] - off
            for name, off, size in zip(layout.names, layout.offsets[:-1], layout.sizes)}


def tp_sampled(trainer, buf, per_leaf):
    """This rank's node's ``buf`` (θ or m) on the sampled columns (float32,
    leaf order): each rank puts the sampled elements its shard holds (a
    replicated leaf's on model rank 0) into a zero vector, and one
    all-reduce over the model group adds them (x + 0 is x)."""
    import numpy as np
    import torch

    views = trainer.layout.stacked_views(buf)
    j, tp = trainer.model_rank, trainer.tp_size
    parts = []
    for name, cols in per_leaf.items():
        full = trainer.full_defs[name].shape
        local = views[name][0]
        vals = torch.zeros(len(cols), dtype=torch.float32, device=buf.device)
        d = trainer.shardings[name].dim_of("model")
        if d is None:
            mine, idx = np.full(len(cols), j == 0), cols
        else:
            coords = list(np.unravel_index(cols, full))
            k = full[d] // tp
            mine = coords[d] // k == j
            coords[d] = coords[d] - j * k
            idx = np.ravel_multi_index([c[mine] for c in coords], tuple(local.shape))
        if mine.any():
            vals[torch.as_tensor(np.nonzero(mine)[0], device=buf.device)] = \
                local.reshape(-1)[torch.as_tensor(idx, device=buf.device)].float()
        parts.append(vals)
    return trainer.model_comm.all_reduce(torch.cat(parts)).cpu().numpy()


def replicated_leaves(trainer, state):
    """The leaves the model axis leaves whole, as this rank holds them."""
    views = trainer.stacked_params(state)
    return {k: views[k].float().cpu().numpy()
            for k, whole in zip(trainer.defs, trainer._replicated()) if whole}


def tp_train(trainer, state, batches, lr, dev, *, record=False):
    """Steps of a tensor-parallel rank, the launch counters zeroed just
    before and read just after; with ``record`` the model group's
    collectives are recorded.  Returns (state, losses, norms, step ms,
    launches, the model group's op record or None)."""
    from repro_torch.kernels import ops

    sync(dev)
    ops.reset_launch_counts()
    losses, norms, step_ms = [], [], []
    with trainer.model_comm.recording() as mops:
        for batch in batches:
            t1 = time.perf_counter()
            state, loss, nrm = trainer.train_step(state, batch, lr)
            sync(dev)
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss[0]))
            norms.append(nrm[0].cpu().numpy())
    return state, losses, norms, step_ms, ops.launch_counts(), (list(mops) if record else None)


def tp_rank_run(comm, per_leaf, steps):
    """Phase 37 on one rank of the (TP_G x TP_M) world: granite-8b x2 from
    the seed-0 weights in float32 (losses, norms, θ and m of its node on the
    sampled columns, the replicated leaves, launches), then in bfloat16,
    timed (step ms, the model group's collectives a step, one activation
    all-reduce's ms, peak allocation)."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    t0 = time.perf_counter()
    out = {"transport": comm.transport}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = tp_granite_cfg(dtype)
        trainer = tp_trainer(cfg, dev)
        if trainer.engine != "ranks" or trainer.tp is None:
            raise RuntimeError(f"rank {comm.rank} runs the {trainer.engine} engine without "
                               "a model group")
        state = trainer.init_state(seed=0)
        src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
        batches = [src.stacked(TP_G, t, BATCH) for t in range(steps)]
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state, losses, norms, step_ms, counts, mops = tp_train(
            trainer, state, batches, LR, dev, record=name == "bf16")
        run = {"losses": np.array(losses), "norms": np.stack(norms), "step_ms": step_ms,
               "launches": counts, "replicated": replicated_leaves(trainer, state),
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
               "row_elems": trainer.layout.size}
        if name == "f32":
            run["theta"] = tp_sampled(trainer, state.theta, per_leaf)
            run["mom"] = tp_sampled(trainer, state.mom, per_leaf)
        else:
            ar = [op for op in mops if op.kind == "all_reduce"]
            run["model_ops_a_step"] = len(mops) / steps
            run["model_all_reduces_a_step"] = len(ar) / steps
            run["model_bytes_a_step"] = sum(op.nbytes for op in mops) / steps
            # one float32 activation all-reduce, as the row-parallel products issue it
            x = torch.zeros(BATCH * SEQ * cfg.d_model, dtype=torch.float32, device=dev)
            trainer.model_comm.all_reduce(x)
            times = []
            for _ in range(TP_ALLREDUCE_ITERS):
                torch.cuda.synchronize(dev)
                t1 = time.perf_counter()
                trainer.model_comm.all_reduce(x)
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t1) * 1e3)
            run["activation_all_reduce_ms"] = float(np.median(times))
            del x
        out[name] = run
        del trainer, state
        torch.cuda.empty_cache()
    out["rank_s"] = time.perf_counter() - t0
    return out


def stacked_tp_reference(dev, sample, steps):
    """Phase 37's reference: the stacked engine at G = TP_G with the same
    mesh (one card: the model axis carries no device), granite-8b x2 in
    float32 from the seed-0 weights: per-step losses and norms, θ and m on
    the sampled columns."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM

    cfg = tp_granite_cfg(torch.float32)
    trainer = tp_trainer(cfg, dev)
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(steps):
        state, loss, nrm = trainer.train_step(state, src.stacked(TP_G, t, BATCH), LR)
        losses.append(loss.cpu().numpy())
        norms.append(nrm.cpu().numpy())
    idx = torch.as_tensor(sample, device=dev)
    ref = {"losses": np.stack(losses), "norms": np.stack(norms),
           "theta": state.theta[:, idx].cpu().numpy(), "mom": state.mom[:, idx].cpu().numpy()}
    del trainer, state, idx
    torch.cuda.empty_cache()
    return ref


def check_replicated(label, res):
    """Every node's model ranks hold their replicated leaves bit for bit."""
    import numpy as np

    n = 0
    for i in range(TP_G):
        a = res[i * TP_M]
        for j in range(1, TP_M):
            b = res[i * TP_M + j]
            if list(a) != list(b):
                fail(f"{label}: node {i}'s ranks hold different replicated leaves")
            for k in a:
                if not np.array_equal(a[k], b[k]):
                    fail(f"{label}: replicated leaf {k} differs between node {i}'s model "
                         f"ranks 0 and {j}")
                n += 1
    return n


def check_tp(res, ref, dev, layout):
    """Phase 37's checks of the world's results (``res[r]``: rank r's
    ``tp_rank_run``) against the stacked engine's ``ref``, and K2 on one
    rank's shard row against its twin.  Returns (the phase's numbers, K2's
    max abs error)."""
    import numpy as np
    import torch

    want = {"gossip_program_update": 0, "gossip_update": TP_STEPS,
            "segment_l2_norms": TP_STEPS, "flash_attention": 0}
    worst = {"loss": 0.0, "theta": 0.0, "mom": 0.0, "norm_rel": 0.0}
    for r, rank in enumerate(res):
        i = r // TP_M
        for name in ("f32", "bf16"):
            if rank[name]["launches"] != want:
                fail(f"phase 37 rank {r} ({name}): launches {rank[name]['launches']}, "
                     f"expected {want}")
            if not np.isfinite(rank[name]["losses"]).all():
                fail(f"phase 37 rank {r} ({name}): non-finite losses")
        f = rank["f32"]
        d_loss = float(np.abs(f["losses"] - ref["losses"][:, i]).max())
        d_theta = float(np.abs(f["theta"] - ref["theta"][i]).max())
        d_mom = float(np.abs(f["mom"] - ref["mom"][i]).max())
        rel = np.abs(f["norms"] - ref["norms"][:, i]) / np.abs(ref["norms"][:, i])
        if max(d_loss, d_theta, d_mom) >= 5e-5 or not (rel <= 1e-5).all():
            fail(f"phase 37 rank {r}: against the stacked engine losses {d_loss:.3e}, theta "
                 f"{d_theta:.3e}, m {d_mom:.3e}, norms rel {float(rel.max()):.3e}")
        worst = {"loss": max(worst["loss"], d_loss), "theta": max(worst["theta"], d_theta),
                 "mom": max(worst["mom"], d_mom),
                 "norm_rel": max(worst["norm_rel"], float(rel.max()))}
    n_rep = check_replicated("phase 37 f32", [rk["f32"]["replicated"] for rk in res])
    check_replicated("phase 37 bf16", [rk["bf16"]["replicated"] for rk in res])
    # K2 on one rank's shard row (the bf16 run's row length) against its twin
    p_row = res[0]["bf16"]["row_elems"]
    theta0, grad1, nbrs, mom0, w_row = k2_inputs(dev, p_row)
    err_k2 = k2_against_twin(theta0, grad1, nbrs, mom0, w_row)
    del theta0, grad1, nbrs, mom0
    torch.cuda.empty_cache()
    b = [rk["bf16"] for rk in res]
    out = {
        "ranks": TP_G * TP_M, "mesh": {"data": TP_G, "model": TP_M},
        "transport": res[0]["transport"], "cards": torch.cuda.device_count(),
        "f32_vs_stacked": worst, "replicated_leaves_checked": n_rep,
        "row_elems": p_row, "node_elems": layout.size,
        "bf16_step_ms": [rk["step_ms"] for rk in b],
        "f32_step_ms": [rk["f32"]["step_ms"] for rk in res],
        "model_ops_a_step": b[0]["model_ops_a_step"],
        "model_all_reduces_a_step": b[0]["model_all_reduces_a_step"],
        "model_bytes_a_step": b[0]["model_bytes_a_step"],
        "activation_all_reduce_ms": [rk["activation_all_reduce_ms"] for rk in b],
        "peak_allocated_bytes": [int(rk["peak_allocated_bytes"]) for rk in b],
        "launches": {k: sum(rk["f32"]["launches"][k] + rk["bf16"]["launches"][k] for rk in res)
                     for k in want},
        "k2_shard_row_max_abs_err": err_k2, "rank_s": max(rk["rank_s"] for rk in res),
    }
    log(f"phase 37: {TP_G} x {TP_M} ranks over {out['transport']}: float32 {TP_STEPS} "
        f"steps against the stacked engine: losses {worst['loss']:.3e}, theta "
        f"{worst['theta']:.3e}, m {worst['mom']:.3e}, norms rel {worst['norm_rel']:.3e}; "
        f"{n_rep} replicated leaves bit for bit across model ranks; K2 {want['gossip_update']} "
        f"and K3 {want['segment_l2_norms']} a rank a run; bf16 step ms per rank "
        f"{[[round(x, 1) for x in ms] for ms in out['bf16_step_ms']]}; the model group's "
        f"{out['model_all_reduces_a_step']:.0f} all-reduces a step "
        f"({out['model_bytes_a_step'] / 2**20:.1f} MiB of operands), one activation "
        f"all-reduce {[round(x, 2) for x in out['activation_all_reduce_ms']]} ms; peak "
        f"{[round(x / 2**30, 2) for x in out['peak_allocated_bytes']]} GiB a rank; shard "
        f"row {p_row:,} of {layout.size:,}; K2 on it within {err_k2:.3e} of its twin; "
        f"{out['rank_s']:.1f} s on the ranks")
    return out, err_k2


def tp_ep_rank_run(comm, per_leaf, steps):
    """Phases 37 and 38 on one rank of their shared (TP_G x TP_M) world."""
    return {"tp": tp_rank_run(comm, per_leaf, steps), "ep": ep_rank_run(comm)}


def phase_tp_ep(dev, done):
    """The checks of phases 37 and 38, which ran in one world of TP_G x
    TP_M ranks (NCCL with a card per rank, else gloo through pinned host
    buffers on the one card).  ``done``: the stacked engine's float32
    reference and ``apply_moe``'s, their seconds, the ranks' results and
    seconds from ``rank_world``.  Returns (phase 37's numbers, phase 38's,
    K2's max abs error on the shard row)."""
    _, layout = granite_layout()
    (ref37, want38, (t0, t1, t2)), res, world_s = done
    t3 = t2 + world_s
    t_check = time.perf_counter()
    out37, err_k2 = check_tp([r["tp"] for r in res], ref37, dev, layout)
    t4 = time.perf_counter()
    out38 = check_ep([r["ep"] for r in res], want38)
    out37["reference_s"], out38["reference_s"] = t1 - t0, t2 - t1
    out37["world_s"] = out38["world_s"] = t3 - t2
    out37["k2_check_s"] = t4 - t_check
    log(f"phases 37-38: references {t1 - t0:.1f} + {t2 - t1:.1f} s, the world {t3 - t2:.1f} s "
        f"(phase 37 {out37['rank_s']:.1f} s, phase 38 {out38['rank_s']:.1f} s on the ranks)")
    return out37, out38, err_k2


def run_rank_jobs(comm, jobs):
    """Each ``(fn, args)`` of ``jobs`` in turn on this rank: [(fn(comm,
    *args), seconds)]."""
    out = []
    for fn, args in jobs:
        t0 = time.perf_counter()
        out.append((fn(comm, *args), time.perf_counter() - t0))
    return out


RANK_PHASES = (9, 22, 24, "tp", 40, 41, 42, 43)


def rank_world(dev, layout, sample, phases=RANK_PHASES):
    """The rank halves of ``phases`` (of RANK_PHASES; "tp" is 37 and 38)
    in one world of G ranks on ``dev``'s device (the card, or gloo ranks
    on the CPU), so that its processes start once: the references of 22,
    37, 38, 40 and 41 first (in this process), phase 24's file read on its
    sampled columns and removed after.  Returns each phase's ``done``
    argument."""
    import shutil

    import torch
    from repro_torch.launch.comm import spawn_world

    dev = torch.device(dev)
    device = None if dev.type == "cuda" else dev.type
    if {"tp", 40, 41, 42, 43} & set(phases) and TP_G * TP_M != G:
        fail(f"phases 37-43 need a world of {TP_G * TP_M} ranks, the shared one has {G}")
    for n, msg in ((22, PREDICT_22), (24, PREDICT_24), ("tp", PREDICT_37), ("tp", PREDICT_38),
                   (40, PREDICT_40), (41, PREDICT_41), (42, PREDICT_42), (43, PREDICT_43)):
        if n in phases:
            log(msg)
    refs, jobs = {}, {}
    if 9 in phases:
        jobs[9] = (rank_run, (sample, RANK_STEPS))
    if 22 in phases:
        refs[22] = stacked_fault_reference(dev, sample, FAULT_RANK_STEPS)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        jobs[22] = (fault_rank_run, (sample, FAULT_RANK_STEPS))
    if "tp" in phases:
        t0 = time.perf_counter()
        ref37 = stacked_tp_reference(dev, sample, TP_STEPS)
        t1 = time.perf_counter()
        want38 = ep_reference(dev)
        refs["tp"] = (ref37, want38, (t0, t1, time.perf_counter()))
        jobs["tp"] = (tp_ep_rank_run, (leaf_samples(layout, sample), TP_STEPS))
    if 40 in phases:
        from repro_torch.core.flat import FlatLayout
        from repro_torch.models import transformer as tfm

        t0 = time.perf_counter()
        refs40, layouts, runs = {}, {}, []
        for label, cfg32, cfg16 in p40_runs():
            layouts[label] = FlatLayout.of_defs(tfm.model_defs(cfg32, TP_M))
            cols = sample_columns(layouts[label])
            refs40[label] = stacked_ssm_reference(cfg32, dev, cols, P40_F32_STEPS, SEQ, BATCH)
            runs.append((label, cfg32, cfg16, leaf_samples(layouts[label], cols)))
        refs[40] = (refs40, layouts)
        jobs[40] = (ssm_tp_rank_run, (runs, SEQ, BATCH))
        log(f"phase 40: the stacked engine's references in {time.perf_counter() - t0:.1f} s")
    if 41 in phases:
        t0 = time.perf_counter()
        cases, cfg16, tb, ts, tnew = p41_cases()
        refs[41] = (single_card_serving(dev, cases, P41_B, P41_S, P41_NEW), cfg16)
        jobs[41] = (serve_rank_run, (cases, P41_B, P41_S, P41_NEW, (cfg16, tb, ts, tnew)))
        log(f"phase 41: the single card's references in {time.perf_counter() - t0:.1f} s")
    for n, cfg_of, reference, job in ((42, p42_cfg, g1_reference, g1_rank_run),
                                      (43, p43_cfg, fault_tp_reference, fault_tp_rank_run)):
        if n in phases:
            from repro_torch.core.flat import FlatLayout
            from repro_torch.models import transformer as tfm

            t0 = time.perf_counter()
            node = FlatLayout.of_defs(tfm.model_defs(cfg_of(torch.float32), TP_M))
            cols = sample_columns(node)
            refs[n] = reference(dev, cols)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            jobs[n] = (job, (leaf_samples(node, cols),))
            log(f"phase {n}: the stacked engine's reference in "
                f"{time.perf_counter() - t0:.1f} s")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    d = checkpoint_dir(state_bytes(layout)) if 24 in phases else None
    try:
        if d is not None:
            jobs[24] = (resume_rank_run, (str(d), RANK_RESUME_STEPS, RANK_RESUME_CUT))
        keys = [k for k in phases if k in jobs]
        res = spawn_world(run_rank_jobs, G, ([jobs[k] for k in keys],),
                          timeout=RANK_TIMEOUT + TP_TIMEOUT * len({"tp", 40, 41, 42, 43}
                                                                  & set(keys)),
                          device=device)
        if d is not None:
            file24 = ranks_resume_file(d, layout, sample)
    finally:
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)
    done = {k: ([r[i][0] for r in res], max(r[i][1] for r in res)) for i, k in enumerate(keys)}
    log(f"phases {keys} ranks: {[round(done[k][1], 1) for k in keys]} s in one world of {G}")
    for k, ref in refs.items():
        done[k] = (ref,) + done[k]
    if 24 in done:
        done[24] = (done[24][0], file24, done[24][1])
    return done


def ep_layer(dev, experts):
    """The phase 38 MoE layer at phi3.5-moe's width: the router and the
    experts ``experts`` (each seeded by its index, float32), the input x
    (EP_B, EP_S, d_model) and a seeded output weighting."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(EP_ARCH)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def randn(shape, seed, std):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev) * std

    params = {"router": randn((d, e), 380, 0.02)}
    for n, (k, shape, std) in enumerate((("w_gate", (d, f), (2 / d) ** 0.5),
                                         ("w_up", (d, f), (2 / d) ** 0.5),
                                         ("w_down", (f, d), (2 / f) ** 0.5))):
        params[k] = torch.stack([randn(shape, 1000 * (i + 1) + n, std) for i in experts])
    x = randn((EP_B, EP_S, d), 381, 1.0)
    w = randn((EP_B, EP_S, d), 382, 1.0)
    return cfg, params, x, w


def ep_rank_run(comm):
    """Phase 38 on one rank of the (TP_G x TP_M) world: the MoE layer with
    this rank's experts over its node's model group (forward and backward,
    float32).  (phi3.5-moe x1 trains on the same world in phase 42, under
    kimi-k2's placement.)"""
    import numpy as np
    import torch
    from repro_torch.launch.comm import mesh_comms
    from repro_torch.launch.tensor_parallel import ModelParallel
    from repro_torch.models.moe import apply_moe_manual_ep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    t0 = time.perf_counter()
    _, model = mesh_comms(comm, TP_G, TP_M)
    cfg = zoo_cfg(EP_ARCH, 1)
    e_local = cfg.n_experts // TP_M
    experts = range(model.rank * e_local, (model.rank + 1) * e_local)
    _, params, x, w = ep_layer(dev, experts)
    params = {k: v.requires_grad_() for k, v in params.items()}
    out, aux = apply_moe_manual_ep(params, x, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor, tp=ModelParallel(model))
    ((out * w).sum() + cfg.aux_loss_weight * aux).backward()
    layer = {"out": out.detach().cpu().numpy(), "aux": float(aux),
             "expert_grad_max": {k: params[k].grad.abs().amax(dim=(1, 2)).cpu().numpy()
                                 for k in ("w_gate", "w_up", "w_down")},
             "experts": list(experts)}
    del params, x, w, out, aux
    torch.cuda.empty_cache()
    return {"layer": layer, "transport": comm.transport, "rank_s": time.perf_counter() - t0}


def ep_reference(dev):
    """Phase 38's reference: ``apply_moe`` on one rank holding every expert
    of the layer (float32): (output, aux loss) on the host."""
    import torch
    from repro_torch.models.moe import apply_moe

    cfg, params, x, _ = ep_layer(dev, range(zoo_cfg(EP_ARCH, 1).n_experts))
    with torch.no_grad():
        want, want_aux = apply_moe(params, x, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
    out = (want.cpu().numpy(), float(want_aux))
    del params, x, want
    torch.cuda.empty_cache()
    return out


def check_ep(res, want):
    """Phase 38's checks: each rank's manual-EP layer against ``apply_moe``
    (the reference's manual-EP bars: output atol 1e-5, aux 1e-6; every
    expert a nonzero gradient)."""
    import numpy as np

    cfg = zoo_cfg(EP_ARCH, 1)
    want, want_aux = want
    err_out = err_aux = 0.0
    for r, rank in enumerate(res):
        lay = rank["layer"]
        err_out = max(err_out, float(np.abs(lay["out"] - want).max()))
        err_aux = max(err_aux, abs(lay["aux"] - want_aux))
        for k, g in lay["expert_grad_max"].items():
            if not (g > 0).all():
                fail(f"phase 38 rank {r}: experts {lay['experts']} {k} gradients {g.tolist()}")
    if err_out >= 1e-5 or err_aux >= 1e-6:
        fail(f"phase 38: manual EP against apply_moe: output {err_out:.3e} (bar 1e-5), aux "
             f"{err_aux:.3e} (bar 1e-6)")
    out = {
        "layer": {"tokens": EP_B * EP_S, "experts_a_rank": cfg.n_experts // TP_M,
                  "max_abs_err": err_out, "aux_abs_err": err_aux},
        "transport": res[0]["transport"], "rank_s": max(rk["rank_s"] for rk in res),
    }
    log(f"phase 38: the MoE layer ({EP_B * EP_S} tokens, {cfg.n_experts} experts, "
        f"{cfg.n_experts // TP_M} a rank) against apply_moe: output {err_out:.3e}, aux "
        f"{err_aux:.3e}, every expert a gradient; {out['rank_s']:.1f} s on the ranks")
    return out


def train100m_runs(comm, argvs):
    """Phase 39 on one rank: ``repro_torch.examples.train_100m.run`` for
    each argument list in turn, in this world; the rank's shard rows of θ
    and m come back as the SHA-1 of their bytes."""
    from repro_torch.examples import train_100m

    out = []
    for argv in argvs:
        r = train_100m.run(argv, comm=comm)
        r.pop("trainer")
        state = r.pop("state")
        r["theta"] = _digest(r["theta"])
        r["mom"] = _digest(state.mom[0].cpu().numpy())
        out.append(r)
    return out


def phase_train_100m(dev):
    """Phase 39: the example's 100m preset on (4 data x 2 model) ranks:
    P39_STEPS steps uninterrupted and, in the same world, P39_CUT steps that
    end in a checkpoint; then a fresh world resumed from that checkpoint to
    step P39_STEPS, whose every rank's shard rows of θ and m must be the
    uninterrupted run's bit for bit (their SHA-1 digests equal)."""
    import shutil

    import numpy as np
    from repro_torch.launch.comm import spawn_world

    ckpt = CKPT_DIR / "p39"
    shutil.rmtree(ckpt, ignore_errors=True)
    run = lambda steps, every, d: ["--preset", "100m", "--steps", str(steps), "--ckpt-every",
                                   str(every), "--ckpt-dir", str(ckpt / d)]
    t0 = time.perf_counter()
    try:
        world1 = spawn_world(train100m_runs, 8, ([run(P39_STEPS, 0, "full"),
                                                  run(P39_CUT, P39_CUT, "cut")],),
                             timeout=TP_TIMEOUT)
        t1 = time.perf_counter()
        world2 = spawn_world(train100m_runs, 8, ([run(P39_STEPS, 0, "cut")],),
                             timeout=TP_TIMEOUT)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want = {"gossip_update": P39_STEPS, "segment_l2_norms": P39_STEPS}
    for r, (full, resumed) in enumerate(zip([w[0] for w in world1], [w[0] for w in world2])):
        if full["start"] != 0 or resumed["start"] != P39_CUT:
            fail(f"phase 39 rank {r}: started at steps {full['start']} and {resumed['start']}")
        for what in ("theta", "mom"):
            if full[what] != resumed[what]:
                fail(f"phase 39 rank {r}: the resumed shard row of {what} differs from the "
                     f"uninterrupted run's (SHA-1 {resumed[what]} against {full[what]})")
        if full["losses"][P39_CUT:] != resumed["losses"]:
            fail(f"phase 39 rank {r}: resumed losses differ")
        if any(full["launches"][k] != v for k, v in want.items()):
            fail(f"phase 39 rank {r}: launches {full['launches']}, expected {want}")
        if not np.isfinite(full["losses"]).all():
            fail(f"phase 39 rank {r}: losses {full['losses']}")
    full = world1[0][0]
    out = {
        "preset": "100m", "n_params": full["n_params"], "mesh": {"data": 4, "model": 2},
        "step_ms": [w[0]["step_ms"] for w in world1],
        "median_step_ms": float(np.median([x for w in world1 for x in w[0]["step_ms"][1:]])),
        "losses": full["losses"], "gini_first_last": full["gini"],
        "launches": {k: sum(w[0]["launches"][k] for w in world1) for k in full["launches"]},
        "world1_s": t1 - t0, "world2_s": t2 - t1,
    }
    log(f"phase 39: train_100m 100m preset ({full['n_params'] / 1e6:.1f}M) on 4 x 2 ranks: "
        f"median step {out['median_step_ms']:.1f} ms, loss {full['losses'][0]:.4f} -> "
        f"{full['losses'][-1]:.4f}; resumed at step {P39_CUT} in a fresh world == the "
        f"uninterrupted run bit for bit on all 8 ranks (theta and m); gini(param norms): "
        f"first={full['gini'][0]:.5f} last={full['gini'][1]:.5f} (unrounded "
        f"{full['gini'][0]!r}, {full['gini'][1]!r}); the worlds {t1 - t0:.1f} + "
        f"{t2 - t1:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phases 40-41: the ssm and hybrid families on the tensor-parallel ranks
# engine; serving on a mesh (both in the shared world, TP_G x TP_M ranks)
# ---------------------------------------------------------------------------

P40_ARCHS = (("rwkv6-1.6b", 2), ("zamba2-7b", 7))   # (arch, layers) at published width
P40_F32_STEPS, P40_BF16_STEPS = 3, 2
P40_TOL = 5e-5
P41_ARCHS = (("granite-8b", 2), ("rwkv6-1.6b", 2), ("zamba2-7b", 7))
P41_B, P41_S, P41_NEW = 4, 64, 16               # float32 check: prompts, new tokens
P41_TIME = ("granite-8b", 36, 2, 512, 32)         # bf16 on (1 x 2): arch, layers, B, S, new
P41_TOL = 5e-5                                    # of the largest logit's magnitude
PREDICT_40 = (
    "phase 40 prediction (PERF.md §6): rwkv6-1.6b x2 and zamba2-7b x7 on (2 data x 2 model) "
    "ranks over gloo-host: float32 against the stacked engine at G = 2, the first step's "
    "loss, norms, theta and m within 5e-5 (norms rtol 1e-5) plus twice the stacked engine's "
    "own float32 rounding (its run with a float64 forward and backward); after 3 steps the "
    "runs part about as far as that rounding (run B: rwkv6 theta 1.4e-3, zamba2 losses "
    "3.1e-2), printed, not gated; replicated "
    "leaves bit for bit (zamba2's float32 a_log and d_skip included), K2 and K3 once a step a "
    "rank; bf16 rank step near phase 37's (1-2 s) for rwkv6 and 2-5 s for zamba2 x7 (a half "
    "row of 451M crosses gloo-host), peak about half a stacked node's (rwkv6 3-6 GiB, zamba2 "
    "8-14 GiB a rank); 40-90 s")
PREDICT_41 = (
    "phase 41 prediction (PERF.md §6): granite-8b x2, rwkv6-1.6b x2 and zamba2-7b x7 in "
    "float32 on (2 x 2) ranks: prefill and every decode step's logits within 5e-5 of the "
    "largest logit's magnitude of the single-card engine's (expected <= 1e-6), the greedy "
    "tokens equal; granite-8b x36 bf16 on (1 x 2): prefill 2 x 512 0.3-1.5 s, decode "
    "80-200 ms a token (phase 11's 74 ms plus ~72 small all-reduces over gloo-host), peak "
    "9-11 GiB a rank; no kernel launch; 20-60 s")


def p40_runs():
    """Phase 40's configurations: (label, float32 cfg, bf16 cfg) of each of
    P40_ARCHS at published width (``zoo_cfg``), depth cut."""
    import torch

    return [(arch, zoo_cfg(arch, layers, torch.float32), zoo_cfg(arch, layers))
            for arch, layers in P40_ARCHS]


def p41_cases():
    """Phase 41's float32 configurations and its bf16 timing's."""
    import torch

    arch, layers, b, s, n_new = P41_TIME
    return ([(arch_, zoo_cfg(arch_, layers_, torch.float32)) for arch_, layers_ in P41_ARCHS],
            zoo_cfg(arch, layers), b, s, n_new)


def _digest(x):
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(x).tobytes()).hexdigest()


def wide_loss(cfg):
    """``cfg``'s loss with the forward and backward in float64 (the
    parameters and the loss cast at the boundary): the stacked engine's
    run that measures its own float32 rounding."""
    import torch
    from repro_torch.models import transformer as tfm

    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    return lambda p, b: tfm.loss_fn({k: v.double() for k, v in p.items()}, cfg64, b).float()


def stacked_ssm_reference(cfg, dev, sample, steps, seq, batch):
    """Phase 40's reference for one configuration: the stacked engine at G =
    TP_G with the (TP_G x TP_M) mesh, float32 from the seed-0 weights, and
    the same run with a float64 forward and backward: per-step losses and
    norms, θ and m on the sampled columns of each after the first step
    (``theta1``, ``mom1``) and after the last."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM

    out = {}
    idx = torch.as_tensor(sample, device=dev)
    for name, kw in (("f32", {}), ("wide", {"loss_fn": wide_loss(cfg)})):
        trainer = tp_trainer(cfg, dev, **kw)
        state = trainer.init_state(seed=0)
        src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0)
        run, losses, norms = {}, [], []
        for t in range(steps):
            state, loss, nrm = trainer.train_step(state, src.stacked(TP_G, t, batch), LR)
            losses.append(loss.cpu().numpy())
            norms.append(nrm.cpu().numpy())
            if t == 0 or t == steps - 1:
                tag = "1" if t == 0 else ""
                run["theta" + tag] = state.theta[:, idx].float().cpu().numpy()
                run["mom" + tag] = state.mom[:, idx].cpu().numpy()
        out[name] = dict(run, losses=np.stack(losses), norms=np.stack(norms))
        del trainer, state
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


def ssm_tp_rank_run(comm, runs, seq, batch):
    """Phase 40 on one rank of the (TP_G x TP_M) world: each configuration
    of ``runs`` ((label, float32 cfg, bf16 cfg, the sampled columns of each
    leaf)) from the seed-0 weights, P40_F32_STEPS steps in float32 (losses,
    norms, θ and m of its node on the sampled columns, digests of the
    replicated leaves, launches), then P40_BF16_STEPS steps in bfloat16
    timed (step ms, the model group's collectives a step, one activation
    all-reduce's ms, peak)."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    cuda = dev.type == "cuda"
    out = {"transport": comm.transport}
    for label, cfg32, cfg16, per_leaf in runs:
        t0 = time.perf_counter()
        res = {}
        for name, cfg, steps in (("f32", cfg32, P40_F32_STEPS), ("bf16", cfg16, P40_BF16_STEPS)):
            trainer = tp_trainer(cfg, dev)
            if trainer.engine != "ranks" or trainer.tp is None:
                raise RuntimeError(f"rank {comm.rank} runs the {trainer.engine} engine "
                                   "without a model group")
            state = trainer.init_state(seed=0)
            src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0)
            batches = [src.stacked(TP_G, t, batch) for t in range(steps)]
            sync(dev)
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            first = {}
            if name == "f32":     # θ and m after the first step, then the rest
                state, l1, n1, ms1, c1, _ = tp_train(trainer, state, batches[:1], LR, dev)
                first = {"theta1": tp_sampled(trainer, state.theta, per_leaf),
                         "mom1": tp_sampled(trainer, state.mom, per_leaf)}
                batches = batches[1:]
            state, losses, norms, step_ms, counts, mops = tp_train(
                trainer, state, batches, LR, dev, record=name == "bf16")
            if name == "f32":
                losses, norms, step_ms = l1 + losses, n1 + norms, ms1 + step_ms
                counts = {k: counts[k] + c1[k] for k in counts}
            views = trainer.stacked_params(state)
            run = {"losses": np.array(losses), "norms": np.stack(norms), "step_ms": step_ms,
                   "launches": counts, "row_elems": trainer.layout.size,
                   "replicated": {k: _digest(views[k].float().cpu().numpy())
                                  for k, whole in zip(trainer.defs, trainer._replicated())
                                  if whole},
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev) if cuda
                   else 0, **first}
            if name == "f32":
                run["theta"] = tp_sampled(trainer, state.theta, per_leaf)
                run["mom"] = tp_sampled(trainer, state.mom, per_leaf)
            else:
                run["model_all_reduces_a_step"] = sum(
                    op.kind == "all_reduce" for op in mops) / steps
                run["model_bytes_a_step"] = sum(op.nbytes for op in mops) / steps
                x = torch.zeros(batch * seq * cfg.d_model, dtype=torch.float32, device=dev)
                trainer.model_comm.all_reduce(x)
                times = []
                for _ in range(TP_ALLREDUCE_ITERS):
                    sync(dev)
                    t1 = time.perf_counter()
                    trainer.model_comm.all_reduce(x)
                    sync(dev)
                    times.append((time.perf_counter() - t1) * 1e3)
                run["activation_all_reduce_ms"] = float(np.median(times))
                del x
            res[name] = run
            del trainer, state, views
            if cuda:
                torch.cuda.empty_cache()
        res["rank_s"] = time.perf_counter() - t0
        out[label] = res
    return out


def check_ssm_tp(res, refs, layouts):
    """Phase 40's checks: every rank's float32 run against the stacked
    engine's (``refs[label]``: its float32 run and its float64-forward
    run) from the same seed-0 weights: the first step's loss and norms, and
    θ and m after it, within P40_TOL (norms rtol 1e-5) plus twice the
    stacked engine's own rounding of them; the later steps part as
    free-running float32 runs of these families do (ill-conditioned group
    norms), so their distance is reported beside the stacked engine's own
    float32-float64 spread and gated by finiteness; the replicated leaves
    bit for bit across each node's model ranks (their digests) after every
    run; K2 and K3 once a step a rank.  Returns the phase's numbers."""
    import numpy as np

    out = {"ranks": TP_G * TP_M, "mesh": {"data": TP_G, "model": TP_M},
           "transport": res[0]["transport"]}
    launches = {"gossip_program_update": 0, "gossip_update": 0, "segment_l2_norms": 0,
                "flash_attention": 0}
    # the CPU's ranks (gloo) run the kernels' twins, which count no launch
    on_card = out["transport"] != "gloo"
    for label, ref in refs.items():
        r32, wide = ref["f32"], ref["wide"]
        term = {"loss": 2 * float(np.abs(wide["losses"][0] - r32["losses"][0]).max()),
                "theta1": 2 * float(np.abs(wide["theta1"] - r32["theta1"]).max()),
                "mom1": 2 * float(np.abs(wide["mom1"] - r32["mom1"]).max())}
        spread = {k: float(np.abs(wide[k] - r32[k]).max()) for k in ("losses", "theta", "mom")}
        norm_term = 2 * np.abs(wide["norms"][0] - r32["norms"][0])
        worst = {"loss": 0.0, "theta1": 0.0, "mom1": 0.0, "norm_rel": 0.0}
        later = {"losses": 0.0, "theta": 0.0, "mom": 0.0}
        for r, rank in enumerate(res):
            i = r // TP_M
            mine = rank[label]
            for name, steps in (("f32", P40_F32_STEPS), ("bf16", P40_BF16_STEPS)):
                want = {"gossip_program_update": 0, "gossip_update": steps * on_card,
                        "segment_l2_norms": steps * on_card, "flash_attention": 0}
                if mine[name]["launches"] != want:
                    fail(f"phase 40 {label} rank {r} ({name}): launches "
                         f"{mine[name]['launches']}, expected {want}")
                if not np.isfinite(mine[name]["losses"]).all():
                    fail(f"phase 40 {label} rank {r} ({name}): non-finite losses")
                for k in launches:
                    launches[k] += mine[name]["launches"][k]
            f = mine["f32"]
            got = {"loss": f["losses"][0], "theta1": f["theta1"], "mom1": f["mom1"]}
            want = {"loss": r32["losses"][0, i], "theta1": r32["theta1"][i],
                    "mom1": r32["mom1"][i]}
            for k in got:
                d = float(np.abs(got[k] - want[k]).max())
                if d > P40_TOL + term[k]:
                    fail(f"phase 40 {label} rank {r}: {k} {d:.3e} from the stacked engine, "
                         f"bar {P40_TOL:.0e} + {term[k]:.3e}")
                worst[k] = max(worst[k], d)
            for k, w in (("losses", r32["losses"][:, i]), ("theta", r32["theta"][i]),
                         ("mom", r32["mom"][i])):
                later[k] = max(later[k], float(np.abs(f[k] - w).max()))
                if not np.isfinite(f[k]).all():
                    fail(f"phase 40 {label} rank {r}: non-finite {k}")
            n_ref = r32["norms"][0, i]
            dn = np.abs(f["norms"][0] - n_ref)
            if not (dn <= 1e-5 * np.abs(n_ref) + norm_term[i]).all():
                fail(f"phase 40 {label} rank {r}: norms {float((dn / np.abs(n_ref)).max()):.3e} "
                     "relative from the stacked engine")
            worst["norm_rel"] = max(worst["norm_rel"],
                                    float((dn / np.maximum(np.abs(n_ref), 1e-30)).max()))
        n_rep = 0
        for name in ("f32", "bf16"):
            for i in range(TP_G):
                a = res[i * TP_M][label][name]["replicated"]
                for j in range(1, TP_M):
                    if res[i * TP_M + j][label][name]["replicated"] != a:
                        fail(f"phase 40 {label} {name}: node {i}'s model ranks hold different "
                             "replicated leaves")
                n_rep += len(a)
        b = [rk[label]["bf16"] for rk in res]
        out[label] = {
            "node_elems": layouts[label].size, "row_elems": res[0][label]["f32"]["row_elems"],
            "f32_vs_stacked_first_step": worst, "rounding_term": term,
            "f32_vs_stacked_last_step": later, "stacked_f32_vs_f64_last_step": spread,
            "replicated_leaves_checked": n_rep,
            "f32_step_ms": [rk[label]["f32"]["step_ms"] for rk in res],
            "bf16_step_ms": [x["step_ms"] for x in b],
            "model_all_reduces_a_step": b[0]["model_all_reduces_a_step"],
            "model_bytes_a_step": b[0]["model_bytes_a_step"],
            "activation_all_reduce_ms": [x["activation_all_reduce_ms"] for x in b],
            "peak_allocated_bytes": [int(x["peak_allocated_bytes"]) for x in b],
            "rank_s": max(rk[label]["rank_s"] for rk in res),
        }
        log(f"phase 40: {label} on {TP_G} x {TP_M} ranks over {out['transport']}: float32 "
            f"against the stacked engine, the first step: loss {worst['loss']:.3e}, theta "
            f"{worst['theta1']:.3e}, m {worst['mom1']:.3e} (rounding terms "
            f"{ {k: float(f'{v:.3e}') for k, v in term.items()} }), norms rel "
            f"{worst['norm_rel']:.3e}; after {P40_F32_STEPS} steps losses {later['losses']:.3e}, "
            f"theta {later['theta']:.3e}, m {later['mom']:.3e} (the stacked engine's own float32 "
            f"against float64: {spread['losses']:.3e}, {spread['theta']:.3e}, "
            f"{spread['mom']:.3e}); {n_rep} replicated leaves bit for bit; bf16 step ms "
            f"per rank {[[round(x, 1) for x in ms] for ms in out[label]['bf16_step_ms']]}; "
            f"{out[label]['model_all_reduces_a_step']:.0f} model-group all-reduces a step "
            f"({out[label]['model_bytes_a_step'] / 2**20:.1f} MiB), one activation all-reduce "
            f"{[round(x, 2) for x in out[label]['activation_all_reduce_ms']]} ms; peak "
            f"{[round(x / 2**30, 2) for x in out[label]['peak_allocated_bytes']]} GiB a rank; "
            f"shard row {out[label]['row_elems']:,} of {layouts[label].size:,}")
    out["launches"] = launches
    return out


def serve_prompts(cfg, b, s, dev, seed=41):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)


def serve_chain(eng, params, prompts, n_new):
    """Through ``eng`` (whole batch in, whole logits out on every rank):
    the prefill's last logits, then every decode step's logits (the prompt
    replayed from an empty state, then ``n_new`` greedy steps on the whole
    rows' argmax), and ``generate``'s greedy tokens: (logits (steps + 1, B,
    V) float32 numpy, the chain's tokens, generate's tokens)."""
    import numpy as np
    import torch

    b, s = prompts.shape
    last, _ = eng.prefill(params, prompts)
    logits = [last.float().cpu().numpy()]
    state = eng.init_decode_state(b, s + n_new)
    for t in range(s):
        last, state = eng.decode_step(params, prompts[:, t:t + 1], t, state)
        logits.append(last.float().cpu().numpy())
    chain = []
    for i in range(n_new):
        tok = torch.argmax(last, dim=-1)[:, None]
        chain.append(tok)
        last, state = eng.decode_step(params, tok, s + i, state)
        logits.append(last.float().cpu().numpy())
    gen = eng.generate(params, prompts, n_new)
    return (np.stack(logits), torch.cat(chain, dim=1).cpu().numpy(), gen.cpu().numpy())


def single_card_serving(dev, cases, b, s, n_new):
    """Phase 41's reference: each float32 case on one card through
    ``ServeEngine(cfg)``, seed-0 weights: ``serve_chain``'s logits and
    tokens, and the family's rounding term: 0, or for the ssm and hybrid
    families twice the largest difference of those logits from the same
    chain run in float64 (the same weights, widened)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeEngine

    out = {}
    for label, cfg in cases:
        eng = ServeEngine(cfg, dev)
        params = eng.init_params(seed=0)
        prompts = serve_prompts(cfg, b, s, dev)
        logits, chain, gen = serve_chain(eng, params, prompts, n_new)
        term = 0.0
        if cfg.family in ("ssm", "hybrid"):
            wide = ServeEngine(dataclasses.replace(cfg, dtype=torch.float64), dev)
            w_logits = serve_chain(wide, {k: v.double() for k, v in params.items()}, prompts,
                                   n_new)[0]
            term = 2 * float(np.abs(w_logits - logits).max())
        out[label] = (logits, chain, gen, term)
        del eng, params
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


def serve_rank_run(comm, cases, b, s, n_new, timing):
    """Phase 41 on one rank of the (TP_G x TP_M) world: each float32 case
    through ``ServeEngine(cfg, mesh=...)`` on the (TP_G data x TP_M model)
    mesh, seed-0 weights, ``serve_chain`` (rank 0 returns its logits and
    tokens, the others the digests of theirs); then, on the first model
    group alone as a (1 x TP_M) world, ``timing`` = (bf16 cfg, B, S, new
    tokens): prefill timed twice, then that many decode steps from the
    prefill's state (its caches grown), timed a token, and the peak."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.comm import mesh_comms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import ServeEngine, grow_caches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    cuda = dev.type == "cuda"
    data_comm, model_comm = mesh_comms(comm, TP_G, TP_M)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out = {"transport": comm.transport}
    for label, cfg in cases:
        eng = ServeEngine(cfg, dev, mesh=make_mesh((TP_G, TP_M), ("data", "model")),
                          model_comm=model_comm, data_comm=data_comm)
        params = eng.init_params(seed=0)
        logits, chain, gen = serve_chain(eng, params, serve_prompts(cfg, b, s, dev), n_new)
        out[label] = ({"logits": logits, "chain": chain, "tokens": gen} if comm.rank == 0
                      else {"digest": (_digest(logits), _digest(chain), _digest(gen))})
        del eng, params
        if cuda:
            torch.cuda.empty_cache()
    cfg16, tb, ts, tnew = timing
    if data_comm.rank == 0:
        eng = ServeEngine(cfg16, dev, mesh=make_mesh((1, TP_M), ("data", "model")),
                          model_comm=model_comm)
        params = eng.init_params(seed=0)
        prompts = serve_prompts(cfg16, tb, ts, dev)
        sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        prefill_s = []
        for _ in range(2):
            t1 = time.perf_counter()
            last, state = eng.prefill(params, prompts)
            sync(dev)
            prefill_s.append(time.perf_counter() - t1)
        state = grow_caches(state, ts + tnew)
        step = eng.decode_fn(None)
        sync(dev)
        t1 = time.perf_counter()
        for i in range(tnew):
            tok = eng._next_token(last, 0.0, None)
            last, state = step(params, tok, ts + i, state)
        sync(dev)
        out["timing"] = {"prefill_s": prefill_s,
                         "decode_ms_a_token": (time.perf_counter() - t1) * 1e3 / tnew,
                         "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev) if cuda
                         else 0,
                         "weights_bytes_a_rank": sum(p.numel() * p.element_size()
                                                     for p in params.values())}
        del eng, params, state, last
        if cuda:
            torch.cuda.empty_cache()
    out["launches"] = ops.launch_counts()
    out["rank_s"] = time.perf_counter() - t0
    return out


def check_mesh_serving(res, ref, timing_cfg):
    """Phase 41's checks: rank 0's logits (the prefill's and every decode
    step's) within P41_TOL of the largest logit's magnitude of the single
    card's (plus, for the ssm and hybrid families, the single card's own
    float32 rounding term), its chain's and ``generate``'s tokens equal;
    every other rank the same bits (digests); no kernel launched.  Returns
    the numbers."""
    import numpy as np

    out = {"ranks": TP_G * TP_M, "mesh": {"data": TP_G, "model": TP_M},
           "transport": res[0]["transport"]}
    for label, (logits, chain, gen, term) in ref.items():
        mine = res[0][label]
        scale = float(np.abs(logits).max())
        err = float(np.abs(mine["logits"] - logits).max())
        if not err <= P41_TOL * scale + term:
            fail(f"phase 41 {label}: logits {err:.3e} from the single card's "
                 f"(bar {P41_TOL:.0e} x {scale:.3f} + {term:.3e})")
        if not (np.array_equal(mine["chain"], chain) and np.array_equal(mine["tokens"], gen)):
            fail(f"phase 41 {label}: greedy tokens differ from the single card's")
        want = (_digest(mine["logits"]), _digest(mine["chain"]), _digest(mine["tokens"]))
        for r in range(1, len(res)):
            if res[r][label]["digest"] != want:
                fail(f"phase 41 {label}: rank {r}'s logits or tokens differ from rank 0's")
        out[label] = {"max_abs_err": err, "largest_logit": scale, "rounding_term": term,
                      "steps_checked": int(logits.shape[0])}
        log(f"phase 41: {label} on {TP_G} x {TP_M} ranks: prefill and {logits.shape[0] - 1} "
            f"decode steps within {err:.3e} of the single card's (largest logit "
            f"{scale:.3f}, rounding term {term:.3e}); greedy tokens equal")
    for r, rank in enumerate(res):
        if any(rank["launches"].values()):
            fail(f"phase 41 rank {r}: kernel launches {rank['launches']} while serving")
    t = [rk["timing"] for rk in res if "timing" in rk]
    arch, layers, b, s, n_new = P41_TIME
    out["timing"] = {"model": f"{arch} x{layers} bf16 on (1 x {TP_M}), prefill {b} x {s}, "
                              f"{n_new} new tokens", "ranks": t}
    out["rank_s"] = max(rk["rank_s"] for rk in res)
    log(f"phase 41: {arch} x{layers} bf16 on 1 x {TP_M} ranks: prefill {b}x{s} "
        f"{[[round(x, 3) for x in r['prefill_s']] for r in t]} s, decode "
        f"{[round(r['decode_ms_a_token'], 2) for r in t]} ms a token, peak "
        f"{[round(r['peak_allocated_bytes'] / 2**30, 2) for r in t]} GiB a rank "
        f"(weights {[round(r['weights_bytes_a_rank'] / 2**30, 2) for r in t]} GiB)")
    return out


def phase_ssm_serve(done):
    """Phases 40 and 41's checks from ``rank_world``'s ``done``."""
    (refs40, layouts), res40, s40 = done[40]
    (ref41, timing_cfg), res41, s41 = done[41]
    out40 = check_ssm_tp(res40, refs40, layouts)
    out40["world_s"] = s40
    out41 = check_mesh_serving(res41, ref41, timing_cfg)
    out41["world_s"] = s41
    return out40, out41


# ---------------------------------------------------------------------------
# Phases 42-43: kimi-k2's G = 1 placement (FSDP over the data axes,
# moe_shard_ff) and faults on a model axis, both in the shared world
# ---------------------------------------------------------------------------

P42_ARCH = "phi3.5-moe-42b-a6.6b"   # phase 42 runs its widths under kimi-k2's name
P42_NAME = "kimi-k2-1t-a32b"        # gossip_axes_for gives () on a (data, model) mesh: G = 1
P42_BATCH = 4                       # the global batch, 2 rows a data rank
P42_BF16_STEPS = 2
P43_FAULT = ("crash", dict(rate=0.5, seed=2, down_steps=1))   # node 1 down at 1, back at 2
P43_STEPS = 3
PREDICT_42 = (
    "phase 42 prediction (PERF.md §6): kimi-k2's G = 1 placement at phi3.5-moe x1's width "
    "(1,562,980,352 parameters a node) on (2 data x 2 model) ranks over gloo-host, "
    "moe_shard_ff: the first float32 step within 5e-5 of the stacked engine at G = 1 on the "
    "whole batch (norms rtol 1e-5), the dropped assignments equal, leaves whole on a group "
    "bit for bit; about 390.7M parameters a rank, 3.1 GB of bf16 state a rank plus a "
    "gathered layer; the data group moves about 0.8 GB each way a rank a step, a bf16 rank "
    "step 2-6 s; K3 once a step a rank, no K1 or K2 (no gossip at G = 1)")
PREDICT_43 = (
    "phase 43 prediction (PERF.md §6): granite-8b x1 at full width on (2 x 2) ranks, G = 2, "
    "d_ring, fused, a crash of node 1 at step 1 rejoining at step 2: float32 within 5e-5 of "
    "the stacked engine (K1 with fault rows) under the same model, replicated leaves bit for "
    "bit; K3 3 a rank, K2 on each fused step; the fault step about a fault-free rank step "
    "(0.5-2 s), the "
    "rejoin step 5-20 s (the handoff's gathers of a shard row's chunks over gloo-host)")


def p42_cfg(dtype):
    """Phase 42's model: phi3.5-moe's published widths, 1 layer, remat off,
    ``moe_shard_ff``, named kimi-k2 (its gossip placement)."""
    return dataclasses.replace(zoo_cfg(P42_ARCH, 1, dtype, moe_shard_ff=True), name=P42_NAME)


def p43_cfg(dtype):
    """Phase 43's model: phase 4's granite-8b at 1 layer."""
    return dataclasses.replace(tp_granite_cfg(dtype), n_layers=1)


def p42_trainer(cfg, dev):
    """The G = 1 trainer of phase 42 on a (TP_G data x TP_M model) mesh:
    plain momentum-SGD (no fused step at G = 1), norms."""
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    return SPMDTrainer(cfg, make_topology("d_ring", 1), sgd(momentum=0.9),
                       collect_norms=True, device=dev,
                       mesh=make_mesh((TP_G, TP_M), ("data", "model")))


def p43_trainer(cfg, dev):
    """Phase 43's trainer: phase 37's under the crash model."""
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.faults import make_fault_model
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    fm = make_fault_model(P43_FAULT[0], TP_G, **P43_FAULT[1])
    return SPMDTrainer(cfg, make_topology("d_ring", TP_G, fault_model=fm), sgd(momentum=0.9),
                       collect_norms=True, fused_apply=True, device=dev,
                       mesh=make_mesh((TP_G, TP_M), ("data", "model")))


def p42_batch(cfg, t):
    """Phase 42's step-t batch: the reference's flat (B, S) at G = 1."""
    from repro_torch.data import SyntheticLM

    b = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0).stacked(1, t, P42_BATCH)
    return {k: v[0] for k, v in b.items()}


def node_sampled(trainer, buf, per_leaf):
    """This rank's node's ``buf`` (θ or m) on the sampled columns (float32,
    leaf order): each rank puts the sampled elements its shard holds into a
    zero vector (a leaf whole on an axis: that axis's rank 0), and one
    all-reduce over each of the node's groups adds them (x + 0 is x)."""
    import numpy as np
    import torch

    views = trainer.layout.stacked_views(buf)
    coords = trainer._node_coords()
    parts = []
    for (name, cols), counted in zip(per_leaf.items(), trainer._counted()):
        full = trainer.full_defs[name].shape
        local = views[name][0]
        vals = torch.zeros(len(cols), dtype=torch.float32, device=buf.device)
        sl = trainer.shardings[name].slices(full, coords)
        at = list(np.unravel_index(cols, full))
        mine = np.full(len(cols), counted)
        for d, s in enumerate(sl):
            mine &= (at[d] >= s.start) & (at[d] < s.stop)
        if mine.any():
            idx = np.ravel_multi_index([at[d][mine] - sl[d].start for d in range(len(full))],
                                       tuple(local.shape))
            vals[torch.as_tensor(np.nonzero(mine)[0], device=buf.device)] = \
                local.reshape(-1)[torch.as_tensor(idx, device=buf.device)].float()
        parts.append(vals)
    return trainer._node_sum(torch.cat(parts)).cpu().numpy()


def whole_digests(trainer, state):
    """(leaves the model axis leaves whole, those the data axes leave
    whole): name -> SHA-1 of this rank's copy."""
    views = trainer.stacked_params(state)
    model = {k: _digest(views[k].float().cpu().numpy())
             for k, w in zip(trainer.defs, trainer._replicated()) if w}
    data = {k: _digest(views[k].float().cpu().numpy())
            for k, w in zip(trainer.defs, trainer._data_whole()) if w}
    return model, data


class _TimedComm:
    """Time (ms, after a device synchronize) and bytes of a ``Comm``'s
    all-gathers and reduce-scatters while installed on it."""

    def __init__(self, comm):
        self.comm, self.ms, self.nbytes = comm, {}, {}
        self.orig = {k: getattr(comm, k) for k in ("all_gather", "reduce_scatter")}
        for k, fn in self.orig.items():
            setattr(comm, k, self._timed(k, fn))

    def _timed(self, kind, fn):
        def run(x, *a, **kw):
            sync(x.device)
            t0 = time.perf_counter()
            out = fn(x, *a, **kw)
            sync(x.device)
            self.ms[kind] = self.ms.get(kind, 0.0) + (time.perf_counter() - t0) * 1e3
            self.nbytes[kind] = self.nbytes.get(kind, 0) + x.numel() * x.element_size()
            return out
        return run

    def remove(self):
        for k in self.orig:
            delattr(self.comm, k)


def g1_rank_run(comm, per_leaf):
    """Phase 42 on one rank of the shared (TP_G x TP_M) world: kimi-k2's
    G = 1 placement at phi3.5-moe x1's width.  One float32 step from the
    seed-0 weights (loss, norms, dropped assignments, θ and m of the node on
    the sampled columns, the digests of the leaves whole on an axis), then
    bf16 steps timed (step ms, the data group's all-gathers and
    reduce-scatters a step: bytes and ms, peak allocation)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.moe import counting_drops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    t0 = time.perf_counter()
    out = {"transport": comm.transport}
    cfg = p42_cfg(torch.float32)
    trainer = p42_trainer(cfg, dev)
    if (trainer.engine, trainer.g, trainer.dp_size, trainer.tp_size) != ("ranks", 1, TP_G, TP_M):
        raise RuntimeError(f"rank {comm.rank}: {trainer.engine} engine, G {trainer.g}, "
                           f"{trainer.dp_size} x {trainer.tp_size} a node")
    state = trainer.init_state(seed=0)
    sync(dev)
    ops.reset_launch_counts()
    with counting_drops() as drops:
        state, loss, norms = trainer.train_step(state, p42_batch(cfg, 0), LR)
    sync(dev)
    out["f32"] = {"loss": float(loss), "norms": norms.cpu().numpy(),
                  "drops": [int(x) for x in drops], "launches": ops.launch_counts(),
                  "theta": node_sampled(trainer, state.theta, per_leaf),
                  "mom": node_sampled(trainer, state.mom, per_leaf),
                  "whole": whole_digests(trainer, state), "row_elems": trainer.layout.size}
    del trainer, state
    torch.cuda.empty_cache()
    cfg = p42_cfg(torch.bfloat16)
    trainer = p42_trainer(cfg, dev)
    state = trainer.init_state(seed=0)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    step_ms, losses, per_step = [], [], []
    for t in range(P42_BF16_STEPS):
        timed = _TimedComm(trainer.data_comm)
        t1 = time.perf_counter()
        state, loss, _ = trainer.train_step(state, p42_batch(cfg, t), LR)
        sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        timed.remove()
        losses.append(float(loss))
        per_step.append({"ms": timed.ms, "bytes": timed.nbytes})
    out["bf16"] = {"step_ms": step_ms, "losses": losses, "data_group": per_step,
                   "launches": ops.launch_counts(), "whole": whole_digests(trainer, state),
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
                   "row_elems": trainer.layout.size}
    del trainer, state
    torch.cuda.empty_cache()
    out["rank_s"] = time.perf_counter() - t0
    return out


def g1_reference(dev, sample):
    """Phase 42's reference: the stacked engine at G = 1 on one card (the
    same mesh, no world: whole leaves, the whole batch), one float32 step
    from the seed-0 weights."""
    import torch
    from repro_torch.models.moe import counting_drops

    cfg = p42_cfg(torch.float32)
    trainer = p42_trainer(cfg, dev)
    if (trainer.engine, trainer.g) != ("stacked", 1):
        fail(f"phase 42's reference runs the {trainer.engine} engine at G = {trainer.g}")
    state = trainer.init_state(seed=0)
    with counting_drops() as drops:
        state, loss, norms = trainer.train_step(state, p42_batch(cfg, 0), LR)
    idx = torch.as_tensor(sample, device=dev)
    ref = {"loss": float(loss), "norms": norms.cpu().numpy(), "drops": [int(x) for x in drops],
           "theta": state.theta[0, idx].float().cpu().numpy(),
           "mom": state.mom[0, idx].cpu().numpy(), "node_elems": trainer.layout.size}
    del trainer, state, idx
    torch.cuda.empty_cache()
    return ref


def check_groups(label, whole, d, m):
    """Leaves whole on the model axis bit for bit across the ranks of a
    data index, leaves whole on the data axes across those of a model
    index (``whole[r]``: rank r's (model, data) digests; rank i·m + j)."""
    n = 0
    for r, (model, data) in enumerate(whole):
        i, j = divmod(r, m)
        for k, h in model.items():
            if h != whole[i * m][0][k]:
                fail(f"{label}: {k} (whole on the model axis) differs between ranks "
                     f"{i * m} and {r}")
            n += 1
        for k, h in data.items():
            if h != whole[j][1][k]:
                fail(f"{label}: {k} (whole on the data axes) differs between ranks {j} and {r}")
            n += 1
    return n


def check_g1(res, ref):
    """Phase 42's checks of the world's results against the stacked engine's
    ``ref``."""
    import numpy as np

    want32 = {"gossip_program_update": 0, "gossip_update": 0, "segment_l2_norms": 1,
              "flash_attention": 0}
    worst = {"loss": 0.0, "theta": 0.0, "mom": 0.0, "norm_rel": 0.0}
    for r, rank in enumerate(res):
        f = rank["f32"]
        if f["launches"] != want32 or rank["bf16"]["launches"] != {
                **want32, "segment_l2_norms": P42_BF16_STEPS}:
            fail(f"phase 42 rank {r}: launches {f['launches']}, {rank['bf16']['launches']}")
        if f["drops"] != ref["drops"]:
            fail(f"phase 42 rank {r}: dropped assignments {f['drops']}, the stacked "
                 f"engine's {ref['drops']}")
        d_loss = abs(f["loss"] - ref["loss"])
        d_theta = float(np.abs(f["theta"] - ref["theta"]).max())
        d_mom = float(np.abs(f["mom"] - ref["mom"]).max())
        rel = float((np.abs(f["norms"] - ref["norms"]) / np.abs(ref["norms"])).max())
        if max(d_loss, d_theta, d_mom) >= 5e-5 or rel > 1e-5:
            fail(f"phase 42 rank {r}: against the stacked engine loss {d_loss:.3e}, theta "
                 f"{d_theta:.3e}, m {d_mom:.3e}, norms rel {rel:.3e}")
        worst = {k: max(worst[k], v) for k, v in
                 (("loss", d_loss), ("theta", d_theta), ("mom", d_mom), ("norm_rel", rel))}
        if not np.isfinite(rank["bf16"]["losses"]).all():
            fail(f"phase 42 rank {r}: bf16 losses {rank['bf16']['losses']}")
    n_whole = check_groups("phase 42 f32", [rk["f32"]["whole"] for rk in res], TP_G, TP_M)
    check_groups("phase 42 bf16", [rk["bf16"]["whole"] for rk in res], TP_G, TP_M)
    b = [rk["bf16"] for rk in res]
    warm = [s for rk in b for s in rk["data_group"][1:]]
    out = {
        "ranks": TP_G * TP_M, "mesh": {"data": TP_G, "model": TP_M}, "gossip_nodes": 1,
        "model": f"{P42_ARCH} widths x1, named {P42_NAME}, moe_shard_ff",
        "node_elems": ref["node_elems"], "row_elems": b[0]["row_elems"],
        "transport": res[0]["transport"], "f32_vs_stacked": worst,
        "dropped_assignments": ref["drops"], "whole_leaves_checked": n_whole,
        "bf16_step_ms": [rk["step_ms"] for rk in b],
        "data_group_all_gather_bytes_a_step": b[0]["data_group"][-1]["bytes"].get("all_gather"),
        "data_group_reduce_scatter_bytes_a_step":
            b[0]["data_group"][-1]["bytes"].get("reduce_scatter"),
        "data_group_all_gather_ms_a_step": [s["ms"].get("all_gather") for s in warm],
        "data_group_reduce_scatter_ms_a_step": [s["ms"].get("reduce_scatter") for s in warm],
        "peak_allocated_bytes": [int(rk["peak_allocated_bytes"]) for rk in b],
        "launches": {k: sum(rk["f32"]["launches"][k] + rk["bf16"]["launches"][k] for rk in res)
                     for k in want32},
        "rank_s": max(rk["rank_s"] for rk in res),
    }
    log(f"phase 42: {P42_NAME} G = 1 at {P42_ARCH} x1 width ({ref['node_elems']:,} a node, "
        f"{out['row_elems']:,} a rank) on {TP_G} data x {TP_M} model ranks over "
        f"{out['transport']}: the first float32 step against the stacked engine: loss "
        f"{worst['loss']:.3e}, theta {worst['theta']:.3e}, m {worst['mom']:.3e}, norms rel "
        f"{worst['norm_rel']:.3e}; dropped assignments {ref['drops']} on every rank; "
        f"{n_whole} whole leaves bit for bit; bf16 step ms per rank "
        f"{[[round(x, 1) for x in rk['step_ms']] for rk in b]}; the data group a step: "
        f"all-gather {out['data_group_all_gather_bytes_a_step'] / 2**30:.3f} GiB of operands "
        f"in {[round(x, 1) for x in out['data_group_all_gather_ms_a_step']]} ms, "
        f"reduce-scatter {out['data_group_reduce_scatter_bytes_a_step'] / 2**30:.3f} GiB in "
        f"{[round(x, 1) for x in out['data_group_reduce_scatter_ms_a_step']]} ms; peak "
        f"{[round(x / 2**30, 2) for x in out['peak_allocated_bytes']]} GiB a rank; "
        f"{out['rank_s']:.1f} s on the ranks")
    return out


def fault_tp_rank_run(comm, per_leaf):
    """Phase 43 on one rank of the shared world: granite-8b x1 in float32
    on (TP_G x TP_M) ranks under the crash model: losses, norms, θ and m of
    the node on the sampled columns, step ms (step 1 the crash, step 2 the
    rejoin), launches and the digests of the replicated leaves."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    t0 = time.perf_counter()
    cfg = p43_cfg(torch.float32)
    trainer = p43_trainer(cfg, dev)
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    sync(dev)
    ops.reset_launch_counts()
    losses, norms, step_ms = [], [], []
    for t in range(P43_STEPS):
        t1 = time.perf_counter()
        state, loss, nrm = trainer.train_step(state, src.stacked(TP_G, t, BATCH), LR)
        sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss[0]))
        norms.append(nrm[0].cpu().numpy())
    out = {"losses": np.array(losses), "norms": np.stack(norms), "step_ms": step_ms,
           "launches": ops.launch_counts(), "whole": whole_digests(trainer, state),
           "theta": node_sampled(trainer, state.theta, per_leaf),
           "mom": node_sampled(trainer, state.mom, per_leaf),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "transport": comm.transport}
    del trainer, state
    torch.cuda.empty_cache()
    out["rank_s"] = time.perf_counter() - t0
    return out


def fault_tp_reference(dev, sample):
    """Phase 43's reference: the stacked engine at G = TP_G on the same mesh
    under the same crash (K1 with fault rows), float32."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM

    from repro_torch.kernels import ops

    cfg = p43_cfg(torch.float32)
    trainer = p43_trainer(cfg, dev)
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    ops.reset_launch_counts()
    for t in range(P43_STEPS):
        state, loss, nrm = trainer.train_step(state, src.stacked(TP_G, t, BATCH), LR)
        losses.append(loss.cpu().numpy())
        norms.append(nrm.cpu().numpy())
    idx = torch.as_tensor(sample, device=dev)
    # the fused steps: a node left without neighbours mixes through the interpreter
    ref = {"k1_launches": ops.launch_counts()["gossip_program_update"],
           "losses": np.stack(losses), "norms": np.stack(norms),
           "theta": state.theta[:, idx].float().cpu().numpy(),
           "mom": state.mom[:, idx].cpu().numpy()}
    del trainer, state, idx
    torch.cuda.empty_cache()
    return ref


def check_fault_tp(res, ref):
    """Phase 43's checks against the stacked engine under the same crash."""
    import numpy as np

    # every step but the crash's is fused (at the crash node 0 has no live
    # neighbour at G = 2 and mixes through the interpreter): K1 on the
    # stacked engine, K2 on every rank
    if ref["k1_launches"] != P43_STEPS - 1:
        fail(f"phase 43: the stacked engine launched K1 {ref['k1_launches']} times, "
             f"expected {P43_STEPS - 1}")
    want = {"gossip_program_update": 0, "gossip_update": P43_STEPS - 1,
            "segment_l2_norms": P43_STEPS, "flash_attention": 0}
    worst = {"loss": 0.0, "theta": 0.0, "mom": 0.0, "norm_rel": 0.0}
    for r, rank in enumerate(res):
        i = r // TP_M
        if rank["launches"] != want:
            fail(f"phase 43 rank {r}: launches {rank['launches']}, expected {want}")
        d_loss = float(np.abs(rank["losses"] - ref["losses"][:, i]).max())
        d_theta = float(np.abs(rank["theta"] - ref["theta"][i]).max())
        d_mom = float(np.abs(rank["mom"] - ref["mom"][i]).max())
        rel = float((np.abs(rank["norms"] - ref["norms"][:, i])
                     / np.abs(ref["norms"][:, i])).max())
        if max(d_loss, d_theta, d_mom) >= 5e-5 or rel > 1e-5:
            fail(f"phase 43 rank {r}: against the stacked engine losses {d_loss:.3e}, theta "
                 f"{d_theta:.3e}, m {d_mom:.3e}, norms rel {rel:.3e}")
        worst = {k: max(worst[k], v) for k, v in
                 (("loss", d_loss), ("theta", d_theta), ("mom", d_mom), ("norm_rel", rel))}
    n_rep = check_groups("phase 43", [rk["whole"] for rk in res], TP_G, TP_M)
    out = {
        "ranks": TP_G * TP_M, "mesh": {"data": TP_G, "model": TP_M},
        "fault": [P43_FAULT[0], P43_FAULT[1]], "transport": res[0]["transport"],
        "f32_vs_stacked": worst, "replicated_leaves_checked": n_rep,
        "step_ms": [rk["step_ms"] for rk in res],
        "fault_step_ms": [rk["step_ms"][1] for rk in res],
        "rejoin_step_ms": [rk["step_ms"][2] for rk in res],
        "peak_allocated_bytes": [int(rk["peak_allocated_bytes"]) for rk in res],
        "launches": {k: sum(rk["launches"][k] for rk in res) for k in want},
        "rank_s": max(rk["rank_s"] for rk in res),
    }
    log(f"phase 43: granite-8b x1 float32 on {TP_G} x {TP_M} ranks over {out['transport']} "
        f"under {P43_FAULT}: against the stacked engine losses {worst['loss']:.3e}, theta "
        f"{worst['theta']:.3e}, m {worst['mom']:.3e}, norms rel {worst['norm_rel']:.3e}; "
        f"{n_rep} replicated leaves bit for bit; step ms per rank "
        f"{[[round(x, 1) for x in rk['step_ms']] for rk in res]} (step 1 the crash, 2 the "
        f"rejoin); peak {[round(x / 2**30, 2) for x in out['peak_allocated_bytes']]} GiB a "
        f"rank; {out['rank_s']:.1f} s on the ranks")
    return out


def phase_g1_faults(done):
    """Phases 42 and 43's checks from ``rank_world``'s ``done``."""
    ref42, res42, s42 = done[42]
    ref43, res43, s43 = done[43]
    out42 = check_g1(res42, ref42)
    out42["world_s"] = s42
    out43 = check_fault_tp(res43, ref43)
    out43["world_s"] = s43
    return out42, out43


# phase 44: K5, Zamba2's grouped SSD scan, at the zamba2-7b-g4-b4x1024 cell's shapes
SSD_SHAPE = (4, 1024, 112, 2)     # (B, L, H, G) of one node's scan; P = N = 64
SSD_CHUNK = 256                   # the configuration's chunk_size: the eager route's chunk
SSD_NODES = 2                     # the published-block step: 6 mixers on each of 2 nodes
SSD_CONFIG = ROOT / "perfbench" / "configs" / "zamba2-7b-x6-g4.json"
# float32 relative errors against the float64 eager scan: the bars of
# tests/test_torch_ssd_kernel.py, whose docstring gives their reasons
SSD_BARS = {"y": 2e-5, "h": 2e-5, "dx": 2e-5, "ddt": 2e-4, "dB": 2e-5, "dC": 2e-5,
            "da": 5e-4, "dh0": 2e-5}
PREDICT_44 = (
    "phase 44 prediction (PERF.md §6): K5 at the zamba2 cell's scan (4, 1024, 112, 64, G 2, "
    "N 64) with a non-zero h0 within the float32 bars of the float64 eager scan (the gpu "
    "test read y 1.6e-7, the gradients 1.6e-7-7.1e-6 with h0 zero); the launches alone "
    "0.64 ms forward and 1.54 backward against bounds of 0.141 and 0.337 (22 %), forward + "
    "backward through autograd 2.3-2.6 ms against the eager float32 scan's 10.1-10.3; a "
    "published-block step on 2 nodes launches 12 forward and 12 backward and counts 12 "
    "ssd_kernel; under 60 s")


def ssd_errors(scan, shape, dev, chunk=SSD_CHUNK, seed=44):
    """(relative errors, float32 results): ``scan`` on float32 inputs
    against ``_ssd_groups`` in float64, for y, the final state and the
    gradients of x, dt, B, C, a and h0 (‖got − truth‖ / ‖truth‖); dt a
    softplus and A in [-16, -1] as the zamba2 mixer makes them, h0
    non-zero."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.recurrence import _ssd_groups

    bsz, l, h, g = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=torch.float64)
    a = -torch.exp(torch.rand(h, generator=gen, device=dev, dtype=torch.float64) * math.log(16))
    ins = [r(bsz, l, h, 64), F.softplus(r(bsz, l, h)), r(bsz, l, g, 64), r(bsz, l, g, 64), a,
           r(bsz, h, 64, 64)]
    dy, dh = r(bsz, l, h, 64), r(bsz, h, 64, 64)
    pad = (-l) % chunk

    def eager(x, dt, b, c, a, h0):
        p = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        y, hf = _ssd_groups(p(x), p(dt), p(b), p(c), a, h0, chunk)
        return y[:, :l], hf

    def run(fn, ts, dy, dh):
        ts = [t.detach().clone().requires_grad_() for t in ts]
        y, hf = fn(*ts)
        grads = torch.autograd.grad((y * dy).sum() + (hf * dh).sum(), ts)
        return dict(zip(SSD_BARS, (y.detach(), hf.detach(), *grads)))

    want = run(eager, ins, dy, dh)
    got = run(scan, [t.float() for t in ins], dy.float(), dh.float())
    rel = {k: float((got[k].double() - want[k]).norm() / want[k].norm()) for k in SSD_BARS}
    return rel, got


def check_ssd(scan, shape, dev, chunk=SSD_CHUNK):
    """Fail unless ``scan`` holds every bar of ``SSD_BARS`` with finite
    results; returns the errors."""
    import torch

    rel, got = ssd_errors(scan, shape, dev, chunk)
    bad = {k: v for k, v in rel.items() if not v < SSD_BARS[k]}
    bad.update({k: "not finite" for k, v in got.items() if not bool(torch.isfinite(v).all())})
    if bad:
        fail(f"phase 44: K5 at {shape} off the float64 eager scan: {bad} (bars {SSD_BARS})")
    return rel


def phase_ssd(dev):
    """Phase 44: K5 against the eager ``_ssd_groups`` at the zamba2 cell's
    scan (float64 truth, float32 bars), its time beside the eager float32
    route's and its bounds (``ssd_scan.scan_cost``), then one training
    step of the cell's published block (``SSD_CONFIG``, 6 layers at
    published width) on ``SSD_NODES`` nodes, whose launches and
    ``ssd_kernel`` counts must be one a mixer and node."""
    import torch
    import torch.nn.functional as F

    from perfbench import program as bench_program
    from repro_torch.core.dsgd import make_topology
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.models.recurrence import _ssd_groups
    from repro_torch.optim.sgd import sgd
    from repro_torch.telemetry.recorder import MetricsRecorder

    bsz, l, h, g = SSD_SHAPE
    before = (K.ssd_scan.launches, K.ssd_scan.backward_launches)
    rel = check_ssd(K.ssd_scan, SSD_SHAPE, dev)
    parity = (K.ssd_scan.launches - before[0], K.ssd_scan.backward_launches - before[1])
    if parity != (1, 1):
        fail(f"phase 44: the parity call launched {parity} K5 pairs, not (1, 1)")
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(4401)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    ins = [r(bsz, l, h, 64), F.softplus(r(bsz, l, h)), r(bsz, l, g, 64), r(bsz, l, g, 64),
           -torch.exp(torch.rand(h, generator=gen, device=dev) * math.log(16)),
           r(bsz, h, 64, 64)]
    dy, dh = r(bsz, l, h, 64), r(bsz, h, 64, 64)
    fwd_ms = cuda_ms(lambda: K._kernel_forward(*ins), 10)
    _, states = K._kernel_forward(*ins)
    bwd_ms = cuda_ms(lambda: K._kernel_backward(*ins[:5], states, dy, dh), 10)
    del states
    leaves = [t.requires_grad_() for t in ins]

    def both(fn):
        y, hf = fn(*leaves)
        torch.autograd.grad((y * dy).sum() + (hf * dh).sum(), leaves)

    def eager(x, dt, b, c, a, h0):
        return _ssd_groups(x, dt, b, c, a, h0, SSD_CHUNK)

    ms = cuda_ms(lambda: both(K.ssd_scan), 10)
    plain_ms = cuda_ms(lambda: both(eager), 3)
    del leaves, ins, dy, dh
    torch.cuda.empty_cache()
    flops, nbytes = K.scan_cost(bsz, l, h, g)
    bound = {k: 1e3 * max(flops[k] / F32_OPS_PER_S, nbytes[k] / HBM_BYTES_PER_S) for k in flops}
    bound_by = {k: "operations" if flops[k] / F32_OPS_PER_S >= nbytes[k] / HBM_BYTES_PER_S
                else "bytes" for k in flops}

    cfg = json.loads(SSD_CONFIG.read_text())
    arch = bench_program.arch_config(cfg)
    trainer = SPMDTrainer(arch, make_topology("d_ring", SSD_NODES), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=True, device=dev)
    state = trainer.init_state(seed=44)
    toks = torch.randint(0, cfg["vocab"], (SSD_NODES, bsz, l + 1), generator=gen, device=dev)
    batch = {"tokens": toks[..., :-1].int(), "targets": toks[..., 1:].int()}
    state, losses, _ = trainer.train_step(state, batch, 1e-2)       # warm
    recorder = MetricsRecorder()
    recorder.configure(device=dev)
    torch.cuda.synchronize()
    before = (K.ssd_scan.launches, K.ssd_scan.backward_launches)
    t0 = time.perf_counter()
    with recorder.device_trace() as records:
        with recorder.span("train_step", step=0):
            state, losses, _ = trainer.train_step(state, batch, 1e-2)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step = (K.ssd_scan.launches - before[0], K.ssd_scan.backward_launches - before[1],
            records.counts.get("ssd_kernel", {}).get(0, 0))
    mixers = sum(1 for kind in cfg["layers_block_type"] if kind in ("mamba", "hybrid"))
    if step != (mixers * SSD_NODES,) * 3:
        fail(f"phase 44: a published-block step on {SSD_NODES} nodes launched K5 {step[:2]} "
             f"and counted {step[2]} ssd_kernel, not {mixers * SSD_NODES} each")
    if not bool(torch.isfinite(losses).all()):
        fail(f"phase 44: the published-block step's losses {losses.tolist()} are not finite")
    del trainer, state, batch, toks
    torch.cuda.empty_cache()
    out = {"shape": list(SSD_SHAPE) + [64, 64], "rel_err": rel, "bars": SSD_BARS,
           "forward_ms": fwd_ms, "backward_ms": bwd_ms, "ms": ms, "plain_ms": plain_ms,
           "bound": bound, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
           "launches_by_path": {"phase 44 (parity)": parity[0],
                                "phase 44 (published-block step)": step[0]},
           "backward_launches_by_path": {"phase 44 (parity)": parity[1],
                                         "phase 44 (published-block step)": step[1]},
           "ssd_kernel_counts": step[2], "step_s": step_s}
    log(f"phase 44: K5 at {tuple(out['shape'])} against the float64 eager scan "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"; launches alone forward {fwd_ms:.3f} ms (bound {bound['forward']:.3f}), "
        f"backward {bwd_ms:.3f} (bound {bound['backward']:.3f}); both through autograd "
        f"{ms:.3f} against the eager float32 scan's {plain_ms:.3f}; a published-block step "
        f"on {SSD_NODES} nodes: {step[0]} forward and {step[1]} backward launches, {step[2]} "
        f"ssd_kernel counts, {step_s:.2f} s")
    return out


# phases that run on their own with --phases (each needs only the kernels built)
ALONE = (34, 37, 38, 39, 40, 41, 42, 43, 44)


def selected_phases(argv):
    """``--phases 37,39``: run only these of ``ALONE`` after the build (a
    debugging aid: the line of kernels and the result line are left out).
    None (the default) runs every phase."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        fail(f"usage: chip_smoke.py [--phases N,N,...] (N in {ALONE}); got {argv}")
    chosen = tuple(int(x) for x in argv[1].split(","))
    if not set(chosen) <= set(ALONE):
        fail(f"--phases takes {ALONE}, got {chosen}")
    return chosen


def run_alone(dev, chosen, smi):
    """The chosen phases of ``ALONE``, each printing its prediction first."""
    _, layout = granite_layout()
    out = {}
    pair = tuple(n for n in (40, 41) if n in chosen)
    for n in chosen:
        if n == 38 and 37 in chosen or n == 41 and 40 in chosen or n == 43 and 42 in chosen:
            continue   # run with 37, 40 or 42, in its world
        t0 = time.perf_counter()
        if n == 34:
            log(PREDICT_34)
            out[n] = phase_dryrun(dev)
        elif n in (37, 38):
            sample = sample_columns(layout)
            out[37], out[38], _ = phase_tp_ep(dev, rank_world(dev, layout, sample, ("tp",))["tp"])
            if 38 not in chosen:
                del out[38]
            if 37 not in chosen:
                del out[37]
            n = 37 if 37 in chosen else 38
        elif n in (40, 41):
            if pair != (40, 41):
                fail("--phases runs 40 and 41 together, in one world")
            out[40], out[41] = phase_ssm_serve(rank_world(dev, layout, sample_columns(layout),
                                                          pair))
            n = 40
        elif n in (42, 43):
            which = tuple(k for k in (42, 43) if k in chosen)
            done = rank_world(dev, layout, sample_columns(layout), which)
            if 42 in done:
                ref, res, s = done[42]
                out[42] = check_g1(res, ref)
                out[42]["world_s"] = s
            if 43 in done:
                ref, res, s = done[43]
                out[43] = check_fault_tp(res, ref)
                out[43]["world_s"] = s
            n = which[0]
        elif n == 44:
            log(PREDICT_44)
            out[n] = phase_ssd(dev)
        else:
            log(PREDICT_39)
            out[n] = phase_train_100m(dev)
        out[n]["wall_s"] = time.perf_counter() - t0
        log(f"phase {n}: {out[n]['wall_s']:.1f} s on {smi}")
    log("phases " + json.dumps({str(k): v for k, v in out.items()}, default=str))


def main():
    import numpy as np
    import torch

    chosen = selected_phases(sys.argv[1:])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.dsgd import make_topology
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import _build, cost, ops
    from repro_torch.kernels.gossip_update import (
        gossip_program_update, gossip_program_update_plain, gossip_update,
        gossip_update_plain, gossip_wire,
    )
    from repro_torch.kernels.ssd_scan import ssd_scan
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
    if chosen is not None:
        run_alone(dev, chosen, smi)
        return

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
    sample = sample_columns(layout)
    idx = torch.as_tensor(sample, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    one_pass4 = gossip_program_update.one_pass
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
        if t == 0:   # what phase 19's fault-free step must equal bit for bit
            step0 = {"losses": loss.clone(), "norms": norms.clone(),
                     "theta": state.theta[:, idx].clone(), "mom": state.mom[:, idx].clone()}
    counts = ops.launch_counts()
    if counts != {"gossip_program_update": STEPS, "gossip_update": 0,
                  "segment_l2_norms": STEPS, "flash_attention": 0}:
        fail(f"main path launch counts {counts}, expected {STEPS} of K1 and K3")
    one_pass4 = gossip_program_update.one_pass - one_pass4
    if one_pass4 != STEPS:
        fail(f"main path: {one_pass4} of its {STEPS} K1 launches took the one-pass route")
    log(f"phase 4: launches {counts}, K1 by the one-pass route {one_pass4}; peak allocated "
        f"{peak / 2**30:.2f} GiB over {STEPS - 1} steps")

    # what phase 9's ranks must reproduce: the first RANK_STEPS steps
    ref9 = {"losses": np.array(losses[:RANK_STEPS]), "norms": np.stack(norm_hist[:RANK_STEPS]),
            "theta": snap.theta[:, idx].float().cpu().numpy(),
            "mom": snap.mom[:, idx].cpu().numpy()}
    del idx
    # what phase 16's bucketed runs must reproduce bit for bit: the same
    # steps, with the tail of the largest bucket size (it holds the others')
    tail0 = min(tail_start(layout, mb) for mb in BUCKET_MBS)
    ref16 = {"losses": ref9["losses"], "norms": ref9["norms"], "theta": ref9["theta"],
             "mom": ref9["mom"], "tail_start": tail0,
             "theta_tail": snap.theta[:, tail0:].clone(), "mom_tail": snap.mom[:, tail0:].clone()}

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
    # the monolithic step (the parent's path) under the check phase 16 runs
    sync6 = sync_error(trainer, state, batches[0])
    breakdown["sync_debug_error"] = sync6
    log("phase 6: a monolithic step with the inert recorder under "
        f"set_sync_debug_mode('error'): {sync6 or 'no synchronizing call'}")
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
    # the step's one-pass route on copies, the parent's wire + K1 in place
    # (the state is only timed from here on)
    got_t, got_m = theta.clone(), mom.clone()
    gossip_program_update(got_t, None, srcs, w, grad, got_m, **k1)
    gossip_program_update(theta, wire, srcs, w, grad, mom, **k1)
    if not (torch.equal(got_t, theta) and torch.equal(got_m, mom)):
        fail("phase 6: K1's one-pass route on the main-path state is not bit for bit the "
             "wire + K1")
    del got_t, got_m
    log("phase 6: K1 one pass on the main-path state: bit for bit the wire + K1")
    k1_ms = cuda_ms(lambda: gossip_program_update(theta, wire, srcs, w, grad, mom, **k1), 5)
    k1_one_pass_ms = cuda_ms(
        lambda: gossip_program_update(theta, None, srcs, w, grad, mom, **k1), 5)

    def k1_plain():
        for a in range(0, p_cols, TWIN_CHUNK):
            b = min(a + TWIN_CHUNK, p_cols)
            gossip_program_update_plain(theta[:, a:b], wire[:, a:b], srcs, w,
                                        grad[:, a:b], mom[:, a:b], **k1)

    k1_plain_ms = cuda_ms(k1_plain, 2)
    eb = theta.element_size()
    k1_bytes, k1_ops = cost.k1_cost(G, p_cols, eb, deg)   # θ g m wire in; θ' m' out
    k1_bound = 1e3 * max(k1_bytes / HBM_BYTES_PER_S, k1_ops / F32_OPS_PER_S)
    op_bytes, op_ops = cost.k1_one_pass_cost(G, p_cols, eb, deg)   # θ g m in; θ' m' out
    k1_one_pass_bound = 1e3 * max(op_bytes / HBM_BYTES_PER_S, op_ops / F32_OPS_PER_S)

    offs = layout.offsets
    k3_ms = cuda_ms(lambda: segment_l2_norms(theta, offs), 10)
    k3_plain_ms = cuda_ms(lambda: segment_l2_norms_plain(theta, offs), 2)
    k3_lib_ms = cuda_ms(lambda: [
        torch.linalg.vector_norm(theta[:, a:b], dim=1, dtype=torch.float32)
        for a, b in zip(offs[:-1], offs[1:])
    ], 3)
    k3_bytes, k3_ops = cost.k3_cost(G, offs, eb)
    k3_bound = 1e3 * max(k3_bytes / HBM_BYTES_PER_S, k3_ops / F32_OPS_PER_S)
    log(f"phase 6: K1 {k1_ms:.3f} ms (bound {k1_bound:.3f}, plain {k1_plain_ms:.3f}) after "
        f"the wire's {wire_ms:.3f}; K1 one pass {k1_one_pass_ms:.3f} ms (bound "
        f"{k1_one_pass_bound:.3f}); K3 {k3_ms:.3f} ms (bound {k3_bound:.3f}, plain "
        f"{k3_plain_ms:.3f}, library {k3_lib_ms:.3f})")
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
    k2_bytes, k2_ops = cost.k2_cost(p_cols, eb, deg2)   # θ g m nbrs in; θ' m' out
    k2_bound = 1e3 * max(k2_bytes / HBM_BYTES_PER_S, k2_ops / F32_OPS_PER_S)
    log(f"phase 8: K2 {k2_ms:.3f} ms (bound {k2_bound:.3f}, plain {k2_plain_ms:.3f})")
    del theta0, grad1, nbrs, mom0, theta1, mom1
    torch.cuda.empty_cache()

    # 9. the ranks engine: G ranks on this machine, against phase 4's rows
    # the rank halves of phases 9, 22, 24, 37 and 38 share one world
    shared = rank_world(dev, layout, sample)
    torch.cuda.empty_cache()
    ranks9 = phase_ranks(layout, ref9, sample, shared[9])
    torch.cuda.empty_cache()
    # phase 34's full-width dry-run records build on the host from here on
    dry34 = start_dryrun()

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

    # 13. the simulator at granite width, against the trainer
    t13 = time.perf_counter()
    launches13, sim13, rows13, ref_interp16 = phase_simulator(cfg, batches, sample)
    sim13["wall_s"] = time.perf_counter() - t13
    torch.cuda.empty_cache()

    # 14. the trainer with multi-round gossip and closed-loop Ada
    t14 = time.perf_counter()
    batches14 = batches + [
        {k: torch.as_tensor(v, device=dev) for k, v in src.stacked(G, t, BATCH).items()}
        for t in range(len(batches), ADA_STEPS)]
    launches14, rounds14 = phase_rounds(cfg, layout, batches14)
    rounds14["wall_s"] = time.perf_counter() - t14
    torch.cuda.empty_cache()

    # 15. the paper's configurations through the simulator, card against CPU
    t15 = time.perf_counter()
    launches15, paper15 = phase_paper(dev)
    paper15["wall_s"] = time.perf_counter() - t15
    torch.cuda.empty_cache()

    # 16. the bucketed trainer against phase 4's monolithic run
    t16 = time.perf_counter()
    launches16, buckets16, err_k1_slices = phase_buckets(cfg, layout, batches, ref16, sample,
                                                         ref_interp16)
    buckets16["wall_s"] = time.perf_counter() - t16
    err_k1 = max(err_k1, err_k1_slices)
    del ref16, ref_interp16
    torch.cuda.empty_cache()

    # 17. closed-loop Ada with the folded probe; the bucketed simulator
    t17 = time.perf_counter()
    launches17, fold17 = phase_folded_probe(cfg, layout, batches14,
                                            rounds14["d_ada closed loop"], rows13, sample)
    fold17["wall_s"] = time.perf_counter() - t17
    torch.cuda.empty_cache()

    # 18. run telemetry on the card
    t18 = time.perf_counter()
    launches18, tel18 = phase_telemetry(cfg, layout, batches14, dev)
    tel18["wall_s"] = time.perf_counter() - t18
    torch.cuda.empty_cache()

    # 19-20. the fused trainer under faults, monolithic then bucketed
    t19 = time.perf_counter()
    log(PREDICT_19)
    log(PREDICT_20)
    launches19, launches20, faults19, faults20 = {}, {}, {}, {}
    for name in FAULT_RUNS:
        c19, faults19[name], final = phase_fault_run(cfg, batches14, name)
        c20, faults20[name] = phase_fault_bucket_run(cfg, batches14, name, final)
        del final
        torch.cuda.empty_cache()
        for total, c in ((launches19, c19), (launches20, c20)):
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
    phase_fault_free_step(cfg, batches, step0, sample)
    faults19["fault_free_step_equals_phase_4"] = True
    faults19["wall_s"] = time.perf_counter() - t19
    torch.cuda.empty_cache()

    # 21. the simulator under the same models, against the unfused trainer
    t21 = time.perf_counter()
    launches21, faults21 = phase_fault_simulator(cfg, batches14)
    faults21["wall_s"] = time.perf_counter() - t21
    torch.cuda.empty_cache()

    # 22. the ranks engine under a crash with rejoin, against the stacked rows
    ranks22 = phase_fault_ranks(sample, shared[22])
    torch.cuda.empty_cache()

    # 23. the stacked trainer checkpointed and resumed
    t23 = time.perf_counter()
    launches23, resume23, members23 = phase_stacked_resume(cfg, layout, batches14, peak)
    resume23["wall_s"] = time.perf_counter() - t23
    torch.cuda.empty_cache()

    # 24. the ranks engine checkpointed and resumed; its file against phase 4
    ranks24 = phase_ranks_resume(layout, sample, step0, members23, shared[24])
    del step0
    torch.cuda.empty_cache()

    # 25. the simulator checkpointed and resumed
    t25 = time.perf_counter()
    launches25, sim25 = phase_sim_resume(dev)
    sim25["wall_s"] = time.perf_counter() - t25
    torch.cuda.empty_cache()

    # 26. the trainer's knobs and the examples
    t26 = time.perf_counter()
    launches26, knobs26 = phase_knobs(cfg, layout, batches)
    knobs26["wall_s"] = time.perf_counter() - t26
    del batches, batches14
    torch.cuda.empty_cache()

    # 27-30. the model zoo at published widths, depth cut
    zoo = {}
    for n, run in ((27, phase_moe), (28, phase_ssm), (29, phase_hybrid), (30, phase_vlm)):
        log(globals()[f"PREDICT_{n}"])
        t_zoo = time.perf_counter()
        zoo[n] = run(dev)
        zoo[n]["wall_s"] = time.perf_counter() - t_zoo
        zoo[n]["card"] = smi
        log(f"phase {n}: {time.perf_counter() - t_zoo:.1f} s on {smi}")
        torch.cuda.empty_cache()
    train30 = zoo[30]["train"]

    # 31-33. the mixed-dtype state bucketed, under faults and in the
    # simulator; the analysis pipeline on the card
    mixed = {}
    for n, run in ((31, phase_mixed_buckets), (32, phase_mixed_simulator)):
        log(globals()[f"PREDICT_{n}"])
        t_n = time.perf_counter()
        mixed[n] = run(dev)
        mixed[n]["wall_s"] = time.perf_counter() - t_n
        mixed[n]["card"] = smi
        log(f"phase {n}: {mixed[n]['wall_s']:.1f} s on {smi}")
        torch.cuda.empty_cache()
    log(PREDICT_33)
    t33 = time.perf_counter()
    batches33 = [{k: torch.as_tensor(v, device=dev) for k, v in src.stacked(G, t, BATCH).items()}
                 for t in range(ADA_STEPS)]
    mixed[33] = phase_analysis(dev, cfg, batches33)
    mixed[33]["wall_s"] = time.perf_counter() - t33
    mixed[33]["card"] = smi
    log(f"phase 33: {mixed[33]['wall_s']:.1f} s on {smi}")
    del batches33
    torch.cuda.empty_cache()

    # 34-36. the dry run on meta; one step against its roofline; shard_nodes
    tooling = {}
    log(PREDICT_34)
    t34 = time.perf_counter()
    tooling[34] = phase_dryrun(dev, dry34)
    tooling[34]["wall_s"] = time.perf_counter() - t34
    log(f"phase 34: {tooling[34]['wall_s']:.1f} s on {smi}")
    log(PREDICT_35)
    t35 = time.perf_counter()
    launches35, tooling[35] = phase_roofline_step(dev, k1_one_pass_bound, k3_bound, smi)
    tooling[35]["wall_s"] = time.perf_counter() - t35
    log(f"phase 35: {tooling[35]['wall_s']:.1f} s on {smi}")
    torch.cuda.empty_cache()
    log(PREDICT_36)
    t36 = time.perf_counter()
    launches36, tooling[36] = phase_shard_nodes(dev)
    tooling[36]["wall_s"] = time.perf_counter() - t36
    log(f"phase 36: {tooling[36]['wall_s']:.1f} s on {smi}")
    torch.cuda.empty_cache()

    # 37-39. tensor and expert parallelism inside a node (37 and 38 share
    # one world); train_100m
    tp = {}
    t37 = time.perf_counter()
    tp[37], tp[38], err_k2_tp = phase_tp_ep(dev, shared["tp"])
    err_k2 = max(err_k2, err_k2_tp)
    log(f"phases 37-38: {time.perf_counter() - t37:.1f} s on {smi}")
    torch.cuda.empty_cache()
    log(PREDICT_39)
    t39 = time.perf_counter()
    tp[39] = phase_train_100m(dev)
    tp[39]["wall_s"] = time.perf_counter() - t39
    log(f"phase 39: {tp[39]['wall_s']:.1f} s on {smi}")
    for n in (37, 38, 39):
        tp[n]["card"] = smi
    torch.cuda.empty_cache()

    # 40-41. the ssm and hybrid families on the tensor-parallel ranks
    # engine; serving on a mesh (their ranks ran in the shared world)
    t40 = time.perf_counter()
    tp[40], tp[41] = phase_ssm_serve(shared)
    for n in (40, 41):
        tp[n]["card"] = smi
    log(f"phases 40-41: {time.perf_counter() - t40:.1f} s of checks on {smi}; the world's "
        f"jobs {tp[40]['world_s']:.1f} + {tp[41]['world_s']:.1f} s")

    # 42-43. kimi-k2's G = 1 placement; faults on a model axis (their ranks
    # ran in the shared world)
    t42 = time.perf_counter()
    tp[42], tp[43] = phase_g1_faults(shared)
    for n in (42, 43):
        tp[n]["card"] = smi
    log(f"phases 42-43: {time.perf_counter() - t42:.1f} s of checks on {smi}; the world's "
        f"jobs {tp[42]['world_s']:.1f} + {tp[43]['world_s']:.1f} s")

    # 44. K5 at the zamba2 cell's scan against the eager scan; a
    # published-block step's launches
    log(PREDICT_44)
    t44 = time.perf_counter()
    ssd44 = phase_ssd(dev)
    ssd44["wall_s"] = time.perf_counter() - t44
    ssd44["card"] = smi
    log(f"phase 44: {ssd44['wall_s']:.1f} s on {smi}")
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
        "simulator": sim13,
        "rounds": rounds14,
        "paper": paper15,
        "buckets": buckets16,
        "folded_probe": fold17,
        "telemetry": tel18,
        "faults": faults19,
        "fault_buckets": faults20,
        "fault_simulator": faults21,
        "fault_ranks": ranks22,
        "stacked_resume": resume23,
        "ranks_resume": ranks24,
        "simulator_resume": sim25,
        "knobs": knobs26,
        "moe": zoo[27],
        "ssm": zoo[28],
        "hybrid": zoo[29],
        "vlm": zoo[30],
        "mixed_buckets": mixed[31],
        "mixed_simulator": mixed[32],
        "analysis": mixed[33],
        "dryrun": tooling[34],
        "roofline_step": tooling[35],
        "shard_nodes": tooling[36],
        "tensor_parallel": tp[37],
        "expert_parallel": tp[38],
        "train_100m": tp[39],
        "ssm_tensor_parallel": tp[40],
        "mesh_serving": tp[41],
        "g1_placement": tp[42],
        "tp_faults": tp[43],
        "ssd_scan": ssd44,
    }
    log("summary " + json.dumps(summary))
    # each kernel's launches on every main path that runs it
    by_path = {
        "gossip_program_update": {"phase 4": counts["gossip_program_update"],
                                  "phase 14": launches14["gossip_program_update"],
                                  "phase 16": launches16["gossip_program_update"],
                                  "phase 17": launches17["gossip_program_update"],
                                  "phase 18": launches18["gossip_program_update"],
                                  "phase 19": launches19["gossip_program_update"],
                                  "phase 20": launches20["gossip_program_update"],
                                  "phase 23": launches23["gossip_program_update"],
                                  "phase 26": launches26["gossip_program_update"],
                                  "phase 27": zoo[27]["launches"]["gossip_program_update"],
                                  "phase 28": zoo[28]["launches"]["gossip_program_update"],
                                  "phase 29": zoo[29]["launches"]["gossip_program_update"],
                                  "phase 30": train30["launches"]["gossip_program_update"],
                                  "phase 31": mixed[31]["launches"]["gossip_program_update"],
                                  "phase 35": launches35["gossip_program_update"]},
        "gossip_update": {"phase 9": ranks9["launches"]["gossip_update"],
                          "phase 22": ranks22["launches"]["gossip_update"],
                          "phase 24": ranks24["launches"]["gossip_update"],
                          "phase 37": tp[37]["launches"]["gossip_update"],
                          "phase 39": tp[39]["launches"]["gossip_update"],
                          "phase 40": tp[40]["launches"]["gossip_update"],
                          "phase 43": tp[43]["launches"]["gossip_update"]},
        "segment_l2_norms": {"phase 4": counts["segment_l2_norms"],
                             "phase 9": ranks9["launches"]["segment_l2_norms"],
                             "phase 13": launches13["segment_l2_norms"],
                             "phase 14": launches14["segment_l2_norms"],
                             "phase 15": launches15["segment_l2_norms"],
                             "phase 16": launches16["segment_l2_norms"],
                             "phase 17": launches17["segment_l2_norms"],
                             "phase 18": launches18["segment_l2_norms"],
                             "phase 19": launches19["segment_l2_norms"],
                             "phase 20": launches20["segment_l2_norms"],
                             "phase 21": launches21["segment_l2_norms"],
                             "phase 22": ranks22["launches"]["segment_l2_norms"],
                             "phase 23": launches23["segment_l2_norms"],
                             "phase 24": ranks24["launches"]["segment_l2_norms"],
                             "phase 25": launches25["segment_l2_norms"],
                             "phase 26": launches26["segment_l2_norms"],
                             "phase 27": zoo[27]["launches"]["segment_l2_norms"],
                             "phase 28": zoo[28]["launches"]["segment_l2_norms"],
                             "phase 29": zoo[29]["launches"]["segment_l2_norms"],
                             "phase 30": train30["launches"]["segment_l2_norms"],
                             "phase 31": mixed[31]["launches"]["segment_l2_norms"],
                             "phase 32": mixed[32]["launches"]["segment_l2_norms"],
                             "phase 35": launches35["segment_l2_norms"],
                             "phase 36": launches36["segment_l2_norms"],
                             "phase 37": tp[37]["launches"]["segment_l2_norms"],
                             "phase 39": tp[39]["launches"]["segment_l2_norms"],
                             "phase 40": tp[40]["launches"]["segment_l2_norms"],
                             "phase 42": tp[42]["launches"]["segment_l2_norms"],
                             "phase 43": tp[43]["launches"]["segment_l2_norms"]},
        "flash_attention": {"phase 12": k4_launches},
    }
    kernels = [
        {
            "name": "gossip_program_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gossip_update.cu",
            "replaces": "src/repro/kernels/gossip_update.py:254",
            "launches": sum(by_path["gossip_program_update"].values()),
            "launches_by_path": by_path["gossip_program_update"],
            "max_abs_err": max([err_k1] + [zoo[n]["k1_err"] for n in (27, 28, 29)]
                               + [train30["k1_err"]]),
            "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
            "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / F32_OPS_PER_S
            else "operations",
            "library_ms": None,
            "one_pass": {"launches": gossip_program_update.one_pass, "phase 4": one_pass4,
                         "ms": k1_one_pass_ms, "bound_ms": k1_one_pass_bound,
                         "bound_by": "bytes" if op_bytes / HBM_BYTES_PER_S
                         >= op_ops / F32_OPS_PER_S else "operations",
                         "wire_ms": wire_ms},
        },
        {
            "name": "gossip_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gossip_update.cu",
            "replaces": "src/repro/kernels/gossip_update.py:184",
            "launches": sum(by_path["gossip_update"].values()),
            "launches_by_path": by_path["gossip_update"], "max_abs_err": err_k2,
            "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
            "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / F32_OPS_PER_S
            else "operations",
            "library_ms": None,
        },
        {
            "name": "segment_l2_norms", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/l2_norms.cu",
            "replaces": "src/repro/kernels/stats.py:38",
            "launches": sum(by_path["segment_l2_norms"].values()),
            "launches_by_path": by_path["segment_l2_norms"],
            "max_abs_err": max([err_k3] + [zoo[n]["k3_err"] for n in (27, 28, 29)]
                               + [train30["k3_err"]]),
            "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
            "bound_by": "bytes" if k3_bytes / HBM_BYTES_PER_S >= k3_ops / F32_OPS_PER_S
            else "operations",
            "library_ms": k3_lib_ms,
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:90",
            "launches": sum(by_path["flash_attention"].values()),
            "launches_by_path": by_path["flash_attention"],
            "max_abs_err": attn12["max_abs_err_vs_twin_causal"],
            "ms": attn12["k4_ms"], "plain_ms": attn12["plain_ms"],
            "bound_ms": attn12["bound_ms"], "bound_by": attn12["bound_by"],
            "library_ms": attn12["sdpa_ms"],
        },
        {
            "name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": None,   # the JAX package's scan is plain jnp: no Pallas kernel
            "launches": sum(ssd44["launches_by_path"].values()),
            "launches_by_path": ssd44["launches_by_path"],
            "backward_launches_by_path": ssd44["backward_launches_by_path"],
            "launches_in_script": ssd_scan.launches,
            "max_rel_err": max(ssd44["rel_err"].values()),
            "ms": ssd44["ms"], "plain_ms": ssd44["plain_ms"],
            "bound_ms": ssd44["bound"]["forward"] + ssd44["bound"]["backward"],
            "bound_by": "operations" if set(ssd44["bound_by"].values()) == {"operations"}
            else ssd44["bound_by"],
            "forward": {"ms": ssd44["forward_ms"], "bound_ms": ssd44["bound"]["forward"]},
            "backward": {"ms": ssd44["backward_ms"], "bound_ms": ssd44["bound"]["backward"]},
            "library_ms": None,
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
