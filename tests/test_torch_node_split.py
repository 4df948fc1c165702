"""The simulator's node split over row blocks (``shard_nodes``,
``repro_torch/core/node_split.py``) against the unsplit port and the
reference's virtual-node sharding.

``split_devices`` is replaced by the rule as it acts on a machine of k
cards, with every block on the CPU (``[cpu] * d``): a k-block split runs
here with no card.  Every case runs the port unsplit, split as on 2 and on
4 cards, and the reference's simulator with ``shard_nodes=True`` on the
same numpy inputs:

* split == unsplit bit for bit (θ, every optimizer slot, losses, norms,
  controller transitions), the dense interpreter within 1e-6 relative
  (its per-block product is not the unsplit one's shape);
* the port within 5e-5 of the reference (norms rtol 1e-5), the mixed
  state's bfloat16 leaf within one bf16 step of its value's scale a step
  (the reference contracts θ − lr·m' into an FMA, ``test_torch_mixed.py``);
* a join that re-splits (n 8 → 9 → 10: 4 blocks → 3 → 2 on 4 cards),
  crash with rejoin and preemption handoffs across blocks, a checkpoint
  written split equal byte for byte to the unsplit file and restored both
  ways;
* the reference's real split over 4 host devices (a subprocess with
  ``--xla_force_host_platform_device_count``), and its device rule for 1–8
  devices and n 1–16.
"""
import functools
import importlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dsgd as jdsgd  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    load_checkpoint_extra, restore_checkpoint, save_checkpoint,
)
from repro_torch.core import dsgd as tdsgd  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import node_split  # noqa: E402
from repro_torch.core.node_split import NodeBlocks, split_devices  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator as TSim  # noqa: E402
from repro_torch.core.simulator import SimState  # noqa: E402

torch.set_num_threads(1)
joptim = importlib.import_module("repro.optim.sgd")
toptim = importlib.import_module("repro_torch.optim.sgd")
SRC = Path(__file__).resolve().parents[1] / "src"


def cards(k):
    """``split_devices`` as on a machine of k cards, every block on the CPU."""
    return lambda n, device: [torch.device("cpu")] * max(
        d for d in range(1, k + 1) if n % d == 0)


def full(x):
    return x.to_full() if isinstance(x, NodeBlocks) else x


# ---------------------------------------------------------------------------
# The device rule
# ---------------------------------------------------------------------------

REF_RULE = textwrap.dedent("""
    import json, jax
    from repro.core.simulator import DecentralizedSimulator as S
    devs = jax.devices()
    out = {}
    for count in range(1, 9):
        jax.devices = lambda backend=None, c=count: devs[:c]
        out[count] = [S._node_sharding(n).mesh.devices.size for n in range(1, 17)]
    print(json.dumps(out))
""")


def _ref_subprocess(code, devices):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _ref_result(proc):
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_split_devices_is_the_reference_rule(monkeypatch):
    """The reference's ``_node_sharding`` on 1–8 host devices and the
    port's ``split_devices`` with 1–8 cards agree for n 1–16; the CPU and
    the split-off flag keep one device."""
    want = _ref_result(_ref_subprocess(REF_RULE, 8))
    for count in range(1, 9):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        got = [split_devices(n, torch.device("cuda", 0)) for n in range(1, 17)]
        assert [len(d) for d in got] == want[str(count)], count
        for d in got:
            assert d == ([torch.device("cuda", 0)] if len(d) == 1 else
                         [torch.device("cuda", i) for i in range(len(d))])
        assert split_devices(8, "cpu") == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

D_IN, D_OUT, B = 5, 3, 4


def _tloss(p, b):
    return torch.mean((b["x"] @ p["w"] + p["v"] - b["y"]) ** 2)


def _jloss(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["v"] - b["y"]) ** 2)


def _mixed_tloss(p, b):
    return 0.5 * sum(torch.sum((p[k].float() - b[k]) ** 2) for k in ("a", "c"))


def _mixed_jloss(p, b):
    return 0.5 * sum(jnp.sum((p[k].astype(jnp.float32) - b[k]) ** 2) for k in ("a", "c"))


def _params(mixed=False):
    r = np.random.default_rng(0)
    if mixed:
        return {"a": r.normal(size=(4,)).astype(np.float32),
                "c": r.normal(size=(3,)).astype(np.float32)}
    return {"w": r.normal(size=(D_IN, D_OUT)).astype(np.float32),
            "v": r.normal(size=(D_OUT,)).astype(np.float32)}


def _batch(t, n, mixed=False):
    r = np.random.default_rng(100 + t)
    if mixed:
        return {"a": r.normal(size=(n, 4)).astype(np.float32),
                "c": r.normal(size=(n, 3)).astype(np.float32)}
    return {"x": r.normal(size=(n, B, D_IN)).astype(np.float32),
            "y": r.normal(size=(n, B, D_OUT)).astype(np.float32)}


ADA = dict(k0=6, k_floor="one_peer", consensus_target=0.9)
# name -> (topology, topology kwargs, simulator kwargs, optimizer, fault
# (kind, kwargs) or None, steps)
CASES = {
    "shift": ("d_ring", {}, dict(mixing="shift", debug_no_retrace=True), ("sgd", 0.9), None, 4),
    "dense": ("d_ring", {}, dict(mixing="dense"), ("sgd", 0.9), None, 4),
    "shift-adamw": ("d_one_peer_exp", {}, dict(mixing="shift"), ("adamw",), None, 4),
    "dense-adamw": ("d_one_peer_exp", {}, dict(mixing="dense"), ("adamw",), None, 4),
    "mix-rounds-2": ("d_one_peer_exp", {}, dict(mixing="shift", mix_rounds=2),
                     ("sgd", 0.9), None, 4),
    "c-complete": ("c_complete", {}, dict(mixing="shift"), ("sgd", 0.9), None, 4),
    "pre-order": ("d_ring", dict(mix_order="pre"), dict(mixing="shift"), ("sgd", 0.9),
                  None, 4),
    "star": ("d_star", {}, dict(mixing="shift"), ("sgd", 0.9), None, 4),
    "complete-allreduce": ("d_complete", {}, dict(mixing="shift"), ("sgd", 0.9), None, 4),
    "complete-dropout": ("d_complete", {}, dict(mixing="shift"), ("sgd", 0.9),
                         ("dropout", dict(rate=0.3, seed=3)), 6),
    "complete-crash": ("d_complete", {}, dict(mixing="shift"), ("sgd", 0.9),
                       ("crash", dict(rate=0.5, seed=1)), 6),
    "dense-dropout": ("d_one_peer_exp", {}, dict(mixing="dense"), ("sgd", 0.9),
                      ("dropout", dict(rate=0.3, seed=3)), 6),
    "bucket-mb": ("d_ring", {}, dict(mixing="shift", bucket_mb=24 / 2**20), ("sgd", 0.9),
                  None, 4),
    "node-loop": ("d_one_peer_exp", {}, dict(mixing="shift", node_loop=True), ("sgd", 0.9),
                  None, 4),
    "dropout": ("d_one_peer_exp", {}, dict(mixing="shift", debug_no_retrace=True),
                ("sgd", 0.9), ("dropout", dict(rate=0.3, seed=3)), 6),
    "join-resplit": ("d_ring", {}, dict(mixing="shift"), ("sgd", 0.9),
                     ("join", dict(rate=0.0, seed=1, join_steps=(2, 4))), 6),
    "crash-rejoin": ("d_ada", dict(k0=4, k_floor="one_peer", consensus_target=0.5),
                     dict(mixing="shift"), ("sgd", 0.9),
                     ("crash", dict(rate=0.5, seed=1, down_steps=3)), 8),
    "preempt": ("d_ring", {}, dict(mixing="shift"), ("sgd", 0.9),
                ("preempt", dict(rate=0.4, seed=1, drain_steps=3)), 8),
    "ada-closed-loop": ("d_ada", ADA, dict(mixing="shift"), ("sgd", 0.9), None, 10),
    "ada-closed-loop-bucketed": ("d_ada", ADA, dict(mixing="shift", bucket_mb=24 / 2**20,
                                                    debug_no_retrace=True),
                                 ("sgd", 0.9), None, 10),
    "mixed-dtype": ("d_ring", {}, dict(mixing="shift"), ("sgd", 0.9), None, 4),
}
LR = {"adamw": 1e-4}


def _optimizer(lib, spec):
    mod = joptim if lib == "ref" else toptim
    return mod.sgd(spec[1]) if spec[0] == "sgd" else mod.adamw()


def _make(lib, case, **over):
    """(simulator, fault model or None) of one case."""
    topo, topo_kw, sim_kw, opt, fault, _ = CASES[case]
    dsgd, faults = (jdsgd, jfaults) if lib == "ref" else (tdsgd, tfaults)
    fm = None if fault is None else faults.make_fault_model(fault[0], 8, **fault[1])
    topology = dsgd.make_topology(topo, 8, fault_model=fm, **topo_kw)
    mixed = case == "mixed-dtype"
    kw = dict(sim_kw, collect_norms=True, **over)
    if lib == "ref":
        kw.pop("node_loop", None)
        kw.pop("debug_no_retrace", None)
        return JSim(_mixed_jloss if mixed else _jloss, _optimizer(lib, opt), topology,
                    shard_nodes=True, **kw), fm
    return TSim(_mixed_tloss if mixed else _tloss, _optimizer(lib, opt), topology,
                device="cpu", **kw), fm


def _init(lib, sim, case):
    p = _params(case == "mixed-dtype")
    if case == "mixed-dtype":   # a bfloat16 leaf beside a float32 one
        if lib == "ref":
            return sim.init({"a": jnp.asarray(p["a"], jnp.bfloat16), "c": jnp.asarray(p["c"])})
        return sim.init({"a": torch.from_numpy(p["a"]).bfloat16(), "c": torch.from_numpy(p["c"])})
    return sim.init({k: jnp.asarray(v) for k, v in p.items()} if lib == "ref" else p)


def _size(sim, fm, t):
    return fm.n_at(t) if fm is not None and hasattr(fm, "n_at") else sim.n


@functools.lru_cache(maxsize=None)
def run(case, k):
    """One case's run: k = 0 the reference's, else the port split as on k
    cards (1: unsplit).  Returns (θ {leaf: (n, ...)} float64 numpy, the
    optimizer slots {name: numpy}, [losses], [norms], transitions, the
    block counts the run went through)."""
    steps, lr = CASES[case][5], LR.get(CASES[case][3][0], 0.05)
    mixed = case == "mixed-dtype"
    if k == 0:
        sim, fm = _make("ref", case)
        state = _init("ref", sim, case)
        losses, norms = [], []
        for t in range(steps):
            b = {kk: jnp.asarray(v) for kk, v in _batch(t, _size(sim, fm, t), mixed).items()}
            state, loss, nrm = sim.train_step(state, b, lr, epoch=t // 3)
            losses.append(np.asarray(loss, np.float64))
            norms.append(np.asarray(nrm, np.float64))
        theta = {kk: np.asarray(jnp.asarray(v, jnp.float32), np.float64)
                 for kk, v in state.params.items()}
        ctl = sim.topology.controller
        return theta, {}, losses, norms, (list(ctl.transitions) if ctl else None), ()
    mp = pytest.MonkeyPatch()
    mp.setattr(node_split, "split_devices", cards(k))
    try:
        sim, fm = _make("torch", case, shard_nodes=k > 1)
        state = _init("torch", sim, case)
        losses, norms, blocks = [], [], []
        for t in range(steps):
            state, loss, nrm = sim.train_step(state, _batch(t, _size(sim, fm, t), mixed), lr,
                                              epoch=t // 3)
            losses.append(loss.numpy().astype(np.float64))
            norms.append(nrm.numpy().astype(np.float64))
            blocks.append(len(state.theta.blocks) if isinstance(state.theta, NodeBlocks) else 1)
    finally:
        mp.undo()
    theta = {kk: full(v).float().numpy().astype(np.float64) for kk, v in state.params.items()}
    opt = {kk: full(v).numpy().copy() for kk, v in state.opt.items()}
    ctl = sim.topology.controller
    return theta, opt, losses, norms, (list(ctl.transitions) if ctl else None), tuple(blocks)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_split_equals_unsplit_and_the_reference(case, k):
    split, plain, ref = run(case, k), run(case, 1), run(case, 0)
    if k == 4 and case not in ("join-resplit", "c-complete"):
        assert set(split[5]) == {4}, split[5]
    if case == "join-resplit":
        # 8, 8, 9, 9, 10, 10 nodes: the rule re-derives the split at each size
        assert split[5] == ((4, 4, 3, 3, 2, 2) if k == 4 else (2, 2, 1, 1, 2, 2))
    if CASES[case][2]["mixing"] == "dense":
        for name in plain[0]:
            np.testing.assert_allclose(split[0][name], plain[0][name], rtol=1e-6, atol=1e-7)
        for name in plain[1]:
            np.testing.assert_allclose(split[1][name], plain[1][name], rtol=1e-6, atol=1e-7)
        for a, b in zip(split[2] + split[3], plain[2] + plain[3]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    else:
        for name in plain[0]:
            np.testing.assert_array_equal(split[0][name], plain[0][name], err_msg=name)
        for name in plain[1]:
            np.testing.assert_array_equal(split[1][name], plain[1][name], err_msg=name)
        for a, b in zip(split[2] + split[3], plain[2] + plain[3]):
            np.testing.assert_array_equal(a, b)
    assert split[4] == plain[4] == ref[4]
    if case.startswith("ada"):
        assert len(ref[4]) >= 1, "the closed loop moved no rung"
    for name in ref[0]:
        if case == "mixed-dtype" and name == "a":
            # bf16: one step of the leaf's scale a training step
            bar = len(split[2]) * 2.0 ** -7 * np.abs(ref[0][name]).max()
            np.testing.assert_allclose(split[0][name], ref[0][name], rtol=0, atol=bar)
        else:
            np.testing.assert_allclose(split[0][name], ref[0][name], rtol=0, atol=5e-5,
                                       err_msg=name)
    for a, b in zip(split[2], ref[2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-5 if case != "mixed-dtype" else 5e-2)
    if case != "mixed-dtype":
        for a, b in zip(split[3], ref[3]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _ckpt_run(tmp, k, *, cut, total, restore_k=None):
    """The crash-with-rejoin case on the closed loop (k cards), saved at
    ``cut``; with ``restore_k`` the rest of the run resumes from that file
    in a fresh engine split as on restore_k cards.  Returns (file bytes,
    final θ, final m)."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(node_split, "split_devices", cards(k))
        sim, fm = _make("torch", "crash-rejoin", shard_nodes=k > 1)
        state = _init("torch", sim, "crash-rejoin")
        for t in range(cut):
            state, _, _ = sim.train_step(state, _batch(t, 8), 0.05, epoch=t // 3)
        path = save_checkpoint(str(tmp), cut, sim.checkpoint_tree(state),
                               extra=sim.snapshot_extra())
        data = Path(path).read_bytes()
        if restore_k is not None:
            mp.setattr(node_split, "split_devices", cards(restore_k))
            sim, _ = _make("torch", "crash-rejoin", shard_nodes=restore_k > 1)
            sim.restore_extra(load_checkpoint_extra(str(tmp)))
            state = _init("torch", sim, "crash-rejoin")
            step = restore_checkpoint(str(tmp), sim.checkpoint_tree(state))
            state = SimState(state.theta, state.opt, state.layout, step)
        for t in range(cut, total):
            state, _, _ = sim.train_step(state, _batch(t, 8), 0.05, epoch=t // 3)
    finally:
        mp.undo()
    return data, full(state.theta).clone(), full(state.opt["mom"]).clone()


@pytest.mark.parametrize("restore_k", [4, 1], ids=["restored-split", "restored-unsplit"])
def test_checkpoint_written_split_is_the_unsplit_file(tmp_path, restore_k):
    """Saved from 4 blocks at step 4, the file is byte for byte the
    unsplit run's; restored split or unsplit, the run continues bit for
    bit the uninterrupted one."""
    plain, _, _ = _ckpt_run(tmp_path / "plain", 1, cut=4, total=4)
    _, want_theta, want_mom = _ckpt_run(tmp_path / "whole", 1, cut=8, total=8)
    split, theta, mom = _ckpt_run(tmp_path / "split", 4, cut=4, total=8, restore_k=restore_k)
    assert split == plain
    assert torch.equal(theta, want_theta) and torch.equal(mom, want_mom)


# ---------------------------------------------------------------------------
# The reference's real split over 4 host devices
# ---------------------------------------------------------------------------

REF_SPLIT = textwrap.dedent("""
    import json, jax, jax.numpy as jnp, numpy as np
    from repro.core.dsgd import make_topology
    from repro.core.faults import make_fault_model
    from repro.core.simulator import DecentralizedSimulator
    from repro.optim.sgd import sgd
    assert len(jax.devices()) == 4
    topo = make_topology("d_one_peer_exp", 8,
                         fault_model=make_fault_model("dropout", 8, rate=0.3, seed=3))
    sim = DecentralizedSimulator(lambda p, b: jnp.mean((b - p["w"]) ** 2), sgd(0.1), topo,
                                 mixing="shift", shard_nodes=True)
    state = sim.init({"w": jnp.zeros((4,), jnp.float32)})
    assert len(state.params["w"].sharding.device_set) == 4
    rng = np.random.default_rng(2)
    losses = []
    for _ in range(6):
        b = jnp.asarray(rng.normal(size=(8, 2, 4)).astype(np.float32))
        state, loss, _ = sim.train_step(state, b, 0.05)
        losses.append(np.asarray(loss).tolist())
    print(json.dumps({"w": np.asarray(state.params["w"]).tolist(), "losses": losses}))
""")


def test_four_block_split_matches_the_references_four_device_split(monkeypatch):
    """``tests/test_elastic.py``'s case (n 8, dropout 0.3, d_one_peer_exp,
    6 steps): the reference split over 4 host devices, the port over 4
    blocks, within 5e-5."""
    proc = _ref_subprocess(REF_SPLIT, 4)
    monkeypatch.setattr(node_split, "split_devices", cards(4))
    topo = tdsgd.make_topology(
        "d_one_peer_exp", 8, fault_model=tfaults.make_fault_model("dropout", 8, rate=0.3,
                                                                  seed=3))
    sim = TSim(lambda p, b: torch.mean((b["b"] - p["w"]) ** 2), toptim.sgd(0.1), topo,
               mixing="shift", shard_nodes=True, device="cpu")
    state = sim.init({"w": np.zeros((4,), np.float32)})
    assert len(state.theta.blocks) == 4
    rng = np.random.default_rng(2)
    losses = []
    for _ in range(6):
        b = rng.normal(size=(8, 2, 4)).astype(np.float32)
        state, loss, _ = sim.train_step(state, {"b": torch.from_numpy(b)}, 0.05)
        losses.append(loss.numpy())
    want = _ref_result(proc)
    np.testing.assert_allclose(full(state.params["w"]).numpy(), np.asarray(want["w"]),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.stack(losses), np.asarray(want["losses"]), rtol=0, atol=5e-5)


# ---------------------------------------------------------------------------
# NodeBlocks itself
# ---------------------------------------------------------------------------

def test_node_blocks_rows_columns_and_resplit():
    x = torch.arange(8 * 5, dtype=torch.float32).reshape(8, 5)
    nb = NodeBlocks.split(x, [torch.device("cpu")] * 4)
    assert nb.shape == x.shape and nb.starts == (0, 2, 4, 6, 8)
    assert torch.equal(nb.to_full(), x)
    idx = [7, 0, 3, 3, 6]
    assert torch.equal(nb.rows(idx), x[idx])
    assert torch.equal(nb.rows(idx, cols=(1, 4)), x[idx, 1:4])
    assert torch.equal(nb.columns(2, 5), x[:, 2:5])
    assert torch.equal(nb.row(5), x[5]) and nb.locate(5) == (2, 1)
    grown = nb.grow(x[:2] + 100)
    assert grown.starts == (0, 2, 4, 6, 10)
    again = grown.resplit([torch.device("cpu")] * 2)
    assert again.starts == (0, 5, 10)
    assert torch.equal(again.to_full(), torch.cat([x, x[:2] + 100]))
    with pytest.raises(ValueError, match="equal blocks"):
        grown.resplit([torch.device("cpu")] * 3)


def test_mix_dense_and_shift_take_split_rows():
    """``mixing.mix_dense`` and ``mix_shift`` on row blocks equal them on
    the whole buffer (shift bit for bit, dense within 1e-6)."""
    from repro_torch.core.graphs import Ring
    from repro_torch.core.mixing import mix_dense, mix_shift

    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 3, 7)).astype(np.float32))
    nb = NodeBlocks.split(x, [torch.device("cpu")] * 4)
    g = Ring(8)
    assert torch.equal(mix_shift(nb, g).to_full(), mix_shift(x, g))
    w = g.mixing_matrix()
    torch.testing.assert_close(mix_dense(nb, w).to_full(), mix_dense(x, w), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Reductions over every node, by column chunks
# ---------------------------------------------------------------------------

def _reducing_program(name, n=8):
    from repro_torch.core.graphs import Ring
    from repro_torch.core.schedule import AllReduce, GossipProgram, compile_graph, dense_program

    if name == "allreduce":
        return GossipProgram("allreduce", n, (AllReduce(),), 0.0)
    if name == "gatherrow":
        return dense_program(Ring(n))
    # a reduction between two permute terms: the terms add in program order
    ring = compile_graph(Ring(n)).ops
    return GossipProgram("ring+allreduce", n, ring[:1] + (AllReduce(),) + ring[1:], 0.25)


@pytest.mark.parametrize("masked", [False, True], ids=["stacked", "masked"])
@pytest.mark.parametrize("name", ["allreduce", "gatherrow", "ring+allreduce"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_reductions_take_column_chunks(monkeypatch, name, masked, dtype):
    """An op that reads every node (AllReduce, GatherRow, and under masks a
    program that is not all-PPermute) over 4 blocks reduces column chunks
    gathered to the first device: 160 columns in chunks of 64 (the last
    taking the remainder: 64 and 96) equal the unsplit op, one chunk of
    every column, bit for bit, and that op the dense matrix within
    float32 rounding.  (A chunk must start on a multiple of the CPU's
    vector blocks for its columns to sum as the whole width's do; the
    real ``SPLIT_CHUNK`` is 2**22.  On the card a chunk's matrix product
    may round apart: ``chip_smoke.py`` phase 36 holds it within 1e-6.)"""
    program = _reducing_program(name)
    alive = np.array([1, 0, 1, 2, 1, 1, 1, 1], np.float32)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(8, 16, 10))
                         .astype(np.float32)).to(dtype)

    def mix(v):
        return program.apply_masked(v, alive) if masked else program.apply_stacked(v)

    want = mix(x)
    dense = (program.apply_masked(x, alive, engine="dense") if masked
             else program.apply_dense(x))
    torch.testing.assert_close(want.float(), dense.float(), rtol=1e-6 if dtype == torch.float32
                               else 1e-2, atol=1e-6 if dtype == torch.float32 else 1e-2)
    monkeypatch.setattr(node_split, "SPLIT_CHUNK", 64)
    assert torch.equal(mix(x), want)
    assert torch.equal(mix(NodeBlocks.split(x, [torch.device("cpu")] * 4)).to_full(), want)


def test_centralized_mean_and_final_model_take_column_chunks(monkeypatch):
    """``c_complete``'s gradient mean and ``SimState.mean_params`` over 4
    blocks in chunks of 64 columns (64 and 96) equal the unsplit mean bit
    for bit; every block receives the whole mean."""
    from repro_torch.core.flat import FlatLayout
    from repro_torch.core.simulator import _centralized_mean

    g = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 16, 10)).astype(np.float32))
    want = g.mean(dim=0, keepdim=True).bfloat16().expand_as(g)
    assert torch.equal(_centralized_mean(g, torch.bfloat16), want)
    layout = FlatLayout.from_shapes({"w": (16, 10)}, {"w": torch.float32})
    theta = g.reshape(8, 160)
    plain = SimState(theta, {}, layout, 0).mean_params()["w"]
    monkeypatch.setattr(node_split, "SPLIT_CHUNK", 64)
    nb = NodeBlocks.split(g, [torch.device("cpu")] * 4)
    got = _centralized_mean(nb, torch.bfloat16)
    assert len(got.blocks) == 4 and torch.equal(got.to_full(), want)
    split = SimState(NodeBlocks.split(theta, [torch.device("cpu")] * 4), {}, layout, 0)
    assert torch.equal(split.mean_params()["w"], plain)
    assert torch.equal(plain, g.mean(dim=0))


def test_host_grad_norm_of_row_blocks():
    """The recorder's gradient norm takes a split buffer's column chunks
    through the buffer's own ``columns``: the unsplit norm bit for bit."""
    from repro_torch.telemetry import host_grad_norm

    x = torch.from_numpy(np.random.default_rng(6).normal(size=(8, 40)).astype(np.float32))
    assert host_grad_norm(NodeBlocks.split(x, [torch.device("cpu")] * 4)) == host_grad_norm(x)


@pytest.mark.parametrize("k", [2, 4])
def test_split_node_loop_draws_the_unsplit_numbers(monkeypatch, k):
    """With ``has_rng`` each block's nodes draw from a generator that takes
    the run's generator state and hands it back: θ and the losses of a
    noisy loss equal the unsplit run's bit for bit."""
    def loss(p, b, gen):
        noise = torch.randn(b["x"].shape, generator=gen)
        return torch.mean(((b["x"] + 0.1 * noise) @ p["w"] + p["v"] - b["y"]) ** 2)

    def go(shard):
        sim = TSim(loss, toptim.sgd(0.9), tdsgd.make_topology("d_ring", 8), mixing="shift",
                   has_rng=True, shard_nodes=shard, device="cpu")
        state = sim.init(_params())
        losses = []
        for t in range(3):
            state, lo, _ = sim.train_step(state, _batch(t, 8), 0.05)
            losses.append(lo)
        return full(state.theta), torch.stack(losses), state

    plain_theta, plain_losses, _ = go(False)
    monkeypatch.setattr(node_split, "split_devices", cards(k))
    theta, losses, state = go(True)
    assert len(state.theta.blocks) == k
    assert torch.equal(theta, plain_theta) and torch.equal(losses, plain_losses)
