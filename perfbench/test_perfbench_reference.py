"""The plain reference against the port's train_step on the CPU at tiny
sizes, the control (the reference in float8 in the program's place) and
the faults a run must catch."""
import numpy as np
import pytest
import torch

from perfbench import check, generator, manifest, program, reference
from perfbench.cell import program_readings, run_cell

CELLS = ("granite8b-g4-b4x1024", "phi35moe-g4-b4x1024")


def _sides(root, cell, seed, **ref_kw):
    man = manifest.load(root)
    wl = manifest.workload(man, cell)
    cfg, traffic = manifest.config(man, wl["config"], root), manifest.traffic(wl["traffic"], root)
    dtype = reference.DTYPES[cfg["dtype"]]
    lr, beta = cfg["optimizer"]["lr"], cfg["optimizer"]["momentum"]
    weights = reference.draw_weights(cfg, seed, "cpu", dtype)
    trainer, state = program.build(cfg, traffic, weights, "cpu")
    pool = generator.make_pool(traffic, vocab=cfg["vocab"], nodes=cfg["nodes"], seed=seed,
                               device="cpu")
    _, prog = program_readings(trainer, state, pool, lr)
    batches = pool[:check.CHECKED_STEPS]
    kw = dict(nodes=cfg["nodes"], lr=lr, beta=beta, topology=traffic["topology"])
    ref = reference.run_reference(cfg, weights, batches, **kw)
    other = reference.run_reference(cfg, weights, batches, **kw, **ref_kw) if ref_kw else None
    return cfg, prog, ref, other


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_in_float32(tiny_root, cell):
    cfg, prog, ref, _ = _sides(tiny_root, cell, 3)
    got = check.gaps(prog, ref, reference.leaf_sizes(cfg))
    assert got["loss_gap"] < 1e-6 and got["grad_norm_gap"] < 1e-5
    assert got["change_gap"] < 1e-3 and got["probe_gap"] < 1e-6
    assert np.all(prog["change"][:, :3] > 0)   # the MLP or the experts moved


def test_the_control_is_not_correct(tiny_bf16_root):
    """In bfloat16 the program's first gradient lies within a limit set
    between its readings and the control's, and the control outside."""
    sound, control = [], []
    for seed in (5, 6):
        cfg, prog, ref, ctl = _sides(tiny_bf16_root, CELLS[0], seed, quant="fp8")
        sizes = reference.leaf_sizes(cfg)
        sound.append(check.gaps(prog, ref, sizes)["grad_norm_gap"])
        control.append(check.gaps(ctl, ref, sizes)["grad_norm_gap"])
    assert min(control) >= 3 * max(sound)
    limit = {"grad_norm_gap": (max(sound) * min(control)) ** 0.5}
    assert all(check.judge({"grad_norm_gap": v}, limit)[0] for v in sound)
    assert not any(check.judge({"grad_norm_gap": v}, limit)[0] for v in control)


def test_a_topology_the_reference_cannot_build_is_refused(tiny_root):
    """The traffic's graph reaches both sides: a ring is built, any other
    graph is refused at set-up, before the program runs."""
    assert np.allclose(reference.mixing_matrix("d_ring", 4).sum(axis=1), 1.0)
    man = manifest.load(tiny_root)
    cfg = manifest.config(man, "granite-8b-x2-g4", tiny_root)
    traffic = {**manifest.traffic("d_ring-b2x512", tiny_root), "topology": "d_torus"}
    weights = reference.draw_weights(cfg, 1, "cpu", torch.float32)
    with pytest.raises(ValueError, match="d_ring"):
        program.build(cfg, traffic, weights, "cpu")


def test_small_leaves_change_is_compared_apart():
    """Two large leaves, a router and two gains that neither side moves:
    the router's change is its own number, and moving a gain fails."""
    grad = np.array([[1.0, 2.0, 0.5, 0.01, 0.01]])
    ref = {"losses": np.ones((1, 1)), "probe": np.ones((1, 1, 5)), "grad": grad,
           "change": np.array([[1.0, 2.0, 0.1, 0.0, 0.0]])}
    prog = {**ref, "change": np.array([[1.0, 2.0, 0.11, 0.0, 0.0]])}
    sizes = [10_000, 10_000, 8, 4, 4]
    got = check.gaps(prog, ref, sizes)
    assert got["change_gap"] == 0.0
    assert got["small_change_gap"] == pytest.approx(0.1)
    moved = {**prog, "change": np.array([[1.0, 2.0, 0.1, 1e-3, 0.0]])}
    assert check.gaps(moved, ref, sizes)["small_change_gap"] == float("inf")


class _Broken:
    """The trainer with its timed path broken underneath the harness."""

    def __init__(self, trainer, fault):
        self._t, self._fault = trainer, fault
        if fault == "no_mix":
            trainer._program_at = lambda step, epoch: None

    def __getattr__(self, name):
        return getattr(self._t, name)

    def train_step(self, state, batch, lr, **kw):
        if self._fault == "unchanged":
            _, loss, norms = self._t.train_step(state.clone(), batch, lr, **kw)
            return state, loss, norms
        if self._fault == "half_batch":
            half = batch["tokens"].shape[1] // 2
            batch = {k: v[:, :half] for k, v in batch.items()}
        state, loss, norms = self._t.train_step(state, batch, lr, **kw)
        if self._fault == "probe_shift":
            norms = torch.roll(norms, 1, dims=1)
        return state, loss, norms


@pytest.mark.parametrize("fault", reference.FAULTS)
def test_a_broken_step_is_not_correct(tiny_root, fault):
    out = run_cell(CELLS[0], 11, 0.05, False, root=tiny_root, device="cpu",
                   fault=lambda t: _Broken(t, fault), log=lambda _: None)
    assert out["correct"] is False
    assert out["attempted"] >= 1 and out["metrics"]["setup_s"]["value"] > 0


def test_a_sound_run_is_correct(tiny_root):
    out = run_cell(CELLS[1], 12, 0.05, False, root=tiny_root, device="cpu",
                   log=lambda _: None)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "checks"
