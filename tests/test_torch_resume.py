"""Port parity: crash-consistent ``--resume`` in all three engines, the
counterpart of ``tests/resume_cli_script.py`` (and of the reference's
simulator resume in ``tests/test_elastic.py``).

Through the port's ``main(..., device="cpu")`` with ``--mesh 4,1``:

* a faulted closed-loop ``d_ada`` run stopped at step 4 and resumed to 8
  writes the uninterrupted run's step-8 file bit for bit, ``__extra__``
  (controller, membership, telemetry totals) included; also fused (K1's
  twin), bucketed with the Ξ fold pending at the checkpoint, and AdamW
  (its int32 count);
* a spare-rank run whose resume crosses the activation;
* a mismatched topology fails fast with both names, before anything is
  restored; ``--resume`` without ``--ckpt-dir`` exits;
* ``--telemetry`` with ``--resume``: the appended stream's counters
  continue, and the totals equal the uninterrupted run's;
* the simulator's ``snapshot_extra``/``restore_extra`` (an elastic resume
  that grows n included) bit for bit, its payload shaped as the
  reference's;
* the ranks engine over gloo: its file equals the stacked engine's member
  for member, and its resume is bit for bit;
* a checkpoint the reference's trainer writes at step 4 (reduced config,
  float32), resumed by the port to step 6, within 5e-5 of the reference's
  own continuation.
"""
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_rank_worker  # noqa: E402
from repro.core import dsgd as jdsgd  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.simulator import DecentralizedSimulator as JSim  # noqa: E402
from repro.optim.sgd import sgd as jsgd  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    load_checkpoint_extra, restore_checkpoint, save_checkpoint,
)
from repro_torch.core import dsgd as tdsgd  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.simulator import DecentralizedSimulator as TSim  # noqa: E402
from repro_torch.core.simulator import SimState  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.optim.sgd import sgd as tsgd  # noqa: E402
from repro_torch.telemetry import read_jsonl  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEP8 = "step_0000000008.npz"
COMMON = ["--reduced", "--steps-per-epoch", "10", "--seq", "16", "--per-node-batch", "2",
          "--mesh", "4,1"]
# the reference script's runs: faulted closed-loop d_ada, and a spare pool
# whose ghost rank activates at step 6, after the step-4 checkpoint
CLOSED = ["--topology", "d_ada", "--k-floor", "one_peer", "--consensus-target", "0.5",
          "--fault-model", "dropout", "--fault-rate", "0.35", "--fault-seed", "3"]
SPARE = ["--topology", "d_ada", "--k-floor", "one_peer", "--consensus-target", "0.5",
         "--fault-model", "join", "--fault-join-steps", "6", "--spare-ranks", "1",
         "--fault-seed", "5"]
CASES = {
    "dropout-closed-loop": CLOSED,
    "dropout-closed-loop-fused": CLOSED + ["--fused-apply"],
    # no faults, so the bucketed step folds the next probe's Ξ: the step-4
    # checkpoint carries the pending fold
    "closed-loop-bucketed-fused": ["--topology", "d_ada", "--k-floor", "one_peer",
                                   "--consensus-target", "0.5", "--bucket-mb", "0.05",
                                   "--fused-apply"],
    "adamw": ["--topology", "d_ring", "--optimizer", "adamw", "--lr", "1e-4"],
    "spare-activation": SPARE,
}


def _run(argv, ckpt_dir, steps, *extra):
    return main(COMMON + argv + ["--steps", str(steps), "--ckpt-dir", str(ckpt_dir),
                                 "--ckpt-every", "4", *extra], device="cpu")


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _assert_same_file(a, b):
    ma, mb = _members(a), _members(b)
    assert list(ma) == list(mb)
    bad = [n for n in ma if ma[n] != mb[n]]
    assert not bad, f"resume diverged on {bad[:10]}"


@pytest.mark.parametrize("case", list(CASES))
def test_resume_is_bit_for_bit_the_uninterrupted_run(tmp_path, case):
    argv = CASES[case]
    _run(argv, tmp_path / "a", 8)
    _run(argv, tmp_path / "b", 4)
    out = _run(argv, tmp_path / "b", 8, "--resume")
    assert len(out["losses"]) == 4   # steps 4..7
    assert "__extra__.npy" in _members(tmp_path / "a" / STEP8)
    _assert_same_file(tmp_path / "a" / STEP8, tmp_path / "b" / STEP8)
    extra = load_checkpoint_extra(str(tmp_path / "a"))
    assert extra["run_config"]["n"] == 4
    if case.startswith("dropout"):
        assert extra["controller"]["transitions"] and extra["last_membership"] is not None
    if case == "closed-loop-bucketed-fused":
        # the step-4 file held the fold the resumed step-4 probe read
        assert load_checkpoint_extra(str(tmp_path / "b"), 4)["xi_fold"]["step"] == 4
    if case == "spare-activation":
        assert extra["last_membership"] == [True] * 4


def test_mismatched_resume_fails_fast_before_any_restore(tmp_path, monkeypatch):
    _run(CLOSED, tmp_path, 4)
    from repro_torch.launch import train as train_mod

    restored = []
    monkeypatch.setattr(train_mod, "restore_checkpoint",
                        lambda *a, **k: restored.append(1))
    with pytest.raises(ValueError, match="resume config mismatch") as e:
        main(COMMON + ["--topology", "d_ring", "--steps", "8", "--ckpt-dir", str(tmp_path),
                       "--resume"], device="cpu")
    assert "d_ada" in str(e.value) and "d_ring" in str(e.value)
    assert not restored
    with pytest.raises(ValueError, match="bucket_mb"):
        _run(CLOSED + ["--bucket-mb", "1"], tmp_path, 8, "--resume")


def test_resume_needs_a_checkpoint_directory():
    with pytest.raises(SystemExit, match="--resume requires --ckpt-dir"):
        main(COMMON + ["--steps", "2", "--resume"], device="cpu")


def test_telemetry_resume_continues_the_counters(tmp_path):
    tel = ["--telemetry"]
    argv = CLOSED + ["--metrics-every", "2"]
    _run(argv, tmp_path / "a", 8, *tel, str(tmp_path / "a.jsonl"))
    _run(argv, tmp_path / "b", 4, *tel, str(tmp_path / "b.jsonl"))
    out = _run(argv, tmp_path / "b", 8, "--resume", *tel, str(tmp_path / "b.jsonl"))
    recorder = out["trainer"].telemetry
    a, b = read_jsonl(str(tmp_path / "a.jsonl")), read_jsonl(str(tmp_path / "b.jsonl"))
    manifests = [r for r in b if r["kind"] == "manifest"]
    assert [m["run"]["resumed"] for m in manifests] == [False, True]
    resumed_at = b.index(manifests[1])

    def last_totals(records):
        out = {}
        for r in records:
            if r["kind"] == "counter":
                out[r["name"]] = r["total"]
        return out

    # the appended segment's counters continue from the checkpoint's totals
    before = last_totals(b[:resumed_at])
    first_after = {}
    for r in b[resumed_at:]:
        if r["kind"] == "counter" and r["name"] not in first_after:
            first_after[r["name"]] = r
    assert first_after and all(r["total"] == before[n] + r["inc"]
                               for n, r in first_after.items())
    assert last_totals(b) == last_totals(a)
    assert recorder.totals == last_totals(a)
    assert recorder.rounds_total == 8 and len(recorder.round_ms) == 4
    events_a = [(r["step"], r["name"]) for r in a if r["kind"] == "event"]
    events_b = [(r["step"], r["name"]) for r in b if r["kind"] == "event"]
    assert ("checkpoint_restore" not in dict(events_a).values()
            and (4, "checkpoint_restore") in events_b)
    assert [e for e in events_b if e[1] != "checkpoint_restore"] == events_a
    _assert_same_file(tmp_path / "a" / STEP8, tmp_path / "b" / STEP8)


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------

D = 3


def _tloss(p, b):
    return torch.mean(torch.sum((b["obs"] - p["w"]) ** 2, -1))


def _jloss(p, b):
    return jnp.mean(jnp.sum((b["obs"] - p["w"]) ** 2, -1))


def _batch(t, n):
    rng = np.random.default_rng(1000 + t)
    return {"obs": (np.arange(D) + rng.standard_normal((n, 4, D))).astype(np.float32)}


def _sim(kind, lib="torch"):
    if kind == "join":
        fm_args = ("join", 4, dict(rate=0.0, seed=0, join_steps=(3, 5)))
    else:
        fm_args = ("dropout", 8, dict(rate=0.35, seed=3))
    faults, dsgd = (tfaults, tdsgd) if lib == "torch" else (jfaults, jdsgd)
    fm = faults.make_fault_model(fm_args[0], fm_args[1], **fm_args[2])
    topo = dsgd.make_topology("d_ada", fm_args[1], k0=3, k_floor="one_peer",
                              consensus_target=0.25, fault_model=fm)
    if lib == "torch":
        return TSim(_tloss, tsgd(0.1), topo, device="cpu"), fm
    return JSim(_jloss, jsgd(0.1), topo), fm


@pytest.mark.parametrize("kind", ["dropout", "join"])
def test_simulator_resume_is_bit_for_bit(tmp_path, kind):
    """Checkpoint mid-run (under dropout and closed-loop Ada; under joins,
    after the run grew from 4 to 6 nodes), resume in a fresh engine: the
    continued run equals the uninterrupted one bit for bit, parameters,
    optimizer state and the engine's payload."""
    total, cut = 10, 6
    sim_a, fm = _sim(kind)
    state = sim_a.init({"w": np.zeros(D, np.float32)})
    for t in range(total):
        state, _, _ = sim_a.train_step(state, _batch(t, fm.n_at(t) if kind == "join" else 8), 0.05)
    want_theta, want_mom = state.theta.clone(), state.opt["mom"].clone()

    sim_b, _ = _sim(kind)
    state = sim_b.init({"w": np.zeros(D, np.float32)})
    for t in range(cut):
        state, _, _ = sim_b.train_step(state, _batch(t, fm.n_at(t) if kind == "join" else 8), 0.05)
    save_checkpoint(str(tmp_path), cut, sim_b.checkpoint_tree(state),
                    extra=sim_b.snapshot_extra())
    if kind == "join":
        assert sim_b.n == 6 and sim_b.snapshot_extra()["n"] == 6

    sim_c, _ = _sim(kind)
    sim_c.restore_extra(load_checkpoint_extra(str(tmp_path)))
    state = sim_c.init({"w": np.zeros(D, np.float32)})
    assert state.theta.shape[0] == sim_c.n == (6 if kind == "join" else 8)
    step = restore_checkpoint(str(tmp_path), sim_c.checkpoint_tree(state))
    state = SimState(state.theta, state.opt, state.layout, step)
    for t in range(cut, total):
        state, _, _ = sim_c.train_step(state, _batch(t, fm.n_at(t) if kind == "join" else 8), 0.05)
    assert torch.equal(state.theta, want_theta) and torch.equal(state.opt["mom"], want_mom)
    assert sim_c.snapshot_extra() == sim_a.snapshot_extra()
    assert sim_c.topology.n_nodes == sim_a.topology.n_nodes


def test_simulator_payload_is_shaped_as_the_reference(tmp_path):
    """The same run in both packages: the payloads carry the same keys,
    run configuration, n, membership and controller transitions."""
    sims = {}
    for lib in ("torch", "jax"):
        sim, fm = _sim("join", lib)
        state = sim.init({"w": np.zeros(D, np.float32)})
        for t in range(6):
            b = _batch(t, fm.n_at(t))
            if lib == "jax":
                b = {k: jnp.asarray(v) for k, v in b.items()}
            state, _, _ = sim.train_step(state, b, 0.05)
        sims[lib] = sim.snapshot_extra()
    t, j = sims["torch"], sims["jax"]
    assert set(t) == set(j)
    for key in ("run_config", "n", "last_membership"):
        assert t[key] == j[key], key
    assert t["controller"]["transitions"] == j["controller"]["transitions"]
    assert t["controller"]["events"] == j["controller"]["events"]
    # and the reference's payload restores into the port's engine
    sim, _ = _sim("join")
    sim.restore_extra(j)
    assert sim.n == 6 and sim.topology.controller.transitions == [
        tuple(x) for x in j["controller"]["transitions"]]


@pytest.mark.parametrize("bucket_mb,other,match", [
    (2.0, ("d_one_peer_exp", 2.0), "d_ring.*d_one_peer_exp"),
    (2.0, ("d_ring", None), "bucket_mb"),
])
def test_simulator_restore_validates_the_run_config(bucket_mb, other, match):
    def sim(name, mb):
        return TSim(_tloss, tsgd(0.9), tdsgd.make_topology(name, 8), bucket_mb=mb,
                    device="cpu")

    snap = sim("d_ring", bucket_mb).snapshot_extra()
    assert "n" not in snap["run_config"] and snap["n"] == 8
    sim("d_ring", bucket_mb).restore_extra(snap)
    with pytest.raises(ValueError, match=match):
        sim(*other).restore_extra(snap)
    sim("d_one_peer_exp", None).restore_extra({"last_membership": None})


# ---------------------------------------------------------------------------
# The ranks engine over gloo
# ---------------------------------------------------------------------------

RANKS = ["--topology", "d_ring", "--fused-apply", "--fault-model", "crash",
         "--fault-rate", "0.5", "--fault-seed", "1", "--fault-down-steps", "2"]


def test_ranks_engine_writes_the_stacked_file_and_resumes_bit_for_bit(tmp_path):
    argv = COMMON + RANKS + ["--ckpt-every", "2", "--steps", "4"]
    main(argv + ["--ckpt-dir", str(tmp_path / "stacked")], device="cpu")
    spawn_world(_torch_rank_worker.run_main, 4,
                (argv + ["--ckpt-dir", str(tmp_path / "ranks")],),
                timeout=240, device="cpu", workdir=tmp_path)
    step2, step4 = "step_0000000002.npz", "step_0000000004.npz"
    for name in (step2, step4):
        _assert_same_file(tmp_path / "stacked" / name, tmp_path / "ranks" / name)
    assert load_checkpoint_extra(str(tmp_path / "ranks"))["last_membership"] is not None
    # the ranks resume from the step-2 file, each rank receiving its own row
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    shutil.copy(tmp_path / "ranks" / step2, resumed / step2)
    (resumed / "manifest.json").write_text('{"latest_step": 2}')
    losses = spawn_world(_torch_rank_worker.run_main, 4,
                         (argv + ["--ckpt-dir", str(resumed), "--resume"],),
                         timeout=240, device="cpu", workdir=tmp_path)
    assert all(len(x) == 2 for x in losses)
    _assert_same_file(tmp_path / "stacked" / step4, resumed / step4)


# ---------------------------------------------------------------------------
# A reference checkpoint, resumed by the port
# ---------------------------------------------------------------------------

REF_ARGS = ["--arch", "granite-8b", "--reduced", "--topology", "d_ring",
            "--steps-per-epoch", "10", "--seq", "16", "--per-node-batch", "2",
            "--mesh", "4,1"]


def test_port_resumes_a_reference_checkpoint(tmp_path):
    """The reference's trainer (4 host devices, float32 reduced config)
    writes a step-4 checkpoint and continues to step 6; the port resumes
    the step-4 file to step 6 within 5e-5 of the reference's step-6 file."""
    ref = tmp_path / "ref"
    script = (
        "import sys\n"
        "from repro.launch import train\n"
        f"args = {REF_ARGS!r} + ['--ckpt-dir', {str(ref)!r}]\n"
        "sys.argv = ['train'] + args + ['--steps', '4', '--ckpt-every', '4']\n"
        "train.main()\n"
        "sys.argv = ['train'] + args + ['--steps', '6', '--ckpt-every', '2', '--resume']\n"
        "train.main()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    port = tmp_path / "port"
    port.mkdir()
    shutil.copy(ref / "step_0000000004.npz", port / "step_0000000004.npz")
    (port / "manifest.json").write_text('{"latest_step": 4}')
    main(REF_ARGS[2:] + ["--steps", "6", "--ckpt-every", "2", "--ckpt-dir", str(port),
                         "--resume"], device="cpu")
    with np.load(ref / "step_0000000006.npz") as want, \
            np.load(port / "step_0000000006.npz") as got:
        keys = [k for k in want.files if k != "__extra__"]
        assert keys == [k for k in got.files if k != "__extra__"]
        assert any(k.startswith("o/") for k in keys)
        for k in keys:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-5, err_msg=k)
        # the step moved the state: the bar is not met by standing still
        with np.load(ref / "step_0000000004.npz") as before:
            assert max(float(np.abs(want[k] - before[k]).max()) for k in keys) > 1e-3
