"""Port parity: the G = 1 placement (kimi-k2's replica over a whole pod)
and the G = 1 checkpoint file, against the reference's ``SPMDTrainer``.

The reference runs in a subprocess on 4 host devices
(``tests/_torch_g1_reference.py``); the port runs a world of 4 gloo ranks
on the CPU (``tests/_torch_g1_worker.py``).  Both start from the
reference's ``init_model(cfg, key, tp_size)`` leaves, handed over as numpy
arrays, and train kimi-k2-1t-a32b-reduced (float32, no remat, seq 16,
global batch 4, ``sgd(0.9)``, lr 0.05, norms on) for 3 steps:

* ``single``: a (2 data × 2 model) world at G = 1 (``gossip_axes_for``
  gives () on a mesh without "pod"): every leaf FSDP-sharded over "data"
  and gathered at use, the batch split over the two data ranks, each MoE
  layer routing the tokens of the whole batch; with and without
  ``moe_shard_ff``, and with the aux loss weighted 1.0 (a d-fold aux
  gradient would be far off the bar);
* ``multi``: a (2 pod × 2 data × 1 model) world at G = 2 with
  ``moe_shard_ff``: the node's data ranks hold its whole batch and the
  experts' d_ff slices;
* the G = 1 checkpoint: the world's file and the single-card stacked
  engine's are read by the reference's ``load_checkpoint`` with its own
  unstacked template; the reference's file is restored by both engines; a
  resume from the world's file ends bit for bit at the uninterrupted run.

Bars: losses and the gathered parameters and momentum within 5e-5 of the
reference's, norms within rtol 1e-5, the dropped (token, choice)
assignments of every MoE layer call equal to the reference's (a batch
split before routing would drop others); leaves that no axis of a group
shards are the same bits on that group's ranks.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_g1_worker  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim.sgd import sgd as jsgd  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS, SEQ, LR = 3, 16, 0.05
ARCH = "kimi-k2-1t-a32b"
SINGLE = ((2, 2), ("data", "model"))
MULTI = ((2, 2, 1), ("pod", "data", "model"))
# reference case -> (cfg fields, mesh, rows a node's batch, model axis)
REF = {
    "single": ((), SINGLE, 4, 2),
    "shard_ff": ((("moe_shard_ff", True),), SINGLE, 4, 2),
    "aux": ((("aux_loss_weight", 1.0),), SINGLE, 4, 2),
    "multi": ((("moe_shard_ff", True),), MULTI, 2, 1),
}
# port case -> its reference case (the checkpoint cases run "single")
PORT = {"single": "single", "shard_ff": "shard_ff", "aux": "aux", "ckpt": "single",
        "restore": "single"}
WORLD_TIMEOUT = 300


def _case(ref):
    fields = REF[ref][0]
    return (ARCH, fields, None, "d_ring", ref == "multi")


@functools.lru_cache(maxsize=None)
def _init(ref):
    fields, _, _, tp = REF[ref]
    cfg = dataclasses.replace(jget_config(ARCH + "-reduced"), dtype=jnp.float32, remat=False,
                              **dict(fields))
    tree = jax.device_get(jax.jit(lambda k: jtfm.init_model(cfg, k, tp_size=tp))(
        jax.random.PRNGKey(3)))
    return tree, {k: v.float().numpy() for k, v in params_from_jax(tree).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results per case, the world's per label and case
    (a list over ranks), the directory of the files)."""
    tmp = tmp_path_factory.mktemp("g1")
    for ref in REF:
        np.savez(tmp / f"{ref}.params.npz", **_init(ref)[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_g1_reference.py"),
                          str(tmp), str(STEPS), str(SEQ), str(LR)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0 and "REF_OK" in out.stdout, out.stdout[-3000:] + out.stderr[-3000:]
    ref = {name: dict(np.load(tmp / f"{name}.ref.npz")) for name in REF}
    single = {name: _case(r) for name, r in PORT.items()}
    worlds = [
        ("single", single, {n: _init(r)[1] for n, r in PORT.items()}, STEPS, SEQ, 4, LR,
         *SINGLE, {"ckpt": str(tmp / "world_ckpt"), "restore": str(tmp / "ref_ckpt")}),
        ("multi", {"multi": _case("multi")}, {"multi": _init("multi")[1]}, STEPS, SEQ, 2, LR,
         *MULTI, None),
    ]
    results = spawn_world(_torch_g1_worker.worlds, 4, (worlds,), timeout=WORLD_TIMEOUT,
                          device="cpu", workdir=tmp_path_factory.mktemp("world"))
    world = {label: {name: [r[label][name] for r in results] for name in results[0][label]}
             for label in results[0]}
    return ref, world, tmp


def _check_run(got, want, node=None):
    """A run's losses, norms, parameters and momentum against the
    reference's (``node``: the reference's row of a G > 1 run)."""
    sel = (lambda x: x) if node is None else (lambda x: x[:, node])
    np.testing.assert_allclose(got["losses"].reshape(STEPS), sel(want["losses"]), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(got["norms"].reshape(STEPS, -1), sel(want["norms"]),
                               rtol=1e-5, atol=1e-30)
    for key, tree in (("p", got["full"]), ("m", got["mom"])):
        for k, v in tree.items():
            w = want[f"{key}.{k}"]
            w = w if node is None else w[node]
            assert v[0].shape == w.shape, k
            assert float(np.abs(v[0] - w).max()) < 5e-5, (key, k)


def _check_groups(per_rank, d, m):
    """Ranks (i, j) = rank i·m + j of a node: a leaf that the model axis
    leaves whole is the same bits on the ranks of a data index, one the data
    axes leave whole on the ranks of a model index; the shards of a leaf
    the axes split put together give the node's leaf."""
    for r in per_rank:
        assert np.array_equal(r["losses"], per_rank[0]["losses"])
    for k, (model_whole, data_whole) in per_rank[0]["whole"].items():
        for i in range(d):
            for j in range(m):
                a = per_rank[i * m + j]["local"][k]
                if model_whole:
                    assert np.array_equal(a, per_rank[i * m]["local"][k]), k
                if data_whole:
                    assert np.array_equal(a, per_rank[j]["local"][k]), k
        parts = (1 if model_whole else m) * (1 if data_whole else d)
        assert per_rank[0]["local"][k].size * parts == per_rank[0]["full"][k].size, k


@pytest.mark.parametrize("case", ["single", "shard_ff", "aux"])
def test_g1_world_matches_the_reference_trainer(runs, case):
    ref, world, _ = runs
    per_rank = world["single"][case]
    assert all(r["engine"] == ("ranks", 1, 2, 2) for r in per_rank)
    for r in per_rank:
        _check_run(r, ref[case])
        # the whole batch's routing: the reference's dropped assignments,
        # on every data rank
        assert r["drops"] == ref[case]["drops"].tolist()
    _check_groups(per_rank, 2, 2)
    # every leaf of this model is FSDP-split over the two data ranks
    assert not any(dw for _, dw in per_rank[0]["whole"].values())
    # on the CPU every wrapper takes its plain twin and counts no launch
    assert all(set(r["launches"].values()) <= {0} for r in per_rank)


def test_some_assignments_drop_and_the_aux_loss_matters(runs):
    """The drop check has something to check, and the aux case's bar is
    tight enough to catch a d-fold aux gradient: the reference's own aux
    run is far off its plain run, the world within 5e-5 of it."""
    ref, _, _ = runs
    assert ref["single"]["drops"].sum() > 0
    far = max(float(np.abs(ref["aux"][k] - ref["single"][k]).max())
              for k in ref["single"] if k.startswith("p."))
    assert far > 100 * 5e-5


def test_multi_world_with_shard_ff_matches_the_reference_trainer(runs):
    ref, world, _ = runs
    per_rank = world["multi"]["multi"]
    assert all(r["engine"] == ("ranks", 2, 2, 1) for r in per_rank)
    for rank, r in enumerate(per_rank):
        _check_run(r, ref["multi"], node=rank // 2)
    for node in range(2):
        _check_groups(per_rank[2 * node:2 * node + 2], 2, 1)
    # moe_shard_ff puts the experts' d_ff over "data"; the rest stays whole there
    whole = per_rank[0]["whole"]
    assert [k for k, (_, dw) in whole.items() if not dw] == \
        ["blocks.ffn.w_down", "blocks.ffn.w_gate", "blocks.ffn.w_up"]


def _ref_template():
    tree = jax.tree.map(jnp.asarray, _init("single")[0])
    return {"p": tree, "o": jsgd(0.9).init(tree)}


def _check_file_reads_as_the_references(directory, ref_dir):
    """The reference's ``load_checkpoint`` reads ``directory``'s step-2
    file with its own unstacked G = 1 template, within 5e-5 of its own
    step-2 file."""
    template = _ref_template()
    got, step = jckpt.load_checkpoint(directory, template, step=STEPS // 2)
    want, _ = jckpt.load_checkpoint(ref_dir, template, step=STEPS // 2)
    assert step == STEPS // 2
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert [x.shape for x in gl] == [x.shape for x in wl]
    assert max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(gl, wl)) < 5e-5


def test_g1_world_checkpoint_is_the_references_file(runs):
    ref, world, tmp = runs
    _check_file_reads_as_the_references(str(tmp / "world_ckpt"), str(tmp / "ref_ckpt"))
    # resumed from its own file by a fresh seed-1 trainer in the same world (its
    # process groups reused): bit for bit the uninterrupted run
    for r in world["single"]["ckpt"]:
        for k, v in r["full"].items():
            assert np.array_equal(r["resumed"][k], v), k
    # the reference's G = 1 file restored by the world, the rest of the run
    for r in world["single"]["restore"]:
        for k, v in r["full"].items():
            assert float(np.abs(v[0] - ref["single"]["p." + k]).max()) < 5e-5, k


def test_stacked_engine_g1_checkpoint_is_the_references_file(runs, tmp_path):
    """The single-card engine at G = 1 (kimi-k2 on the (2 × 2) mesh with no
    world: whole leaves, the whole batch): its run is the reference's, its
    file reads as the reference's, and it restores the reference's file."""
    ref, _, tmp = runs
    got = _torch_g1_worker.stacked(ARCH, (), *SINGLE, _init("single")[1], STEPS, SEQ, 4, LR,
                                   ckpt_dir=str(tmp_path / "stacked"), save_at=STEPS // 2)
    assert got["engine"] == ("stacked", 1, 2, 2)
    _check_run(got, ref["single"])
    assert got["drops"] == ref["single"]["drops"].tolist()
    _check_file_reads_as_the_references(str(tmp_path / "stacked"), str(tmp / "ref_ckpt"))
    tr = got["trainer"]
    state = tr.init_state(seed=1)
    start = tr.restore_checkpoint(str(tmp / "ref_ckpt"), state)
    assert start == STEPS // 2
    from repro_torch.launch.train import TrainState

    res = _torch_g1_worker.run(tr, None, STEPS, SEQ, 4, LR,
                               state=TrainState(state.theta, state.opt, start), start=start)
    for k, v in res["full"].items():
        assert float(np.abs(v[0] - ref["single"]["p." + k]).max()) < 5e-5, k


def test_cli_runs_kimi_at_g1_and_raises_where_the_reference_does(tmp_path, capsys):
    """The CLI takes G from ``--mesh``'s first entry, as the reference's
    does (``g = shape[0]``), while kimi-k2's gossip size is 1 on a mesh
    without "pod": it runs at ``--mesh 1,m`` (here the single-card engine
    at G = 1, the reference's flat batch) and raises at ``--mesh 2,2``.
    A G = 1 run checkpointed at step 2 and resumed to 3 ends where the
    uninterrupted run does, bit for bit, and its file holds the reference's
    unstacked leaves."""
    from repro_torch.checkpoint.ckpt import checkpoint_path, leaf_shapes
    from repro_torch.launch.train import main
    import zipfile

    argv = ["--arch", ARCH, "--mesh", "1,2", "--seq", "16", "--per-node-batch", "2",
            "--topology", "d_ring"]
    full = main(argv + ["--steps", "3"], device="cpu")
    assert full["trainer"].g == 1 and full["trainer"].engine == "stacked"
    assert all(np.isfinite(full["losses"]))
    d = str(tmp_path / "ck")
    main(argv + ["--steps", "2", "--ckpt-dir", d, "--ckpt-every", "2"], device="cpu")
    with zipfile.ZipFile(checkpoint_path(d, 2)) as zf:
        shapes = leaf_shapes(zf)
    defs = full["trainer"].full_defs
    assert shapes["p/blocks/ffn/w_down"] == defs["blocks.ffn.w_down"].shape
    resumed = main(argv + ["--steps", "3", "--ckpt-dir", d, "--resume"], device="cpu")
    assert resumed["losses"] == full["losses"][2:]
    assert torch.equal(resumed["state"].theta, full["state"].theta)
    with pytest.raises(ValueError, match="gossip nodes"):
        main(["--arch", ARCH, "--mesh", "2,2", "--steps", "1", "--seq", "16"], device="cpu")
