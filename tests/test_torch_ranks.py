"""Port parity: the ranks engine (one ``torch.distributed`` rank per node)
against the reference's dense oracle and the port's stacked trainer.

One world of 4 gloo ranks on the CPU per module (file-store rendezvous in
a temporary directory, so concurrent test workers never race for a port)
trains every case below for 4 steps from the reference's weights
(granite-8b-reduced, float32, seq 16, per-node batch 2, ``sgd(0.9)`` unless
a case names AdamW or LARS, DBench norms on), as
``tests/test_torch_train.py`` trains the stacked trainer; the cases include
multi-round programs (hub-balanced too) and closed-loop Ada, whose
transitions every rank must share with the oracle.  Bounds: parameters and losses within 5e-5 of the dense oracle,
norms within rtol 1e-5; the fused cases equal the stacked trainer (K1's
twin on the same rows) within 1e-6.  Every world ends within its hard
timeout: a deadlock fails, it does not hang.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_rank_worker  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from test_torch_train import (  # noqa: E402
    BATCH, EXTRA, G, LR, SEQ, STEPS, _freeze, _init, _oracle_case, _port_case,
)

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 120

# name -> (topology, fused, mix_order, mixing)
CASES = {
    "d_ring-interpreter": ("d_ring", False, "post", "ppermute"),
    "d_ring-fused": ("d_ring", True, "post", "ppermute"),
    "d_exponential-fused": ("d_exponential", True, "post", "ppermute"),
    # edge-coloured: nodes idle in some rounds and land zeros
    "d_star-fused": ("d_star", True, "post", "ppermute"),
    # AllReduce: the gradients' pmean (fused_apply leaves it to the interpreter)
    "c_complete": ("c_complete", True, "post", "ppermute"),
    # GatherRow: all_gather and this rank's row of W
    "d_ring-dense": ("d_ring", False, "post", "dense"),
    "d_ring-pre": ("d_ring", True, "pre", "ppermute"),
}


def _extra_case(name, fused):
    """A case of ``test_torch_train.EXTRA`` in the worker's form."""
    topology, topo_kw, engine_kw, opt, lr = EXTRA[name]
    topo_kw = dict(topo_kw)
    mix_order = topo_kw.pop("mix_order", "post")
    return (topology, fused, mix_order, "ppermute",
            {"topo_kw": topo_kw, "engine_kw": engine_kw, "opt": opt, "lr": lr})


# multi-round programs (the shard interpreter folds over the stages; with
# fused_apply K2 runs round 1), closed-loop Ada (Ξ from two pmeans) and the
# other optimizers
CASES.update({
    "d_one_peer_exp-rounds2-fused": _extra_case("d_one_peer_exp-rounds2", True),
    "d_star-rounds3-hub-fused": _extra_case("d_star-rounds3-hub", True),
    "d_ring-rounds2-pre": _extra_case("d_ring-rounds2-pre", False),
    "d_ada-closed-fused": _extra_case("d_ada-closed", True),
    "d_ring-adamw": _extra_case("d_ring-adamw", False),
    "d_exponential-lars": _extra_case("d_exponential-lars", False),
})


def _spec(case):
    """The oracle's spec of a case (``test_torch_train._freeze`` form)."""
    topology, _, mix_order, _, *extra = CASES[case]
    if not extra:
        return _freeze((topology, {"mix_order": mix_order}, {}, ("sgd", {}), LR))
    e = extra[0]
    return _freeze((topology, {"mix_order": mix_order, **e["topo_kw"]}, e["engine_kw"],
                    e["opt"], e["lr"]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's per-rank results: ``{case: [rank 0 .. G-1 results]}``."""
    _, params = _init()
    tparams = {k: v.numpy() for k, v in params_from_jax(params).items()}
    results = spawn_world(
        _torch_rank_worker.run_cases, G, (CASES, tparams, STEPS, SEQ, BATCH, LR),
        timeout=WORLD_TIMEOUT, device="cpu", workdir=tmp_path_factory.mktemp("world"),
    )
    return {name: [r[name] for r in results] for name in CASES}


def _stacked(per_rank):
    """Rank results -> (params {k: (G, ...)}, [losses (G,)], [norms (G, L)])."""
    params = {k: np.concatenate([r["params"][k] for r in per_rank]) for k in per_rank[0]["params"]}
    losses = [np.array([r["losses"][t] for r in per_rank]) for t in range(STEPS)]
    norms = [np.stack([r["norms"][t] for r in per_rank]) for t in range(STEPS)]
    return params, losses, norms


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_match_dense_oracle(world, case):
    topology = CASES[case][0]
    per_rank = world[case]
    assert all(r["engine"] == ("ranks", "gloo") for r in per_rank)
    got_p, got_l, got_n = _stacked(per_rank)
    want_p, want_l, want_n, want_tr = _oracle_case(_spec(case))
    assert all(r["transitions"] == want_tr for r in per_rank)
    assert list(got_p) == list(want_p)
    maxdiff = max(float(np.abs(got_p[k] - want_p[k]).max()) for k in want_p)
    lossdiff = max(float(np.abs(a - b).max()) for a, b in zip(got_l, want_l))
    assert maxdiff < 5e-5, f"MAXDIFF={maxdiff:.3e}"
    assert lossdiff < 5e-5, f"LOSSDIFF={lossdiff:.3e}"
    for a, b in zip(got_n, want_n):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    # the replicas really diverged and mixed: not a trivially equal run
    if topology != "c_complete":
        assert float(np.abs(got_l[-1] - got_l[-1].mean()).max()) > 0
    # on the CPU every wrapper takes its plain twin and counts no launch
    for r in per_rank:
        assert set(r["launches"].values()) == {0}


@pytest.mark.parametrize("case", [c for c, spec in CASES.items()
                                  if spec[1] and spec[0] != "c_complete"])
def test_fused_ranks_match_stacked_trainer(world, case):
    """The ranks' K2 path against the stacked trainer's K1 path on the same
    rows: the same arithmetic, so within 1e-6."""
    topology, topo_kw, engine_kw, (opt, opt_kw), lr = _spec(case)
    got_p, got_l, got_n = _stacked(world[case])
    want_p, want_l, want_n, _ = _port_case(
        (topology, dict(topo_kw), dict(engine_kw), (opt, dict(opt_kw)), lr), True)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=1e-6, err_msg=k)
    for a, b in zip(got_l, want_l):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(got_n, want_n):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_main_under_torch_distributed_run(tmp_path):
    """The CLI as ``torch.distributed.run --standalone --nproc-per-node 4``
    starts it: every process joins the gloo group as one rank."""
    script = tmp_path / "run_main.py"
    script.write_text(
        "from repro_torch.launch.train import main\n"
        "main(['--reduced', '--steps', '2', '--topology', 'd_ring', '--fused-apply',\n"
        "      '--seq', '16', '--mesh', '4,1'], device='cpu')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(script)],
        capture_output=True, text=True, env=env, timeout=WORLD_TIMEOUT, cwd=tmp_path,
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "engine ranks | transport gloo" in out.stdout
    assert "apply fused kernel K2" in out.stdout
    assert out.stdout.count("2 steps in") == 1   # rank 0 alone prints


def test_comm_collectives(tmp_path):
    """``permute`` lands zeros (not the buffer's old contents) on ranks that
    are no destination; ``pmean`` and ``all_gather`` over 4 gloo ranks."""
    res = spawn_world(_torch_rank_worker.comm_checks, 4, (1000,), timeout=WORLD_TIMEOUT,
                      device="cpu", workdir=tmp_path)
    assert res == [{"transport": "gloo", "permute": True, "pmean": True,
                    "all_gather": True}] * 4


@pytest.mark.gpu
def test_comm_collectives_on_the_card(tmp_path):
    """The same on the card: NCCL with a card per rank, else gloo through
    pinned host chunks, here 80M float32 (320 MB) per rank, so that every
    collective is staged in several chunks with a ragged last one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = spawn_world(_torch_rank_worker.comm_checks, 4, (80_000_000,), timeout=300,
                      workdir=tmp_path)
    transport = "nccl" if torch.cuda.device_count() >= 4 else "gloo-host"
    assert res == [{"transport": transport, "permute": True, "pmean": True,
                    "all_gather": True}] * 4


@pytest.mark.parametrize("fn,error,timeout", [
    ("fail_on_rank_1", RuntimeError, 60),   # the other waits in a collective
    ("sleep_forever", TimeoutError, 10),
])
def test_world_ends_on_a_failed_or_stuck_rank(tmp_path, fn, error, timeout):
    t0 = time.monotonic()
    with pytest.raises(error):
        spawn_world(getattr(_torch_rank_worker, fn), 2, timeout=timeout, device="cpu",
                    workdir=tmp_path)
    assert time.monotonic() - t0 < timeout + 15
