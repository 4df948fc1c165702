"""Port parity: tensor and expert parallelism inside a node — the ranks
engine on a (2 data × 2 model) world of 4 gloo ranks on the CPU — against
the reference's dense simulator on one device.

Every case starts from the reference's ``init_model(cfg, key,
tp_size=2)`` weights (heads padded at the model size of 2 where the config
pads) and trains 4 steps (float32, seq 16, per-node batch 2, ``sgd(0.9)``,
DBench norms on); rank (i, j) holds shard j of node i and its flat state is
its shard row.  Bounds, the reference's ``spmd_equivalence_script.py``
bar: the node's gathered parameters and its losses within 5e-5 of the
oracle's, norms within rtol 1e-5, the controller's transitions the
oracle's; every leaf that the model axis leaves whole is the same bits on
both model ranks of a node after the run.  Cases:

* granite-8b-reduced (4/2 heads: heads on "model") on d_ring, with the
  ppermute program and with the dense (GatherRow) one, and d_star with
  fused apply (K2's twin on the shard row);
* d_ada open loop and closed loop;
* the contraction-dim fallback (3 heads, 1 KV head, no padding: q/k/v row
  parallel over d_model, ``wo`` split on its output dim);
* padded heads: qwen2.5-14b-reduced at 3 heads and 1 KV head, which
  ``head_padding(3, 1, 2)`` pads to (4, 1, 4) (heads-sharded q over a
  whole KV head), and with ``pad_kv`` to (6, 2, 3); its q/k/v biases are
  replicated leaves used on local heads;
* phi3.5-moe-reduced (4 experts, 2 a rank) with ``moe_impl`` "gather" and
  "manual_ep" (the oracle runs the reference's ``apply_moe``: its
  manual-EP path needs a mesh);
* a checkpoint written by the world at step 2, which the reference's
  ``load_checkpoint`` reads as the gathered state, and a resume from it
  that ends bit for bit at the uninterrupted run's parameters;
* the ssm and hybrid families: rwkv6-1.6b-reduced (4 heads, 2 a rank) and
  zamba2-7b-reduced (8 SSD heads, 4 a rank; the shared attention block's
  4/2 heads on "model") in float32, and zamba2 in bfloat16 on its
  mixed-dtype float32 state, each step held against the reference's step
  from the world's own state (their group norms make free-running runs
  part), at the family's rounding bars.

The padded, pad_kv and contraction cases also run on the stacked engine
with the same (2 × 2) mesh in one process, against the same oracle.

The CLI's ``--mesh 2,2`` runs this engine under ``torch.distributed.run``
with 4 processes.
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

import _torch_tp_worker  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.dsgd import make_topology as jmake_topology  # noqa: E402
from repro.core.simulator import DecentralizedSimulator  # noqa: E402
from repro.core.simulator import SimState  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim.sgd import sgd as jsgd  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
G, TP, STEPS, SEQ, BATCH, LR = 2, 2, 4, 16, 2, 0.05
WORLD_TIMEOUT = 300
HEADS31 = (("n_heads", 3), ("n_kv", 1), ("d_head", 64))

# name -> (arch, cfg replace, topology, topology kwargs, engine kwargs, fused, mixing)
CASES = {
    "d_ring": ("granite-8b", (), "d_ring", (), (), False, "ppermute"),
    "d_ring-dense": ("granite-8b", (), "d_ring", (), (), False, "dense"),
    "d_star-fused": ("granite-8b", (), "d_star", (), (), True, "ppermute"),
    "d_ada": ("granite-8b", (), "d_ada", (("k_floor", "one_peer"),), (), True, "ppermute"),
    "d_ada-closed": ("granite-8b", (), "d_ada",
                     (("k_floor", "one_peer"), ("consensus_target", 0.9)),
                     (("mix_every", 2),), True, "ppermute"),
    "contraction": ("granite-8b", HEADS31, "d_ring", (), (), True, "ppermute"),
    "padded": ("qwen2.5-14b", HEADS31, "d_ring", (), (), True, "ppermute"),
    "padded-kv": ("qwen2.5-14b", HEADS31 + (("pad_kv", True),), "d_ring", (), (), False,
                  "ppermute"),
    "moe-gather": ("phi3.5-moe-42b-a6.6b", (), "d_ring", (), (), True, "ppermute"),
    "moe-manual_ep": ("phi3.5-moe-42b-a6.6b", (("moe_impl", "manual_ep"),), "d_ring", (), (),
                      True, "ppermute"),
    "ckpt": ("granite-8b", (), "d_ring", (), (), True, "ppermute"),
    "rwkv6": ("rwkv6-1.6b", (), "d_ring", (), (), True, "ppermute"),
    "zamba2": ("zamba2-7b", (), "d_ring", (), (), True, "ppermute"),
    "zamba2-mixed": ("zamba2-7b", (("dtype", "bfloat16"),), "d_ring", (), (), True,
                     "ppermute"),
}
# the ssm and hybrid cases are held step by step; the others as a whole run
STEPWISE = ["rwkv6", "zamba2", "zamba2-mixed"]
WHOLE_RUN = [name for name in CASES if name not in STEPWISE]


def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jcfg(name):
    arch, replace = CASES[name][:2]
    replace = dict(replace)
    if replace.get("moe_impl") == "manual_ep":
        replace["moe_impl"] = "gather"      # the reference's manual EP needs a mesh
    dtype = getattr(jnp, replace.pop("dtype", "float32"))
    return dataclasses.replace(jget_config(arch + "-reduced"), dtype=dtype, remat=False,
                               **replace)


@functools.lru_cache(maxsize=None)
def _init(name):
    cfg = _jcfg(name)
    return jax.device_get(jax.jit(lambda k: jtfm.init_model(cfg, k, tp_size=TP))(
        jax.random.PRNGKey(7)))


@functools.lru_cache(maxsize=None)
def _oracle(name):
    """(params {path: (G, ...)}, [losses (G,)], [norms (G, L)], transitions,
    the initial state's {"p", "o"} tree) of the reference's dense simulator."""
    cfg = _jcfg(name)
    _, _, topology, topo_kw, engine_kw, _, _ = CASES[name]
    topo = jmake_topology(topology, G, **dict(topo_kw))
    sim = DecentralizedSimulator(lambda p, b: jtfm.loss_fn(p, cfg, b), jsgd(0.9), topo,
                                 mixing="dense", collect_norms=True, **dict(engine_kw))
    state = sim.init(jax.tree.map(jnp.asarray, _init(name)))
    template = {"p": state.params, "o": state.opt_state}
    src = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, seed=0)
    losses, norms = [], []
    for t in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.stacked(G, t, BATCH).items()}
        state, loss, nrm = sim.train_step(state, batch, LR, epoch=0)
        losses.append(np.asarray(loss))
        norms.append(np.asarray(nrm))
    ctl = topo.controller
    return (_flat_np(jax.device_get(state.params)), losses, norms,
            None if ctl is None else list(ctl.transitions), template)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Per case, the results of ranks 0..3 (rank i·2 + j: shard j of node i)."""
    params = {name: {k: v.float().numpy() for k, v in params_from_jax(_init(name)).items()}
              for name in CASES}
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    results = spawn_world(
        _torch_tp_worker.tp_cases, G * TP, (CASES, params, STEPS, SEQ, BATCH, LR, TP, ckpt),
        timeout=WORLD_TIMEOUT, device="cpu", workdir=tmp_path_factory.mktemp("world"),
    )
    return {name: [r[name] for r in results] for name in CASES}, ckpt


def _node(per_rank, i, key, t=None):
    r = per_rank[i * TP]
    return r[key] if t is None else r[key][t]


@pytest.mark.parametrize("case", WHOLE_RUN)
def test_tp_world_matches_the_dense_oracle(world, case):
    per_rank = world[0][case]
    assert all(r["engine"] == ("ranks", "gloo", True) for r in per_rank)
    want_p, want_l, want_n, want_tr, _ = _oracle(case)
    got_p = {k: np.concatenate([_node(per_rank, i, "full")[k] for i in range(G)])
             for k in per_rank[0]["full"]}
    assert list(got_p) == list(want_p)
    maxdiff = max(float(np.abs(got_p[k] - want_p[k]).max()) for k in want_p)
    assert maxdiff < 5e-5, f"MAXDIFF={maxdiff:.3e}"
    for t in range(STEPS):
        losses = np.array([_node(per_rank, i, "losses", t) for i in range(G)])
        assert float(np.abs(losses - want_l[t]).max()) < 5e-5
        norms = np.stack([_node(per_rank, i, "norms", t) for i in range(G)])
        np.testing.assert_allclose(norms, want_n[t], rtol=1e-5, atol=1e-30)
    assert all(r["transitions"] == want_tr for r in per_rank)
    _check_model_ranks(per_rank, want_l)


def _check_model_ranks(per_rank, want_l):
    """Both model ranks of a node: the same loss, the same replicated
    leaves, a sharded leaf's 1/TP; the replicas diverged; no launch."""
    for i in range(G):
        a, b = per_rank[i * TP], per_rank[i * TP + 1]
        assert np.array_equal(a["losses"], b["losses"])
        assert a["replicated"] and a["replicated"] == b["replicated"]
        for k in a["replicated"]:
            assert np.array_equal(a["local"][k], b["local"][k]), k
        for k in a["local"]:
            if k not in a["replicated"]:
                assert a["local"][k].size * TP == a["full"][k].size, k
    # the replicas diverged and mixed: not a trivially equal run
    assert float(np.abs(want_l[-1] - want_l[-1].mean()).max()) > 0
    # on the CPU every wrapper takes its plain twin and counts no launch
    assert all(set(r["launches"].values()) <= {0} for r in per_rank)


@pytest.mark.parametrize("case", ["padded", "padded-kv", "contraction"])
def test_stacked_engine_on_a_model_axis_matches_the_dense_oracle(case):
    """The stacked engine with a (2 × 2) mesh on one device: the model axis
    only sets the padded heads and the active-head mask, as the reference's
    stacked GSPMD realization computes them.  The same bars as the world's
    against the same oracle; the padded cases hold the mask, the unpadded
    one that a mesh pads nothing it should not."""
    params = {k: v.numpy() for k, v in params_from_jax(_init(case)).items()}
    got = _torch_tp_worker.stacked_case(CASES[case], params, STEPS, SEQ, BATCH, LR, G, TP)
    assert got["engine"] == ("stacked", TP, True)
    want_p, want_l, want_n, want_tr, _ = _oracle(case)
    assert list(got["params"]) == list(want_p)
    for k in want_p:
        assert got["params"][k].shape == want_p[k].shape, k
    maxdiff = max(float(np.abs(got["params"][k] - want_p[k]).max()) for k in want_p)
    assert maxdiff < 5e-5, f"MAXDIFF={maxdiff:.3e}"
    for t in range(STEPS):
        assert float(np.abs(got["losses"][t] - want_l[t]).max()) < 5e-5
        np.testing.assert_allclose(got["norms"][t], want_n[t], rtol=1e-5, atol=1e-30)
    assert got["transitions"] == want_tr
    assert set(got["launches"].values()) <= {0}


def _x64():
    """jax's float64 mode for the block (its context manager by version)."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64

    return enable_x64()


def _nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split(".")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


@functools.lru_cache(maxsize=None)
def _step_sim(name, wide):
    """(the reference's dense simulator of case ``name``, its leaves' dtypes):
    the case's own, or ``wide`` (float64 for a float32 case, float32 for a
    bfloat16 one: what measures the reference's own rounding)."""
    cfg = _jcfg(name)
    dtypes = {k: v.dtype for k, v in _flat_np(_init(name)).items()}
    if wide:
        w = jnp.float32 if cfg.dtype == jnp.bfloat16 else jnp.float64
        cfg = dataclasses.replace(cfg, dtype=w)
        dtypes = {k: w for k in dtypes}
    _, _, topology, topo_kw, engine_kw, _, _ = CASES[name]
    sim = DecentralizedSimulator(lambda p, b: jtfm.loss_fn(p, cfg, b), jsgd(0.9),
                                 jmake_topology(topology, G, **dict(topo_kw)),
                                 mixing="dense", collect_norms=True, **dict(engine_kw))
    return sim, dtypes


def _ref_step(name, theta, mom, t, wide):
    """One step of the reference's dense simulator from the port's state
    (``theta``/``mom``: {path: (G, ...) float32}) on step ``t``'s batch:
    (params, momentum, losses, norms) as float64 numpy."""
    import contextlib

    sim, dtypes = _step_sim(name, wide)
    big = wide and dtypes[next(iter(dtypes))] == jnp.float64
    with (_x64() if big else contextlib.nullcontext()):
        mdt = jnp.float64 if big else jnp.float32
        state = SimState(params=_nest({k: jnp.asarray(v).astype(dtypes[k])
                                       for k, v in theta.items()}),
                         opt_state=_nest({k: jnp.asarray(v, mdt) for k, v in mom.items()}),
                         step=t)
        src = SyntheticLM(vocab=_jcfg(name).vocab, seq_len=SEQ, seed=0)
        batch = {k: jnp.asarray(v) for k, v in src.stacked(G, t, BATCH).items()}
        out, loss, nrm = sim.train_step(state, batch, LR, epoch=0)
        f64 = lambda tree: {k: np.asarray(v, np.float64)
                            for k, v in _flat_np(jax.device_get(tree)).items()}
        return (f64(out.params), f64(out.opt_state), np.asarray(loss, np.float64),
                np.asarray(nrm, np.float64))


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("case", STEPWISE)
def test_tp_world_ssm_and_hybrid_match_the_reference_step_by_step(world, case):
    """The ssm and hybrid families on the (2 × 2) world, each step held
    against the single-card stacked engine's step and the reference's dense
    simulator's step from the world's own state before it (their
    ill-conditioned group norms make free-running float32 runs part:
    ROADMAP "Behaviours found").  The rounding term of a leaf is twice the
    larger of the two packages' own rounding of that step: each one's
    float32 step against its float64 step (bf16 against float32 on the
    mixed state; the norms', the reference's alone).  Bars against the single-card step: float32, the oracle
    bar (5e-5; norms rtol 1e-5) plus the rounding term; the mixed state
    (bf16 leaves, float32 ``a_log``/``d_skip``), PR 20's bars (float32
    leaves and m 1e-6 of scale, bf16 leaves one ulp, and after the mix one
    ulp of the column's terms) plus the rounding term.  Against the
    reference: the same bars plus the single-card step's own distance from
    it (which ``test_torch_zoo.py`` holds), so that the world is no further
    from the reference than one card is.  The world computes the single
    card's function exactly: ``test_ssm_and_hybrid_tp_gradients_are_one_cards``
    holds it in float64.  Replicated leaves bit for bit across model ranks."""
    per_rank = world[0][case]
    assert all(r["engine"] == ("ranks", "gloo", True) for r in per_rank)
    mixed = case.endswith("-mixed")
    wide = "float32" if mixed else "float64"
    tree = _flat_np(_init(case))
    narrow = {k for k, v in tree.items() if v.dtype == jnp.bfloat16}
    assert bool(narrow) == mixed
    init = {k: np.stack([v] * G).astype(np.float32) for k, v in tree.items()}
    before = (init, {k: np.zeros_like(v) for k, v in init.items()})
    trail = [tuple({k: np.concatenate([_node(per_rank, i, "trail", t)[j][k]
                                       for i in range(G)]) for k in init}
                   for j in (0, 1)) for t in range(STEPS)]

    def bar(k, want, prior):
        """The case's bar for a leaf (``prior``: θ before the step) or, with
        ``prior`` None, its momentum."""
        if not mixed:
            return 5e-5
        out = 1e-6 * max(float(np.abs(want).max()), 1e-30)
        if prior is not None and k in narrow:
            cols = np.maximum(np.abs(prior).max(0), np.abs(want).max(0))
            out = out + _bf16_ulp(want) + _bf16_ulp(2 * cols)[None]
        return out

    def held(label, got, one, want, one_w, want_w, base):
        term = 2 * max(np.abs(want - want_w).max(),
                       0.0 if one_w is None else np.abs(one - one_w).max())
        assert np.all(np.abs(got - one) <= base + term), (label, "one card")
        assert np.all(np.abs(got - want) <= base + term + np.abs(one - want).max()), \
            (label, "reference")

    want_losses = []
    for t in range(STEPS):
        ref, ref_w = (_ref_step(case, *before, t, w) for w in (False, True))
        one, one_w = (_torch_tp_worker.stacked_step(CASES[case], *before, t, SEQ, BATCH, LR,
                                                    G, dtype=w) for w in (None, wide))
        got_p, got_m = trail[t]
        for k in init:
            held((t, k), got_p[k], one[0][k], ref[0][k], one_w[0][k], ref_w[0][k],
                 bar(k, ref[0][k], before[0][k]))
            held((t, k, "m"), got_m[k], one[1][k], ref[1][k], one_w[1][k], ref_w[1][k],
                 bar(k, ref[1][k], None))
            if k in narrow:
                assert np.array_equal(
                    got_p[k].astype(jnp.bfloat16).astype(np.float32), got_p[k]), (t, k)
        losses = np.array([_node(per_rank, i, "losses", t) for i in range(G)])
        held((t, "losses"), losses, one[2], ref[2], one_w[2], ref_w[2], 5e-5)
        norms = np.stack([_node(per_rank, i, "norms", t) for i in range(G)])
        held((t, "norms"), norms, one[3], ref[3], one_w[3], ref_w[3], 1e-5 * np.abs(ref[3]))
        want_losses.append(ref[2])
        before = trail[t]
    _check_model_ranks(per_rank, want_losses)


@pytest.mark.parametrize("case", ["rwkv6", "zamba2"])
def test_ssm_and_hybrid_tp_gradients_are_one_cards(case):
    """In float64 the loss and every gradient of two model ranks (their
    shards put together; replicated leaves' gradients the same bits on
    both) equal one card's within 1e-10 relative: the sharded forward and
    backward compute the single card's function (float32 leaves only
    round differently: the step test's rounding term)."""
    flat = {k: v.astype(np.float64) for k, v in _flat_np(_init(case)).items()}
    src = SyntheticLM(vocab=_jcfg(case).vocab, seq_len=SEQ, seed=0)
    batch = {k: v[1] for k, v in src.stacked(G, 0, BATCH).items()}
    (l0, g0, dims), (l1, g1, _) = spawn_world(_torch_tp_worker.tp_grads, TP,
                                              (CASES[case], flat, batch), timeout=120,
                                              device="cpu")
    want_l, want_g = _torch_tp_worker.one_card_grads(CASES[case], flat, batch)
    assert l0 == l1 and abs(l0 - want_l) <= 1e-10 * abs(want_l)
    for k, want in want_g.items():
        if dims[k] is None:
            assert np.array_equal(g0[k], g1[k]), k
            got = g0[k]
        else:
            got = np.concatenate([g0[k], g1[k]], axis=dims[k])
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max(), k


def test_tp_checkpoint_is_the_reference_file_and_resumes_bit_for_bit(world):
    results, ckpt = world
    per_rank = results["ckpt"]
    template = _oracle("ckpt")[4]
    restored, step = jckpt.load_checkpoint(ckpt, template)
    assert step == STEPS // 2
    saved_p = {k: np.concatenate([_node(per_rank, i, "saved")[0][k] for i in range(G)])
               for k in per_rank[0]["full"]}
    saved_m = {k: np.concatenate([_node(per_rank, i, "saved")[1][k] for i in range(G)])
               for k in per_rank[0]["full"]}
    file_p = _flat_np(jax.device_get(restored["p"]))
    file_m = _flat_np(jax.device_get(restored["o"]))
    assert list(file_p) == list(saved_p)
    for k in saved_p:
        assert np.array_equal(file_p[k], saved_p[k]), k
    assert len(file_m) == len(saved_m)
    for (fk, fv), k in zip(file_m.items(), saved_m):
        assert fk.endswith(k) and np.array_equal(fv, saved_m[k]), k
    for r in per_rank:
        for k in r["full"]:
            assert np.array_equal(r["resumed"][k], r["full"][k]), k


@functools.lru_cache(maxsize=None)
def _moe_inputs():
    cfg = jget_config("phi3.5-moe-42b-a6.6b-reduced")
    cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    params = jax.device_get(jax.jit(lambda k: jtfm.init_model(cfg, k, tp_size=TP))(
        jax.random.PRNGKey(5)))
    ffn = {k: np.asarray(v[0]) for k, v in params["blocks"]["ffn"].items()
           if not isinstance(v, dict)}
    x = np.random.default_rng(0).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return cfg, ffn, x


def test_manual_ep_matches_the_reference_apply_moe():
    """The port's manual-EP schedule on two ranks (each holding 2 of the 4
    experts) against the reference's ``apply_moe`` on one: the reference's
    ``spmd_manual_ep_script.py`` bars (output atol 1e-5, aux loss 1e-6),
    with every expert's gradient nonzero."""
    cfg, ffn, x = _moe_inputs()
    want, want_aux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in ffn.items()},
                                    jnp.asarray(x), top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor)
    results = spawn_world(_torch_tp_worker.manual_ep_check, TP,
                          (ffn, x, cfg.top_k, cfg.capacity_factor), timeout=120,
                          device="cpu")
    for out, aux, grads in results:
        np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=1e-5)
        assert abs(aux - float(want_aux)) < 1e-6
        for name in ("w_gate", "w_up", "w_down"):
            assert all(np.abs(g).max() > 0 for g in grads[name]), name
    # the experts' gradients of the two ranks are those of their own experts
    assert results[0][2]["w_gate"].shape[0] == ffn["w_gate"].shape[0] // TP


def test_cli_runs_the_tp_ranks_engine_under_torch_distributed_run(tmp_path):
    """``--mesh 2,2`` under ``torch.distributed.run --nproc-per-node 4``: a
    (2 × 2) tensor-parallel world; rank 0 alone prints."""
    script = tmp_path / "run_main.py"
    script.write_text(
        "from repro_torch.launch.train import main\n"
        "main(['--reduced', '--steps', '2', '--topology', 'd_ring', '--fused-apply',\n"
        "      '--seq', '16', '--mesh', '2,2'], device='cpu')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(script)],
        capture_output=True, text=True, env=env, timeout=WORLD_TIMEOUT, cwd=tmp_path,
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "engine ranks | transport gloo | tensor parallel x2" in out.stdout
    assert "apply fused kernel K2" in out.stdout
    assert out.stdout.count("2 steps in") == 1


def test_every_family_and_a_fault_model_take_the_tp_ranks_engine():
    """The ssm and hybrid families and a fault model on a model axis > 1
    build the tensor-parallel ranks engine (rank (0, 0) of a (2 × 2) world
    on paper); ``tests/test_torch_tp_faults.py`` runs faults there."""
    from repro_torch.configs import get_config as tget_config
    from repro_torch.core.dsgd import make_topology as tmake_topology
    from repro_torch.core.faults import make_fault_model
    from repro_torch.launch.comm import RecordingComm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd as tsgd

    mesh = make_mesh((2, 2), ("data", "model"))
    ranks = {"comm": RecordingComm(0, 2), "model_comm": RecordingComm(0, 2),
             "device": "meta", "mesh": mesh}
    granite = tget_config("granite-8b-reduced")
    faulty = SPMDTrainer(granite, tmake_topology(
        "d_ring", 2, fault_model=make_fault_model("crash", 2, rate=0.5)), tsgd(0.9), **ranks)
    assert faulty.tp is not None and faulty.fault_model is not None
    for arch in ("rwkv6-1.6b-reduced", "zamba2-7b-reduced"):
        assert SPMDTrainer(tget_config(arch), tmake_topology("d_ring", 2), tsgd(0.9),
                           **ranks).tp is not None
