"""Port parity: the trainer, the ranks engine and checkpoints on the zoo.

* The stacked trainer with fused apply (K1's plain twin on the CPU) at
  G = 4 on d_ring, seq 16, per-node batch 2, ``sgd(0.9)``: phi3.5-moe and
  rwkv6 at ``-reduced`` run 2 steps from the reference's weights against
  the reference's dense simulator on the same ``SyntheticLM`` batches
  (parameters and losses within 5e-5).  zamba2's float32 gradients carry
  rounding of up to ~5e-2 in both packages (see ``tests/test_torch_zoo.py``)
  which a step of lr 0.05 turns into ~1e-3 in the parameters: its first
  loss is held to the simulator's within 5e-5, and its fused step to the
  reference's ``fused_apply_stacked`` on the same gradients within 1e-6.
* zamba2-reduced set back to bfloat16 (leaves of two dtypes: the Mamba2
  ``a_log``/``d_skip`` stay float32): the port's flat state is float32,
  and its fused step equals the reference's fused step on the same
  gradients — the float32 leaves within 1e-6 of their scale, the bfloat16
  leaves within one bfloat16 ulp (plus float32 rounding at the leaf's
  scale, where an update cancels to ~0), each leaf a value of its own
  dtype — and
  its interpreter step the reference's per-leaf update and mix the same
  way.  The same model over 4 gloo ranks equals its stacked rows bit for
  bit; its checkpoint is the reference's file with each leaf in its dtype,
  read both ways.  ``bucket_mb`` on that model is the monolithic step bit
  for bit.
* ``main --arch`` trains every architecture; a VLM without patch
  embeddings raises a ValueError naming them.
"""
import dataclasses
import functools
import importlib
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_rank_worker  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import ARCH_NAMES, get_config as jget_config  # noqa: E402
from repro.core.dsgd import make_topology as jmake_topology  # noqa: E402
from repro.core.schedule import compile_graph as jcompile_graph  # noqa: E402
from repro.core.simulator import DecentralizedSimulator  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.kernels.gossip_update import fused_apply_stacked as jfused_apply  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.dsgd import make_topology as tmake_topology  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.launch.train import SPMDTrainer, main  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

torch.set_num_threads(1)
jopt = importlib.import_module("repro.optim.sgd")
topt = importlib.import_module("repro_torch.optim.sgd")

G, SEQ, BATCH, LR = 4, 16, 2, 0.05
HYBRID = "zamba2-7b"
F32_LEAVES = ("mamba_groups.a_log", "mamba_groups.d_skip", "tail_mamba.a_log",
              "tail_mamba.d_skip")


def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _f32(a):
    """A reference leaf (bfloat16 included) as float32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.float32))


@functools.lru_cache(maxsize=None)
def _init(arch, dtype_name="float32"):
    jcfg = dataclasses.replace(jget_config(arch + "-reduced"), remat=False,
                               dtype=jnp.dtype(dtype_name))
    tcfg = dataclasses.replace(tget_config(arch + "-reduced"), remat=False,
                               dtype=getattr(torch, dtype_name))
    params = jax.device_get(jax.jit(lambda k: jtfm.init_model(jcfg, k, tp_size=1))(
        jax.random.PRNGKey(42)))
    return jcfg, tcfg, params


@functools.lru_cache(maxsize=None)
def _oracle(arch, steps):
    """The reference's dense simulator: (params {path: (G, ...)}, [losses])."""
    jcfg, _, params = _init(arch)
    sim = DecentralizedSimulator(lambda p, b: jtfm.loss_fn(p, jcfg, b), jopt.sgd(0.9),
                                 jmake_topology("d_ring", G), mixing="dense")
    state = sim.init(jax.tree.map(jnp.asarray, params))
    src = SyntheticLM(vocab=jcfg.vocab, seq_len=SEQ, seed=0)
    losses = []
    for t in range(steps):
        state, loss, _ = sim.train_step(
            state, {k: jnp.asarray(v) for k, v in src.stacked(G, t, BATCH).items()}, LR)
        losses.append(np.asarray(loss))
    return _flat_np(jax.device_get(state.params)), losses


def _trainer(arch, dtype_name="float32", fused=True):
    _, tcfg, params = _init(arch, dtype_name)
    trainer = SPMDTrainer(tcfg, tmake_topology("d_ring", G), topt.sgd(0.9),
                          fused_apply=fused, device="cpu")
    return trainer, trainer.init_state(params=params_from_jax(params))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "rwkv6-1.6b"])
def test_fused_trainer_matches_reference_simulator(arch):
    want, want_losses = _oracle(arch, 2)
    trainer, state = _trainer(arch)
    src = SyntheticLM(vocab=trainer.cfg.vocab, seq_len=SEQ, seed=0)
    for t in range(2):
        state, loss, _ = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
        np.testing.assert_allclose(loss.numpy(), want_losses[t], atol=5e-5, rtol=0)
    for name, v in trainer.stacked_params(state).items():
        np.testing.assert_allclose(v.numpy(), want[name], atol=5e-5, rtol=0, err_msg=name)


def _reference_step(arch, dtype_name, grads, lr, fused):
    """The reference's step from the replicated weights on the given
    (G, P) flat gradients: ``fused_apply_stacked`` (fused) or the
    optimizer's per-leaf update and the program's per-leaf mix."""
    jcfg, _, params = _init(arch, dtype_name)
    stack = lambda x: jnp.broadcast_to(jnp.asarray(x)[None], (G,) + x.shape)
    p_tree = jax.tree.map(stack, params)
    leaves, treedef = jax.tree.flatten(p_tree)
    g_leaves, off = [], 0
    for leaf in leaves:
        n = int(np.prod(leaf.shape[1:]))
        g_leaves.append(jnp.asarray(grads[:, off:off + n].reshape(leaf.shape), leaf.dtype))
        off += n
    g_tree = jax.tree.unflatten(treedef, g_leaves)
    opt = jopt.sgd(0.9)
    m_tree = jax.tree.map(stack, opt.init(params))
    program = jcompile_graph(jmake_topology("d_ring", G).graph_at(0, 0))
    if fused:
        new_p, new_m = jfused_apply(program, p_tree, g_tree, m_tree, lr=lr, beta=0.9)
    else:
        new_p, new_m = jax.vmap(opt.update, in_axes=(0, 0, 0, None))(g_tree, m_tree,
                                                                      p_tree, lr)
        new_p = program.apply_stacked(new_p)
    return _flat_np(jax.device_get(new_p)), _flat_np(jax.device_get(new_m))


def _one_step_with_grads(arch, dtype_name, fused, grads=None):
    """One port trainer step on SyntheticLM step 0; with ``grads`` given,
    the step takes them instead of its own (same losses).  Returns
    (trainer, state, the (G, P) float32 gradients the step used)."""
    trainer, state = _trainer(arch, dtype_name, fused)
    used = {}
    own = trainer._grads_into

    def grads_into(theta, grad, batch):
        losses = own(theta, grad, batch)
        if grads is not None:
            grad.copy_(torch.from_numpy(grads))
        used["g"] = grad.float().numpy().copy()
        return losses

    trainer._grads_into = grads_into
    src = SyntheticLM(vocab=trainer.cfg.vocab, seq_len=SEQ, seed=0)
    state, _, _ = trainer.train_step(state, src.stacked(G, 0, BATCH), LR)
    return trainer, state, used["g"]


def _check_against_reference(trainer, state, want_p, want_m, bf16_ulps):
    for name, v in trainer.stacked_params(state).items():
        got, want = v.float().numpy(), _f32(want_p[name])
        scale = max(float(np.abs(want).max()), 1e-30)
        if want_p[name].dtype == np.float32:
            np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0, err_msg=name)
        else:
            # plus float32 rounding at the leaf's scale: an update that
            # cancels to ~0 rounds there before it rounds to bfloat16
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert np.all(np.abs(got - want) <= bf16_ulps * ulp + 1e-6 * scale), name
    for name, v in trainer.layout.stacked_views(state.mom).items():
        want = _f32(want_m[name])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(v.numpy(), want, atol=1e-6 * scale, rtol=0, err_msg=name)


def test_hybrid_fused_step_matches_reference_on_the_same_gradients():
    want, want_losses = _oracle(HYBRID, 1)
    trainer, state, grads = _one_step_with_grads(HYBRID, "float32", True)
    src = SyntheticLM(vocab=trainer.cfg.vocab, seq_len=SEQ, seed=0)
    trainer2, state2 = _trainer(HYBRID)
    _, loss, _ = trainer2.train_step(state2, src.stacked(G, 0, BATCH), LR)
    np.testing.assert_allclose(loss.numpy(), want_losses[0], atol=5e-5, rtol=0)
    want_p, want_m = _reference_step(HYBRID, "float32", grads, LR, fused=True)
    _check_against_reference(trainer, state, want_p, want_m, 0)


@pytest.mark.parametrize("fused", [True, False])
def test_mixed_dtype_step_matches_reference(fused):
    """bf16 zamba2: float32 flat state, f32 leaves stay float32, every bf16
    leaf a bfloat16 value within one ulp of the reference's."""
    trainer, state, grads = _one_step_with_grads(HYBRID, "bfloat16", fused)
    layout = trainer.layout
    assert layout.mixed and state.theta.dtype == torch.float32
    dtypes = dict(zip(layout.names, layout.dtypes))
    assert {k for k, d in dtypes.items() if d == torch.float32} == set(F32_LEAVES)
    views = layout.leaf_views(state.theta[0])
    for name, v in views.items():
        assert v.dtype == dtypes[name], name
    bf = torch.cat([state.theta[:, a:b] for a, b, _ in layout.narrow_leaves()], dim=1)
    assert torch.equal(bf, bf.bfloat16().float())   # every bf16 leaf holds a bf16 value
    want_p, want_m = _reference_step(HYBRID, "bfloat16", grads, LR, fused=fused)
    assert all(want_p[k].dtype == np.float32 for k in F32_LEAVES)
    _check_against_reference(trainer, state, want_p, want_m, 1)


@pytest.mark.parametrize("fused", [True, False])
def test_mixed_dtype_rejects_buckets(fused):
    """``bucket_mb`` on bf16 zamba2 (it raised before the bucket step
    rounded the narrower leaves): at 1 MiB (13 buckets, several across a
    leaf-dtype boundary) and in one bucket, 2 steps bit for bit the
    monolithic trainer's (θ, m, losses), every bf16 leaf a bf16 value."""
    _, tcfg, params = _init(HYBRID, "bfloat16")
    src = SyntheticLM(vocab=tcfg.vocab, seq_len=SEQ, seed=0)
    runs = {}
    for mb in (None, 1, 1e6):
        trainer = SPMDTrainer(tcfg, tmake_topology("d_ring", G), topt.sgd(0.9),
                              fused_apply=fused, bucket_mb=mb, device="cpu")
        state = trainer.init_state(params=params_from_jax(params))
        losses = []
        for t in range(2):
            state, loss, _ = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
            losses.append(loss)
        runs[mb] = (state, torch.stack(losses))
    layout = trainer.layout
    assert trainer._bucket_layout.num_buckets == 1
    (mono, mono_l) = runs[None]
    for mb in (1, 1e6):
        state, losses = runs[mb]
        assert torch.equal(state.theta, mono.theta), mb
        assert torch.equal(state.mom, mono.mom), mb
        assert torch.equal(losses, mono_l), mb
    bf = torch.cat([mono.theta[:, a:b] for a, b, _ in layout.narrow_leaves()], dim=1)
    assert torch.equal(bf, bf.bfloat16().float())


def test_mixed_dtype_ranks_equal_stacked_rows(tmp_path):
    """4 gloo ranks (K2's twin) from the seed-0 weights: each rank's float32
    row (θ and m) bit for bit the stacked trainer's (K1's twin); the ranks'
    checkpoint is the stacked trainer's file member for member, and
    restored on the ranks gives the same rows."""
    _, tcfg, _ = _init(HYBRID, "bfloat16")
    trainer = SPMDTrainer(tcfg, tmake_topology("d_ring", G), topt.sgd(0.9),
                          fused_apply=True, device="cpu")
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=tcfg.vocab, seq_len=SEQ, seed=0)
    for t in range(2):
        state, _, _ = trainer.train_step(state, src.stacked(G, t, BATCH), LR)
    stacked = trainer.save_checkpoint(str(tmp_path / "stacked"), state)
    ranks_dir = str(tmp_path / "ranks")
    rows = spawn_world(_torch_rank_worker.zoo_rows, G,
                       (HYBRID, "bfloat16", 2, SEQ, BATCH, LR, ranks_dir),
                       timeout=300, device="cpu", workdir=tmp_path)
    for r, (theta, mom, engine) in enumerate(rows):
        assert engine == "ranks"
        assert theta.dtype == np.float32
        assert torch.equal(torch.from_numpy(theta), state.theta[r]), r
        assert torch.equal(torch.from_numpy(mom), state.mom[r]), r
    with zipfile.ZipFile(stacked) as a, zipfile.ZipFile(
            tckpt.checkpoint_path(ranks_dir, 2)) as b:
        names = [n for n in a.namelist() if n != "__extra__.npy"]
        assert sorted(names) == sorted(n for n in b.namelist() if n != "__extra__.npy")
        for n in names:
            assert a.read(n) == b.read(n), n


def test_mixed_dtype_checkpoint_is_the_reference_file(tmp_path):
    """Written by the port: every leaf in its own dtype, loaded by the
    reference; written by the reference: restored by the port exactly."""
    trainer, state, _ = _one_step_with_grads(HYBRID, "bfloat16", True)
    path = trainer.save_checkpoint(str(tmp_path / "port"), state)
    assert path is not None
    _, _, params = _init(HYBRID, "bfloat16")
    stack = lambda x: jnp.broadcast_to(jnp.asarray(x)[None], (G,) + x.shape)
    jtree = {"p": jax.tree.map(stack, params),
             "o": jax.tree.map(stack, jopt.sgd(0.9).init(params))}
    restored, step = jckpt.load_checkpoint(str(tmp_path / "port"), jtree)
    assert step == 1
    got_p = _flat_np(jax.device_get(restored["p"]))
    for name, v in trainer.stacked_params(state).items():
        if name in F32_LEAVES:
            assert got_p[name].dtype == np.float32, name
        else:   # the reference hands a bfloat16 leaf back as 2-byte void records
            assert got_p[name].dtype.kind == "V" and got_p[name].dtype.itemsize == 2, name
            got_p[name] = got_p[name].view(jnp.bfloat16)
        np.testing.assert_array_equal(_f32(got_p[name]), v.float().numpy(), err_msg=name)
    # the reference's file (its restored tree, a step later by one SGD-like nudge)
    nudged = jax.tree.map(lambda x: (jnp.asarray(x.view(jnp.bfloat16) if x.dtype.kind == "V"
                                                 else x, jnp.float32) * 1.5).astype(
        jnp.bfloat16 if x.dtype.kind == "V" else x.dtype), restored)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 7, nudged)
    fresh, fresh_state = _trainer(HYBRID, "bfloat16")
    assert fresh.restore_checkpoint(str(tmp_path / "ref"), fresh_state) == 7
    want_p = _flat_np(jax.device_get(nudged["p"]))
    for name, v in fresh.stacked_params(fresh_state).items():
        np.testing.assert_array_equal(v.float().numpy(), _f32(want_p[name]), err_msg=name)
    want_m = _flat_np(jax.device_get(nudged["o"]))
    for name, v in fresh.layout.stacked_views(fresh_state.mom).items():
        np.testing.assert_array_equal(v.numpy(), _f32(want_m[name]), err_msg=name)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cli_trains_every_arch(arch, capsys):
    argv = ["--arch", arch, "--steps", "1", "--seq", "8", "--mesh", "2,1",
            "--topology", "d_ring", "--fused-apply"]
    if arch == "internvl2-2b":
        with pytest.raises(ValueError, match="patch_embeds"):
            main(argv, device="cpu")
        return
    if arch.startswith("kimi"):
        # the reference's CLI takes G from --mesh's first entry while kimi-k2
        # gossips over pods only (G = 1 on a data x model mesh): it runs at
        # --mesh 1,m, the reference's G = 1 step (no gossip, no fused kernel)
        with pytest.raises(ValueError, match="gossip nodes"):
            main(argv, device="cpu")
        out = main([("1,1" if a == "2,1" else a) for a in argv], device="cpu")
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
        assert out["trainer"].g == 1 and "fused kernel" not in capsys.readouterr().out
        return
    out = main(argv, device="cpu")
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    assert "fused kernel K1" in capsys.readouterr().out
