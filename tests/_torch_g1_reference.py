"""Reference half of ``tests/test_torch_g1.py``: the JAX package's
``SPMDTrainer`` on 4 host devices (run as a subprocess: the test process
has one device).

    python tests/_torch_g1_reference.py OUT_DIR STEPS SEQ LR

reads ``OUT_DIR/<case>.params.npz`` (the port's initial full leaves,
dotted names) for every case of ``CASES`` and writes
``OUT_DIR/<case>.ref.npz``: per-step losses and norms, the final
parameters and momentum ("p.<name>", "m.<name>") and, at G = 1, the
dropped (token, choice) assignments of every MoE layer call.  The case
"single" also saves the reference's G = 1 checkpoint at step STEPS // 2
into ``OUT_DIR/ref_ckpt``.  Prints REF_OK.
"""
import dataclasses
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.dsgd import make_topology  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.launch.mesh import gossip_axes_for, gossip_size, make_mesh  # noqa: E402
from repro.launch.train import SPMDTrainer, TrainState  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim.sgd import sgd  # noqa: E402

# name -> (cfg fields, mesh shape, mesh axes, rows a node's batch)
CASES = {
    "single": ((), (2, 2), ("data", "model"), 4),
    "shard_ff": ((("moe_shard_ff", True),), (2, 2), ("data", "model"), 4),
    "aux": ((("aux_loss_weight", 1.0),), (2, 2), ("data", "model"), 4),
    "multi": ((("moe_shard_ff", True),), (2, 2, 1), ("pod", "data", "model"), 2),
}

DROPS: list = []


def _count_drops(logits, k):
    """The reference router, the assignments past capacity counted on the host."""
    weights, ids = _router(logits, k)
    t, e = logits.shape
    cap = int(max(k * t * CAPACITY_FACTOR / e, 4))

    def note(x):
        counts = np.bincount(np.asarray(x).reshape(-1), minlength=e)
        DROPS.append(int(np.maximum(counts - cap, 0).sum()))

    jax.debug.callback(note, ids)
    return weights, ids


_router = jmoe._top_k_router
CAPACITY_FACTOR = 1.25


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    return out


def _walk(tree, prefix, res, key):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _walk(tree[k], prefix + k + ".", res, key)
        else:
            res[key + "." + prefix + k] = np.asarray(tree[k])


def main():
    out_dir, steps, seq, lr = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        float(sys.argv[4])
    for name, (fields, shape, axes, rows) in CASES.items():
        cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b-reduced"), dtype=jnp.float32,
                                  remat=False, name="kimi-k2-1t-a32b", **dict(fields))
        mesh = make_mesh(shape, axes)
        g = gossip_size(mesh, gossip_axes_for(cfg.name, mesh))
        # the drop count's host callback at G = 1 (jax's debug callback does
        # not lower inside the G > 1 step's partially manual shard_map)
        jmoe._top_k_router = _count_drops if g == 1 else _router
        opt = sgd(momentum=0.9)
        tr = SPMDTrainer(cfg, mesh, make_topology("d_ring", g), opt, collect_norms=True,
                         donate=False)
        params = _nest(dict(np.load(os.path.join(out_dir, name + ".params.npz"))))
        o = opt.init(params)
        if g > 1:
            stack = lambda t: jax.tree.map(  # noqa: E731
                lambda x: jnp.broadcast_to(x[None], (g,) + x.shape), t)
            params, o = stack(params), stack(o)
        state = TrainState(jax.device_put(params, tr.param_shardings),
                           jax.device_put(o, tr.opt_shardings), 0)
        src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0)
        losses, norms, drops = [], [], []
        for t in range(steps):
            b = src.stacked(g, t, rows)
            b = {k: jnp.asarray(v[0] if g == 1 else v) for k, v in b.items()}
            DROPS.clear()
            state, loss, nrm = tr.train_step(state, b, lr)
            jax.block_until_ready(loss)
            jax.effects_barrier()
            losses.append(np.asarray(loss))
            norms.append(np.asarray(nrm))
            drops.append(list(DROPS))
            if name == "single" and t + 1 == steps // 2:
                jckpt.save_checkpoint(os.path.join(out_dir, "ref_ckpt"), t + 1,
                                      {"p": state.params, "o": state.opt_state},
                                      extra=tr.snapshot_extra())
        res = {"losses": np.stack(losses), "norms": np.stack(norms)}
        if g == 1:
            res["drops"] = np.array(drops)
        _walk(jax.device_get(state.params), "", res, "p")
        _walk(jax.device_get(state.opt_state), "", res, "m")
        res["specs"] = np.array([f"{jax.tree_util.keystr(k)}={v.spec}" for k, v in
                                 jax.tree_util.tree_leaves_with_path(tr.param_shardings)])
        np.savez(os.path.join(out_dir, name + ".ref.npz"), **res)
    print("REF_OK")


if __name__ == "__main__":
    main()
