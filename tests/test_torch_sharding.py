"""Port parity: meshes, logical specs and shardings against the reference's
``repro/launch/mesh.py``, ``repro/launch/sharding.py`` and
``repro/models``' ``ParamDef`` specs.

* ``spec_tree(model_defs(cfg, tp))`` equals the reference's for all ten
  archs, full and reduced, at tp 1, 2 and 16 (leaf names, shapes, specs);
* ``head_padding``, ``active_head_mask`` and ``attn_dims`` equal the
  reference's over ``tests/test_perf_features.py``'s grid (group 1–8, kv
  1–32, tp 2–16, pad_kv both ways);
* every leaf's validated spec equals the reference's
  ``leaf_sharding(...).spec`` on the production meshes (16, 16) and (2, 16,
  16), built as ``jax.sharding.AbstractMesh``es, and ``batch_sharding``
  too;
* ``gossip_axes_for``/``gossip_size`` equal the reference's;
* ``shard_leaf``/``unshard`` round trips, and the G = 1 placements
  (``fsdp``, ``moe_shard_ff``) raise naming their ROADMAP item.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_NAMES, get_config as jget_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.common import ParamDef as JParamDef  # noqa: E402
from repro.models.common import spec_tree as jspec_tree  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import flatten_tree, spec_tree  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jdefs_flat(jcfg, tp):
    defs = jtfm.model_defs(jcfg, tp)
    paths = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=lambda x: isinstance(x, JParamDef))[0]
    return {".".join(str(getattr(k, "key", k)) for k in path): d for path, d in paths}


@pytest.mark.parametrize("tp", [1, 2, 16])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_tree_matches_the_reference(arch, reduced, tp):
    name = arch + ("-reduced" if reduced else "")
    jdefs = _jdefs_flat(jget_config(name), tp)
    tdefs = ttfm.model_defs(tget_config(name), tp)
    assert list(tdefs) == list(jdefs)
    assert {k: d.shape for k, d in tdefs.items()} == {k: d.shape for k, d in jdefs.items()}
    tspecs = spec_tree(tdefs)
    jspecs = flatten_tree(jax.tree.map(lambda s: s, jspec_tree(jtfm.model_defs(
        jget_config(name), tp)), is_leaf=lambda x: isinstance(x, tuple)))
    assert tspecs == jspecs


def test_head_padding_and_masks_match_the_reference_over_the_grid():
    for group, kv, tp, pad_kv in itertools.product(range(1, 9), range(1, 33),
                                                    (2, 4, 8, 16), (False, True)):
        h = group * kv
        got = tattn.head_padding(h, kv, tp, pad_kv=pad_kv)
        assert got == jattn.head_padding(h, kv, tp, pad_kv=pad_kv), (h, kv, tp, pad_kv)
        mask = tattn.active_head_mask(h, kv, *got).numpy()
        np.testing.assert_array_equal(mask, np.asarray(jattn.active_head_mask(h, kv, *got)))
        cfg = dataclasses.replace(tget_config("granite-8b-reduced"), n_heads=h, n_kv=kv,
                                  pad_heads=True, pad_kv=pad_kv)
        jcfg = dataclasses.replace(jget_config("granite-8b-reduced"), n_heads=h, n_kv=kv,
                                   pad_heads=True, pad_kv=pad_kv)
        assert ttfm.attn_dims(cfg, tp) == jtfm.attn_dims(jcfg, tp)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "starcoder2-7b", "musicgen-medium"])
def test_padded_configs_pad_at_their_tensor_parallel_size(arch):
    for tp in (1, 2, 4, 16):
        assert ttfm.attn_dims(tget_config(arch), tp) == jtfm.attn_dims(jget_config(arch), tp)
    cfg = tget_config(arch)
    assert ttfm.attn_dims(cfg, 1) == (cfg.n_heads, cfg.n_kv)


def _abstract(defs):
    return {k: torch.empty(d.shape, dtype=d.dtype, device="meta") for k, d in defs.items()}


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_leaf_shardings_match_the_reference(arch, mesh_kind):
    shape, axes = MESHES[mesh_kind]
    jm = AbstractMesh(shape, axes)
    tm = tmesh.make_mesh(shape, axes)
    gx = tmesh.gossip_axes_for(arch, tm)
    assert gx == jmesh.gossip_axes_for(arch, jm)
    g = tmesh.gossip_size(tm, gx)
    assert g == jmesh.gossip_size(jm, gx)
    tp = tm.shape["model"]
    tdefs = ttfm.model_defs(tget_config(arch), tp)
    jdefs = _jdefs_flat(jget_config(arch), tp)
    stacked = g > 1
    abstract = _abstract(tdefs)
    if stacked:
        abstract = tsharding.stack_abstract(abstract, g)
    got = tsharding.param_shardings(abstract, spec_tree(tdefs), tm, gx, stacked=stacked)
    for name, jd in jdefs.items():
        jshape = ((g,) if stacked else ()) + tuple(jd.shape)
        want = jsharding.leaf_sharding(jshape, jd.spec, jm, gx, stacked=stacked).spec
        assert got[name].spec == tuple(want), name
        assert tuple(abstract[name].shape) == jshape
    for ndim in (2, 3):
        assert tsharding.batch_sharding(tm, gx, ndim, stacked=stacked).spec == tuple(
            jsharding.batch_sharding(jm, gx, ndim, stacked=stacked).spec)
    nbytes = tsharding.tree_size_bytes(abstract)
    assert nbytes == sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype).element_size()
                         for s in abstract.values())


def test_gossip_axes_and_sizes_match_the_reference():
    for shape, axes in [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
                        ((4, 2), ("data", "model")), ((2, 2, 1), ("pod", "data", "model"))]:
        tm, jm = tmesh.make_mesh(shape, axes), AbstractMesh(shape, axes)
        for arch in ("granite-8b", "kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b"):
            gx = tmesh.gossip_axes_for(arch, tm)
            assert gx == jmesh.gossip_axes_for(arch, jm)
            assert tmesh.gossip_size(tm, gx) == jmesh.gossip_size(jm, gx)
            assert tmesh.gossip_axes_for(arch, dict(zip(axes, shape))) == gx
    prod = tmesh.make_production_mesh()
    assert (prod.axis_names, prod.shape) == (("data", "model"), {"data": 16, "model": 16})
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512


def test_mesh_ranks_and_coordinates_round_trip():
    m = tmesh.make_mesh((2, 4, 2), ("pod", "data", "model"))
    for r in range(m.size):
        c = m.coords(r)
        assert m.rank_of(c) == r
    assert m.coords(5) == {"pod": 0, "data": 2, "model": 1}
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 2), ("data",))


@pytest.mark.parametrize("spec", [(None, "model", None), ("model", None, None),
                                  (None, None, None), (("data", "model"), None, None)])
def test_shard_leaf_and_unshard_round_trip(spec):
    m = tmesh.make_mesh((2, 4), ("data", "model"))
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    s = tsharding.leaf_sharding(tuple(x.shape), spec, m, (), stacked=False)
    shards = [tsharding.shard_leaf(x, s, m.coords(r)).clone() for r in range(m.size)]
    assert tuple(shards[0].shape) == s.shard_shape(x.shape)
    assert torch.equal(tsharding.unshard(shards, s), x)
    if spec[1] == "model":
        assert s.dim_of("model") == 1
        assert torch.equal(shards[3], x[:, 9:12])


def test_an_undivisible_dim_falls_back_to_replication():
    m = tmesh.make_mesh((2, 4), ("data", "model"))
    s = tsharding.leaf_sharding((6, 5), (None, "model"), m, ("data",), stacked=False)
    assert s.spec == (None, None) and s.dim_of("model") is None


def test_the_g1_placements_raise_naming_their_item():
    m = tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="item 8d"):
        tsharding.leaf_sharding((4, 4), (None, None), m, (), stacked=False, fsdp=True)
    with pytest.raises(ValueError, match="item 8d"):
        tmoe.moe_defs(64, 128, 4, shard_ff=True)
    with pytest.raises(ValueError, match="item 8d"):
        ttfm.model_defs(dataclasses.replace(tget_config("kimi-k2-1t-a32b-reduced"),
                                            moe_shard_ff=True))
