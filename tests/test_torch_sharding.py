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
  16), built as ``jax.sharding.AbstractMesh``es, with ``fsdp=not stacked``
  as the reference's trainer builds them (kimi-k2's G = 1 placement: FSDP
  over the data axes), all ten archs full and reduced, and kimi-k2 with
  ``moe_shard_ff`` too; ``batch_sharding`` as well;
* ``moe_defs(shard_ff=True)``'s specs are the reference's, and a
  ``moe_shard_ff`` model whose "data" axis is also a gossip axis raises
  where the reference's ``NamedSharding`` does (the stacked spec repeats
  the axis);
* ``gossip_axes_for``/``gossip_size`` equal the reference's;
* ``shard_leaf``/``unshard`` round trips.
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


def _norm_spec(spec) -> tuple:
    """A spec's entries as ``PartitionSpec`` normalizes them: a one-axis
    tuple as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


LEAF_CASES = [(a, r, False) for a in ARCH_NAMES for r in (False, True)] + \
    [("kimi-k2-1t-a32b", r, True) for r in (False, True)]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,reduced,shard_ff", LEAF_CASES)
def test_leaf_shardings_match_the_reference(arch, reduced, shard_ff, mesh_kind):
    shape, axes = MESHES[mesh_kind]
    jm = AbstractMesh(shape, axes)
    tm = tmesh.make_mesh(shape, axes)
    gx = tmesh.gossip_axes_for(arch, tm)
    assert gx == jmesh.gossip_axes_for(arch, jm)
    g = tmesh.gossip_size(tm, gx)
    assert g == jmesh.gossip_size(jm, gx)
    tp = tm.shape["model"]
    name_ = arch + ("-reduced" if reduced else "")
    tcfg = dataclasses.replace(tget_config(name_), moe_shard_ff=shard_ff)
    jcfg = dataclasses.replace(jget_config(name_), moe_shard_ff=shard_ff)
    tdefs = ttfm.model_defs(tcfg, tp)
    jdefs = _jdefs_flat(jcfg, tp)
    stacked = g > 1
    abstract = _abstract(tdefs)
    if stacked:
        abstract = tsharding.stack_abstract(abstract, g)
    got = tsharding.param_shardings(abstract, spec_tree(tdefs), tm, gx, stacked=stacked,
                                    fsdp=not stacked)
    fsdp_used = False
    for name, jd in jdefs.items():
        jshape = ((g,) if stacked else ()) + tuple(jd.shape)
        want = jsharding.leaf_sharding(jshape, jd.spec, jm, gx, stacked=stacked,
                                       fsdp=not stacked).spec
        assert _norm_spec(got[name].spec) == _norm_spec(tuple(want)), name
        assert tuple(abstract[name].shape) == jshape
        fsdp_used |= not stacked and "data" in _norm_spec(got[name].spec)
    # kimi-k2 on one pod is the G = 1 placement: FSDP over "data"
    assert fsdp_used == (not stacked)
    assert (not stacked) == (arch.startswith("kimi") and mesh_kind == "single")
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


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("shard_ff", [False, True])
def test_moe_defs_specs_match_the_reference(shard_ff, n_shared):
    from repro.models import moe as jmoe

    got = flatten_tree(tmoe.moe_defs(64, 128, 4, n_shared=n_shared, shard_ff=shard_ff))
    want = jax.tree_util.tree_flatten_with_path(
        jmoe.moe_defs(64, 128, 4, n_shared=n_shared, shard_ff=shard_ff),
        is_leaf=lambda x: isinstance(x, JParamDef))[0]
    want = {".".join(str(getattr(k, "key", k)) for k in path): d for path, d in want}
    assert list(got) == list(want)
    for k, d in want.items():
        assert (got[k].shape, got[k].spec) == (tuple(d.shape), tuple(d.spec)), k
    if shard_ff:
        assert got["w_up"].spec == ("model", None, "data")
        assert got["w_down"].spec == ("model", "data", None)


@pytest.mark.parametrize("shape,axes,leaf,logical", [
    ((2, 2), ("data", "model"), (8, 64, 32), (None, None, None)),      # the largest dim
    ((2, 2), ("data", "model"), (6, 6), (None, None)),                 # a tie: the first
    ((4, 2), ("data", "model"), (6, 3), (None, None)),                 # nothing divides
    ((2, 4), ("data", "model"), (8, 3, 12), (None, None, "model")),    # "model" kept
    ((2, 3, 1), ("pod", "data", "model"), (3, 4), (None, None)),       # the last axis alone
])
def test_fsdp_rule_matches_the_reference(shape, axes, leaf, logical):
    """FSDP's choice of dim against the reference's ``leaf_sharding`` on
    small meshes, and a leaf that already names a data axis keeping its
    spec."""
    jm, tm = AbstractMesh(shape, axes), tmesh.make_mesh(shape, axes)
    for spec in (logical, ("data",) + logical[1:]):
        got = tsharding.leaf_sharding(leaf, spec, tm, (), stacked=False, fsdp=True).spec
        want = jsharding.leaf_sharding(leaf, spec, jm, (), stacked=False, fsdp=True).spec
        assert _norm_spec(got) == _norm_spec(tuple(want)), spec


def test_shard_ff_on_a_gossip_data_axis_raises_as_the_reference_does():
    """phi3.5-moe with ``moe_shard_ff`` on one pod: "data" is a gossip axis,
    so the stacked spec of an expert leaf names it twice.  The reference's
    ``NamedSharding`` raises (``DuplicateSpecError``); so does the port."""
    from jax.sharding import PartitionSpec as P

    shape, axes = MESHES["single"]
    name = "phi3.5-moe-42b-a6.6b"
    tm, jm = tmesh.make_mesh(shape, axes), AbstractMesh(shape, axes)
    gx = tmesh.gossip_axes_for(name, tm)
    d = ttfm.model_defs(dataclasses.replace(tget_config(name), moe_shard_ff=True), 16)
    leaf = d["blocks.ffn.w_up"]
    with pytest.raises(ValueError, match="more than one dim"):
        tsharding.leaf_sharding((16,) + leaf.shape, leaf.spec, tm, gx, stacked=True)
    with pytest.raises(Exception, match="duplicate"):
        jax.sharding.NamedSharding(jm, P(gx, *leaf.spec))


def test_node_shards_split_a_g1_node_over_data_and_model():
    """kimi-k2-reduced on (2 data × 2 model) at G = 1: every rank's shard of
    every leaf, put back together, is the leaf; the node's mesh is the
    whole mesh and its specs are the FSDP ones."""
    cfg = tget_config("kimi-k2-1t-a32b-reduced")
    m = tmesh.make_mesh((2, 2), ("data", "model"))
    defs = ttfm.model_defs(cfg, 2)
    node, shardings, local = tsharding.node_shards(defs, m, ())
    assert node.shape == {"data": 2, "model": 2}
    assert shardings["blocks.ffn.w_down"].spec == (None, "model", "data", None)
    gen = torch.Generator().manual_seed(0)
    for k, d in defs.items():
        x = torch.randn(d.shape, generator=gen)
        parts = [tsharding.shard_leaf(x, shardings[k], node.coords(r)) for r in range(4)]
        assert tuple(parts[0].shape) == local[k].shape
        assert torch.equal(tsharding.unshard(parts, shardings[k]), x), k
