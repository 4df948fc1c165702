"""Port parity: checkpoints (``repro_torch/checkpoint``) against the
reference's ``repro/checkpoint``.

* the port's own contract, as ``tests/test_data_checkpoint.py`` and
  ``tests/test_elastic.py`` hold the reference's: round trip, ``keep``
  pruning, shape mismatch, the reserved key, ``latest_step``, the
  ``extra`` payload; an in-place restore into views of flat buffers;
* ``validate_run_config`` against the reference's on the same recorded
  configurations: the same verdict and the same message;
* the files, both ways, from numpy-built leaves (float32, AdamW's int32
  count, bfloat16): a file the reference writes loads in the port bit for
  bit and one the port writes loads in the reference; the member names
  and every member's bytes (header and payload) are equal;
* the engines' checkpoint trees name and shape their leaves as the
  reference's trainer state does, for every optimizer;
* ``Comm.gather_host``/``scatter_host`` over 4 gloo ranks, in several
  chunks, float32 and bfloat16.
"""
import dataclasses
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import _torch_rank_worker  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim.sgd import get_optimizer as jget_optimizer  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.launch.comm import spawn_world  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.optim.sgd import get_optimizer as tget_optimizer  # noqa: E402

torch.set_num_threads(1)


def _leaves(seed=0):
    """Numpy-built leaves of each dtype a trainer checkpoint holds."""
    rng = np.random.default_rng(seed)
    return {
        "w32": rng.normal(size=(4, 3, 5)).astype(np.float32),
        "bf": rng.normal(size=(4, 6)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "t": np.full((4,), 7, np.int32),
        "s": np.float32(rng.normal()),
    }


def _jax_tree(leaves):
    return {"p": {"blocks": {"w": jnp.asarray(leaves["w32"])}, "emb": jnp.asarray(leaves["bf"])},
            "o": {"mu": {"blocks": {"w": jnp.asarray(leaves["w32"] * 2)}}, "t": jnp.asarray(leaves["t"])},
            "x": [jnp.asarray(leaves["s"])]}


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _torch_tree(leaves):
    return {"p": {"blocks": {"w": _torch(leaves["w32"])}, "emb": _torch(leaves["bf"])},
            "o": {"mu": {"blocks": {"w": _torch(leaves["w32"] * 2)}}, "t": _torch(leaves["t"])},
            "x": [_torch(leaves["s"])]}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(_bits(x), _bits(y)), k


# ---------------------------------------------------------------------------
# The port's own contract
# ---------------------------------------------------------------------------

def test_roundtrip_restores_every_leaf_bit_for_bit(tmp_path):
    tree = _torch_tree(_leaves())
    d = str(tmp_path / "ckpt")
    path = tckpt.save_checkpoint(d, 42, tree)
    assert os.path.basename(path) == "step_0000000042.npz"
    assert tckpt.latest_step(d) == 42
    zeros = {"p": {"blocks": {"w": torch.zeros(4, 3, 5)}, "emb": torch.zeros(4, 6, dtype=torch.bfloat16)},
             "o": {"mu": {"blocks": {"w": torch.zeros(4, 3, 5)}}, "t": torch.zeros(4, dtype=torch.int32)},
             "x": [torch.zeros(())]}
    restored, step = tckpt.load_checkpoint(d, zeros)
    assert step == 42
    _assert_trees_equal(restored, tree)
    assert isinstance(restored["x"], list)


def test_restore_in_place_into_views_of_flat_buffers(tmp_path):
    """The engines restore into (G, ...) column views of their (G, P)
    buffers: strided leaves, written in place."""
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(rng.normal(size=(4, 20)).astype(np.float32)).bfloat16()
    tree = {"a": buf[:, :12].view(4, 3, 4), "b": buf[:, 12:]}
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 3, tree)
    target = torch.zeros_like(buf)
    step = tckpt.restore_checkpoint(d, {"a": target[:, :12].view(4, 3, 4), "b": target[:, 12:]})
    assert step == 3 and torch.equal(target.view(torch.int16), buf.view(torch.int16))


def test_as_dtype_leaves_stream_cast_chunk_by_chunk(tmp_path, monkeypatch):
    """An ``AsDtype`` leaf (float32 column views of a flat buffer, written
    as bfloat16) streams in chunks of a few elements: the member is the
    reference's bfloat16 file of the rounded values, and it restores into
    float32 views exactly; chunks end inside rows and inside elements'
    pieces."""
    from repro_torch.checkpoint.ckpt import AsDtype

    monkeypatch.setattr("repro_torch.checkpoint.ckpt._CHUNK", 12)
    rng = np.random.default_rng(2)
    buf = torch.from_numpy(rng.normal(size=(4, 23)).astype(np.float32))
    narrow = buf[:, 5:18].view(4, 13)
    tree = {"w": buf[:, :5], "n": AsDtype(narrow, torch.bfloat16)}
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 2, tree)
    back, _ = jckpt.load_checkpoint(d, {"w": jnp.zeros((4, 5), jnp.float32),
                                        "n": jnp.zeros((4, 13), jnp.bfloat16)})
    got = np.asarray(back["n"])
    got = got.view(ml_dtypes.bfloat16) if got.dtype.kind == "V" else got
    assert np.array_equal(got.astype(np.float32), narrow.bfloat16().float().numpy())
    assert np.array_equal(np.asarray(back["w"]), buf[:, :5].numpy())
    target = torch.full_like(buf, 7.0)
    tckpt.restore_checkpoint(d, {"w": target[:, :5],
                                 "n": AsDtype(target[:, 5:18].view(4, 13), torch.bfloat16)})
    assert torch.equal(target[:, 5:18], narrow.bfloat16().float())
    assert torch.equal(target[:, :5], buf[:, :5]) and bool((target[:, 18:] == 7.0).all())


def test_leaves_restore_by_the_template_dtype(tmp_path):
    """A leaf whose file dtype differs from the template's is converted to
    the template's; a 2-byte void (bfloat16) leaf restores only as
    bfloat16."""
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 1, {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                                 "b": torch.ones(2, dtype=torch.bfloat16)})
    back, _ = tckpt.load_checkpoint(d, {"a": torch.zeros(2, 3, dtype=torch.float64),
                                        "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert back["a"].dtype == torch.float64
    assert torch.equal(back["a"], torch.arange(6, dtype=torch.float64).reshape(2, 3))
    with pytest.raises(ValueError, match="cannot restore"):
        tckpt.load_checkpoint(d, {"a": torch.zeros(2, 3, dtype=torch.int32),
                                  "b": torch.zeros(2, dtype=torch.float16)})


def test_keep_prunes_old_checkpoints(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in range(5):
        tckpt.save_checkpoint(d, s, {"x": torch.ones(1) * s}, keep=2)
    files = sorted(f for f in os.listdir(d) if f.startswith("step_"))
    assert files == ["step_0000000003.npz", "step_0000000004.npz"]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    restored, step = tckpt.load_checkpoint(d, {"x": torch.zeros(1)})
    assert step == 4 and float(restored["x"][0]) == 4.0
    back, _ = tckpt.load_checkpoint(d, {"x": torch.zeros(1)}, step=3)
    assert float(back["x"][0]) == 3.0


def test_shape_mismatch_raises_before_any_leaf_is_written(tmp_path):
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, 0, {"a": torch.ones(2), "x": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(d, {"a": torch.zeros(2), "x": torch.zeros((3,))})
    a = torch.zeros(2)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(d, {"a": a, "x": torch.zeros((3,))})
    assert torch.equal(a, torch.zeros(2))   # checked first, nothing written
    with pytest.raises(KeyError, match="y"):
        tckpt.load_checkpoint(d, {"y": torch.zeros(2)})


def test_reserved_key_clash_raises(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        tckpt.save_checkpoint(str(tmp_path), 0, {"__extra__": torch.ones(1)})


def test_latest_step_and_missing_manifest(tmp_path):
    assert tckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path), {"x": torch.zeros(1)})
    tckpt.save_checkpoint(str(tmp_path), 7, {"x": torch.ones(1)})
    tckpt.save_checkpoint(str(tmp_path), 9, {"x": torch.ones(1)})
    assert tckpt.latest_step(str(tmp_path)) == 9


def test_extra_payload_roundtrip(tmp_path):
    tree = {"p": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    extra = {"controller": {"rung": 2}, "last_membership": [True, False]}
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 3, tree, extra=extra)
    assert tckpt.load_checkpoint_extra(d) == extra
    back, step = tckpt.load_checkpoint(d, tree)
    assert step == 3 and torch.equal(back["p"], tree["p"])
    # checkpoints without an extra payload read back as None
    tckpt.save_checkpoint(d, 4, tree)
    assert tckpt.load_checkpoint_extra(d, 4) is None


def test_leaves_may_be_host_callables(tmp_path):
    """A leaf given as a callable is called when it is written (the ranks
    engine's gathered leaves)."""
    calls = []

    def leaf():
        calls.append(1)
        return torch.full((2, 2), 3.0)

    tckpt.save_checkpoint(str(tmp_path), 1, {"a": leaf, "b": torch.ones(1)})
    assert calls == [1]
    back, _ = tckpt.load_checkpoint(str(tmp_path), {"a": torch.zeros(2, 2), "b": torch.zeros(1)})
    assert torch.equal(back["a"], torch.full((2, 2), 3.0))


# ---------------------------------------------------------------------------
# validate_run_config against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recorded,kw", [
    ({}, dict(topology="d_ring", bucket_mb=None)),
    ({"topology": "d_ring"}, dict(topology="d_ring", bucket_mb=None)),
    ({"topology": "d_ada"}, dict(topology="d_ring", bucket_mb=None)),
    ({"topology": "d_ring", "bucket_mb": 2.0}, dict(topology="d_ring", bucket_mb=2.0)),
    ({"topology": "d_ring", "bucket_mb": 2.0}, dict(topology="d_ring", bucket_mb=4.0)),
    ({"topology": "d_ring", "bucket_mb": 2.0}, dict(topology="d_ring", bucket_mb=None)),
    ({"topology": "d_ring", "bucket_mb": None}, dict(topology="d_ring", bucket_mb=1)),
    ({"topology": "d_ring", "n": 8}, dict(topology="d_ring", bucket_mb=None, n=8)),
    ({"topology": "d_ring", "n": 8}, dict(topology="d_ring", bucket_mb=None, n=4,
                                          n_label="mesh gossip size")),
    ({"topology": "d_ring", "n": 8}, dict(topology="d_ring", bucket_mb=None)),
    ({"n": 8}, dict(topology="d_torus", bucket_mb=None, n=4)),
])
def test_validate_run_config_matches_the_reference(recorded, kw):
    def verdict(fn):
        try:
            fn(dict(recorded), **kw)
        except ValueError as e:
            return str(e)
        return None

    want = verdict(jckpt.validate_run_config)
    assert verdict(tckpt.validate_run_config) == want


# ---------------------------------------------------------------------------
# The files, both ways
# ---------------------------------------------------------------------------

def _members(path):
    with zipfile.ZipFile(path) as zf:
        return zf.namelist(), {n: zf.read(n) for n in zf.namelist()}


def test_files_are_the_reference_files_member_for_member(tmp_path):
    leaves = _leaves(3)
    extra = {"run_config": {"topology": "d_ring", "n": 4, "bucket_mb": None}, "k": [1, 2.5]}
    jckpt.save_checkpoint(str(tmp_path / "ref"), 5, _jax_tree(leaves), extra=extra)
    tckpt.save_checkpoint(str(tmp_path / "port"), 5, _torch_tree(leaves), extra=extra)
    names_r, bytes_r = _members(tmp_path / "ref" / "step_0000000005.npz")
    names_p, bytes_p = _members(tmp_path / "port" / "step_0000000005.npz")
    assert names_p == names_r
    assert "o/mu/blocks/w.npy" in names_r and "o/t.npy" in names_r and "x/#0.npy" in names_r
    for n in names_r:
        assert bytes_p[n] == bytes_r[n], n   # header (descr <V2 for bf16) and payload


def test_a_reference_file_loads_in_the_port_bit_for_bit(tmp_path):
    leaves = _leaves(4)
    jckpt.save_checkpoint(str(tmp_path), 2, _jax_tree(leaves), extra={"a": 1})
    template = jax.tree.map(lambda t: torch.zeros_like(t), _torch_tree(leaves))
    restored, step = tckpt.load_checkpoint(str(tmp_path), template)
    assert step == 2
    _assert_trees_equal(restored, _torch_tree(leaves))
    assert tckpt.load_checkpoint_extra(str(tmp_path)) == {"a": 1}


def test_a_port_file_loads_in_the_reference_bit_for_bit(tmp_path):
    leaves = _leaves(5)
    tckpt.save_checkpoint(str(tmp_path), 2, _torch_tree(leaves), extra={"a": [1, 2]})
    template = _jax_tree(leaves)
    restored, step = jckpt.load_checkpoint(str(tmp_path), template)
    assert step == 2
    assert jckpt.load_checkpoint_extra(str(tmp_path)) == {"a": [1, 2]}
    for (kp, got), want in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                               jax.tree.leaves(template)):
        want = np.asarray(want)
        got = np.asarray(got)
        if want.dtype == ml_dtypes.bfloat16:
            # the reference hands a bfloat16 leaf back as 2-byte void records
            assert got.dtype.kind == "V" and got.dtype.itemsize == 2
            got = got.view(ml_dtypes.bfloat16)
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes(), kp


# ---------------------------------------------------------------------------
# The engines' trees name their leaves as the reference's trainer state does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt,kw", [("sgd", {}), ("sgd", {"momentum": 0.0}), ("adamw", {}),
                                    ("lars", {})])
def test_checkpoint_tree_keys_match_the_reference_state(tmp_path, opt, kw):
    g = 4
    jcfg = dataclasses.replace(jget_config("granite-8b-reduced"), remat=False)
    params = jtfm.init_model(jcfg, jax.random.PRNGKey(0), tp_size=1)
    jopt = jget_optimizer(opt, **kw)
    stack = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x[None], (g,) + x.shape), t)
    jtree = {"p": stack(params), "o": stack(jopt.init(params))}
    trainer = SPMDTrainer(tget_config("granite-8b-reduced"), make_topology("d_ring", g),
                          tget_optimizer(opt, **kw), device="cpu")
    state = trainer.init_state(seed=0)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 0, jtree)
    trainer.save_checkpoint(str(tmp_path / "port"), state)
    with zipfile.ZipFile(tmp_path / "ref" / "step_0000000000.npz") as zr, \
            zipfile.ZipFile(tmp_path / "port" / "step_0000000000.npz") as zp:
        assert zp.namelist()[:-1] == zr.namelist()   # the port adds __extra__
        assert zp.namelist()[-1] == "__extra__.npy"
        for n in zr.namelist():
            hr = zr.read(n)[:128].split(b"}")[0]
            hp = zp.read(n)[:128].split(b"}")[0]
            assert hp == hr, n   # dtype and shape
    # the reference's state loads into the port's buffers
    restored = jckpt.load_checkpoint(str(tmp_path / "port"), jtree)[0]
    assert jax.tree.structure(restored) == jax.tree.structure(jtree)


# ---------------------------------------------------------------------------
# Gather to and scatter from one rank's host memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_host_and_scatter_host_over_gloo_ranks(tmp_path, dtype):
    res = spawn_world(_torch_rank_worker.host_gather_checks, 4, (1001, dtype, 1024),
                      timeout=120, device="cpu", workdir=tmp_path)
    assert res == [{"transport": "gloo", "gather": True, "scatter": True}] * 4


@pytest.mark.gpu
def test_gather_host_and_scatter_host_on_the_card(tmp_path):
    """The same through pinned host chunks (gloo-host) or NCCL: 80M
    bfloat16 per rank in 256 MiB chunks, with a ragged last one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = spawn_world(_torch_rank_worker.host_gather_checks, 4,
                      (80_000_001, "bfloat16", None), timeout=300, workdir=tmp_path)
    transport = "nccl" if torch.cuda.device_count() >= 4 else "gloo-host"
    assert res == [{"transport": transport, "gather": True, "scatter": True}] * 4
