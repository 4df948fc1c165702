"""Port parity: the dry run on the ``meta`` device (``launch/dryrun.py``,
``SPMDTrainer.lower_step``, ``ServeEngine.lower_prefill``/``lower_decode``,
``models/common.abstract_params``, ``configs.input_specs``), the ``meta``
branches of the K1–K4 wrappers and the config repair.

* the five archs and mini shapes of ``tests/spmd_dryrun_script.py``
  (train 64 × 8, prefill and decode 256; reduced widths; the (2, 2) gossip
  grid) build train, prefill and decode with every op output on ``meta``;
  ``is_suspect`` flags none; a G > 1 record holds gossip collectives;
* ``argument_bytes`` is ``FlatLayout.row_bytes`` × rows plus the
  optimizer slots, for the stacked engine and for one rank;
* the CLI's JSON is read by the port's and the reference's
  ``roofline.analyze``;
* ``lower_step`` of fused stacked and ranks trainers bills K1 and K2 (and
  K3), under a fault model too, and leaves the live trainer's run alone;
* ``is_attention_free`` and ``input_specs`` equal the reference's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import input_specs as jinput_specs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import validate_dryrun as jvalid  # noqa: E402
from repro_torch.configs import SHAPES, InputShape, input_specs  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.core.faults import make_fault_model  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.gossip_update import (  # noqa: E402
    gossip_program_update, gossip_update,
)
from repro_torch.kernels.stats import segment_l2_norms  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch.comm import RecordingComm  # noqa: E402
from repro_torch.launch.hlo_analysis import analyze_step  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.launch.validate_dryrun import is_suspect  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import abstract_params, flatten_tree  # noqa: E402
from repro_torch.optim.sgd import adamw, sgd  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

MINI_ARCHS = ["granite-8b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "zamba2-7b",
              "kimi-k2-1t-a32b"]
MINI_SHAPES = [InputShape("mini_train", 64, 8, "train"),
               InputShape("mini_prefill", 256, 4, "prefill"),
               InputShape("mini_decode", 256, 8, "decode")]


class _OffMeta(TorchDispatchMode):
    """Every op output that is not on ``meta``, by op."""

    def __init__(self):
        super().__init__()
        self.found = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.found[str(func)] = (str(t.device), tuple(t.shape))
        return out


@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_mini_dry_run_builds_every_step_on_meta(arch):
    for shape in MINI_SHAPES:
        with _OffMeta() as off:
            rec = dryrun.run_one(arch + "-reduced", shape, "mini")
        assert off.found == {}, (shape.name, off.found)
        assert is_suspect(rec) is None, (shape.name, is_suspect(rec))
        h = rec["hlo"]
        assert h["dot_flops"] > 0 and h["traffic_bytes"] > 0
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
        assert rec["input_shape"]["seq_len"] == shape.seq_len
        if shape.kind == "train":
            assert rec["gossip_nodes"] == (2 if arch.startswith("kimi") else 4)
            assert {"collective-permute", "all-reduce"} & set(rec["collectives"]), rec
            assert rec["collectives"]["total_wire_bytes"] == h["total_wire_bytes"] > 0
            assert rec["memory"]["alias_bytes"] == rec["memory"]["argument_bytes"]
        else:
            assert h["total_wire_bytes"] == 0
        json.dumps(rec)   # the artifact's record


@pytest.mark.parametrize("engine", ["stacked", "ranks"])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_argument_bytes_are_the_state_rows_and_slots(engine, opt):
    cfg = tget("granite-8b-reduced")
    optimizer = sgd(0.9) if opt == "sgd" else adamw(1e-3)
    kw = {"comm": RecordingComm(0, 4)} if engine == "ranks" else {}
    trainer = SPMDTrainer(cfg, make_topology("d_ring", 4), optimizer, device="meta", **kw)
    rec = trainer.lower_step(MINI_SHAPES[0])
    layout = FlatLayout.of_defs(ttfm.model_defs(cfg))
    rows = 4 if engine == "stacked" else 1
    slots = rows * layout.size * 4 * (1 if opt == "sgd" else 2)
    counter = rows * 4 if opt == "adamw" else 0     # AdamW's (rows,) int32 step count
    assert rec["memory"]["argument_bytes"] == layout.row_bytes * rows + slots + counter


def test_dryrun_cli_json_is_read_by_both_rooflines(tmp_path, monkeypatch):
    out = str(tmp_path / "dry.json")
    for arch, shapes in (("granite-8b", "train_4k,decode_32k"),
                         ("rwkv6-1.6b,zamba2-7b", "decode_32k,long_500k")):
        with pytest.raises(SystemExit) as done:
            dryrun.main(["--arch", arch, "--shape", shapes, "--mesh", "single",
                         "--out", out, "--skip-existing"])
        assert done.value.code == 0
    records = json.loads(open(out).read())
    assert len(records) == 6 and all("error" not in r for r in records)
    train = next(r for r in records if r["kind"] == "train")
    # rank (0, 0) of the production (16 data x 16 model) mesh: per-card bytes
    assert train["gossip_nodes"] == 16 and train["mesh_shape"] == {"data": 16, "model": 16}
    for rows in (troof.analyze(out), jroof.analyze(out)):
        assert all(r["roofline"]["compute_s"] > 0 for r in rows)
    # the same dominant term once the reference's roofline takes the port's
    # constants (the training record's model-axis collectives weigh by the
    # link's rate)
    monkeypatch.setattr(jroof, "PEAK_FLOPS", troof.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", troof.NVLINK_BW)
    assert [troof.roofline_terms(r)["dominant"] for r in records] == \
        [jroof.roofline_terms(r)["dominant"] for r in records]
    for r in records:
        assert is_suspect(r) is None and jvalid.is_suspect(r) is None, r["arch"]


def test_kimi_gossips_across_pods_only():
    assert dryrun.gossip_axes_for("kimi-k2-1t-a32b", dryrun.MESHES["single"]) == ()
    assert dryrun.gossip_axes_for("kimi-k2-1t-a32b", dryrun.MESHES["multi"]) == ("pod",)
    assert dryrun.gossip_axes_for("granite-8b", dryrun.MESHES["multi"]) == ("pod", "data")
    cfg = dryrun._apply_overrides(tget("granite-8b"), "remat=False,capacity_factor=2.0,"
                                                      "n_layers=3")
    assert (cfg.remat, cfg.capacity_factor, cfg.n_layers) == (False, 2.0, 3)


def _trainer(fused, engine, fault=None, device="meta"):
    topo = make_topology("d_ring", 4, fault_model=fault)
    kw = {"comm": RecordingComm(0, 4, device)} if engine == "ranks" else {}
    return SPMDTrainer(tget("granite-8b-reduced"), topo, sgd(0.9), collect_norms=True,
                       fused_apply=fused, device=device, **kw)


@pytest.mark.parametrize("engine,kernel", [("stacked", "gossip_program_update"),
                                           ("ranks", "gossip_update")])
@pytest.mark.parametrize("fault", [None, "crash"])
def test_lower_step_bills_the_fused_kernels(engine, kernel, fault):
    fm = None if fault is None else make_fault_model(fault, 4, rate=0.5, seed=1)
    trainer = _trainer(True, engine, fm)
    before = ops.launch_counts()
    rec = trainer.lower_step(MINI_SHAPES[0])
    assert ops.launch_counts() == before     # meta stands in for launches
    k = rec["hlo"]["kernels"]
    p, rows = trainer.layout.size, trainer.rows
    want = (cost.k1_cost(rows, p, 4, 2) if engine == "stacked" else cost.k2_cost(p, 4, 2))
    assert (k[kernel]["launches"], k[kernel]["bytes"], k[kernel]["ops"]) == (1, *want)
    assert k["segment_l2_norms"]["bytes"] == cost.k3_cost(rows, trainer.layout.offsets, 4)[0]
    if engine == "ranks":
        assert rec["collectives"]["collective-permute"]["count"] == 2


def test_lower_step_leaves_the_live_trainer_alone():
    """A CPU trainer's dry run between two steps changes nothing of its run:
    the steps equal a trainer's that never lowered, bit for bit."""
    from repro_torch.data import SyntheticLM

    src = SyntheticLM(vocab=tget("granite-8b-reduced").vocab, seq_len=16, seed=0)
    runs = []
    for lower in (False, True):
        trainer = _trainer(True, "stacked", device="cpu")
        state = trainer.init_state(seed=0)
        losses = []
        for t in range(2):
            state, loss, _ = trainer.train_step(state, src.stacked(4, t, 2), 1e-2)
            losses.append(loss.clone())
            if lower:
                rec = trainer.lower_step(InputShape("t", 16, 8, "train"), step=t + 1)
                assert rec["hlo"]["kernels"]["gossip_program_update"]["launches"] == 1
        assert trainer.device.type == "cpu" and trainer.comm is None
        runs.append((state.theta.clone(), torch.stack(losses)))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_kernel_wrappers_on_meta_check_and_bill_without_launching():
    meta = dict(device="meta")
    theta, grad = torch.empty(4, 64, **meta), torch.empty(4, 64, **meta)
    wire, mom = torch.empty(4, 64, **meta), torch.empty(4, 64, **meta)
    srcs = torch.empty(4, 2, dtype=torch.int32, **meta)
    w, f = torch.empty(4, 3, **meta), torch.empty(4, 3, **meta)
    kw = dict(lr=0.1, beta=0.9, fault=f)
    before = ops.launch_counts()
    info = analyze_step(lambda: (
        gossip_program_update(theta, wire, srcs, w, grad, mom, **kw),
        gossip_update(theta[0], wire[:2], w[0], grad[0], mom[0], lr=0.1, beta=0.9,
                      fault=f[0]),
        segment_l2_norms(theta, (0, 16, 64)),
        flash_attention(*(torch.empty(1, 2, 128, 64, **meta),) * 3)))
    assert ops.launch_counts() == before
    norms, attn = info["result"][2], info["result"][3]
    assert norms.shape == (4, 2) and norms.device.type == "meta"
    assert attn.shape == (1, 2, 128, 64) and attn.device.type == "meta"
    k = info["kernels"]
    assert (k["gossip_program_update"]["bytes"], k["gossip_update"]["bytes"],
            k["segment_l2_norms"]["bytes"], k["flash_attention"]["bytes"]) == (
        cost.k1_cost(4, 64, 4, 2)[0], cost.k2_cost(64, 4, 2)[0],
        cost.k3_cost(4, (0, 16, 64), 4)[0],
        cost.k4_cost(1, 2, 2, 128, 128, 64, 4, causal=True, window=None)[0])
    assert info["dot_flops"] == cost.k4_cost(1, 2, 2, 128, 128, 64, 4, causal=True,
                                             window=None)[1]
    # the same checks as on a card: a wrong shape still raises on meta
    with pytest.raises(ValueError, match="grad must have shape"):
        gossip_program_update(theta, wire, srcs, w, grad[:, :32], mom, **kw)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(torch.empty(1, 2, 128, 48, **meta),) * 3)


# ---------------------------------------------------------------------------
# The repairs: is_attention_free, input_specs, abstract_params
# ---------------------------------------------------------------------------

def test_is_attention_free_matches_the_reference():
    for arch in ARCH_NAMES:
        for name in (arch, arch + "-reduced"):
            assert tget(name).is_attention_free == jget(name).is_attention_free, name
    assert tget("rwkv6-1.6b").is_attention_free


@pytest.mark.parametrize("arch", ["granite-8b", "internvl2-2b"])
def test_input_specs_match_the_reference(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    for name, shape in SHAPES.items():
        for n in (1, 16):
            want = jinput_specs(jcfg, JSHAPES[name], n_nodes=n)
            got = input_specs(tcfg, shape, n_nodes=n)
            assert set(got) == set(want), name
            for k, v in got.items():
                assert tuple(v.shape) == tuple(want[k].shape), (name, n, k)
                assert v.device.type == "meta"
                assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), (name, k)
    with pytest.raises(ValueError, match="not divisible"):
        input_specs(tcfg, SHAPES["train_4k"], n_nodes=3)


def test_abstract_params_are_meta_leaves_of_the_defs():
    cfg = tget("zamba2-7b")   # the mixed-dtype hybrid at full width
    defs = ttfm.model_defs(cfg)
    params = abstract_params(defs)
    for (k, d), (k2, v) in zip(flatten_tree(defs).items(), flatten_tree(params).items()):
        assert k == k2 and tuple(v.shape) == tuple(d.shape) and v.dtype == d.dtype
        assert v.device.type == "meta"
    assert {v.dtype for v in flatten_tree(abstract_params(defs, torch.float32)).values()} \
        == {torch.float32}
    np.testing.assert_equal(sum(v.numel() for v in flatten_tree(params).values()),
                            FlatLayout.of_defs(defs).size)
