"""chip_smoke.py's checks of the dry run and shard_nodes run on the CPU
with the card's bookkeeping stubbed: phase 34 builds its records on meta
(granite-8b at full width over the four shapes on the single mesh, its
training on the multi one, the five mini archs), and
fails a run that moves the card's bytes or a record ``is_suspect`` flags
for any reason but the MoE capacity floor; phase 36 holds the simulator
split into 4 row blocks to the unsplit one (the mini ResNet, and granite
at the reduced width in bf16) and fails a split run that differs or a
probe that is not launched once a block."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.launch import validate_dryrun  # noqa: E402


@pytest.fixture
def no_card(monkeypatch, tmp_path):
    """The card's bookkeeping as a counter that the test can move."""
    allocated = {"bytes": 0}
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: allocated["bytes"])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: allocated["bytes"])
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    monkeypatch.setattr(chip_smoke, "DRY_FULL_ARCHS", ("granite-8b",))
    return allocated


def test_phase34_builds_the_records_on_meta(no_card, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.core.flat import FlatLayout
    from repro_torch.models.transformer import model_defs

    out = chip_smoke.phase_dryrun(torch.device("cpu"))
    assert out["records"] == 4 + 1 + 15 and out["flagged_capacity_floor"] == {}
    assert out["device_bytes_before_after"] == [(0, 0), (0, 0)]
    records = json.loads((tmp_path / "build/repro_torch/dryrun/phase34.json").read_text())
    granite = next(r for r in records if r["shape"] == "train_4k" and r["mesh"] == "single")
    assert granite["gossip_nodes"] == 16
    assert granite["mesh_shape"] == {"data": 16, "model": 16}
    # rank (0, 0)'s state: a sixteenth of a node's θ (bf16) and m (f32), the
    # replicated norm gains whole
    layout = FlatLayout.of_defs(model_defs(get_config("granite-8b")))
    node = layout.row_bytes + 4 * layout.size
    assert node / 16 <= granite["memory"]["argument_bytes"] <= node / 16 * 1.001
    assert out["train_bytes_a_card"]["granite-8b multi"]["mesh_shape"] == {
        "pod": 2, "data": 16, "model": 16}


def test_phase34_fails_a_dry_run_that_allocates_on_the_card(no_card, monkeypatch):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(chip_smoke, "DRY_FULL_ARCHS", ())   # the mini archs suffice

    real = dryrun.run_one

    def allocating(*a, **k):
        no_card["bytes"] += 512
        return real(*a, **k)

    monkeypatch.setattr(dryrun, "run_one", allocating)
    with pytest.raises(SystemExit):
        chip_smoke.phase_dryrun(torch.device("cpu"))


def test_phase34_fails_a_suspect_record(no_card, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DRY_FULL_ARCHS", ())
    monkeypatch.setattr(validate_dryrun, "is_suspect",
                        lambda rec: "dot/model=0.010 (trip counts likely missing)")
    with pytest.raises(SystemExit):
        chip_smoke.phase_dryrun(torch.device("cpu"))


def test_moe_capacity_floor_explains_only_moe_decodes():
    rec = lambda arch, shape, replicas: {"arch": arch, "shape": shape, "kind": "decode",
                                         "replicas": replicas}
    assert chip_smoke.moe_capacity_floor(rec("phi3.5-moe-42b-a6.6b", "long_500k", 1)) == 32.0
    assert chip_smoke.moe_capacity_floor(rec("kimi-k2-1t-a32b", "decode_32k", 16)) == 24.0
    assert chip_smoke.moe_capacity_floor(rec("phi3.5-moe-42b-a6.6b", "decode_32k", 1)) is None
    assert chip_smoke.moe_capacity_floor(rec("granite-8b", "long_500k", 1)) is None
    assert chip_smoke.moe_capacity_floor({**rec("kimi-k2-1t-a32b", "train_4k", 1),
                                          "kind": "train"}) is None


@pytest.fixture
def k3_counts(monkeypatch):
    """The CPU's K3 twin counts no launches: count the probe's calls as the
    card counts its launches, once per call on a block.  One CPU thread:
    with more, torch splits a long row's sum over threads when a call has
    fewer rows than threads, so the twin's rounding would hang on the rows
    a block holds (K3 on the card sums each row in one fixed order)."""
    from repro_torch.core import dbench
    from repro_torch.kernels import ops

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    count = {"n": 0}
    real = dbench.segment_l2_norms

    def counting(x, offsets):
        count["n"] += 1
        return real(x, offsets)

    monkeypatch.setattr(dbench, "segment_l2_norms", counting)
    monkeypatch.setattr(ops, "reset_launch_counts", lambda: count.update(n=0))
    monkeypatch.setattr(ops, "launch_counts", lambda: {
        "gossip_program_update": 0, "gossip_update": 0, "segment_l2_norms": count["n"],
        "flash_attention": 0})
    yield count
    torch.set_num_threads(threads)


def _granite_small():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("granite-8b-reduced"), dtype=torch.bfloat16,
                               remat=False)


def test_phase36_holds_the_split_simulator(no_card, k3_counts, monkeypatch):
    from repro_torch.core import node_split

    monkeypatch.setattr(node_split, "SPLIT_CHUNK", 64)   # the reductions' leaf: 227 columns
    launches, out = chip_smoke.phase_shard_nodes("cpu", granite_cfg=_granite_small())
    assert out["reductions"]["columns"] == 227 and out["reductions"]["blocks"] == 4
    # on the CPU every chunk's product keeps the whole width's bits too
    assert len(out["reductions"]["bit_for_bit"]) == 4
    blocks = chip_smoke.SHARD_BLOCKS
    resnet = out["resnet"]
    assert resnet["shift, node loop"]["bit_for_bit"] and out["granite"]["bit_for_bit"]
    assert resnet["shift, node loop"]["blocks"] == out["granite"]["blocks"] == blocks
    assert resnet["dense, node loop"]["max_rel_err"]["theta"] <= 1e-6
    assert resnet["shift, vmap"]["max_rel_err"]["theta"] <= 1e-6
    assert launches["segment_l2_norms"] == blocks * (
        len(chip_smoke.SHARD_RESNET_RUNS) * chip_smoke.SHARD_STEPS
        + chip_smoke.SHARD_GRANITE_STEPS)


def test_phase36_fails_a_split_run_that_differs(no_card, k3_counts, monkeypatch):
    from repro_torch.core.node_split import NodeBlocks

    real = tsim.DecentralizedSimulator.init

    def nudged(self, params):
        state = real(self, params)
        if isinstance(state.theta, NodeBlocks):
            state.theta.row(3)[0] += 1e-3
        return state

    monkeypatch.setattr(tsim.DecentralizedSimulator, "init", nudged)
    with pytest.raises(SystemExit):
        chip_smoke.phase_shard_nodes("cpu", granite_cfg=_granite_small())


def test_phase36_fails_reductions_that_differ(no_card, k3_counts, monkeypatch):
    """Chunks of 7 columns start off the CPU's vector blocks: a column's
    float32 mean rounds apart from the unsplit one, and the phase fails."""
    from repro_torch.core import node_split

    monkeypatch.setattr(node_split, "SPLIT_CHUNK", 7)
    with pytest.raises(SystemExit):
        chip_smoke.shard_reductions("cpu")


def test_phase36_fails_a_probe_that_is_not_split(no_card, k3_counts, monkeypatch):
    """K3 launched once over the gathered rows instead of once a block."""
    from repro_torch.core import dbench
    from repro_torch.core.node_split import NodeBlocks

    real = dbench.param_l2_norms
    monkeypatch.setattr(dbench, "param_l2_norms", lambda flat, layout: real(
        flat.to_full() if isinstance(flat, NodeBlocks) else flat, layout))
    with pytest.raises(SystemExit):
        chip_smoke.phase_shard_nodes("cpu", granite_cfg=_granite_small())
