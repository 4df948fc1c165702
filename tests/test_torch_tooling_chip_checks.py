"""chip_smoke.py's checks of the dry run and shard_nodes run on the CPU
with the card's bookkeeping stubbed: phase 34 builds its records on meta
(granite-8b at full width over the four shapes on the single mesh, its
training on the multi one, the five mini archs), and
fails a run that moves the card's bytes or a record ``is_suspect`` flags
for any reason but the MoE capacity floor; phase 36 holds the sharded
simulator to the unsharded one and fails a sharded run that differs."""
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


def test_phase36_holds_the_sharded_simulator(no_card, monkeypatch):
    from repro_torch.kernels import ops

    # the CPU's K3 twin does not count launches: count them as the card would
    monkeypatch.setattr(ops, "launch_counts", lambda: {
        "gossip_program_update": 0, "gossip_update": 0,
        "segment_l2_norms": chip_smoke.SHARD_STEPS, "flash_attention": 0})
    launches, out = chip_smoke.phase_shard_nodes("cpu")
    assert out["bit_for_bit"] and launches["segment_l2_norms"] == chip_smoke.SHARD_STEPS


def test_phase36_fails_a_sharded_run_that_differs(no_card, monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "launch_counts", lambda: {
        "gossip_program_update": 0, "gossip_update": 0,
        "segment_l2_norms": chip_smoke.SHARD_STEPS, "flash_attention": 0})
    real = tsim.DecentralizedSimulator.init

    def nudged(self, params):
        state = real(self, params)
        if self.shard_nodes:
            state.theta[3, 0] += 1e-3
        return state

    monkeypatch.setattr(tsim.DecentralizedSimulator, "init", nudged)
    with pytest.raises(SystemExit):
        chip_smoke.phase_shard_nodes("cpu")
