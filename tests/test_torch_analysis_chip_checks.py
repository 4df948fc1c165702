"""chip_smoke.py's phases 31-33 on the CPU at the reduced size: the mixed
state bucketed (bit for bit the monolithic run) and through a
crash-and-rejoin step, the simulator on the mixed model against the
trainer, and the rebuild guard, each with a mutant that must fail (a bucket
step that does not round, a handoff that does not round, a rejoin step that
mixes with the wrong neighbours, a simulator that mixes with the dense
interpreter, a device table rebuilt mid-run); and
``python -m repro_torch.examples.serve_decode``'s ``main`` on the CPU."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.analysis.report import RetraceError  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import buckets  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core import simulator as sim_mod  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from test_torch_chip_checks import _rolled_neighbours, on_cpu  # noqa: E402,F401

torch.set_num_threads(1)


@pytest.fixture
def reduced_mixed(on_cpu, monkeypatch):   # noqa: F811
    """Phases 31-32 at zamba2's reduced size (bf16, its 7 layers)."""
    def zoo_cfg(arch, layers, dtype=None, **kw):
        return dataclasses.replace(get_config(arch + "-reduced"), n_layers=layers,
                                   remat=False, dtype=dtype or torch.bfloat16, **kw)

    monkeypatch.setattr(chip_smoke, "zoo_cfg", zoo_cfg)
    monkeypatch.setattr(chip_smoke, "TWIN_CHUNK", 1 << 16)
    monkeypatch.setattr(chip_smoke, "MIXED_BUCKET_MBS", (1, 0.25))
    monkeypatch.setattr(chip_smoke, "SEQ", 8)
    monkeypatch.setitem(chip_smoke.ZOO, 29, ("zamba2-7b", 7, 7, 2, 8, 3))


def _rejoin_inputs():
    cfg = chip_smoke.zoo_cfg("zamba2-7b", 7)
    return cfg, chip_smoke.zoo_batches(cfg, chip_smoke.G, 1, "cpu")[0]


def test_phase31_buckets_and_rejoin_on_cpu(reduced_mixed):
    out = chip_smoke.phase_mixed_buckets("cpu")
    assert [out[f"bucket_mb={mb}"]["buckets"] for mb in (None, 1, 0.25)] == [1, 13, 51]
    assert out["launches"]["gossip_program_update"] == 2 * (1 + 13 + 51)
    assert out["launches"]["segment_l2_norms"] == 2 * 3
    assert out["rejoin"]["share_of_tolerance"] <= 1.0 and out["rejoin"]["moved_share"] > 0.9


def test_phase31_fails_when_a_bucket_does_not_round(reduced_mixed, monkeypatch):
    monkeypatch.setattr(buckets, "round_columns_", lambda x, ranges, offset=0: x)
    cfg = chip_smoke.zoo_cfg("zamba2-7b", 7)
    batches = chip_smoke.zoo_batches(cfg, chip_smoke.G, chip_smoke.MIXED_STEPS, "cpu")
    with pytest.raises(SystemExit):
        chip_smoke.mixed_run(cfg, batches, bucket_mb=1)


def test_phase31_fails_when_the_handoff_does_not_round(reduced_mixed, monkeypatch):
    monkeypatch.setattr(faults, "round_columns_", lambda x, ranges, offset=0: x)
    with pytest.raises(SystemExit):
        chip_smoke.mixed_rejoin_step(*_rejoin_inputs(), "cpu")


def test_phase31_rejoin_check_fails_a_wrong_mix(reduced_mixed, monkeypatch):
    """The fused step against the interpreter on the mixed state (phase 31's
    rejoin step, which holds phase 29's replicas): a rolled neighbour table
    fails it."""
    out = chip_smoke.mixed_rejoin_step(*_rejoin_inputs(), "cpu")
    assert out["share_of_tolerance"] <= 1.0 and out["moved_share"] > 0.9
    monkeypatch.setattr(gu, "gossip_program_update", _rolled_neighbours(gu.gossip_program_update))
    with pytest.raises(SystemExit):
        chip_smoke.mixed_rejoin_step(*_rejoin_inputs(), "cpu")


def test_phase32_simulator_on_cpu(reduced_mixed):
    out = chip_smoke.phase_mixed_simulator("cpu")
    assert out["launches"]["segment_l2_norms"] == chip_smoke.SIM_STEPS
    assert out["reduced_card_equals_cpu"]


def test_phase32_fails_when_the_simulator_mixes_otherwise(reduced_mixed, monkeypatch):
    monkeypatch.setitem(sim_mod._ENGINES, "shift", "dense")
    monkeypatch.setattr(chip_smoke, "SIM_STEPS", 2)
    with pytest.raises(SystemExit):
        chip_smoke.phase_mixed_simulator("cpu")


def _granite(steps):
    cfg = dataclasses.replace(get_config("granite-8b-reduced"), dtype=torch.bfloat16)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0)
    return cfg, [{k: torch.as_tensor(v) for k, v in src.stacked(chip_smoke.G, t, 2).items()}
                 for t in range(steps)]


def test_phase33_rebuild_guard_on_cpu(on_cpu):   # noqa: F811
    cfg, batches = _granite(chip_smoke.ADA_STEPS)
    out = chip_smoke.rebuild_guard(cfg, batches, "cpu")
    for label in ("phase 4's trainer", "closed-loop d_ada"):
        assert out[label]["nvcc_builds"] == 0 and out[label]["device_tables"] == 0
    assert out["closed-loop d_ada"]["transitions"]


def test_phase33_fails_when_a_table_is_rebuilt(on_cpu, monkeypatch):   # noqa: F811
    from repro_torch.launch import train as train_mod

    orig = train_mod.fused_apply_stacked

    def rebuilding(*args, **kw):
        gu._device_tables.cache_clear()
        return orig(*args, **kw)

    monkeypatch.setattr(train_mod, "fused_apply_stacked", rebuilding)
    cfg, batches = _granite(chip_smoke.ADA_STEPS)
    with pytest.raises((SystemExit, RetraceError)):
        chip_smoke.rebuild_guard(cfg, batches, "cpu")


def test_serve_decode_example_runs_on_cpu(capsys):
    from repro_torch.examples import serve_decode

    out = serve_decode.main(["--new", "4", "--batch", "2"], device="cpu")
    assert out["greedy"].shape == (2, 4) and out["sampled"].shape == (2, 4)
    assert "greedy:" in capsys.readouterr().out
