"""chip_smoke.py's comparison of the fused and the interpreted training step
(its phase 5), run on the CPU at the reduced granite-8b size in bfloat16:
the two true steps pass it, and a step that mixes wrongly fails it."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dsgd import make_topology  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from repro_torch.launch.train import SPMDTrainer  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("granite-8b-reduced"), dtype=torch.bfloat16)
    topo = make_topology("d_ring", chip_smoke.G)
    fused = SPMDTrainer(cfg, topo, sgd(momentum=0.9), fused_apply=True, device="cpu")
    plain = SPMDTrainer(cfg, topo, sgd(momentum=0.9), fused_apply=False, device="cpu")
    state = fused.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0)
    batches = [{k: torch.as_tensor(v) for k, v in src.stacked(chip_smoke.G, t, 2).items()}
               for t in range(3)]
    for t in range(2):
        state, _, _ = fused.train_step(state, batches[t], chip_smoke.LR)
    return fused, plain, state, batches[2]


def _rolled_neighbours(orig):
    def run(theta, wire, srcs, *args, **kw):
        return orig(theta, wire, torch.roll(srcs, 1, 0).contiguous(), *args, **kw)
    return run


def _no_neighbours(orig):
    def run(theta, wire, srcs, weights, *args, **kw):
        w = torch.zeros_like(weights)
        w[:, 0] = 1.0
        return orig(theta, wire, srcs, w, *args, **kw)
    return run


@pytest.mark.parametrize("mutant", [None, _rolled_neighbours, _no_neighbours])
def test_phase5_passes_the_true_step_and_fails_a_wrong_mix(setup, mutant, monkeypatch):
    fused, plain, state, batch = setup
    monkeypatch.setattr(chip_smoke, "TWIN_CHUNK", 1000)   # several chunks
    if mutant is None:
        _, ulps, tol_share, rel_m, moved = chip_smoke.phase_fused_vs_interpreter(
            fused, plain, state.clone(), batch)
        assert tol_share <= 1.0 and rel_m == 0.0 and moved > 0.9
        assert ulps <= 2.0
    else:
        monkeypatch.setattr(gu, "gossip_program_update", mutant(gu.gossip_program_update))
        with pytest.raises(SystemExit):
            chip_smoke.phase_fused_vs_interpreter(fused, plain, state.clone(), batch)
