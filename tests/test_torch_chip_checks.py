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


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 64, True, None), (64, 64, False, None), (64, 64, True, 16),
    (64, 64, False, 16), (96, 40, True, 7), (40, 96, True, None),
    (256, 128, True, 32), (33, 77, False, 100), (50, 50, True, 0),
])
def test_attention_pair_count_matches_brute_force(sq, sk, causal, window):
    """K4's bound counts the (q, k) pairs its mask allows; held against a
    brute-force count of the reference kernel's mask."""
    q = torch.arange(sq)[:, None]
    k = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= k <= q
    if window is not None:
        mask &= k > q - window
    assert chip_smoke.attention_pairs(sq, sk, causal=causal, window=window) == int(mask.sum())


def test_attention_bound_at_granite_prefill():
    """The figures the bound gives at phase 12's shapes (B, H, KV, S, D)."""
    ms, by, flops, nbytes = chip_smoke.attention_bound(4, 32, 8, 4096, 4096, 128, 2,
                                                      causal=True, window=None)
    assert chip_smoke.attention_pairs(4096, 4096, causal=True, window=None) == 8_390_656
    assert flops == 4 * 128 * 4 * 32 * 8_390_656 and nbytes == 335_544_320
    assert by == "operations" and abs(ms - 0.556) < 1e-3
    ms_l, by_l, _, _ = chip_smoke.attention_bound(1, 32, 8, 32768, 32768, 128, 2,
                                                 causal=True, window=None)
    assert by_l == "operations" and abs(ms_l - 8.894) < 1e-3
