"""chip_smoke.py's zoo phases (27-30) run on the CPU at the reduced size of
each architecture in bfloat16: training through K1's and K3's twins with
their launches counted, the twin checks on the run's state, serving, the
decode chain against forward, the dropped-assignment count, phase 29's
mixed-dtype checks (a fused step that mixes with the wrong neighbours
fails the check against the interpreter), and phase 30's reduced-parity
harness (here the CPU against itself)."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from test_torch_chip_checks import _rolled_neighbours, on_cpu  # noqa: E402,F401

torch.set_num_threads(1)


@pytest.fixture
def reduced_zoo(on_cpu, monkeypatch):   # noqa: F811
    """The zoo phases at each arch's reduced size, with CPU timers."""
    def zoo_cfg(arch, layers, dtype=None, **kw):
        return dataclasses.replace(get_config(arch + "-reduced"), n_layers=layers,
                                   remat=False, dtype=dtype or torch.bfloat16, **kw)

    monkeypatch.setattr(chip_smoke, "zoo_cfg", zoo_cfg)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters, warmup=1: (fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "profile_breakdown", lambda fn: (fn(), {})[1])
    monkeypatch.setattr(chip_smoke, "TWIN_CHUNK", 4096)
    monkeypatch.setattr(chip_smoke, "ZOO_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "ZOO_DEC_S", 8)
    small = {27: ("phi3.5-moe-42b-a6.6b", 1, 1, 2, 8, 3), 28: ("rwkv6-1.6b", 2, 2, 2, 8, 3),
             29: ("zamba2-7b", 7, 7, 2, 8, 3), 30: ("internvl2-2b", 2, 2, 2, 8, 3)}
    for n, spec in small.items():
        monkeypatch.setitem(chip_smoke.ZOO, n, spec)


@pytest.mark.parametrize("phase", [27, 28, 29, 30])
def test_zoo_phase_runs_on_cpu(reduced_zoo, monkeypatch, phase):
    monkeypatch.setattr(chip_smoke, "reduced_parity", lambda dev: {"stub": True})
    run = {27: chip_smoke.phase_moe, 28: chip_smoke.phase_ssm,
           29: chip_smoke.phase_hybrid, 30: chip_smoke.phase_vlm}[phase]
    out = run("cpu")
    train = out["train"] if phase == 30 else out
    steps = 1 if phase == 30 else 2   # ZOO_STEPS as patched
    assert train["launches"] == {"gossip_program_update": steps, "gossip_update": 0,
                                 "segment_l2_norms": steps, "flash_attention": 0}
    assert train["k1_err"] == 0.0 and train["k3_err"] <= 1e-5
    assert out["serve"]["decode_tokens"] == 3
    assert out["decode_vs_forward_max_abs_err"] <= 3e-3
    if phase == 27:
        drop = out["dropped_assignments"]
        assert drop["assignments"] == 2 * 8 * 2 and 0 <= drop["dropped"] < drop["assignments"]
    if phase == 29:
        assert train["mixed_leaf_dtypes"] and train["state_dtype"] == "torch.float32"
        assert out["fused_vs_interpreter"]["share_of_tolerance"] <= 1.0
        assert out["fused_vs_interpreter"]["moved_share"] > 0.9
        assert out["reduced_card_vs_cpu"]["max_abs_err_by_dtype"] == {
            "torch.bfloat16": 0.0, "torch.float32": 0.0}
    if phase == 30:
        assert out["serve"]["prefill_len"] == 8 + get_config("internvl2-2b-reduced").n_patches


def test_phase29_mixed_check_fails_a_wrong_mix(reduced_zoo, monkeypatch):
    from repro_torch.core.dsgd import make_topology
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.optim.sgd import sgd

    cfg = chip_smoke.zoo_cfg("zamba2-7b", 7)
    trainer = SPMDTrainer(cfg, make_topology("d_ring", chip_smoke.G), sgd(momentum=0.9),
                          collect_norms=True, fused_apply=True)
    batch = chip_smoke.zoo_batches(cfg, chip_smoke.G, 1, "cpu")[0]
    ulps, tol, rel_m, moved = chip_smoke.phase_hybrid_mixed_check(trainer, cfg, batch, "cpu")
    assert tol <= 1.0 and moved > 0.9
    monkeypatch.setattr(gu, "gossip_program_update", _rolled_neighbours(gu.gossip_program_update))
    with pytest.raises(SystemExit):
        chip_smoke.phase_hybrid_mixed_check(trainer, cfg, batch, "cpu")


def test_reduced_parity_harness_on_cpu(on_cpu):   # noqa: F811
    worst = chip_smoke.reduced_parity("cpu")
    assert set(worst) == set(chip_smoke_archs())
    for arch, by_dtype in worst.items():
        family = get_config(arch).family
        assert set(by_dtype) == ({"float32", "float64"} if family in ("ssm", "hybrid")
                                 else {"float32"}), arch
        for dt, v in by_dtype.items():
            assert (v["loss"], v["grad"], v["decode"]) == (0.0, 0.0, 0.0), arch
            if dt == "float32":   # 5e-5 plus twice the CPU's own rounding
                assert v["grad_bar"] >= 5e-5 and v["decode_bar"] >= 5e-5, arch
            else:                 # 1e-9 of the array's scale
                assert 0.0 < v["grad_bar"] < 1e-6 and 0.0 < v["decode_bar"] < 1e-6, arch


def _stops_short(orig):
    """K1 that leaves the state's last column as it was."""
    def run(theta, wire, srcs, w, grad, mom, **kw):
        return orig(theta[:, :-1], wire[:, :-1], srcs, w, grad[:, :-1], mom[:, :-1], **kw)
    return run


@pytest.mark.parametrize("mutant", [None, "stops-short"])
def test_k1_state_check_holds_the_twin_and_fails_a_short_kernel(on_cpu, monkeypatch,  # noqa: F811
                                                                mutant):
    """``k1_state_against_twin`` over a whole (G, P) state in several
    chunks: the true wrapper passes with error 0, one that stops a column
    short fails."""
    g, p = chip_smoke.G, 1000
    gen = torch.Generator().manual_seed(0)
    theta = (torch.randn((g, p), generator=gen) * 0.02).bfloat16()
    grad = torch.randn((g, p), generator=gen).bfloat16()
    mom = torch.randn((g, p), generator=gen)
    wire = gu.gossip_wire(theta, grad, mom, lr=chip_smoke.LR, beta=0.9)
    srcs, w = chip_smoke.ring_tables("cpu")
    monkeypatch.setattr(chip_smoke, "TWIN_CHUNK", 64)
    if mutant is not None:
        monkeypatch.setattr(gu, "gossip_program_update", _stops_short(gu.gossip_program_update))
        with pytest.raises(SystemExit):
            chip_smoke.k1_state_against_twin("mutant", theta, mom, grad, wire, srcs, w)
        return
    theta0 = theta.clone()
    assert chip_smoke.k1_state_against_twin("state", theta, mom, grad, wire, srcs, w) == 0.0
    assert not torch.equal(theta, theta0)   # the state took the update


def chip_smoke_archs():
    from repro_torch.configs import ARCH_NAMES

    return ARCH_NAMES
