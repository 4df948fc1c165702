"""K1's one-pass route on the CPU: the stacked step's update and mix with
no wire operand (``gossip_program_update(theta, None, ...)``).

* the twin with ``wire=None`` equals the plain wire followed by the
  two-operand twin, bit for bit, in both mix orders, under fault rows (a
  straggler, a dead node, a dropped edge), at β = 0 with zero momentum, at
  a ragged P and on column slices with the state's row stride, in
  bfloat16 and float32; the CPU wrapper, in place, the same;
* the plain wire's float32 operations, in the order the CUDA kernel
  repeats them, against numpy;
* on meta tensors ``fused_apply_stacked`` bills one launch with the
  one-pass bytes and builds no (G, P) wire; above ``k1_one_pass_rows``
  it bills the two-operand route and builds the wire;
* the launch budget of the one-pass route, and the built kernel's
  attributes held to it (its shared memory, no spill).

The CUDA kernel against the plain wire + two-operand K1 on the card is
``tests/test_torch_gpu_kernels.py::test_one_pass_equals_wire_then_k1_bit_for_bit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import budget  # noqa: E402
from repro_torch.analysis.report import BudgetViolation  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.schedule import compile_graph  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels import gossip_update as gu  # noqa: E402
from repro_torch.launch.hlo_analysis import analyze_step  # noqa: E402

torch.set_num_threads(1)

LR = 0.05
# Ring(6): node 3 dead (alive 0, update 0), node 5 a straggler (update 0),
# the edge between nodes 0 and 1 dropped
_ALIVE = [1.0, 1.0, 1.0, 0.0, 1.0, 1.0]
_UPDATE = [1.0, 1.0, 1.0, 0.0, 1.0, 0.0]


def _masks():
    link = torch.ones(6, 6)
    link[0, 1] = link[1, 0] = 0.0
    return {"alive": torch.tensor(_ALIVE), "update": torch.tensor(_UPDATE), "link": link}


def _case(case, dtype, seed=0):
    """(θ, g, m, β, column slice) for one case: the whole state or a
    column slice of a wider one with its row stride."""
    gen = torch.Generator().manual_seed(seed)
    width = {"ragged": 1003, "slice": 1040}.get(case, 1024)
    theta = (torch.randn((6, width), generator=gen) * 0.02).to(dtype)
    grad = torch.randn((6, width), generator=gen).to(dtype)
    mom = torch.randn((6, width), generator=gen)
    beta = 0.9
    if case == "beta0":
        beta, mom = 0.0, torch.zeros_like(mom)
    sl = (slice(None), slice(13, 1016) if case == "slice" else slice(None))
    return theta, grad, mom, beta, sl


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mix_order", ["post", "pre"])
@pytest.mark.parametrize("case", ["all-ones", "faults", "beta0", "ragged", "slice"])
def test_one_pass_twin_equals_plain_wire_then_twin(dtype, mix_order, case):
    program = compile_graph(graphs.Ring(6))
    srcs_np, w_np = program.permute_tables()
    srcs, w = torch.as_tensor(srcs_np, dtype=torch.int32), torch.as_tensor(w_np)
    theta, grad, mom, beta, sl = _case(case, dtype)
    if case == "faults":
        rows = gu.fault_rows(program, _masks(), "cpu")
        update = rows[:, :1]
        assert rows[3].sum() == 0 and rows[5, 0] == 0 and rows[0, 1] == rows[1, 2] == 0
    else:
        rows, update = torch.ones(6, srcs.shape[1] + 1), None
    kw = dict(lr=LR, beta=beta, fault=rows, mix_order=mix_order)
    t, g, m = theta[sl], grad[sl], mom[sl]
    # the parent's stacked step: the plain wire, then the two-operand twin
    wire = gu.gossip_wire(t, g, m, lr=LR, beta=beta, mix_order=mix_order, update=update)
    want_t, want_m = gu.gossip_program_update_plain(t, wire, srcs, w, g, m, **kw)
    got_t, got_m = gu.gossip_program_update_plain(t, None, srcs, w, g, m, **kw)
    assert torch.equal(got_t, want_t) and torch.equal(got_m, want_m)
    # the CPU wrapper, in place on the (sliced) state: no launch is counted
    before = (gu.gossip_program_update.launches, gu.gossip_program_update.one_pass)
    t2, m2 = theta.clone(), mom.clone()
    gu.gossip_program_update(t2[sl], None, srcs, w, g, m2[sl], **kw)
    assert torch.equal(t2[sl], want_t) and torch.equal(m2[sl], want_m)
    if case == "slice":
        assert torch.equal(t2[:, :13], theta[:, :13]) and torch.equal(m2[:, 1016:],
                                                                      mom[:, 1016:])
    assert (gu.gossip_program_update.launches, gu.gossip_program_update.one_pass) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_wire_is_the_order_the_kernel_repeats(dtype):
    """θ* = ((m β + g) u)(−lr) + θ, each operation rounded to float32 and the
    sum to θ's dtype: the one-pass kernel's ``send`` and the plain wire."""
    theta, grad, mom, beta, _ = _case("faults", dtype, seed=3)
    u = torch.tensor(_UPDATE)[:, None]
    f32 = lambda x: x.float().numpy()
    s = f32(mom) * np.float32(beta)
    s = s + f32(grad)
    s = s * f32(u)
    s = s * np.float32(-LR)
    want = torch.from_numpy(s + f32(theta)).to(dtype)
    got = gu.gossip_wire(theta, grad, mom, lr=LR, beta=beta, update=u)
    assert torch.equal(got, want)


def _meta_state(g, p, dtype):
    meta = dict(device="meta")
    return (torch.empty(g, p, dtype=dtype, **meta), torch.empty(g, p, dtype=dtype, **meta),
            torch.empty(g, p, dtype=torch.float32, **meta))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fault", [False, True])
def test_fused_apply_stacked_on_meta_bills_one_pass_and_builds_no_wire(dtype, fault,
                                                                       monkeypatch):
    def no_wire(*a, **kw):
        raise AssertionError("the one-pass route built a (G, P) wire")

    monkeypatch.setattr(gu, "gossip_wire", no_wire)
    program = compile_graph(graphs.Ring(6))
    theta, grad, mom = _meta_state(6, 1000, dtype)
    masks = {k: (None if v is None else v.to("meta")) for k, v in _masks().items()}
    info = analyze_step(lambda: gu.fused_apply_stacked(
        program, theta, grad, mom, lr=LR, beta=0.9, fault=masks if fault else None))
    k = info["kernels"]["gossip_program_update"]
    eb = theta.element_size()
    assert (k["launches"], k["bytes"], k["ops"]) == (1, *cost.k1_one_pass_cost(6, 1000, eb, 2))
    assert k["bytes"] == 6 * 1000 * (3 * eb + 8)   # θ, g, m in; θ', m' out
    # the rest is the tables and fault rows: no op moves a row of the state
    assert info["traffic_bytes"] - k["bytes"] < 1000 * eb


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("extra", [0, 1])
def test_k1_takes_the_two_operand_route_above_the_one_pass_rows(dtype, extra, monkeypatch):
    eb = torch.tensor([], dtype=dtype).element_size()
    g = budget.k1_one_pass_rows(eb) + extra
    assert budget.k1_one_pass_rows(eb) == (8 if dtype == torch.bfloat16 else 6)
    built = []
    wire = gu.gossip_wire
    monkeypatch.setattr(gu, "gossip_wire", lambda *a, **kw: built.append(1) or wire(*a, **kw))
    theta, grad, mom = _meta_state(g, 1000, dtype)
    info = analyze_step(lambda: gu.fused_apply_stacked(
        compile_graph(graphs.Ring(g)), theta, grad, mom, lr=LR, beta=0.9))
    k = info["kernels"]["gossip_program_update"]
    want = (cost.k1_cost if extra else cost.k1_one_pass_cost)(g, 1000, eb, 2)
    assert (k["launches"], k["bytes"], k["ops"]) == (1, *want)
    assert built == [1] * extra


@pytest.mark.parametrize("eb", [2, 4])
def test_one_pass_budget_fits_48_kib_and_refuses_more_rows(eb):
    rows = budget.k1_one_pass_rows(eb)
    got = budget.check_kernel_budget("gossip_program_update", rows=rows, cols=838_881_280,
                                     deg=2, aligned=True, one_pass_bytes=eb)
    assert got["grid"] == (819_220,) and got["threads"] == 128
    assert got["smem_bytes"] == budget.k1_one_pass_smem_bytes(eb, rows) <= 48 * 1024
    assert budget.k1_one_pass_smem_bytes(eb, rows + 1) > 48 * 1024
    with pytest.raises(BudgetViolation, match="one pass"):
        budget.check_kernel_budget("gossip_program_update", rows=rows + 1, cols=64, deg=2,
                                   aligned=True, one_pass_bytes=eb)


@pytest.mark.parametrize("fault", [None, "smem", "spill"])
def test_one_pass_attributes_are_held_to_the_budget(fault):
    """What the card reports for the one-pass route at its most rows
    (chip_smoke.py phase 33): the budget's shared memory and no spill."""
    ok = {"regs_per_thread": 48, "static_smem_bytes": 0,
          "dynamic_smem_bytes": budget.k1_one_pass_smem_bytes(2, 8),
          "max_threads_per_block": 128, "threads": 128, "local_bytes_per_thread": 0}
    bad = dict(ok, **{"smem": {"dynamic_smem_bytes": 24576},
                      "spill": {"local_bytes_per_thread": 16}}.get(fault, {}))
    if fault is None:
        budget.verify_kernel_attributes({"gossip_program_update one-pass bfloat16": ok})
        return
    with pytest.raises(BudgetViolation, match="one-pass"):
        budget.verify_kernel_attributes({"gossip_program_update one-pass bfloat16": bad})
