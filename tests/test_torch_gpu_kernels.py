"""The CUDA kernels against their plain twins, on the card.

Marked ``gpu``: the ``cuda`` fixture skips every test on a machine without
a CUDA device (the decision is taken when a test runs, never at import).
On the card the kernels are built from ``src/repro_torch/kernels/csrc`` at
first use.  Run them there with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py``.

Tolerances: m' within 1e-6 relative (the same float32 expression; the
kernels are built without multiply-add contraction); θ' within 2 ulps of its dtype (float32 or bfloat16
rounding of a float32 accumulation); norms within rtol 1e-5 (float32 sums
in a different order); attention within the reference's own bars, atol
2e-5 in float32 and 2e-2 in bfloat16 (online against one-pass softmax),
and at large magnitudes within the bar of chip_smoke.py's phase 12 (2e-2
plus one bfloat16 rounding step of the element).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.schedule import compile_graph  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain,
)
from repro_torch.kernels.gossip_update import (  # noqa: E402
    gossip_program_update, gossip_program_update_plain, gossip_update, gossip_update_plain,
)
from repro_torch.kernels.stats import (  # noqa: E402
    segment_l2_norms, segment_l2_norms_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ulp(x: torch.Tensor) -> torch.Tensor:
    bits = 23 if x.dtype == torch.float32 else 7
    mag = x.float().abs().clamp_min(torch.finfo(x.dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - bits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [4096, 1003])  # vector path and ragged tail
@pytest.mark.parametrize("mix_order", ["post", "pre"])
@pytest.mark.parametrize("faulty", [False, True])
def test_gossip_program_update_matches_twin(cuda, dtype, p, mix_order, faulty):
    srcs_np, w_np = compile_graph(graphs.Star(6)).permute_tables()
    n, deg = srcs_np.shape
    gen = torch.Generator(device=cuda).manual_seed(p)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda)
    theta, grad, wire = (rnd(n, p).to(dtype) for _ in range(3))
    mom = rnd(n, p)
    srcs = torch.as_tensor(srcs_np, device=cuda)
    w = torch.as_tensor(w_np, device=cuda)
    fault = torch.ones(n, deg + 1, device=cuda)
    if faulty:
        fault[1, 0] = 0.0   # one node skips its update
        fault[0, 1] = 0.0   # one masked edge
    kw = dict(lr=0.05, beta=0.9, fault=fault, mix_order=mix_order)
    want_t, want_m = gossip_program_update_plain(theta, wire, srcs, w, grad, mom, **kw)
    before = gossip_program_update.launches
    got_t, got_m = gossip_program_update(theta, wire, srcs, w, grad, mom, **kw)
    torch.cuda.synchronize()
    assert gossip_program_update.launches == before + 1
    assert got_t.data_ptr() == theta.data_ptr()  # in place
    assert ((got_m - want_m).abs() <= 1e-6 * want_m.abs() + 1e-30).all()
    assert ((got_t.float() - want_t.float()).abs() <= 2 * _ulp(want_t)).all()


# column slices [lo, hi) of a (6, 4104) state: aligned with a width that
# is a multiple of 8 (the vector path), aligned with a ragged width, and
# unaligned (the scalar path)
@pytest.mark.parametrize("lo,hi", [(1024, 3072), (8, 1011), (3, 4100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_program_update_on_a_column_slice(cuda, lo, hi, dtype):
    """K1 launched in place on a bucket (a column slice with the state's
    row stride, a contiguous wire of the bucket's width): bit for bit K1
    on a contiguous copy, the columns outside the slice untouched."""
    from repro_torch.kernels.gossip_update import fused_bucket_update, gossip_wire

    program = compile_graph(graphs.Star(6))
    srcs_np, w_np = program.permute_tables()
    n, deg = srcs_np.shape
    gen = torch.Generator(device=cuda).manual_seed(lo)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda)
    theta, grad = (rnd(n, 4104).to(dtype) for _ in range(2))
    mom = rnd(n, 4104)
    srcs = torch.as_tensor(srcs_np, device=cuda)
    w = torch.as_tensor(w_np, device=cuda)
    kw = dict(lr=0.05, beta=0.9, fault=torch.ones(n, deg + 1, device=cuda))
    sl = (slice(None), slice(lo, hi))
    wire = gossip_wire(theta[sl], grad[sl], mom[sl], lr=0.05, beta=0.9)
    want_t, want_m = theta[sl].contiguous(), mom[sl].contiguous()
    gossip_program_update(want_t, wire, srcs, w, grad[sl].contiguous(), want_m, **kw)
    t2, m2 = theta.clone(), mom.clone()
    fused_bucket_update(program, t2[sl], grad[sl], m2[sl], lr=0.05, beta=0.9)
    torch.cuda.synchronize()
    assert torch.equal(t2[sl], want_t) and torch.equal(m2[sl], want_m)
    assert torch.equal(t2[:, :lo], theta[:, :lo]) and torch.equal(t2[:, hi:], theta[:, hi:])
    assert torch.equal(m2[:, :lo], mom[:, :lo]) and torch.equal(m2[:, hi:], mom[:, hi:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [4096, 1003])  # vector path and ragged tail
@pytest.mark.parametrize("mix_order", ["post", "pre"])
@pytest.mark.parametrize("faulty", [False, True])
def test_gossip_update_matches_twin(cuda, dtype, p, mix_order, faulty):
    deg = 3
    gen = torch.Generator(device=cuda).manual_seed(p + 1)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda)
    theta, grad = (rnd(p).to(dtype) for _ in range(2))
    nbrs = rnd(deg, p).to(dtype)
    mom = rnd(p)
    w = torch.softmax(rnd(deg + 1), 0)
    fault = torch.ones(deg + 1, device=cuda)
    if faulty:
        fault[0] = 0.0   # the node skips its update
        fault[2] = 0.0   # one masked edge
    kw = dict(lr=0.05, beta=0.9, fault=fault, mix_order=mix_order)
    want_t, want_m = gossip_update_plain(theta, nbrs, w, grad, mom, **kw)
    before = gossip_update.launches
    got_t, got_m = gossip_update(theta, nbrs, w, grad, mom, **kw)
    torch.cuda.synchronize()
    assert gossip_update.launches == before + 1
    assert got_t.data_ptr() == theta.data_ptr()  # in place
    assert ((got_m - want_m).abs() <= 1e-6 * want_m.abs() + 1e-30).all()
    assert ((got_t.float() - want_t.float()).abs() <= 2 * _ulp(want_t)).all()


# a realization's masks on Star(6): the hub draining (boost 1.5), node 3 a
# ghost (alive 0, update 0), node 5 a straggler (update 0)
_ALIVE = [1.5, 1.0, 1.0, 0.0, 1.0, 1.0]
_UPDATE = [1.0, 1.0, 1.0, 0.0, 1.0, 0.0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mix_order", ["post", "pre"])
def test_kernels_on_boost_and_ghost_rows_equal_twin_bit_for_bit(cuda, dtype, mix_order):
    """K1 on the fault rows ``fault_rows`` builds for a drain boost, a ghost
    and a straggler (entries above 1, an all-zero row), and K2 on the
    boosted and the ghost row: bit for bit their twins."""
    from repro_torch.kernels.gossip_update import fault_rows

    program = compile_graph(graphs.Star(6))
    srcs_np, w_np = program.permute_tables()
    n, deg = srcs_np.shape
    rows = fault_rows(program, {"alive": torch.tensor(_ALIVE, device=cuda),
                                "update": torch.tensor(_UPDATE, device=cuda), "link": None},
                      cuda)
    assert float(rows.max()) == 1.5 and not bool(rows[3].any())
    gen = torch.Generator(device=cuda).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda)
    p = 4099
    theta, grad, wire = (rnd(n, p).to(dtype) for _ in range(3))
    mom = rnd(n, p)
    srcs = torch.as_tensor(srcs_np, device=cuda)
    w = torch.as_tensor(w_np, device=cuda)
    kw = dict(lr=0.05, beta=0.9, fault=rows, mix_order=mix_order)
    want_t, want_m = gossip_program_update_plain(theta, wire, srcs, w, grad, mom, **kw)
    got_t, got_m = gossip_program_update(theta.clone(), wire, srcs, w, grad, mom.clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_t, want_t) and torch.equal(got_m, want_m)
    nbrs = rnd(deg, p).to(dtype)
    for i in (0, 3):   # the boosted hub, the ghost
        kw = dict(lr=0.05, beta=0.9, fault=rows[i].contiguous(), mix_order=mix_order)
        want_t, want_m = gossip_update_plain(theta[i], nbrs, w[i], grad[i], mom[i], **kw)
        got_t, got_m = gossip_update(theta[i].clone(), nbrs, w[i].contiguous(), grad[i].clone(),
                                     mom[i].clone(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got_t, want_t) and torch.equal(got_m, want_m)
        if i == 3:   # a ghost row is the identity: θ and m unchanged
            assert torch.equal(got_t, theta[i]) and torch.equal(got_m, mom[i])


# (width of the state, columns [lo, hi) run): a granite-8b w_up row, a
# ragged misaligned slice (the scalar path), an aligned slice with the
# state's row stride (the vector path)
@pytest.mark.parametrize("width,lo,hi", [(4096 * 14336, 0, 4096 * 14336), (1040, 13, 1016),
                                         (4104, 8, 4104)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mix_order", ["post", "pre"])
@pytest.mark.parametrize("faulty", [False, True])
def test_one_pass_equals_wire_then_k1_bit_for_bit(cuda, width, lo, hi, dtype, mix_order,
                                                  faulty):
    """K1's one-pass route (no wire: the kernel computes the senders' rows)
    against the plain wire followed by the two-operand K1, bit for bit, on
    Star(6) with a drain boost, a ghost and a straggler; ``one_pass``
    counts the launch."""
    from repro_torch.kernels.gossip_update import fault_rows, gossip_wire

    program = compile_graph(graphs.Star(6))
    srcs_np, w_np = program.permute_tables()
    n, deg = srcs_np.shape
    masks = {"alive": torch.tensor(_ALIVE, device=cuda),
             "update": torch.tensor(_UPDATE, device=cuda), "link": None}
    rows = fault_rows(program, masks, cuda) if faulty else torch.ones(n, deg + 1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(hi)
    theta = (torch.randn((n, width), generator=gen, device=cuda) * 0.02).to(dtype)
    grad = torch.randn((n, width), generator=gen, device=cuda).to(dtype)
    mom = torch.randn((n, width), generator=gen, device=cuda)
    srcs = torch.as_tensor(srcs_np, device=cuda)
    w = torch.as_tensor(w_np, device=cuda)
    kw = dict(lr=0.05, beta=0.9, fault=rows, mix_order=mix_order)
    sl = (slice(None), slice(lo, hi))
    wire = gossip_wire(theta[sl], grad[sl], mom[sl], lr=0.05, beta=0.9, mix_order=mix_order,
                       update=rows[:, :1] if faulty else None)
    want_t, want_m = theta.clone(), mom.clone()
    gossip_program_update(want_t[sl], wire, srcs, w, grad[sl], want_m[sl], **kw)
    del wire
    before = (gossip_program_update.launches, gossip_program_update.one_pass)
    got_t, got_m = theta.clone(), mom.clone()
    gossip_program_update(got_t[sl], None, srcs, w, grad[sl], got_m[sl], **kw)
    torch.cuda.synchronize()
    assert (gossip_program_update.launches, gossip_program_update.one_pass) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got_t, want_t) and torch.equal(got_m, want_m)
    assert not torch.equal(got_t[sl], theta[sl])   # the round moved θ


def test_no_wire_above_the_one_pass_rows_takes_the_two_operand_route(cuda):
    """G = 9 bf16 rows, one more than the one-pass route stages: the wrapper
    builds the wire itself, bit for bit the explicit wire + K1, and
    ``one_pass`` does not count the launch."""
    from repro_torch.analysis.budget import k1_one_pass_rows
    from repro_torch.kernels.gossip_update import gossip_wire

    g = k1_one_pass_rows(2) + 1
    srcs_np, w_np = compile_graph(graphs.Ring(g)).permute_tables()
    gen = torch.Generator(device=cuda).manual_seed(g)
    theta = (torch.randn((g, 4099), generator=gen, device=cuda) * 0.02).bfloat16()
    grad = torch.randn((g, 4099), generator=gen, device=cuda).bfloat16()
    mom = torch.randn((g, 4099), generator=gen, device=cuda)
    srcs, w = torch.as_tensor(srcs_np, device=cuda), torch.as_tensor(w_np, device=cuda)
    kw = dict(lr=0.05, beta=0.9, fault=torch.ones_like(w))
    want_t, want_m = theta.clone(), mom.clone()
    gossip_program_update(want_t, gossip_wire(theta, grad, mom, lr=0.05, beta=0.9), srcs, w,
                          grad, want_m, **kw)
    before = (gossip_program_update.launches, gossip_program_update.one_pass)
    got_t, got_m = theta.clone(), mom.clone()
    gossip_program_update(got_t, None, srcs, w, grad, got_m, **kw)
    torch.cuda.synchronize()
    assert (gossip_program_update.launches, gossip_program_update.one_pass) == (
        before[0] + 1, before[1])
    assert torch.equal(got_t, want_t) and torch.equal(got_m, want_m)


def test_fused_bucket_update_under_faults_equals_monolithic(cuda):
    """K1 per bucket on the step's fault rows (built once) == the monolithic
    fused apply under the same masks, bit for bit."""
    from repro_torch.core.buckets import BucketLayout
    from repro_torch.kernels.gossip_update import (
        fault_rows, fused_apply_stacked, fused_bucket_update,
    )

    program = compile_graph(graphs.Star(6))
    masks = {"alive": torch.tensor(_ALIVE, device=cuda),
             "update": torch.tensor(_UPDATE, device=cuda), "link": None}
    gen = torch.Generator(device=cuda).manual_seed(8)
    theta = torch.randn((6, 5003), generator=gen, device=cuda).bfloat16()
    grad = torch.randn((6, 5003), generator=gen, device=cuda).bfloat16()
    mom = torch.randn((6, 5003), generator=gen, device=cuda)
    whole_t, whole_m = theta.clone(), mom.clone()
    fused_apply_stacked(program, whole_t, grad, whole_m, lr=0.05, beta=0.9, fault=masks)
    rows = fault_rows(program, masks, cuda)
    layout = BucketLayout((2000, 3003), 1024)
    for tb, gb, mb in zip(layout.views(theta), layout.views(grad), layout.views(mom)):
        fused_bucket_update(program, tb, gb, mb, lr=0.05, beta=0.9, fault=rows)
    torch.cuda.synchronize()
    assert torch.equal(theta, whole_t) and torch.equal(mom, whole_m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offsets", [(0, 8, 40000, 40000, 70008), (0, 3, 70001)])
def test_segment_l2_norms_matches_twin(cuda, dtype, offsets):
    gen = torch.Generator(device=cuda).manual_seed(len(offsets))
    x = torch.randn((3, offsets[-1]), generator=gen, device=cuda).to(dtype)
    want = segment_l2_norms_plain(x, offsets)
    before = segment_l2_norms.launches
    got = segment_l2_norms(x, offsets)
    torch.cuda.synchronize()
    assert segment_l2_norms.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    again = segment_l2_norms(x, offsets)
    assert torch.equal(got, again)  # deterministic: no float atomics


def _attention_case(cuda, shape_q, shape_kv, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(shape_q, generator=gen, device=cuda).to(dtype)
    k = torch.randn(shape_kv, generator=gen, device=cuda).to(dtype)
    v = torch.randn(shape_kv, generator=gen, device=cuda).to(dtype)
    return q, k, v


def _check_attention(q, k, v, **kw):
    want = flash_attention_plain(q, k, v, causal=kw.get("causal", True),
                                 window=kw.get("window"))
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    return got


# the sweep of tests/test_kernels.py (the reference kernel's own tests)
@pytest.mark.parametrize(
    "b,h,kv,sq,sk,d",
    [
        (1, 2, 1, 128, 128, 64),
        (2, 4, 2, 128, 256, 64),
        (1, 8, 8, 256, 256, 32),
        (1, 6, 2, 128, 128, 128),
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep_matches_twin(cuda, b, h, kv, sq, sk, d, causal):
    q, k, v = _attention_case(cuda, (b, h, sq, d), (b, kv, sk, d), torch.float32, b * 100 + h)
    _check_attention(q, k, v, causal=causal, block_q=64, block_k=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dtypes_match_twin(cuda, dtype):
    q, k, v = _attention_case(cuda, (1, 2, 128, 64), (1, 2, 128, 64), dtype, 0)
    _check_attention(q, k, v, block_q=64, block_k=64)


@pytest.mark.parametrize("window", [32, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_matches_twin(cuda, window, causal):
    q, k, v = _attention_case(cuda, (1, 2, 256, 64), (1, 2, 256, 64), torch.float32, 5)
    _check_attention(q, k, v, causal=causal, window=window, block_q=64, block_k=64)


def test_flash_attention_fully_masked_rows_are_zero(cuda):
    q, k, v = _attention_case(cuda, (1, 2, 256, 64), (1, 1, 128, 64), torch.float32, 6)
    got = _check_attention(q, k, v, causal=True, window=32)
    assert torch.isfinite(got).all()
    assert (got[:, :, 159:] == 0).all() and (got[:, :, :159].abs().sum(-1) > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_ragged_tiles_match_twin(cuda, dtype):
    # Sq = Sk = 96 passes the reference's check with 128-blocks (bq = 96);
    # the kernel's own 64-row tiles do not divide it
    q, k, v = _attention_case(cuda, (2, 4, 96, 128), (2, 2, 96, 128), dtype, 7)
    _check_attention(q, k, v, causal=True)
    _check_attention(q, k, v, causal=False, window=40)


# the bfloat16 route (tensor cores, 128-row × 128-key tiles) on the same cases
@pytest.mark.parametrize(
    "b,h,kv,sq,sk,d",
    [
        (1, 2, 1, 128, 128, 64),
        (2, 4, 2, 128, 256, 64),
        (1, 8, 8, 256, 256, 32),
        (1, 6, 2, 128, 128, 128),
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_sweep_matches_twin(cuda, b, h, kv, sq, sk, d, causal):
    q, k, v = _attention_case(cuda, (b, h, sq, d), (b, kv, sk, d), torch.bfloat16, b * 100 + h)
    _check_attention(q, k, v, causal=causal, block_q=64, block_k=64)


@pytest.mark.parametrize("window", [32, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_window_matches_twin(cuda, window, causal):
    q, k, v = _attention_case(cuda, (1, 2, 256, 64), (1, 2, 256, 64), torch.bfloat16, 5)
    _check_attention(q, k, v, causal=causal, window=window, block_q=64, block_k=64)


def test_flash_attention_bf16_fully_masked_rows_are_zero(cuda):
    q, k, v = _attention_case(cuda, (1, 2, 256, 64), (1, 1, 128, 64), torch.bfloat16, 6)
    got = _check_attention(q, k, v, causal=True, window=32)
    assert torch.isfinite(got).all()
    assert (got[:, :, 159:] == 0).all() and (got[:, :, :159].abs().sum(-1) > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_attention_ragged_200_by_328_matches_twin(cuda, dtype, d):
    # neither 200 nor 328 tiles by 64 or 128: ragged q and k edges, the
    # bf16 route's TMA zero-fills the rows past them
    q, k, v = _attention_case(cuda, (1, 4, 200, d), (1, 2, 328, d), dtype, 8)
    _check_attention(q, k, v, causal=False, block_q=200, block_k=328)
    _check_attention(q, k, v, causal=True, window=40, block_q=200, block_k=328)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", [8, 2, 1])   # group sizes 1, 4 and 8
def test_flash_attention_group_sizes_match_twin(cuda, dtype, kv):
    q, k, v = _attention_case(cuda, (2, 8, 384, 128), (2, kv, 384, 128), dtype, 9 + kv)
    _check_attention(q, k, v, causal=True)


def test_flash_attention_bf16_large_magnitudes(cuda):
    # q ×8, v ×8: one bf16 rounding of P would be off by ~3e-2 here
    gen = torch.Generator(device=cuda).manual_seed(12)
    q = (8 * torch.randn((1, 8, 512, 128), generator=gen, device=cuda)).bfloat16()
    k = torch.randn((1, 2, 512, 128), generator=gen, device=cuda).bfloat16()
    v = (8 * torch.randn((1, 2, 512, 128), generator=gen, device=cuda)).bfloat16()
    want = flash_attention_plain(q, k, v, causal=True).float()
    got = flash_attention(q, k, v, causal=True).float()
    assert bool(torch.isfinite(got).all()) and float(want.abs().max()) >= 8
    assert bool(((got - want).abs() <= 2e-2 + _ulp(want.bfloat16())).all())


def test_flash_attention_bf16_is_deterministic(cuda):
    q, k, v = _attention_case(cuda, (2, 8, 1024, 128), (2, 2, 1024, 128), torch.bfloat16, 13)
    a = flash_attention(q, k, v, causal=True)
    b = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
