"""The grouped SSD scan (kernel K5, ``kernels/ssd_scan.py``) against the
eager ``models/recurrence.py::_ssd_groups``.

CPU tests: the dispatch (CPU, meta and float64 inputs keep the eager
route and launch nothing), the wrapper's shape check (it needs no card)
and its refusal of CPU tensors, the C interface's argument counts against
their ctypes signatures, and the plain twin below (the kernel's arithmetic
in torch ops, product for product) against autograd through
``_ssd_groups``: alone in float64, and in float32 under the wrapper's
autograd Function with the twin standing in for the launches.

``gpu`` tests, run on the card with
``PYTHONPATH=src python -m pytest -q -s -m gpu tests/test_torch_ssd_kernel.py``:
the kernel pair against ``_ssd_groups`` in float64 (the truth) for y, the
final state and the gradients of x, dt, B, C, a and h0, at the zamba2 cell's
shapes and at small ragged ones; the launch and ``ssd_kernel`` counts; and
the kernel's time beside the eager route's (printed as a JSON line).

Bars, float32 relative errors (‖got − truth‖ / ‖truth‖): 2e-5 for y, the
state and the gradients of x, B, C and h0, sums of at most a few thousand
float32 products: on the CPU the eager float32 route reads up to 4e-6 and
the twin 1.2e-6 (512 rows), on the card the kernel 1.9e-7 at the
cell's shapes.  2e-4 for dt's gradient and 5e-4 for a's, whose terms
cancel (a's sums every row of every sequence): on the CPU the eager route
reads up to 2.1e-5 and 1.3e-4 (100 rows), the twin 1.1e-5 and 1.9e-4, on
the card the kernel 6.6e-7 and 1.5e-5.
"""
import ctypes
import json
import math
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as K  # noqa: E402
from repro_torch.models import recurrence  # noqa: E402
from repro_torch.models.recurrence import _ssd_groups, ssd_chunked  # noqa: E402
from repro_torch.telemetry.recorder import MetricsRecorder  # noqa: E402

BARS = {"y": 2e-5, "h": 2e-5, "dx": 2e-5, "ddt": 2e-4, "dB": 2e-5, "dC": 2e-5, "da": 5e-4,
        "dh0": 2e-5}
NAMES = tuple(BARS)


def _inputs(bsz, l, h, g, *, seed, strong=False, h0=True, device="cpu"):
    """float64 inputs as the zamba2 mixer makes them: dt a softplus, A in
    [-16, -1]; ``strong`` scales dt so that dt·A reaches -60."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    x, b, c = r(bsz, l, h, 64), r(bsz, l, g, 64), r(bsz, l, g, 64)
    dt = F.softplus(r(bsz, l, h))
    a = -torch.exp(torch.rand(h, generator=gen, dtype=torch.float64) * math.log(16))
    if strong:
        dt = dt * (60.0 / float((dt * -a).max()))
    state = r(bsz, h, 64, 64) if h0 else torch.zeros(bsz, h, 64, 64, dtype=torch.float64)
    dy, dh = r(bsz, l, h, 64), r(bsz, h, 64, 64)
    return [t.to(device) for t in (x, dt, b, c, a, state)], dy.to(device), dh.to(device)


def _eager(chunk):
    def run(x, dt, b, c, a, h0):
        l = x.shape[1]
        pad = (-l) % chunk
        p = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        y, hf = _ssd_groups(p(x), p(dt), p(b), p(c), a, h0, chunk)
        return y[:, :l], hf
    return run


def _outputs_and_grads(fn, ins, dy, dh):
    ins = [t.detach().clone().requires_grad_() for t in ins]
    y, hf = fn(*ins)
    grads = torch.autograd.grad((y * dy).sum() + (hf * dh).sum(), ins)
    return dict(zip(NAMES, (y.detach(), hf.detach(), *grads)))


def _rel(got, want):
    return float((got.double() - want).norm() / want.norm())


def _errors(fn, ins, dy, dh, chunk):
    want = _outputs_and_grads(_eager(chunk), ins, dy, dh)
    got = _outputs_and_grads(fn, [t.float() for t in ins], dy.float(), dh.float())
    return {k: _rel(got[k], want[k]) for k in NAMES}, got


# ---------------------------------------------------------------------------
# the plain twin: the kernel's arithmetic, a 64-row sub-chunk at a time over
# (B, H), in torch ops (``csrc/ssd_scan.cu`` forms the same products)

ROWS = K.ROWS


def _rows(t):
    """(B, L, H, ·) -> (k, B, H, 64, ·): 64-row sub-chunks, zero-padded."""
    bsz, l = t.shape[:2]
    pad = (-l) % ROWS
    t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    t = t.view(bsz, (l + pad) // ROWS, ROWS, *t.shape[2:])
    return t.permute(1, 0, 3, 2, *range(4, t.dim()))


def _blocks(x, dt, b_in, c_in):
    """Sub-chunks of x, dt, B and C, B and C repeated over each group's heads."""
    q = x.shape[2] // b_in.shape[2]
    return (_rows(x), _rows(dt), _rows(b_in).repeat_interleave(q, dim=2),
            _rows(c_in).repeat_interleave(q, dim=2))


def _decays(ds, a):
    """la (B, H, 64), its end e (B, H, 1) and the pairs' decays (B, H, t, s)."""
    la = torch.cumsum(ds * a[:, None], dim=-1)
    later = torch.ones((ROWS, ROWS), dtype=torch.bool, device=ds.device).triu(1)
    dec = torch.exp((la[..., :, None] - la[..., None, :]).masked_fill(later, float("-inf")))
    return la, la[..., -1:], dec


def twin_forward(x, dt, b_in, c_in, a, h0):
    """(y (B, L, H, P), states (B, H, k + 1, P, N)), states[:, :, z] the
    state entering sub-chunk z: what the forward kernel writes."""
    bsz, l, h, p = x.shape
    xs, ds, bs, cs = _blocks(x, dt, b_in, c_in)
    st = h0.to(x.dtype)
    states, ys = [st], []
    for xz, dz, bz, cz in zip(xs, ds, bs, cs):
        la, e, dec = _decays(dz, a)
        m = (cz @ bz.transpose(-1, -2)) * dec * dz[..., None, :]
        ys.append(torch.exp(la)[..., None] * (cz @ st.transpose(-1, -2)) + m @ xz)
        w = torch.exp(e - la) * dz
        st = torch.exp(e)[..., None] * st + xz.transpose(-1, -2) @ (w[..., None] * bz)
        states.append(st)
    y = torch.stack(ys, 1).permute(0, 1, 3, 2, 4).reshape(bsz, -1, h, p)[:, :l]
    return y, torch.stack(states, 2)


def twin_backward(x, dt, b_in, c_in, a, states, dy, dh):
    """(dx, ddt, dB, dC, da, dh0) from the forward's states, each in its
    input's shape; ``dh`` the final state's gradient (or None): what the
    backward kernel and the wrapper's sum over a group's heads give."""
    bsz, l, h, p = x.shape
    g, n = b_in.shape[2:]
    xs, ds, bs, cs = _blocks(x, dt, b_in, c_in)
    dys = _rows(dy)
    k = xs.shape[0]
    dH = torch.zeros_like(states[:, :, 0]) if dh is None else dh.to(x.dtype)
    da = torch.zeros_like(a)
    dxs, ddts, dbs, dcs = ([None] * k for _ in range(4))
    strict = torch.ones((ROWS, ROWS), dtype=torch.bool, device=x.device).tril(-1)
    for z in reversed(range(k)):
        xz, dz, bz, cz, dyz, hz = xs[z], ds[z], bs[z], cs[z], dys[z], states[:, :, z]
        la, e, dec = _decays(dz, a)
        s = (cz @ bz.transpose(-1, -2)) * dec                       # (B, H, t, s)
        gg = dyz @ xz.transpose(-1, -2)                             # dy_t · x_s
        dcb = gg * dec * dz[..., None, :]
        # the pairs s < t apart from the diagonal (decay 1), so that no row
        # and column sum of dla cancel it
        s_diag = torch.diagonal(s, dim1=-2, dim2=-1)                # (B, H, 64)
        s = s * strict
        row_z = (gg * s * dz[..., None, :]).sum(-1)
        wp = torch.exp(e - la)
        term2 = wp[..., None] * (bz @ dH.transpose(-1, -2))         # (B, H, s, P)
        term1 = s.transpose(-1, -2) @ dyz
        r1, r2 = (xz * term1).sum(-1), (xz * term2).sum(-1)
        diag = s_diag * torch.diagonal(gg, dim1=-2, dim2=-1)
        dxs[z] = dz[..., None] * (term1 + s_diag[..., None] * dyz + term2)
        c3 = torch.exp(la)[..., None] * (dyz @ hz)                  # (B, H, t, N)
        row_c = (c3 * cz).sum(-1)
        dcs[z] = c3 + dcb @ bz
        dbs[z] = (wp * dz)[..., None] * (xz @ dH) + dcb.transpose(-1, -2) @ cz
        # the gradient of the step's log decay dt_r a: the pairs and C terms
        # from r to the end, the state entering (all r) and the state's
        # terms of the rows before r
        dla = row_z - dz * r1 + row_c
        q = dz * r2
        gsum = (dla.flip(-1).cumsum(-1).flip(-1) + torch.exp(e) * (dH * hz).sum((-1, -2))[..., None]
                + q.cumsum(-1) - q)
        ddts[z] = r1 + diag + r2 + a[:, None] * gsum
        da = da + (dz * gsum).sum((0, 2))
        dH = torch.exp(e)[..., None] * dH + dyz.transpose(-1, -2) @ (torch.exp(la)[..., None] * cz)

    def seq(blocks):
        t = torch.stack(blocks, 1)                                  # (B, k, H, 64, ·)
        t = t.permute(0, 1, 3, 2, *range(4, t.dim())).reshape(bsz, k * ROWS, h, *t.shape[4:])
        return t[:, :l]

    grouped = lambda t: t.reshape(bsz, l, g, h // g, n).sum(3)
    return (seq(dxs), seq(ddts), grouped(seq(dbs)), grouped(seq(dcs)), da, dH)


@pytest.fixture
def twin_function(monkeypatch):
    """The wrapper's autograd Function with the twin standing in for the
    kernel launches, so that it runs on CPU tensors (``ssd_scan`` itself
    refuses them)."""
    monkeypatch.setattr(K, "_kernel_forward", twin_forward)
    monkeypatch.setattr(K, "_kernel_backward", twin_backward)
    return lambda *ins: K._SSDScan.apply(*ins)


# ---------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_and_float64_keep_the_eager_route(monkeypatch, dtype):
    """ssd_chunked's grouped branch on the CPU (float32 or float64) is
    _ssd_groups itself: the scan is never called and launches nothing."""
    def refuse(*_):
        raise AssertionError("the SSD scan kernel was called on the CPU")

    monkeypatch.setattr(recurrence, "ssd_scan", refuse)
    launches = (K.ssd_scan.launches, K.ssd_scan.backward_launches)
    (x, dt, b, c, a, h0), _, _ = _inputs(2, 40, 4, 2, seed=0)
    x, dt, b, c, h0 = (t.to(dtype) for t in (x, dt, b, c, h0))
    a_log = torch.log(-a).to(dtype).requires_grad_()
    d_skip = torch.zeros(4, dtype=dtype)
    y, hf = ssd_chunked(x, dt, a_log, b, c, d_skip, h0, chunk=16)
    y.sum().backward()
    ye, he = _eager(16)(x, dt, b, c, -torch.exp(a_log.detach()), h0)
    assert torch.equal(y.detach(), ye) and torch.equal(hf, he)
    assert (K.ssd_scan.launches, K.ssd_scan.backward_launches) == launches


def test_meta_inputs_keep_the_eager_route(monkeypatch):
    monkeypatch.setattr(recurrence, "ssd_scan", lambda *_: pytest.fail("kernel on meta"))
    m = lambda *s: torch.empty(*s, device="meta")
    y, hf = ssd_chunked(m(1, 64, 4, 64), m(1, 64, 4), m(4), m(1, 64, 2, 64), m(1, 64, 2, 64),
                        m(4), m(1, 4, 64, 64), chunk=32)
    assert y.shape == (1, 64, 4, 64) and hf.shape == (1, 4, 64, 64)


@pytest.mark.parametrize("bad", ["p32", "n16", "groups", "dt", "c_in", "a", "h0", "rank"])
def test_shapes_outside_the_kernel_raise_the_named_error(bad):
    """The wrapper's own check, on every device (here the CPU)."""
    shapes = {"x": (2, 10, 4, 64), "dt": (2, 10, 4), "b": (2, 10, 2, 64), "c": (2, 10, 2, 64),
              "a": (4,), "h0": (2, 4, 64, 64)}
    change = {"p32": {"x": (2, 10, 4, 32), "h0": (2, 4, 32, 64)},
              "n16": {"b": (2, 10, 2, 16), "c": (2, 10, 2, 16), "h0": (2, 4, 64, 16)},
              "groups": {"b": (2, 10, 3, 64), "c": (2, 10, 3, 64)},
              "dt": {"dt": (2, 10, 5)}, "c_in": {"c": (2, 11, 2, 64)}, "a": {"a": (5,)},
              "h0": {"h0": (1, 4, 64, 64)}, "rank": {"b": (2, 10, 64), "c": (2, 10, 64)}}[bad]
    shapes.update(change)
    ins = [torch.zeros(s) for s in shapes.values()]
    with pytest.raises(K.SSDScanShapeError):
        K.ssd_scan(*ins)


def test_the_scan_takes_float32_on_one_device():
    (x, dt, b, c, a, h0), _, _ = _inputs(1, 8, 2, 1, seed=0)
    with pytest.raises(TypeError):
        K.ssd_scan(x, dt, b, c, a, h0)                     # float64


def test_the_scan_refuses_cpu_tensors():
    """In range and float32 on the CPU: the named refusal, nothing launched
    (ssd_chunked never sends CPU tensors there)."""
    (x, dt, b, c, a, h0), _, _ = _inputs(1, 8, 2, 1, seed=0)
    launches = (K.ssd_scan.launches, K.ssd_scan.backward_launches)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        K.ssd_scan(*(t.float() for t in (x, dt, b, c, a, h0)))
    assert (K.ssd_scan.launches, K.ssd_scan.backward_launches) == launches


@pytest.mark.parametrize("source", _build.SOURCES)
def test_c_interfaces_match_their_ctypes_signatures(source):
    """Each ``extern "C"`` function's parameter count is its signature's
    in ``_build`` (ctypes passes whatever it is given)."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    found = {m.group(1): len(m.group(2).split(","))
             for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert found == {name: len(args) for name, args in _build._SIGNATURES[source].items()}


@pytest.mark.parametrize("case", [
    # (B, L, H, G, chunk, strong decays, h0)
    (2, 128, 4, 2, 64, False, True),
    (2, 100, 4, 1, 64, False, True),     # L ragged against both 64 and the chunk
    (1, 200, 8, 4, 64, True, True),      # dt·A down to -60
    (1, 256, 2, 2, 256, False, False),   # the cell's chunk, zero h0
])
def test_plain_twin_in_float64_is_the_eager_scan(case):
    """The twin's forward and hand-written backward, in float64, against
    autograd through _ssd_groups: rounding apart, the same function."""
    bsz, l, h, g, chunk, strong, h0 = case
    ins, dy, dh = _inputs(bsz, l, h, g, seed=l, strong=strong, h0=h0)
    want = _outputs_and_grads(_eager(chunk), ins, dy, dh)
    y, states = twin_forward(*ins)
    got = dict(zip(NAMES, (y, states[:, :, -1], *twin_backward(*ins[:5], states, dy, dh))))
    for k in NAMES:
        assert _rel(got[k], want[k]) < 1e-10, k
        assert torch.isfinite(got[k]).all(), k


@pytest.mark.parametrize("case", [
    (2, 512, 8, 2, 256, False, True),
    (2, 100, 4, 1, 64, False, True),
    (1, 200, 8, 4, 64, True, True),
    (1, 130, 4, 2, 64, False, False),
])
def test_function_plain_path_gives_the_eager_gradients(twin_function, case):
    """The wrapper's autograd Function on CPU float32 tensors, the twin in
    place of the launches, within the float32 bars of the float64 eager
    scan, as the kernel is held on the card; one launch of each counted."""
    bsz, l, h, g, chunk, strong, h0 = case
    ins, dy, dh = _inputs(bsz, l, h, g, seed=l + 1, strong=strong, h0=h0)
    before = (K.ssd_scan.launches, K.ssd_scan.backward_launches)
    errors, got = _errors(twin_function, ins, dy, dh, chunk)
    assert (K.ssd_scan.launches, K.ssd_scan.backward_launches) == (before[0] + 1, before[1] + 1)
    assert all(errors[k] < BARS[k] for k in NAMES), errors
    assert all(torch.isfinite(v).all() for v in got.values())


def _one_output_alone(scan, device):
    """Either output may carry no gradient (autograd passes None).  Mild
    decays, so that h0's gradient stays above float32's range."""
    ins, dy, dh = _inputs(1, 70, 2, 1, seed=3, device=device)
    ins[4] = ins[4] / 16
    f32 = [t.float().requires_grad_() for t in ins]
    y, hf = scan(*f32)
    g_h = torch.autograd.grad((hf * dh.float()).sum(), f32, retain_graph=True)
    g_y = torch.autograd.grad((y * dy.float()).sum(), f32)
    want_h = _outputs_and_grads(_eager(64), ins, torch.zeros_like(dy), dh)
    want_y = _outputs_and_grads(_eager(64), ins, dy, torch.zeros_like(dh))
    for got, want in ((g_h, want_h), (g_y, want_y)):
        for k, gk in zip(NAMES[2:], got):
            if float(want[k].norm()) == 0.0:                 # C reaches only y
                assert float(gk.abs().max()) == 0.0, k
            else:
                assert _rel(gk, want[k]) < BARS[k], k


def test_final_state_gradient_alone_and_output_alone(twin_function):
    _one_output_alone(twin_function, "cpu")


@pytest.mark.parametrize("mutant", [None, "ddt_off", "h0_dropped"])
def test_chip_smoke_phase_44_check_on_cpu(twin_function, monkeypatch, mutant):
    """chip_smoke.py's phase 44 check (``check_ssd``) at a small ragged
    shape with the twin in place of the kernel: it passes the twin and
    fails a backward whose dt gradient is off by 1e-3 and a forward that
    drops h0."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    if mutant == "ddt_off":
        def backward(*args):
            dx, ddt, *rest = twin_backward(*args)
            return (dx, ddt * (1 + 1e-3), *rest)
        monkeypatch.setattr(K, "_kernel_backward", backward)
    elif mutant == "h0_dropped":
        monkeypatch.setattr(K, "_kernel_forward",
                            lambda *ins: twin_forward(*ins[:5], torch.zeros_like(ins[5])))
    if mutant is None:
        assert chip_smoke.SSD_BARS == BARS
        rel = chip_smoke.check_ssd(twin_function, (2, 130, 4, 2), "cpu", chunk=64)
        assert set(rel) == set(BARS) and all(rel[k] < BARS[k] for k in rel)
    else:
        with pytest.raises(SystemExit):
            chip_smoke.check_ssd(twin_function, (2, 130, 4, 2), "cpu", chunk=64)


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CELL = (4, 1024, 112, 2, 256, False, False)   # zamba2-7b-g4-b4x1024: a node's scan, h0 zero


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    CELL,
    (2, 200, 8, 1, 64, False, True),       # L padded by ssd_chunked's chunk, G 1
    (2, 200, 8, 4, 64, False, True),       # G 4
    (1, 300, 8, 2, 64, True, True),        # dt·A down to -60, non-zero h0
    (3, 64, 6, 2, 256, False, True),       # one sub-chunk, L under the chunk
], ids=["cell", "ragged-g1", "ragged-g4", "strong", "one-sub-chunk"])
def test_kernel_matches_the_eager_scan(cuda, case):
    bsz, l, h, g, chunk, strong, h0 = case
    ins, dy, dh = _inputs(bsz, l, h, g, seed=l + h, strong=strong, h0=h0, device=cuda)
    before = (K.ssd_scan.launches, K.ssd_scan.backward_launches)
    errors, got = _errors(K.ssd_scan, ins, dy, dh, chunk)
    torch.cuda.synchronize()
    print(json.dumps({"case": list(case), "errors": errors}))
    assert (K.ssd_scan.launches, K.ssd_scan.backward_launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(v).all() for v in got.values())
    assert all(errors[k] < BARS[k] for k in NAMES), errors


@pytest.mark.gpu
def test_the_kernel_takes_one_output_alone(cuda):
    _one_output_alone(K.ssd_scan, cuda)


@pytest.mark.gpu
def test_ssd_chunked_launches_and_counts_one_kernel_a_scan(cuda):
    """Through ssd_chunked, as the zamba2 mixer calls it: one launch and
    one ``ssd_kernel`` count a scan, forward only."""
    (x, dt, b, c, a, h0), _, _ = _inputs(2, 300, 4, 2, seed=5, device=cuda)
    x, dt, b, c, h0 = (t.float() for t in (x, dt, b, c, h0))
    a_log = torch.log(-a).float().requires_grad_()
    before = K.ssd_scan.launches
    recorder = MetricsRecorder()
    recorder.configure(device=cuda)
    with recorder.device_trace() as records:
        with recorder.span("train_step", step=0):
            for _ in range(3):
                y, _ = ssd_chunked(x, dt, a_log, b, c, torch.zeros(4, device=cuda), h0, chunk=256)
                y.sum().backward()
    assert K.ssd_scan.launches == before + 3
    assert records.counts["ssd_kernel"] == {0: 3}


@pytest.mark.gpu
def test_kernel_time_at_the_cells_shapes(cuda):
    """Forward and forward + backward ms of the kernel pair and of the
    eager _ssd_groups at the cell's shapes (a JSON line); the kernels'
    registers and shared memory."""
    bsz, l, h, g, chunk = CELL[:5]
    ins, dy, dh = _inputs(bsz, l, h, g, seed=1, h0=False, device=cuda)
    ins = [t.float().requires_grad_() for t in ins]
    dy = dy.float()

    def fwd(fn):
        return fn(*ins)

    def fwd_bwd(fn):
        y, _ = fn(*ins)
        torch.autograd.grad(y, ins, dy)

    def ms(work, fn, reps=10):
        work(fn)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            work(fn)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    out = {"device": torch.cuda.get_device_name(0)}
    for name, fn in (("kernel", K.ssd_scan), ("eager", _eager(chunk)), ("kernel_again", K.ssd_scan)):
        out[f"{name}_fwd_ms"] = ms(fwd, fn)
        out[f"{name}_fwd_bwd_ms"] = ms(fwd_bwd, fn)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_bwd(fn)
        out[f"{name}_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    lib = _build.load("ssd_scan")
    for which, name in ((0, "forward"), (1, "backward")):
        attrs = (ctypes.c_int * 6)()
        assert lib.repro_ssd_scan_attributes(which, attrs) == 0
        out[f"{name}_attributes"] = list(attrs)
    flops, nbytes = K.scan_cost(bsz, l, h, g)
    out["bound_ms"] = {k: max(flops[k] / 67e12, nbytes[k] / 3.35e12) * 1e3 for k in flops}
    print(json.dumps(out))
    assert out["kernel_fwd_bwd_ms"] < out["eager_fwd_bwd_ms"]
