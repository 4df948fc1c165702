"""Port parity: the chunked recurrences against ``repro.models.recurrence``.

The same numpy inputs (seeded) go through the reference's and the port's
``rwkv_chunked``/``ssd_chunked`` at the reference test's (l, chunk) cases
(``tests/test_decode_equivalence.py``), padded sequences included, and its
strong-decay case: outputs and final states within 1e-5, gradients too
(the pairs above the diagonal are masked to -inf before the ``exp``, so no
NaN reaches the backward pass); the single steps and the scan oracles the
same way, and the port's chunked forms against its own scan oracles at
the reference test's 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import recurrence as jrec  # noqa: E402
from repro_torch.models import recurrence as trec  # noqa: E402

torch.set_num_threads(1)


def _rwkv_inputs(l, seed=0, b=2, h=3, n=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, l, h, n)).astype(np.float32) for _ in range(3))
    logw = (-np.exp(rng.standard_normal((b, l, h, n)) * 0.5)).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def _ssd_inputs(l, seed=7, b=2, h=3, p=4, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    b_in = rng.standard_normal((b, l, n)).astype(np.float32)
    c_in = rng.standard_normal((b, l, n)).astype(np.float32)
    d_skip = (rng.standard_normal(h) * 0.2).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    return x, dt, a_log, b_in, c_in, d_skip, h0


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("l,chunk", [(16, 4), (15, 4), (8, 8), (21, 5)])
def test_rwkv_chunked_matches_reference(l, chunk):
    args = _rwkv_inputs(l)
    jo, js = jrec.rwkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    to, ts = trec.rwkv_chunked(*map(torch.from_numpy, args), chunk=chunk)
    _close(to, jo)
    _close(ts, js)
    so, ss = trec.rwkv_scan_reference(*map(torch.from_numpy, args))
    _close(to, so.numpy(), 1e-4)
    _close(ts, ss.numpy(), 1e-4)


@pytest.mark.parametrize("l,chunk", [(16, 4), (13, 4), (32, 8)])
def test_ssd_chunked_matches_reference(l, chunk):
    args = _ssd_inputs(l)
    jy, jh = jrec.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, th = trec.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    _close(ty, jy)
    _close(th, jh)
    sy, sh = trec.ssd_scan_reference(*map(torch.from_numpy, args))
    _close(ty, sy.numpy(), 1e-4)
    _close(th, sh.numpy(), 1e-4)


def test_rwkv_strong_decay_matches_reference_without_overflow():
    """w = e^-7 per step over a 32-step chunk: no overflow, as the reference."""
    b, l, h, n = 1, 64, 2, 4
    rng = np.random.default_rng(9)
    r, k, v = (rng.standard_normal((b, l, h, n)).astype(np.float32) for _ in range(3))
    logw = np.full((b, l, h, n), -7.0, np.float32)
    u = np.zeros((h, n), np.float32)
    s0 = np.zeros((b, h, n, n), np.float32)
    args = (r, k, v, logw, u, s0)
    to, ts = trec.rwkv_chunked(*map(torch.from_numpy, args), chunk=32)
    assert bool(torch.isfinite(to).all()) and bool(torch.isfinite(ts).all())
    jo, js = jrec.rwkv_chunked(*map(jnp.asarray, args), chunk=32)
    _close(to, jo)
    _close(ts, js)
    so, _ = trec.rwkv_scan_reference(*map(torch.from_numpy, args))
    _close(to, so.numpy(), 1e-4)


@pytest.mark.parametrize("kind", ["rwkv", "ssd"])
def test_chunked_gradients_match_reference(kind):
    """Gradients of a weighted sum of the outputs and state, for every
    input: finite (the -inf mask precedes the exp) and within 1e-5
    relative to each gradient's scale."""
    if kind == "rwkv":
        args, jfn, tfn = _rwkv_inputs(15), jrec.rwkv_chunked, trec.rwkv_chunked
    else:
        args, jfn, tfn = _ssd_inputs(13), jrec.ssd_chunked, trec.ssd_chunked
    rng = np.random.default_rng(3)
    out_shape = args[0].shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    def jloss(*xs):
        o, s = jfn(*xs, chunk=4)
        return jnp.sum(o * w) + jnp.sum(s)

    jg = jax.grad(jloss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    o, s = tfn(*ts, chunk=4)
    tg = torch.autograd.grad((o * torch.from_numpy(w)).sum() + s.sum(), ts)
    for i, (a, b_) in enumerate(zip(jg, tg)):
        assert bool(torch.isfinite(b_).all()), i
        scale = max(float(np.abs(np.asarray(a)).max()), 1.0)
        np.testing.assert_allclose(b_.numpy() / scale, np.asarray(a) / scale, atol=1e-5,
                                   err_msg=f"input {i}")


def test_steps_match_reference():
    r, k, v, logw, u, s0 = _rwkv_inputs(1)
    args = (r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, s0)
    jo, js = jrec.rwkv_step(*map(jnp.asarray, args))
    to, ts = trec.rwkv_step(*map(torch.from_numpy, args))
    _close(to, jo)
    _close(ts, js)
    x, dt, a_log, b_in, c_in, d_skip, h0 = _ssd_inputs(1)
    args = (x[:, 0], dt[:, 0], a_log, b_in[:, 0], c_in[:, 0], d_skip, h0)
    jy, jh = jrec.ssd_step(*map(jnp.asarray, args))
    ty, th = trec.ssd_step(*map(torch.from_numpy, args))
    _close(ty, jy)
    _close(th, jh)


def test_bfloat16_inputs_compute_in_float32():
    """bf16 inputs: float32 math inside, outputs in the inputs' dtype and
    the state in float32, equal to the float32 run on the rounded inputs."""
    args = _rwkv_inputs(12)
    bf = [torch.from_numpy(a).bfloat16() for a in args[:5]] + [torch.from_numpy(args[5])]
    o, s = trec.rwkv_chunked(*bf, chunk=4)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    o32, s32 = trec.rwkv_chunked(*[t.float() for t in bf], chunk=4)
    assert torch.equal(o, o32.bfloat16()) and torch.equal(s, s32)
