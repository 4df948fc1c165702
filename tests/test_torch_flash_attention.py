"""Port parity: the flash-attention entry point (kernel K4's wrapper) against
the reference's Pallas kernel, ``repro.kernels.ops.flash_attention``, run
in interpret mode on the CPU.

The sweep is the reference kernel's own (``tests/test_kernels.py``): the
same shapes, causal and not, both dtypes, windows 32 and 96, at its bars
(2e-5 in float32, 2e-2 in bfloat16).  Inputs are numpy arrays from a seed;
bfloat16 inputs are carried bit for bit.  On CPU tensors the wrapper takes
the plain twin, so this holds the twin (and the arithmetic the card's
kernel is held to) to the TPU kernel.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)


def _inputs(seed, q_shape, kv_shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    if dtype == "bfloat16":   # round once, in jax; both sides see the same bits
        return tuple(np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    return q, k, v


def _to_torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _compare(q, k, v, tol, **kw):
    want = np.asarray(jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                           interpret=True, **kw), np.float32)
    got = tops.flash_attention(*(_to_torch(a) for a in (q, k, v)), **kw)
    assert got.dtype == _to_torch(q).dtype and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    return got


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
def test_flash_attention_sweep_matches_reference(b, h, kv, sq, sk, d, causal):
    q, k, v = _inputs(b * 100 + h, (b, h, sq, d), (b, kv, sk, d))
    _compare(q, k, v, 2e-5, causal=causal, block_q=64, block_k=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_dtypes_match_reference(dtype):
    q, k, v = _inputs(0, (1, 2, 128, 64), (1, 2, 128, 64), dtype)
    _compare(q, k, v, 2e-5 if dtype == "float32" else 2e-2, block_q=64, block_k=64)


@pytest.mark.parametrize("window", [32, 96])
def test_flash_attention_sliding_window_matches_reference(window):
    q, k, v = _inputs(5, (1, 2, 256, 64), (1, 2, 256, 64))
    _compare(q, k, v, 2e-5, window=window, block_q=64, block_k=64)


def test_fully_masked_rows_are_zero():
    # Sq = 256 > Sk = 128, causal, window 32: rows 159.. see no key
    q, k, v = _inputs(6, (1, 2, 256, 64), (1, 1, 128, 64))
    got = _compare(q, k, v, 2e-5, causal=True, window=32)
    assert torch.isfinite(got).all()
    assert (got[:, :, 159:] == 0).all() and (got[:, :, :159].abs().sum(-1) > 0).all()


def test_ragged_tile_shape_matches_reference():
    # bq = min(128, 96) = 96 passes the reference's check; the card's 64-row
    # tiles do not divide it
    q, k, v = _inputs(7, (2, 4, 96, 32), (2, 2, 96, 32))
    _compare(q, k, v, 2e-5, causal=True)


@pytest.mark.parametrize("sq,sk,kw", [
    (192, 192, dict(block_q=128)),          # 192 % 128
    (128, 192, dict(block_k=128)),          # 192 % 128 on the k side
])
def test_tiling_error_where_the_reference_raises(sq, sk, kw):
    q, k, v = _inputs(8, (1, 2, sq, 32), (1, 2, sk, 32))
    with pytest.raises(ValueError, match="must tile"):
        jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True, **kw)
    with pytest.raises(ValueError, match="must tile"):
        tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs(9, (1, 3, 64, 32), (1, 2, 64, 32)))
    with pytest.raises(ValueError, match="multiple of KV heads"):
        tops.flash_attention(q, k, v)
    q4 = torch.zeros((1, 4, 64, 32))
    with pytest.raises(TypeError, match="dtype"):
        tops.flash_attention(q4, k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_attention(q4.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="devices"):
        tops.flash_attention(q4, k.to("meta"), v)
    # meta is the dry run's device: checked and billed, no launch
    before = tops.flash_attention.launches
    out = tops.flash_attention(q4.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q4.shape
    assert tops.flash_attention.launches == before

    class Elsewhere(torch.Tensor):   # a device with neither a kernel nor a twin
        @property
        def device(self):
            return torch.device("xpu")

    with pytest.raises(ValueError, match="unsupported device"):
        tops.flash_attention(*(t.as_subclass(Elsewhere) for t in (q4, k, v)))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 40), (False, 40)])
def test_ref_oracle_matches_reference_oracle(causal, window):
    q, k, v = _inputs(10, (2, 4, 80, 32), (2, 2, 72, 32))
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=causal, window=window)
    got = tref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window)
    # float32 sums in another order: a few ulps of O(1) outputs (1.1e-6 seen);
    # the bar is the attention modules' (tests/test_attention.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_entry_point_is_exported_and_counted():
    assert tkernels.flash_attention is tops.flash_attention
    assert "flash_attention" in tops.launch_counts()
    before = tops.flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(11, (1, 2, 64, 32), (1, 2, 64, 32)))
    tops.flash_attention(q, k, v)
    assert tops.flash_attention.launches == before   # the CPU twin launches nothing


# --- the bfloat16 kernel's arithmetic, emulated -----------------------------
#
# K4's bfloat16 route runs on the tensor cores: 128-key tiles walked from the
# last; S = q·k from bf16 products (exact in float32) summed in float32; the
# scale enters the exponent as exp2(fma(s, scale·log2 e, -m_safe·scale·log2 e));
# corr = exp2((m_prev - m_safe)·scale·log2 e); l sums the float32 P; P goes
# into the second product split as bf16(P) + bf16(P - bf16(P)).  The guards
# are the reference's.  The emulation below repeats that arithmetic with
# torch on the CPU, so the design's numerics are held to the reference here,
# where the kernel itself cannot run.

_TILE = 128


def _emulate_bf16_kernel(q, k, v, *, causal=True, window=None, split_p=True):
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    c = np.float32(1.4426950408889634 / math.sqrt(d))
    qf = q.float()
    kf = k.float().repeat_interleave(h // kv, 1)
    vf = v.float().repeat_interleave(h // kv, 1)
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in reversed(range(0, sk, _TILE)):
        ke = min(k0 + _TILE, sk)
        s = qf @ kf[:, :, k0:ke].transpose(-1, -2)
        kpos = torch.arange(k0, ke)[None, :]
        ok = torch.ones((sq, ke - k0), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= -5e29, 0.0, m_new)
        corr = torch.where(m <= -5e29, 0.0, torch.exp2((m - m_safe) * c))
        sub = (m_safe * c)[..., None]
        p = torch.exp2((s.double() * float(c) - sub.double()).float())   # one rounding: fmaf
        l = l * corr + p.sum(-1)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float() if split_p else torch.zeros_like(p)
        o = o * corr[..., None] + p_hi @ vf[:, :, k0:ke] + p_lo @ vf[:, :, k0:ke]
        m = m_new
    l = torch.where(l == 0, 1.0, l)
    return (o / l[..., None]).to(q.dtype)


def _bf16_case(seed, q_shape, kv_shape, q_scale=1.0, v_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape).astype(np.float32) * q_scale
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32) * v_scale
    return tuple(np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))


def _emulation_against_reference(q, k, v, split_p=True, **kw):
    """The emulation's output and the Pallas kernel's (interpret mode), both
    as float32 numpy arrays."""
    want = np.asarray(jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                           interpret=True, **kw), np.float32)
    got = _emulate_bf16_kernel(*(_to_torch(a) for a in (q, k, v)), causal=kw.get("causal", True),
                               window=kw.get("window"), split_p=split_p)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    assert torch.isfinite(got).all()
    return got.float().numpy(), want


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
def test_bf16_kernel_arithmetic_sweep_matches_reference(b, h, kv, sq, sk, d, causal):
    q, k, v = _bf16_case(b * 100 + h, (b, h, sq, d), (b, kv, sk, d))
    got, want = _emulation_against_reference(q, k, v, causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("window", [32, 96])
def test_bf16_kernel_arithmetic_window_matches_reference(window):
    q, k, v = _bf16_case(5, (1, 2, 256, 64), (1, 2, 256, 64))
    got, want = _emulation_against_reference(q, k, v, window=window, block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_bf16_kernel_arithmetic_fully_masked_rows_are_zero():
    q, k, v = _bf16_case(6, (1, 2, 256, 64), (1, 1, 128, 64))
    got, want = _emulation_against_reference(q, k, v, causal=True, window=32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert (got[:, :, 159:] == 0).all() and (np.abs(got[:, :, :159]).sum(-1) > 0).all()


def test_bf16_kernel_arithmetic_ragged_tile_matches_reference():
    # Sq = Sk = 96: one ragged 128-key tile with zero-filled rows past Sk
    q, k, v = _bf16_case(7, (2, 4, 96, 32), (2, 2, 96, 32))
    got, want = _emulation_against_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("split_p", [True, False])
def test_bf16_kernel_arithmetic_at_large_magnitudes(split_p):
    """q ×8, v ×8: scores reach hundreds and outputs |x| ≥ 8.  The split P
    holds the bar of the card's check on a real layer, 2e-2 plus one bf16
    rounding step of the element; a single bf16 rounding of P misses it,
    so this case tells the two designs apart."""
    q, k, v = _bf16_case(12, (1, 8, 512, 128), (1, 2, 512, 128), q_scale=8.0, v_scale=8.0)
    got, want = _emulation_against_reference(q, k, v, split_p=split_p, causal=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), np.finfo(np.float32).tiny))) - 7)
    assert np.abs(want).max() >= 8
    within = (np.abs(got - want) <= 2e-2 + ulp).all()
    assert within == split_p, float(np.abs(got - want).max())
