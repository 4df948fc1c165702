"""Chunked linear recurrences for the SSM families: the counterpart of
``repro/models/recurrence.py``.

Two exact chunked algorithms (chunk-parallel within a chunk, a Python loop
across chunks where the reference runs ``lax.scan``):

  * ``rwkv_chunked`` — vector (per-channel) decay with a bonus term
        S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
        o_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    (the RWKV6 "Finch" WKV recurrence; the decay w_t is data-dependent).

  * ``ssd_chunked`` — scalar-per-head decay (Mamba2 SSD)
        h_t = a_t h_{t-1} + dt_t · x_t B_tᵀ
        y_t = h_t C_t + D ⊙ x_t       (a_t = exp(dt_t A) ∈ (0, 1))
    with B and C shared by every head (one group) or given per group:
    head j of H reads group ⌊j·G/H⌋ of G (the heads group-major, as
    Mamba2's ``ngroups`` lays them out).

Both express intra-chunk interactions with pairwise relative decays
``exp(la_t - la_s), s ≤ t`` where ``la = cumsum(log decay)``: every exponent
is ≤ 0, so nothing overflows at any chunk length.  The pairs above the
diagonal are set to -inf BEFORE the ``exp`` (after it, inf · 0 would give
NaN in the backward pass).  The math is float32 whatever the inputs' dtype,
with the reference's padding of the sequence to a multiple of the chunk
(float64 inputs stay float64, for precision checks).

The single-step ``*_step`` variants drive decode; ``*_scan_reference`` are
the step-by-step oracles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import at_least_f32 as _f32

__all__ = [
    "rwkv_chunked",
    "rwkv_step",
    "rwkv_scan_reference",
    "ssd_chunked",
    "ssd_step",
    "ssd_scan_reference",
]


def _chunk(x: torch.Tensor, c: int) -> torch.Tensor:
    """(B, L, ...) -> (n, B, c, ...): chunk-major (L % c == 0)."""
    b, l = x.shape[:2]
    return x.reshape(b, l // c, c, *x.shape[2:]).transpose(0, 1)


def _unchunk(x: torch.Tensor) -> torch.Tensor:
    """(n, B, c, ...) -> (B, L, ...)."""
    n, b, c = x.shape[:3]
    return x.transpose(0, 1).reshape(b, n * c, *x.shape[3:])


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) by ``pad`` at the end."""
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


# ---------------------------------------------------------------------------
# RWKV6: vector decay + bonus
# ---------------------------------------------------------------------------

def rwkv_chunked(r, k, v, logw, u, s0, *, chunk: int = 32):
    """Args:
      r/k/v: (B, L, H, N); logw: (B, L, H, N) (log decay, ≤ 0);
      u: (H, N) bonus; s0: (B, H, N, N) initial state (k-dim × v-dim).
    Returns: (o (B, L, H, N) in v's dtype, s_final in float32).
    """
    b, l, h, n = r.shape
    c = min(chunk, l)
    pad = (-l) % c
    rf, kf, vf, lw = (_chunk(_f32(_pad_seq(t, pad)), c) for t in (r, k, v, logw))
    uf = _f32(u)
    tri_strict = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), -1)
    tri_strict = tri_strict[None, :, :, None, None]

    s = s0.to(rf.dtype)
    outs = []
    for rc, kc, vc, lwc in zip(rf, kf, vf, lw):      # each (B, c, H, N)
        la = torch.cumsum(lwc, dim=1)                # inclusive: Σ_{j<=t} logw_j
        la_prev = la - lwc                           # exclusive: Σ_{j<t}
        # pairwise per-channel decay exp(la_prev_t - la_s), strictly lower
        dmat = la_prev[:, :, None] - la[:, None, :, :, :]          # (B, t, s, H, N)
        dmat = torch.where(tri_strict, dmat, float("-inf"))
        scores = torch.einsum("bthn,bshn,btshn->bths", rc, kc, torch.exp(dmat))
        diag = torch.einsum("bthn,hn,bthn->bth", rc, uf, kc)
        o = torch.einsum("bths,bshn->bthn", scores, vc)
        o = o + diag[..., None] * vc
        # inter-chunk: r_t diag(exp(la_prev_t)) S
        o = o + torch.einsum("bthn,bhnm->bthm", rc * torch.exp(la_prev), s)
        # state: S' = diag(exp(la_C)) S + Σ_s exp(la_C - la_s) k_s v_sᵀ
        la_end = la[:, -1:]                          # (B, 1, H, N)
        k_scaled = kc * torch.exp(la_end - la)
        s = torch.exp(la_end[:, 0])[..., None] * s + torch.einsum(
            "bshn,bshm->bhnm", k_scaled, vc)
        outs.append(o)
    o = _unchunk(torch.stack(outs))[:, :l]
    return o.to(v.dtype), s


def rwkv_step(r, k, v, logw, u, s):
    """Single decode step. r/k/v/logw: (B, H, N); s: (B, H, N, N)."""
    rf, kf, vf = _f32(r), _f32(k), _f32(v)
    sf = s.to(rf.dtype)
    kv = kf[..., :, None] * vf[..., None, :]           # (B, H, N, N)
    o = torch.einsum("bhn,bhnm->bhm", rf, sf + _f32(u)[..., None] * kv)
    s_new = torch.exp(_f32(logw))[..., None] * sf + kv
    return o.to(v.dtype), s_new


def rwkv_scan_reference(r, k, v, logw, u, s0):
    """Step-by-step oracle (tests)."""
    s = _f32(s0)
    outs = []
    for t in range(r.shape[1]):
        o, s = rwkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, s)
        outs.append(o)
    return torch.stack(outs, dim=1), s


# ---------------------------------------------------------------------------
# Mamba2 SSD: scalar-per-head decay
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, a_log, b_in, c_in, d_skip, h0, *, chunk: int = 64):
    """Args:
      x: (B, L, H, P); dt: (B, L, H) (post-softplus, > 0);
      a_log: (H,) (A = -exp(a_log) < 0); b_in/c_in: (B, L, N) (one group)
        or (B, L, G, N) (head j reads group j·G // H: ``_ssd_groups``);
      d_skip: (H,); h0: (B, H, P, N).
    Returns: (y (B, L, H, P) in x's dtype, h_final float32).
    """
    b, l, h, p = x.shape
    c = min(chunk, l)
    pad = (-l) % c
    a = -torch.exp(_f32(a_log))                    # (H,)
    if b_in.dim() == 4:
        y, hst = _ssd_groups(*(_f32(_pad_seq(t, pad)) for t in (x, dt, b_in, c_in)), a,
                             h0, c)
        y = y[:, :l]
    else:
        y, hst = _ssd_one_group(x, dt, a, b_in, c_in, h0, c, pad)
    y = y + _f32(d_skip)[None, None, :, None] * _f32(x)
    return y.to(x.dtype), hst


def _ssd_one_group(x, dt, a, b_in, c_in, h0, c: int, pad: int):
    """B and C shared by every head: the chunks in turn."""
    l = x.shape[1]
    xf, dtf, bf, cf = (_chunk(_f32(_pad_seq(t, pad)), c) for t in (x, dt, b_in, c_in))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))[None, :, :, None]

    hst = h0.to(xf.dtype)
    outs = []
    for xc, dtc, bc, cc in zip(xf, dtf, bf, cf):     # (B,c,H,P), (B,c,H), (B,c,N)
        la = torch.cumsum(dtc * a, dim=1)            # (B, c, H), ≤ 0, decreasing
        dmat = la[:, :, None] - la[:, None, :, :]    # (B, t, s, H) ≤ 0 for s <= t
        dmat = torch.where(tri, dmat, float("-inf"))
        cb = torch.einsum("btn,bsn->bts", cc, bc)
        scores = cb[..., None] * torch.exp(dmat) * dtc[:, None]    # (B, t, s, H)
        y = torch.einsum("btsh,bshp->bthp", scores, xc)
        # inter-chunk: y_t += C_t · exp(la_t) h0   (h: (B, H, P, N))
        y = y + torch.einsum("btn,bhpn,bth->bthp", cc, hst, torch.exp(la))
        # state update
        la_end = la[:, -1:]                          # (B, 1, H)
        w = torch.exp(la_end - la) * dtc             # (B, c, H)
        hst = torch.exp(la_end[:, 0])[..., None, None] * hst + torch.einsum(
            "bshp,bsn,bsh->bhpn", xc, bc, w)
        outs.append(y)
    return _unchunk(torch.stack(outs))[:, :l], hst


def _ssd_groups(x, dt, b_in, c_in, a, h0, c: int):
    """B and C in G groups, heads group-major (H = G·Q): every chunk at
    once, float32.  x: (B, L, H, P); dt: (B, L, H); b_in/c_in: (B, L, G,
    N); L a multiple of the chunk ``c``.  Within a chunk the pairs' decays
    exp(la_t − la_s) (la the chunk's cumulative dt·A); across chunks the
    states a chunk enters with, E_z = Σ_{i ≤ z} exp(Σ_{i ≤ r < z} T_r) U_i
    over U = [h0, the chunks' own states] and T the chunks' total log
    decays, summed term by term for each pair (a segment sum)."""
    b, l, h, p = x.shape
    g, n = b_in.shape[2:]
    q, k = h // g, l // c
    # (B, k chunks, G, Q, c, ...): each (group, head) a batch of chunk products
    xq = x.view(b, k, c, g, q, p).permute(0, 1, 3, 4, 2, 5)
    dq = dt.view(b, k, c, g, q).permute(0, 1, 3, 4, 2)
    bq = b_in.view(b, k, c, g, n).transpose(2, 3)            # (B, k, G, c, N)
    cq = c_in.view(b, k, c, g, n).transpose(2, 3)
    la = torch.cumsum(dq * a.view(g, q, 1), dim=-1)          # (B, k, G, Q, c) ≤ 0
    later = torch.ones((c, c), dtype=torch.bool, device=x.device).triu(1)
    decay = torch.exp((la[..., :, None] - la[..., None, :]).masked_fill_(later, float("-inf")))
    xdt = xq * dq[..., None]                                 # dt_s x_s
    y = ((cq @ bq.transpose(-1, -2))[:, :, :, None] * decay) @ xdt    # (B, k, G, Q, c, P)
    # each chunk's own state, from zero: Σ_s exp(la_end − la_s) dt_s x_s B_sᵀ
    w = torch.exp(la[..., -1:] - la)
    states = (xdt * w[..., None]).transpose(-1, -2) @ bq[:, :, :, None]  # (B, k, G, Q, P, N)
    tp = F.pad(la[..., -1].movedim(1, -1), (1, 0))           # (B, G, Q, k+1): 0, T_0..T_{k-1}
    steps = tp[..., :, None].expand(*tp.shape, k + 1)        # [z, i] = tp_z
    first = torch.ones((k + 1, k + 1), dtype=torch.bool, device=x.device)
    seg = torch.cumsum(steps.masked_fill(first.triu(), 0.0), dim=-2)    # Σ_{i<m≤z} tp_m
    mix = torch.exp(seg.masked_fill(first.triu(1), float("-inf")))      # (B, G, Q, z, i)
    src = torch.cat([h0.to(x.dtype).view(b, 1, g, q, p, n), states], dim=1)
    entered = torch.einsum("bgqzi,bigqpn->bzgqpn", mix, src)  # (B, k+1, G, Q, P, N)
    y = y + (cq[:, :, :, None] @ entered[:, :k].transpose(-1, -2)) * torch.exp(la)[..., None]
    return y.permute(0, 1, 4, 2, 3, 5).reshape(b, l, h, p), entered[:, k].reshape(b, h, p, n)


def ssd_step(x, dt, a_log, b_in, c_in, d_skip, h):
    """Single decode step. x: (B, H, P); dt: (B, H); b/c: (B, N); h: (B, H, P, N)."""
    xf = _f32(x)
    a = -torch.exp(_f32(a_log))
    decay = torch.exp(_f32(dt) * a)                # (B, H)
    h_new = decay[..., None, None] * h.to(xf.dtype) + torch.einsum(
        "bhp,bn,bh->bhpn", xf, _f32(b_in), _f32(dt))
    y = torch.einsum("bhpn,bn->bhp", h_new, _f32(c_in))
    y = y + _f32(d_skip)[None, :, None] * xf
    return y.to(x.dtype), h_new


def ssd_scan_reference(x, dt, a_log, b_in, c_in, d_skip, h0):
    """Step-by-step oracle (tests)."""
    h = _f32(h0)
    outs = []
    for t in range(x.shape[1]):
        y, h = ssd_step(x[:, t], dt[:, t], a_log, b_in[:, t], c_in[:, t], d_skip, h)
        outs.append(y)
    return torch.stack(outs, dim=1), h
