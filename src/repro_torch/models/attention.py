"""GQA attention: the counterpart of ``repro/models/attention.py``.

Implementations (selected by ``impl``):
  * "reference"    — full (B, H, Q, S) score materialization.  Oracle + small-S.
  * "chunked"      — online softmax over KV chunks (the flash algorithm in
    plain tensor ops; the reference's ``lax.scan`` is a Python loop):
    O(Q × chunk) score memory.  The serving prefill takes it.
  * "chunked_skip" — "chunked" per q block over only the KV range its
    causal/window mask can reach.
Any other name raises, "pallas" included, as in the reference; the
hand-written kernel K4 is the entry point ``repro_torch.kernels.flash_attention``.

Precision points follow the reference: scores and softmax in float32; the
reference path casts probabilities to ``v``'s dtype before the PV product,
the chunked paths accumulate PV in float32 and cast at the end.  Supports
causal masking, sliding windows, GQA head grouping, a key-validity mask,
and single-token decode against a (optionally ring-buffered) KV cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import at_least_f32

__all__ = [
    "head_padding",
    "multihead_attention",
    "decode_attention",
    "cache_update",
    "KVCache",
]

_NEG_INF = -1e30


def head_padding(n_heads: int, n_kv: int, tp: int, *, pad_kv: bool = False
                 ) -> tuple[int, int, int]:
    """The reference's grouped head padding for a ``tp``-way model axis:
    (h_pad, kv_pad, group_pad) with h_pad = kv_pad · group_pad.  At tp = 1
    nothing is padded: (n_heads, n_kv, n_heads // n_kv)."""
    group = n_heads // max(n_kv, 1)
    kv_pad = n_kv
    if pad_kv and n_kv % tp:
        kv_pad = -(-n_kv // tp) * tp
    g_pad = group
    while (kv_pad * g_pad) % tp:
        g_pad += 1
    return kv_pad * g_pad, kv_pad, g_pad


def _mask(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool,
    window: Optional[int],
    k_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Boolean (..., Q, S) mask of allowed attention pairs."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    if k_valid is not None:
        m &= k_valid[..., None, :]
    return m


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    k_valid: Optional[torch.Tensor] = None,
    impl: str = "reference",
    chunk_size: int = 1024,
) -> torch.Tensor:
    """GQA attention.

    Args:
      q: (B, Q, H, D); k/v: (B, S, KV, D) with H % KV == 0.
      q_positions/k_positions: (B, Q) / (B, S) absolute positions (drive the
        causal/window masks; RoPE is applied by the caller).
      k_valid: optional (B, S) validity mask (cache slots in use).
    Returns:
      (B, Q, H, D).
    """
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    scale = d ** -0.5
    qg = q.reshape(b, sq, n_kv, h // n_kv, d) * scale  # (B, Q, KV, G, D)

    if impl == "reference":
        scores = torch.einsum("bqhgd,bshd->bhgqs", at_least_f32(qg), at_least_f32(k))
        m = _mask(q_positions, k_positions, causal, window, k_valid)
        scores = torch.where(m[:, None, None], scores, _NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype), v)
        return out.reshape(b, sq, h, d)

    if impl == "chunked":
        return _chunked_attention(
            qg, k, v, q_positions, k_positions, causal, window, k_valid, chunk_size
        ).reshape(b, sq, h, d)

    if impl == "chunked_skip":
        # Causal block skipping: q processed in blocks, each attending only
        # to its kv prefix (and, with a window, only the kv suffix in range).
        # Assumes aligned, monotone positions (training/prefill layout).
        s = k.shape[1]
        qb = max(chunk_size, 1)
        outs = []
        for i in range(-(-sq // qb)):
            hi = min((i + 1) * qb, s) if causal else s
            lo = max(0, i * qb - (window or 0)) if window is not None else 0
            outs.append(
                _chunked_attention(
                    qg[:, i * qb : (i + 1) * qb],
                    k[:, lo:hi],
                    v[:, lo:hi],
                    q_positions[:, i * qb : (i + 1) * qb],
                    k_positions[:, lo:hi],
                    causal,
                    window,
                    None if k_valid is None else k_valid[:, lo:hi],
                    chunk_size,
                )
            )
        return torch.cat(outs, dim=1).reshape(b, sq, h, d)

    raise ValueError(f"unknown attention impl {impl!r}")


def _chunked_attention(
    qg, k, v, q_pos, k_pos, causal, window, k_valid, chunk: int
) -> torch.Tensor:
    """Online-softmax (flash) over KV chunks; O(Q * chunk) score memory."""
    b, sq, n_kv, g, d = qg.shape
    s = k.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
        valid = torch.ones((b, s), dtype=torch.bool, device=k.device) if k_valid is None else k_valid
        k_valid = F.pad(valid, (0, pad), value=False)

    qf = qg.float()
    m = torch.full((b, n_kv, g, sq), _NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((b, sq, n_kv, g, d), dtype=torch.float32, device=qg.device)
    for a in range(0, k.shape[1], chunk):
        kb = k[:, a : a + chunk].float()
        vb = v[:, a : a + chunk].float()
        valb = None if k_valid is None else k_valid[:, a : a + chunk]
        scores = torch.einsum("bqhgd,bshd->bhgqs", qf, kb)
        msk = _mask(q_pos, k_pos[:, a : a + chunk], causal, window, valb)  # (B, Q, C)
        scores = torch.where(msk[:, None, None], scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
        p = torch.exp(scores - m_safe[..., None])
        p = torch.where(msk[:, None, None], p, 0.0)
        dead = m <= _NEG_INF / 2
        corr = torch.exp(torch.where(dead, _NEG_INF, m) - m_safe)
        corr = torch.where(dead, 0.0, corr)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqs,bshd->bqhgd", p, vb)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
        del scores, p, pv
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype)


# ---------------------------------------------------------------------------
# KV cache & decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Per-layer KV cache.

    k/v: (L, B, S_slots, KV, D).  For sliding-window archs ``S_slots`` is the
    window and slots are a ring buffer indexed by ``pos % window``;
    otherwise ``S_slots == max_seq`` and slot == absolute position.
    ``positions``: (L, B, S_slots) absolute position stored in each slot
    (-1 = empty).  RoPE is applied to K *before* caching.
    """

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor

    @property
    def n_slots(self) -> int:
        return self.k.shape[2]

    @classmethod
    def empty(cls, n_layers, batch, n_slots, n_kv, d_head, dtype=torch.bfloat16,
              device=None):
        shape = (n_layers, batch, n_slots, n_kv, d_head)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            positions=torch.full((n_layers, batch, n_slots), -1, dtype=torch.int32,
                                 device=device),
        )


def cache_update(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: int,
    *,
    ring: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert one step (B, 1, KV, D) at absolute position ``pos``.

    Unlike the reference's functional update, the cache tensors are
    written IN PLACE (a decode step then copies no cache) and returned."""
    pos = int(pos)
    n_slots = cache_k.shape[1]
    slot = pos % n_slots if ring else min(pos, n_slots - 1)
    cache_k[:, slot] = k_new[:, 0]
    cache_v[:, slot] = v_new[:, 0]
    cache_pos[:, slot] = pos
    return cache_k, cache_v, cache_pos


def decode_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,
    *,
    pos: int,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention against the cache.

    q: (B, 1, H, D); cache_k/v: (B, S_slots, KV, D); cache_pos: (B, S_slots).
    ``pos``: absolute position of the query token.
    """
    pos = int(pos)
    b = q.shape[0]
    q_positions = torch.full((b, 1), pos, dtype=torch.int32, device=q.device)
    valid = cache_pos >= 0
    if window is not None:
        valid &= cache_pos > pos - window
    return multihead_attention(
        q,
        cache_k,
        cache_v,
        q_positions=q_positions,
        k_positions=cache_pos.clamp_min(0),
        causal=True,
        window=window,
        k_valid=valid,
        impl="reference",
    )
