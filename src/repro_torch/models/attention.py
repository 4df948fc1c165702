"""GQA attention, reference path: the counterpart of ``repro/models/attention.py``.

Only ``impl="reference"`` is ported: full (B, H, Q, S) score
materialization with plain tensor ops.  Precision points follow the
reference: scores and softmax in float32, probabilities cast to ``v``'s
dtype before the PV product.  The chunked paths and the flash-attention
kernel are later slices (ROADMAP queue 1 step 12, kernel K4).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["multihead_attention"]

_NEG_INF = -1e30


def _mask(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    causal: bool,
    window: Optional[int],
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
    impl: str = "reference",
) -> torch.Tensor:
    """GQA attention.

    Args:
      q: (B, Q, H, D); k/v: (B, S, KV, D) with H % KV == 0.
      q_positions/k_positions: (B, Q) / (B, S) absolute positions (drive the
        causal/window masks; RoPE is applied by the caller).
    Returns:
      (B, Q, H, D).
    """
    if impl != "reference":
        raise ValueError(
            f"attention impl {impl!r} is not ported yet (only 'reference'); "
            "ROADMAP queue 1 step 12"
        )
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    scale = d ** -0.5
    qg = q.reshape(b, sq, n_kv, h // n_kv, d) * scale  # (B, Q, KV, G, D)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float())
    m = _mask(q_positions, k_positions, causal, window)
    scores = torch.where(m[:, None, None], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, d)
