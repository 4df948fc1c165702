"""Plain-PyTorch oracles of the ported kernels: the counterpart of
``repro/kernels/ref.py``.

Each is a kernel's plain twin under the reference's signature, so the
arithmetic lives in one place."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.gossip_update import gossip_update_plain
from repro_torch.kernels.stats import segment_l2_norms_plain

__all__ = ["flash_attention_ref", "gossip_update_ref", "l2_norms_ref"]


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D).  K4's twin."""
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def gossip_update_ref(
    theta: torch.Tensor,       # (P,) this node's post-backward params
    neighbors: torch.Tensor,   # (deg, P) neighbor params (post their updates)
    weights: torch.Tensor,     # (deg + 1,): [self, n_1, ..., n_deg]
    grad: torch.Tensor,        # (P,)
    momentum: torch.Tensor,    # (P,)
    *,
    lr: float,
    beta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused decentralized-SGD apply for one node:

      m'     = beta * m + g
      theta* = theta - lr * m'          (local descent)
      theta' = w_0 * theta* + sum_i w_i * n_i   (gossip average)

    K2's twin with the all-ones fault row."""
    w = weights.float()
    return gossip_update_plain(theta, neighbors, w, grad, momentum,
                               lr=lr, beta=beta, fault=torch.ones_like(w))


def l2_norms_ref(x: torch.Tensor) -> torch.Tensor:
    """Row L2 norms of a (R, P) matrix -> (R,) float32 (DBench probe)."""
    return segment_l2_norms_plain(x, (0, x.shape[1]))[:, 0]
