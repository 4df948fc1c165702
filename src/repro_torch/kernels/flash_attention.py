"""Forward flash attention (kernel K4): causal, GQA, optional sliding window.

The counterpart of ``repro/kernels/flash_attention.py::flash_attention``,
with the reference's layouts and signature:

  q:    (B, H, Sq, D)
  k/v:  (B, KV, Sk, D)      (GQA: query head h reads KV head h // (H // KV))
  out:  (B, H, Sq, D), q's dtype

Scores use scale 1/√D in float32; the mask allows ``k <= q`` when causal and
``k > q - window`` with a window (positions are the row indices); a row
with no allowed key gives 0.  ``block_q``/``block_k`` keep the reference's
tiling check (it raises on exactly the same inputs); the CUDA kernels
(``csrc/flash_attention.cu``) tile by their own blocks and mask their
ragged edges: bfloat16 runs on the tensor cores (``wgmma``, TMA, 128-row q
tiles × 128-key tiles), float32 on the CUDA cores (64 × 64 tiles).  CUDA
tensors launch the kernel of their dtype, count the launch in
``flash_attention.launches`` and bill it to the active op accounting
(``kernels/cost.py``); CPU tensors take the plain twin; ``meta`` tensors
(the dry run) are checked and billed, and give an output of q's shape
without a launch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.analysis.budget import check_kernel_budget
from repro_torch.kernels import _build, cost

__all__ = ["flash_attention", "flash_attention_plain"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
# |window| beyond any sequence length the kernel takes (an int32 argument)
_WINDOW_CLAMP = 1 << 30
# f32 score elements per q-row chunk of the plain twin (1 GiB)
_PLAIN_SCORES = 1 << 28


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain twin (``repro/kernels/ref.py::flash_attention_ref``), in
    q-row chunks so that its float32 scores stay near 1 GiB at any length."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    group = h // kv
    kf, vf = k.float(), v.float()
    kpos = torch.arange(sk, device=q.device)[None, :]
    rows = max(1, _PLAIN_SCORES // max(b * h * sk, 1))
    out = torch.empty_like(q)
    for a in range(0, sq, rows):
        e = min(a + rows, sq)
        qg = q[:, :, a:e].reshape(b, kv, group, e - a, d).float() / math.sqrt(d)
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
        qpos = torch.arange(a, e, device=q.device)[:, None]
        mask = torch.ones((e - a, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, _NEG_INF)
        p = torch.softmax(s, dim=-1)
        # fully-masked rows -> zero output
        p = torch.where(mask.any(-1)[:, None], p, 0.0)
        o = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
        out[:, :, a:e] = o.reshape(b, h, e - a, d).to(q.dtype)
        del qg, s, p, o
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) with H % KV == 0 -> (B, H, Sq, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be (B, H, Sq, D) and k, v one (B, KV, Sk, D) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"query heads {h} must be a multiple of KV heads {kv}")
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"seq lens ({sq},{sk}) must tile by ({bq},{bk})")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v lie on different devices: {q.device}, {k.device}, {v.device}")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or q.dtype not in _DTYPES:
        raise TypeError(
            f"q, k, v must share one dtype of float32, bfloat16; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    check_kernel_budget("flash_attention", dtype=str(q.dtype).split(".")[-1], b=b, h=h,
                        sq=sq, d=d)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 16-byte boundaries")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (one of {_HEAD_DIMS})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    billed = cost.k4_cost(b, h, kv, sq, sk, d, q.element_size(), causal=causal, window=window)
    if q.device.type == "meta":
        cost.bill("flash_attention", *billed)
        return out
    fn = _build.load("flash_attention").repro_flash_attention
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, sq, sk, d, int(causal), int(window is not None),
            0 if window is None else max(-_WINDOW_CLAMP, min(int(window), _WINDOW_CLAMP)),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    cost.bill("flash_attention", *billed)
    return out


flash_attention.launches = 0
