"""The plain reference of the benchmarked training step, in float32
PyTorch (TF32 off), written from the model's and the algorithm's
description and independent of the program: it imports nothing of
``repro_torch``, ``repro`` or JAX, and takes nothing the program made.

What it computes, for G nodes of a decentralized ring (d_ring):

* the model: token embedding → per layer RMSNorm, GQA attention with RoPE
  (rotate-half, θ = ``rope_theta``) under a causal mask, RMSNorm and a
  gated SiLU MLP or a top-k mixture of experts with a capacity (first come
  first served in token order; assignments past it are dropped) and the
  load-balance loss E·Σ f_e p_e → final RMSNorm → output head →
  next-token cross-entropy over the valid targets (+ ``aux_loss_weight``
  × the layers' load-balance losses);
* each node's loss and gradients on its own batch, one node at a time;
* momentum SGD (m ← β m + g, from m = 0) and the gossip mix of the
  post-update parameters: θ'_i = W_ii (θ_i − lr m'_i) + Σ_j W_ij θ*_j,
  with the sent rows θ*_j = θ_j − lr m'_j, under the ring's
  Metropolis–Hastings weights (1/3 each);
* the probe: every node's per-leaf L2 norms of θ before the update.

The state is stored in the dtypes the configuration states (θ, the
gradient and the sent rows in the model dtype, m in float32); every
operation on it runs in float32.  ``quant="fp8"`` computes every matrix
product as a float8 training step does (``_product``: the operands in
e4m3, the gradient arriving at the product in e5m2, each under a
per-tensor scale): the control, one precision below the configuration's
bfloat16.  ``fault`` plants one of
the faults a benchmark run must catch (``FAULTS``).

``draw_weights`` makes the initial weights from a seed on the device; the
benchmark hands the same ones to the program and to this reference.
"""
from __future__ import annotations

import hashlib
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["FAULTS", "DTYPES", "sub_seed", "leaf_table", "leaf_sizes", "draw_weights", "ring_weights",
           "mixing_matrix", "loss_fn", "Readings", "ReferenceTrainer", "run_reference", "leaf_norms"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# faults a run must catch: a step that leaves the state as it was; half of
# every node's batch left out (the mean over the rest); the exchange
# between the nodes left out; the probe's answers shifted by one leaf (as
# a wrong offsets table would give them)
FAULTS = ("unchanged", "half_batch", "no_mix", "probe_shift")
_NEG = -1e30


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``"weights"``, ``"traffic"``) of a run's
    seed: the same seed gives the same draws, and no two uses share one."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def head_dim(cfg: Mapping) -> int:
    return cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]


def leaf_table(cfg: Mapping) -> dict:
    """name -> (shape, std or None for ones), in the flat order the
    parameters are laid out (sorted paths, depth first).  Matrices are
    drawn normal with std √(2 / fan-in), the embedding and the head with
    std 0.02, the norms' gains are ones."""
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    h, kv, dh = cfg["n_heads"], cfg["n_kv"], head_dim(cfg)
    he = lambda fan_in: math.sqrt(2.0 / fan_in)
    if cfg.get("n_experts"):
        e = cfg["n_experts"]
        ffn = {"blocks.ffn.router": ((n, d, e), 0.02),
               "blocks.ffn.w_down": ((n, e, f, d), he(f)),
               "blocks.ffn.w_gate": ((n, e, d, f), he(d)),
               "blocks.ffn.w_up": ((n, e, d, f), he(d))}
    else:
        ffn = {"blocks.ffn.w_down": ((n, f, d), he(f)),
               "blocks.ffn.w_gate": ((n, d, f), he(d)),
               "blocks.ffn.w_up": ((n, d, f), he(d))}
    return {**ffn,
            "blocks.ln1.g": ((n, d), None),
            "blocks.ln2.g": ((n, d), None),
            "blocks.wk": ((n, d, kv, dh), he(d)),
            "blocks.wo": ((n, h, dh, d), he(h * dh)),
            "blocks.wq": ((n, d, h, dh), he(d)),
            "blocks.wv": ((n, d, kv, dh), he(d)),
            "embed": ((v, d), 0.02),
            "final_norm.g": ((d,), None),
            "head": ((d, v), 0.02)}


def leaf_sizes(cfg: Mapping) -> list[int]:
    """Each leaf's parameter count, in leaf order."""
    return [math.prod(shape) for shape, _ in leaf_table(cfg).values()]


def draw_weights(cfg: Mapping, seed: int, device, dtype) -> dict:
    """One replica's initial weights in ``dtype``, drawn on ``device`` from
    ``seed``: one normal draw a leaf, in the table's order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    out = {}
    for name, (shape, std) in leaf_table(cfg).items():
        if std is None:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            out[name] = x.mul_(std).to(dtype)
            del x
    return out


def ring_weights(n: int) -> np.ndarray:
    """The ring's Metropolis–Hastings mixing matrix: 1/3 to self and to
    each of the two neighbours."""
    if n < 3:
        raise ValueError(f"a ring of {n} nodes has no two distinct neighbours")
    w = np.zeros((n, n))
    for i in range(n):
        for j in (i - 1, i, i + 1):
            w[i, j % n] += 1.0 / 3.0
    return w


def mixing_matrix(topology: str, n: int) -> np.ndarray:
    """The mixing matrix of a traffic file's ``topology``: the ring's is
    the only one the reference builds."""
    if topology != "d_ring":
        raise ValueError(f"topology {topology!r}: the reference builds d_ring's weights only")
    return ring_weights(n)


# ---------------------------------------------------------------------------
# the model, one node
# ---------------------------------------------------------------------------

def _round8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to a float8 ``dtype`` under one per-tensor scale that
    maps its largest magnitude to ``top``."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Operand(torch.autograd.Function):
    """A matmul operand in float8 e4m3, straight through in the backward."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """A matmul's output as it is; the gradient arriving at it in float8
    e5m2, as the backward's products take it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def _product(quant: Optional[str]):
    """``mm(eq, a, b)``: an einsum of two operands, in float32, or with
    ``quant="fp8"`` as a float8 training step computes it (operands in e4m3,
    the output's gradient in e5m2, each under a per-tensor scale)."""
    if quant is None:
        return torch.einsum
    if quant != "fp8":
        raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
    return lambda eq, a, b: _Fp8Grad.apply(
        torch.einsum(eq, _Fp8Operand.apply(a), _Fp8Operand.apply(b)))


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of (B, S, H, Dh) at positions 0..S−1."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _moe(x, p, l, cfg, mm):
    """Top-k experts with capacity on (T, D) tokens: (out, load-balance loss)."""
    t = x.shape[0]
    e, k = cfg["n_experts"], cfg["top_k"]
    logits = mm("td,de->te", x, p["blocks.ffn.router"][l])
    probs = torch.softmax(logits, dim=-1)
    top_p, ids = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    counts = torch.bincount(ids.reshape(-1), minlength=e).to(probs.dtype)
    aux = e * torch.sum(counts / (t * k) * probs.mean(dim=0))
    cap = int(max(k * t * cfg["capacity_factor"] / e, 4))
    flat_ids, flat_p = ids.reshape(-1), top_p.reshape(-1)
    out = torch.zeros_like(x)
    for ex in range(e):
        a = torch.nonzero(flat_ids == ex)[:, 0][:cap]   # token order: first come first served
        tok = a // k
        xe = x[tok]
        hid = F.silu(mm("td,df->tf", xe, p["blocks.ffn.w_gate"][l, ex])) \
            * mm("td,df->tf", xe, p["blocks.ffn.w_up"][l, ex])
        out = out.index_add(0, tok, mm("tf,fd->td", hid, p["blocks.ffn.w_down"][l, ex])
                            * flat_p[a, None])
    return out, aux


def loss_fn(p: Mapping, cfg: Mapping, tokens: torch.Tensor, targets: torch.Tensor,
            quant: Optional[str] = None) -> torch.Tensor:
    """One node's loss on its (B, S) batch; ``p`` float32 leaves."""
    mm = _product(quant)
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = p["embed"][tokens.long()]
    b, s, d = h.shape
    nh, kv, dh = cfg["n_heads"], cfg["n_kv"], head_dim(cfg)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    aux = torch.zeros((), device=h.device)
    for l in range(cfg["n_layers"]):
        hn = _rms(h, p["blocks.ln1.g"][l], eps)
        qh = _rope(mm("bsd,dhk->bshk", hn, p["blocks.wq"][l]), theta)
        kh = _rope(mm("bsd,dhk->bshk", hn, p["blocks.wk"][l]), theta)
        vh = mm("bsd,dhk->bshk", hn, p["blocks.wv"][l])
        qg = qh.reshape(b, s, kv, nh // kv, dh) * dh ** -0.5
        scores = mm("bqhgd,bshd->bhgqs", qg, kh)
        att = torch.softmax(torch.where(causal, scores, _NEG), dim=-1)
        out = mm("bhgqs,bshd->bqhgd", att, vh).reshape(b, s, nh, dh)
        h = h + mm("bshk,hkd->bsd", out, p["blocks.wo"][l])
        hn2 = _rms(h, p["blocks.ln2.g"][l], eps)
        if cfg.get("n_experts"):
            ff, a = _moe(hn2.reshape(b * s, d), p, l, cfg, mm)
            h = h + ff.reshape(b, s, d)
            aux = aux + a
        else:
            hid = F.silu(mm("bsd,df->bsf", hn2, p["blocks.ffn.w_gate"][l])) \
                * mm("bsd,df->bsf", hn2, p["blocks.ffn.w_up"][l])
            h = h + mm("bsf,fd->bsd", hid, p["blocks.ffn.w_down"][l])
    logits = mm("bsd,dv->bsv", _rms(h, p["final_norm.g"], eps), p["head"])
    valid = targets >= 0
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, targets.clamp_min(0).long()[..., None])[..., 0]
    loss = torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)
    if cfg.get("n_experts"):
        loss = loss + cfg["aux_loss_weight"] * aux
    return loss


# ---------------------------------------------------------------------------
# the decentralized step over G nodes
# ---------------------------------------------------------------------------

def leaf_norms(buf: torch.Tensor, offsets, *, minus: Optional[torch.Tensor] = None,
               chunk: int = 1 << 26) -> np.ndarray:
    """(rows, n_leaves) float64 L2 norms of every leaf's columns of a
    (rows, P) buffer (of ``buf − minus`` with ``minus`` one (P,) row), in
    float32 over column chunks, so no temporary outgrows one chunk."""
    rows = buf.shape[0]
    out = np.zeros((rows, len(offsets) - 1))
    for r in range(rows):
        for j, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
            sq = torch.zeros((), dtype=torch.float32, device=buf.device)
            for c in range(a, b, chunk):
                x = buf[r, c:min(c + chunk, b)].float()
                if minus is not None:
                    x = x - minus[c:min(c + chunk, b)].float()
                sq = sq + x.square().sum()
            out[r, j] = float(sq.sqrt())
    return out


class Readings(dict):
    """What one side's first steps read: ``losses`` (steps, G); ``probe``
    (steps, G, L) norms; ``grad`` (G, L) norms of the first gradient as the
    optimizer holds it after step 1; ``change`` (G, L) norms of θ's change
    after the last step."""


class ReferenceTrainer:
    """G nodes' state as (G, ...) leaves, stepped one node's gradients at
    a time and mixed leaf by leaf, row by row."""

    def __init__(self, cfg: Mapping, weights: Mapping, nodes: int, *, lr: float, beta: float,
                 topology: str, quant: Optional[str] = None, fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
        self.cfg, self.lr, self.beta, self.quant, self.fault = cfg, lr, beta, quant, fault
        self.dtype = DTYPES[cfg["dtype"]]
        self.names = list(leaf_table(cfg))
        self.theta = {k: weights[k][None].expand(nodes, *weights[k].shape).clone()
                      for k in self.names}
        self.mom = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                    for k, v in self.theta.items()}
        w = np.eye(nodes) if fault == "no_mix" else mixing_matrix(topology, nodes)
        self.mix = [[(j, float(w[i, j])) for j in range(nodes) if w[i, j] and j != i]
                    for i in range(nodes)]
        self.self_w = [float(w[i, i]) for i in range(nodes)]
        self.nodes = nodes

    def probe(self) -> np.ndarray:
        out = np.array([[float(self.theta[k][i].float().norm()) for k in self.names]
                        for i in range(self.nodes)])
        return np.roll(out, 1, axis=1) if self.fault == "probe_shift" else out

    def step(self, tokens: torch.Tensor, targets: torch.Tensor):
        """One step on (G, B, S) batches; returns ((G,) losses, (G, L) probe)."""
        probe = self.probe()
        losses = []
        if self.fault == "half_batch":
            half = tokens.shape[1] // 2
            tokens, targets = tokens[:, :half], targets[:, :half]
        for i in range(self.nodes):
            params = {k: self.theta[k][i].float().requires_grad_() for k in self.names}
            loss = loss_fn(params, self.cfg, tokens[i], targets[i], self.quant)
            grads = torch.autograd.grad(loss, list(params.values()))
            del params
            losses.append(float(loss.detach()))
            if self.fault == "unchanged":
                continue
            for k, g in zip(self.names, grads):
                self.mom[k][i].mul_(self.beta).add_(g.to(self.dtype).float())
            del grads
        if self.fault != "unchanged":
            with torch.no_grad():
                for k in self.names:
                    self._mix_leaf(k)
        return np.array(losses), probe

    def _mix_leaf(self, k: str) -> None:
        th, m, lr = self.theta[k], self.mom[k], self.lr
        wire = torch.empty_like(th)
        for j in range(self.nodes):
            wire[j] = (th[j].float() - lr * m[j]).to(self.dtype)
        for i in range(self.nodes):
            acc = self.self_w[i] * (th[i].float() - lr * m[i])
            for j, wij in self.mix[i]:
                acc = acc + wij * wire[j].float()
            th[i] = acc.to(self.dtype)

    def norms(self, bufs: Mapping, minus: Optional[Mapping] = None) -> np.ndarray:
        """(G, L) norms of each leaf of ``bufs`` (of ``bufs − minus``)."""
        out = np.zeros((self.nodes, len(self.names)))
        for j, k in enumerate(self.names):
            for i in range(self.nodes):
                x = bufs[k][i].float()
                if minus is not None:
                    x = x - minus[k].float()
                out[i, j] = float(x.norm())
        return out


def run_reference(cfg: Mapping, weights: Mapping, batches, *, nodes: int, lr: float,
                  beta: float, topology: str, quant: Optional[str] = None,
                  fault: Optional[str] = None) -> Readings:
    """The reference's readings of the first ``len(batches)`` steps from
    ``weights``; ``batches`` hold (G, B, S) ``tokens`` and ``targets``."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = ReferenceTrainer(cfg, weights, nodes, lr=lr, beta=beta, topology=topology,
                               quant=quant, fault=fault)
        losses, probes, grad = [], [], None
        for t, batch in enumerate(batches):
            loss, probe = ref.step(batch["tokens"], batch["targets"])
            losses.append(loss)
            probes.append(probe)
            if t == 0:
                grad = ref.norms(ref.mom)
        change = ref.norms(ref.theta, minus=weights)
        del ref
        return Readings(losses=np.array(losses), probe=np.array(probes), grad=grad,
                        change=change)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
