"""The plain reference of the benchmarked training step, in float32
PyTorch (TF32 off), written from the algorithm's description and
independent of the program: it imports nothing of ``repro_torch``,
``repro`` or JAX, and takes nothing the program made.

The model is not here: each configuration names its plain reference,
``perfbench/references/<reference>.py`` (``model``), which exports

* ``leaf_table(cfg)``: name -> (shape, init, dtype) in the program's flat
  leaf order; ``init`` a std (one normal draw), None (ones) or a callable
  ``(gen, shape, device) -> float32 tensor`` drawn from the same
  generator in table order; ``dtype`` the leaf's own (a ``DTYPES`` name)
  or None for the configuration's;
* ``loss_fn(p, cfg, tokens, targets, quant=None)``: one node's float32
  loss, every matrix product through ``_product(quant)``;
* ``model_flops_per_step(cfg, *, nodes, per_node_batch, seq, causal=True)``:
  the work the model needs, from shapes alone;
* ``arch_fields(cfg)``: the port's ``ArchConfig`` field values, the dtype
  as its name, raising for whatever ``loss_fn`` does not compute;
* ``tiny(cfg)``: the keys that cut the configuration to the CPU tests'
  size.

What this file computes, for G nodes of a decentralized ring (d_ring):

* each node's loss and gradients on its own batch, one node at a time;
* momentum SGD (m ← β m + g, from m = 0) and the gossip mix of the
  post-update parameters: θ'_i = W_ii (θ_i − lr m'_i) + Σ_j W_ij θ*_j,
  with the sent rows θ*_j = θ_j − lr m'_j, under the ring's
  Metropolis–Hastings weights (1/3 each);
* the probe: every node's per-leaf L2 norms of θ before the update.

The state is stored in the dtypes the configuration states (θ and the
gradient in each leaf's dtype, the sent rows in the leaves' promoted
dtype, m in float32); every operation on it runs in float32.
``quant="fp8"`` computes every matrix product as a float8 training step
does (``_product``: the operands in e4m3, the gradient arriving at the
product in e5m2, each under a per-tensor scale): the control, one
precision below the configuration's bfloat16.  ``fault`` plants one of
the faults a benchmark run must catch (``FAULTS``).

``draw_weights`` makes the initial weights from a seed on the device; the
benchmark hands the same ones to the program and to this reference.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import math
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["FAULTS", "DTYPES", "sub_seed", "model", "leaves", "leaf_sizes", "param_bytes",
           "draw_weights", "ring_weights", "mixing_matrix", "Readings", "ReferenceTrainer",
           "run_reference", "leaf_norms"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# faults a run must catch: a step that leaves the state as it was; half of
# every node's batch left out (the mean over the rest); the exchange
# between the nodes left out; the probe's answers shifted by one leaf (as
# a wrong offsets table would give them)
FAULTS = ("unchanged", "half_batch", "no_mix", "probe_shift")
# the reference modules loaded, by path (``model``)
_MODELS: dict = {}


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``"weights"``, ``"traffic"``) of a run's
    seed: the same seed gives the same draws, and no two uses share one."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def model(cfg: Mapping, root: Optional[Path] = None):
    """The plain reference module the configuration names (its
    ``reference`` key): ``perfbench/references/<reference>.py`` of the
    checkout at ``root`` (by default the one holding this file), loaded
    once a path."""
    name = cfg["reference"]
    if not name.isidentifier():
        raise ValueError(f"reference {name!r} is not a module name")
    base = Path(root) / "perfbench" if root is not None else Path(__file__).resolve().parent
    path = (base / "references" / f"{name}.py").resolve()
    mod = _MODELS.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(f"perfbench_reference_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODELS[path] = mod
    return mod


def leaves(cfg: Mapping, root: Optional[Path] = None, dtype=None) -> list:
    """(name, shape, init, torch dtype) of every leaf, in leaf order; a
    leaf of no dtype of its own takes ``dtype`` (the configuration's by
    default)."""
    dtype = dtype or DTYPES[cfg["dtype"]]
    return [(k, shape, init, DTYPES[dt] if dt else dtype)
            for k, (shape, init, dt) in model(cfg, root).leaf_table(cfg).items()]


def leaf_sizes(cfg: Mapping, root: Optional[Path] = None) -> list[int]:
    """Each leaf's parameter count, in leaf order."""
    return [math.prod(shape) for _, shape, _, _ in leaves(cfg, root)]


def param_bytes(cfg: Mapping, root: Optional[Path] = None) -> int:
    """Bytes of one node's parameters, each leaf in its own dtype."""
    return sum(math.prod(shape) * dt.itemsize for _, shape, _, dt in leaves(cfg, root))


def draw_weights(cfg: Mapping, seed: int, device, dtype=None,
                 root: Optional[Path] = None) -> dict:
    """One replica's initial weights drawn on ``device`` from ``seed``:
    one draw a leaf from one generator, in the table's order, each leaf in
    its own dtype (``dtype``, the configuration's by default, where the
    table gives none)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    out = {}
    for name, shape, init, dt in leaves(cfg, root, dtype):
        if init is None:
            out[name] = torch.ones(shape, dtype=dt, device=device)
            continue
        if callable(init):
            x = init(gen, shape, device)
        else:
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            x.mul_(init)
        out[name] = x.to(dt)
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
# matrix products: float32, or float8 (the control)
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
                 topology: str, quant: Optional[str] = None, fault: Optional[str] = None,
                 root: Optional[Path] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
        self.cfg, self.lr, self.beta, self.quant, self.fault = cfg, lr, beta, quant, fault
        self.loss_fn = model(cfg, root).loss_fn
        table = leaves(cfg, root)
        self.names = [k for k, _, _, _ in table]
        self.dtypes = {k: dt for k, _, _, dt in table}
        # the sent rows are of the leaves' promoted dtype (one flat state)
        self.wire_dtype = functools.reduce(torch.promote_types, self.dtypes.values())
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
            loss = self.loss_fn(params, self.cfg, tokens[i], targets[i], self.quant)
            grads = torch.autograd.grad(loss, list(params.values()))
            del params
            losses.append(float(loss.detach()))
            if self.fault == "unchanged":
                continue
            for k, g in zip(self.names, grads):
                self.mom[k][i].mul_(self.beta).add_(g.to(self.dtypes[k]).float())
            del grads
        if self.fault != "unchanged":
            with torch.no_grad():
                for k in self.names:
                    self._mix_leaf(k)
        return np.array(losses), probe

    def _mix_leaf(self, k: str) -> None:
        th, m, lr = self.theta[k], self.mom[k], self.lr
        wire = torch.empty(th.shape, dtype=self.wire_dtype, device=th.device)
        for j in range(self.nodes):
            wire[j] = (th[j].float() - lr * m[j]).to(self.wire_dtype)
        for i in range(self.nodes):
            acc = self.self_w[i] * (th[i].float() - lr * m[i])
            for j, wij in self.mix[i]:
                acc = acc + wij * wire[j].float()
            th[i] = acc.to(self.dtypes[k])

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
                  fault: Optional[str] = None, root: Optional[Path] = None) -> Readings:
    """The reference's readings of the first ``len(batches)`` steps from
    ``weights``; ``batches`` hold (G, B, S) ``tokens`` and ``targets``;
    the model is the one the configuration names under ``root``."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = ReferenceTrainer(cfg, weights, nodes, lr=lr, beta=beta, topology=topology,
                               quant=quant, fault=fault, root=root)
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
