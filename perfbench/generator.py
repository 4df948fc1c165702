"""The one traffic generator: a traffic file's parameters -> a pool of
seeded training batches, built on the device during set-up.

The token source is a learnable Markov chain (a copy of the port's
``SyntheticLM`` rule, drawn with torch on the device instead of numpy on
the host): the first token uniform, then with probability ``structure``
the next token is ``(token · M + 12345) mod V`` (M = 6364136223846793005
mod V), else uniform.  Targets are the tokens shifted by one, the last
position masked with −1.  Every batch of the pool differs; a run feeds
them in order and wraps around.

Traffic file keys (``traffic/<name>.json``):

``source``          ``"markov_lm"`` (the only one so far)
``topology``        the gossip graph (``"d_ring"``, the one the reference
                    builds; ``reference.mixing_matrix`` refuses others)
``per_node_batch``  sequences a node a step
``seq_len``         tokens a sequence
``structure``       the chain's rule probability
``pool``            distinct batches built in set-up
``fused_apply``,    the trainer's knobs of the same names (``program.build``),
``bucket_mb``       which change how the step runs and not what it computes

Steps run in a closed loop, each dispatched as soon as the host has
dispatched the previous one, and every step mixes and probes.
"""
from __future__ import annotations

from typing import Mapping

import torch

from perfbench.reference import sub_seed

__all__ = ["make_pool", "tokens_per_step"]

_MULT = 6364136223846793005


def tokens_per_step(traffic: Mapping, nodes: int) -> int:
    return nodes * traffic["per_node_batch"] * traffic["seq_len"]


def make_pool(traffic: Mapping, *, vocab: int, nodes: int, seed: int, device) -> list[dict]:
    """``traffic["pool"]`` batches of (nodes, B, S) int32 ``tokens`` and
    ``targets`` on ``device``, the same for the same seed."""
    if traffic.get("source") != "markov_lm":
        raise ValueError(f"unknown traffic source {traffic.get('source')!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "traffic"))
    n, b, s = traffic["pool"], traffic["per_node_batch"], traffic["seq_len"]
    rows = n * nodes * b
    toks = torch.empty((rows, s + 1), dtype=torch.int64, device=device)
    toks[:, 0] = torch.randint(0, vocab, (rows,), generator=gen, device=device)
    follow = torch.rand((rows, s), generator=gen, device=device) < traffic["structure"]
    rand = torch.randint(0, vocab, (rows, s), generator=gen, device=device)
    mult = _MULT % vocab
    for t in range(s):
        nxt = (toks[:, t] * mult + 12345) % vocab
        toks[:, t + 1] = torch.where(follow[:, t], nxt, rand[:, t])
    tokens = toks[:, :-1].to(torch.int32).reshape(n, nodes, b, s)
    targets = toks[:, 1:].to(torch.int32).reshape(n, nodes, b, s).clone()
    targets[..., -1] = -1
    return [{"tokens": tokens[i], "targets": targets[i]} for i in range(n)]
