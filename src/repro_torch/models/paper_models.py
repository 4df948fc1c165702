"""The paper's own benchmark models: the counterpart of
``repro/models/paper_models.py``.

A compact ResNet-style CNN (the CIFAR-class image classifier, the
ResNet20/DenseNet100 stand-in at benchmark scale) and an LSTM language
model (the WikiText2 subject) drive the DBench experiments: image
classification and language modelling across the SGD implementations.

Parameters keep the reference's shapes, so its weights carry across leaf
for leaf: convolutions are HWIO (kh, kw, c_in, c_out) in the state and are
permuted to PyTorch's OIHW inside the forward; images are NHWC as the
reference takes them.  The functions take one node's parameters as a
nested dict or as the flat dotted-path dict the engines hold
(``flatten_tree``).
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ParamDef, flatten_tree, he_normal, normal_init, ones_init, zeros_init,
)

__all__ = [
    "mini_resnet_defs", "mini_resnet_apply", "mini_resnet_loss",
    "lstm_defs", "lstm_apply", "lstm_loss", "lstm_perplexity",
    "synthetic_images",
]


def _flat(params: Mapping) -> Mapping:
    if any(isinstance(v, Mapping) for v in params.values()):
        return flatten_tree(params)
    return params


# ---------------------------------------------------------------------------
# Mini ResNet (image classification)
# ---------------------------------------------------------------------------

def _conv_def(cin, cout, k=3):
    return ParamDef((k, k, cin, cout), he_normal((-4, -3, -2)))


def mini_resnet_defs(channels: int = 16, n_classes: int = 10, depth: int = 2):
    defs = {"stem": _conv_def(3, channels)}
    for i in range(depth):
        defs[f"block{i}"] = {
            "conv1": _conv_def(channels, channels),
            "conv2": _conv_def(channels, channels),
            "g1": ParamDef((channels,), ones_init()),
            "g2": ParamDef((channels,), ones_init()),
        }
    defs["head"] = ParamDef((channels, n_classes), normal_init(0.05))
    defs["head_b"] = ParamDef((n_classes,), zeros_init())
    return defs


def _conv(x, w):
    """'SAME' stride-1 convolution of NCHW ``x`` with an HWIO kernel."""
    k = w.shape[0]
    return F.conv2d(x, w.permute(3, 2, 0, 1), padding=k // 2)


def _chan_norm(x, g, eps=1e-5):
    """Per-channel norm over (H, W) with the population variance: BN's
    stateless, replica-local cousin."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g[:, None, None]


def mini_resnet_apply(params, images):
    """images: (B, H, W, 3) -> logits (B, n_classes)."""
    p = _flat(params)
    h = F.relu(_conv(images.permute(0, 3, 1, 2), p["stem"]))
    i = 0
    while f"block{i}.conv1" in p:
        b = f"block{i}."
        r = F.relu(_chan_norm(_conv(h, p[b + "conv1"]), p[b + "g1"]))
        r = _chan_norm(_conv(r, p[b + "conv2"]), p[b + "g2"])
        h = F.relu(h + r)
        i += 1
    pooled = h.mean(dim=(2, 3))
    return pooled @ p["head"] + p["head_b"]


def mini_resnet_loss(params, batch):
    logits = mini_resnet_apply(params, batch["images"])
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, batch["labels"].long()[:, None]).mean()


def synthetic_images(gen: torch.Generator, n_classes=10, batch=32, size=16,
                     noise=0.6):
    """Class-conditional Gaussian images (learnable but non-trivial), drawn
    from ``gen`` on its device; the class prototypes are fixed (seed 7).
    Returns ``{"images": (batch, size, size, 3) float32, "labels": (batch,)
    int64}``.  The bits differ from the reference's ``jax.random`` draws."""
    dev = gen.device
    labels = torch.randint(0, n_classes, (batch,), generator=gen, device=dev)
    protos = torch.randn((n_classes, size, size, 3),
                         generator=torch.Generator(device=dev).manual_seed(7),
                         device=dev)
    imgs = protos[labels] + noise * torch.randn((batch, size, size, 3),
                                                generator=gen, device=dev)
    return {"images": imgs, "labels": labels}


# ---------------------------------------------------------------------------
# LSTM language model
# ---------------------------------------------------------------------------

def lstm_defs(vocab: int = 256, d: int = 128):
    return {
        "embed": ParamDef((vocab, d), normal_init(0.05)),
        "wx": ParamDef((d, 4 * d), he_normal((-2,))),
        "wh": ParamDef((d, 4 * d), he_normal((-2,))),
        "b": ParamDef((4 * d,), zeros_init()),
        "head": ParamDef((d, vocab), normal_init(0.05)),
    }


def lstm_apply(params, tokens):
    """tokens (B, S) -> logits (B, S, V); the reference's ``lax.scan`` over
    S is a loop (forget-gate bias +1)."""
    p = _flat(params)
    x = p["embed"][tokens.long()]  # (B, S, D)
    b, s, d = x.shape
    h = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    c = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        z = x[:, t] @ p["wx"] + h @ p["wh"] + p["b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1) @ p["head"]


def lstm_loss(params, batch):
    """Mean next-token CE over the positions whose target is >= 0."""
    logits = lstm_apply(params, batch["tokens"])
    t = batch["targets"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = torch.gather(logp, -1, t.clamp_min(0)[..., None])[..., 0]
    valid = (t >= 0).float()
    return -(tgt * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def lstm_perplexity(params, batch):
    return torch.exp(lstm_loss(params, batch))
