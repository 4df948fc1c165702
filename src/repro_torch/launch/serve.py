"""Serving: prefill and decode for one replica on one card.

The counterpart of ``repro/launch/serve.py``.  ``ServeEngine`` builds the
prefill and decode step functions of any family and runs batched greedy
or sampled generation against its decode state (KV caches, RWKV states,
or the hybrid's Mamba2 states and shared-attention caches).  A VLM's
prompt takes its precomputed patch embeddings first.  ``lower_prefill``
and ``lower_decode`` are the dry run of the two steps (the reference's
abstract lowering): the step run once on ``meta`` under the op accounting
(``launch/hlo_analysis.py``), returning the dry run's record.  The
reference's mesh shardings are tensor/data-parallel layout, which one card
has no counterpart of.

  PYTHONPATH=src python -m repro_torch.launch.serve [--arch granite-8b] [--new 16]

runs the counterpart of ``examples/serve_decode.py`` on the card (pass
``device="cpu"`` to ``main`` to run it on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Mapping, Optional

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import abstract_params, flatten_tree

__all__ = ["ServeEngine", "DEFAULT_WINDOW", "grow_caches", "main"]

DEFAULT_WINDOW = 8192  # sliding window for full-attention archs on long_500k


class ServeEngine:
    """Prefill/decode steps and a generation loop for one architecture."""

    def __init__(self, cfg: ArchConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Random weights from ``seed``, made on the engine's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tfm.init_model(self.cfg, gen, self.device)

    # -- prefill -----------------------------------------------------------------
    def prefill_fn(self):
        # reference attention materializes (B, H, S, S) — never at 32k.
        # an explicit chunked-family override (e.g. chunked_skip) is honored.
        cfg = (
            self.cfg
            if self.cfg.attn_impl.startswith("chunked")
            else dataclasses.replace(self.cfg, attn_impl="chunked")
        )

        @torch.no_grad()
        def fn(params, tokens, patch_embeds=None):
            return tfm.prefill(params, cfg, tokens, patch_embeds=patch_embeds)

        return fn

    # -- decode ------------------------------------------------------------------
    def decode_window(self, shape: InputShape) -> Optional[int]:
        """Sliding window if this arch needs one at this context length."""
        if self.cfg.family in ("ssm",):
            return None
        if shape.seq_len > 100_000:
            return self.cfg.sliding_window or DEFAULT_WINDOW
        return None

    def decode_fn(self, window: Optional[int]):
        cfg = self.cfg

        @torch.no_grad()
        def fn(params, tokens, pos, state):
            return tfm.decode_step(params, cfg, tokens, pos, state, window=window)

        return fn

    def abstract_decode_state(self, shape: InputShape):
        """(the decode state of ``shape`` on ``meta``, its window)."""
        window = self.decode_window(shape)
        return (tfm.init_decode_state(self.cfg, shape.global_batch, shape.seq_len,
                                      window=window, device="meta"), window)

    # -- the dry run ---------------------------------------------------------------------
    def lower_prefill(self, shape: InputShape) -> dict:
        """The dry run of the prefill of ``shape`` (``configs.input_specs``)
        on ``meta``: the record of ``launch/hlo_analysis.step_record``."""
        from repro_torch.configs.base import input_specs
        from repro_torch.launch.hlo_analysis import step_record

        params = abstract_params(tfm.model_defs(self.cfg))
        batch = input_specs(self.cfg, shape)
        return step_record(self.prefill_fn(), params, batch["tokens"],
                           patch_embeds=batch.get("patch_embeds"),
                           arguments=list(flatten_tree(params).values()))

    def lower_decode(self, shape: InputShape) -> dict:
        """The dry run of one decode step against the ``shape.seq_len``-deep
        decode state on ``meta``.  The position is a host integer in the
        port, so the step decodes at the last position, ``seq_len - 1``
        (the reference's traced ``pos``): on ``meta`` the work is the same
        at every position.  The record's ``memory`` counts the parameters
        and the decode state as arguments."""
        from repro_torch.configs.base import input_specs
        from repro_torch.launch.hlo_analysis import step_record

        state, window = self.abstract_decode_state(shape)
        params = abstract_params(tfm.model_defs(self.cfg))
        batch = input_specs(self.cfg, shape)
        state_leaves = [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
        return step_record(self.decode_fn(window), params, batch["tokens"],
                           shape.seq_len - 1, state,
                           arguments=list(flatten_tree(params).values()) + state_leaves)

    # -- concrete serving loop ----------------------------------------------------------
    @torch.no_grad()
    def generate(
        self,
        params: Mapping[str, torch.Tensor],
        prompts: torch.Tensor,
        n_new: int,
        *,
        patch_embeds: Optional[torch.Tensor] = None,
        max_len: Optional[int] = None,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Batched greedy (or, with ``temperature > 0`` and a ``generator``,
        sampled) generation: (B, S0) prompts -> (B, n_new) tokens.

        As in the reference, a text prompt's prefill is run and discarded;
        the prompt is then replayed token by token into a ``max_len``
        state.  A VLM prompt with ``patch_embeds`` (B, n_patches, D) keeps
        its prefill instead (decode steps take tokens, not patches): the
        prefill's caches grow to ``max_len`` slots (n_patches + S0 + n_new
        by default) and decoding continues at position n_patches + S0."""
        cfg = self.cfg
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s0 = prompts.shape
        vlm = cfg.input_kind == "vlm" and patch_embeds is not None
        n_patches = cfg.n_patches if vlm else 0
        max_len = max_len or (s0 + n_patches + n_new)
        last, state = tfm.prefill(params, cfg, prompts, patch_embeds=patch_embeds)
        if vlm:
            state = grow_caches(state, max_len)
            pos = n_patches + s0
        else:
            state = tfm.init_decode_state(cfg, b, max_len, device=self.device)
            last = None
            pos = 0
            for t in range(s0):
                last, state = tfm.decode_step(params, cfg, prompts[:, t : t + 1], pos, state)
                pos += 1
        out = []
        for _ in range(n_new):
            if temperature > 0.0 and generator is not None:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = torch.argmax(last, dim=-1)[:, None]
            out.append(tok)
            last, state = tfm.decode_step(params, cfg, tok, pos, state)
            pos += 1
        return torch.cat(out, dim=1)


def grow_caches(state: tfm.DecodeState, slots: int) -> tfm.DecodeState:
    """A prefill's decode state with its KV caches grown to ``slots`` slots
    (empty slots: zero k and v, position -1)."""

    def grow(kv):
        k, v, p = kv
        extra = slots - k.shape[2]
        if extra <= 0:
            return kv
        pad = lambda x, fill: torch.cat(
            [x, torch.full(x.shape[:2] + (extra,) + x.shape[3:], fill, dtype=x.dtype,
                           device=x.device)], dim=2)
        return pad(k, 0), pad(v, 0), pad(p, -1)

    if state.kv is not None:
        return state._replace(kv=grow(state.kv))
    if state.hybrid is not None:
        return state._replace(hybrid=dict(state.hybrid,
                                          attn_cache=grow(state.hybrid["attn_cache"])))
    return state


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, device=None) -> dict:
    """Batched serving demo on the reduced architecture in float32: greedy
    and sampled generation from seeded weights and prompts.  ``device`` (a
    keyword, not a flag) selects the CPU for tests.  Returns ``{"prompts",
    "greedy", "sampled"}`` as (B, ·) tensors."""
    from repro_torch.configs import get_config

    args = _parser().parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch + "-reduced"), dtype=torch.float32,
                              remat=False)
    eng = ServeEngine(cfg, device)
    params = eng.init_params(seed=0)
    gen = torch.Generator(device=eng.device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=eng.device)
    print(f"arch={cfg.name} (reduced) | batch={args.batch} | "
          f"prompt={args.prompt_len} | generating {args.new} tokens")

    _sync(eng.device)
    t0 = time.time()
    greedy = eng.generate(params, prompts, n_new=args.new,
                          max_len=args.prompt_len + args.new)
    _sync(eng.device)
    t1 = time.time()
    sampled = eng.generate(params, prompts, n_new=args.new,
                           max_len=args.prompt_len + args.new,
                           temperature=args.temperature,
                           generator=torch.Generator(device=eng.device).manual_seed(2))
    _sync(eng.device)
    t2 = time.time()

    for i in range(args.batch):
        print(f"  req{i}: prompt={prompts[i].tolist()}")
        print(f"        greedy  -> {greedy[i].tolist()}")
        print(f"        sampled -> {sampled[i].tolist()}")
    tok_s = args.batch * args.new / (t1 - t0)
    print(f"\ngreedy: {t1-t0:.2f}s ({tok_s:.1f} tok/s incl. prompt replay); "
          f"sampled: {t2-t1:.2f}s")
    if greedy.shape != (args.batch, args.new):
        raise SystemExit(f"greedy tokens have shape {tuple(greedy.shape)}")
    return {"prompts": prompts, "greedy": greedy, "sampled": sampled}


if __name__ == "__main__":
    main()
