"""Serving: prefill and decode for one replica, on one card or on a mesh.

The counterpart of ``repro/launch/serve.py``.  ``ServeEngine`` builds the
prefill and decode step functions of any family and runs batched greedy
or sampled generation against its decode state (KV caches, RWKV states,
or the hybrid's Mamba2 states and shared-attention caches).  A VLM's
prompt takes its precomputed patch embeddings first.  ``lower_prefill``
and ``lower_decode`` are the dry run of the two steps (the reference's
abstract lowering): the step run once on ``meta`` under the op accounting
(``launch/hlo_analysis.py``), returning the dry run's record.

On a mesh (``launch/mesh.Mesh`` with "model" and data axes) the engine is
one rank of a data × model world, as the reference's is one program over
its mesh: the weights are sharded over "model" (``launch/sharding.py``'s
validated specs, the padded heads of ``model_defs(cfg, tp)``; rank j of a
replica holds shard j) and replicated over the data axes; the request
batch is split over the data ranks where they divide it (the reference's
``_batch_axes``), else every data rank serves all of it, as it does for a
MoE model (its experts' capacity, and so which assignments drop, follows
the whole batch's tokens in the reference's global step).  The forward on a
rank is ``models/transformer.py``'s ``tp=`` path (the model group's
collectives through ``launch/tensor_parallel.py``); the decode state holds
the rank's share (``init_decode_state(..., tp_size=, tp_rank=)``: its KV
heads by ``cache_kv_heads``, its RWKV and Mamba2 heads).  The reference
places its caches by a sharding rule instead (one dim of each leaf over
"model", the later and smaller first: at granite-8b's shapes the head dim;
the combined axes on the slots at B = 1; ``launch/dryrun.py``'s
``reference_placement_bytes``): a placement, not a different number.  Logits are vocab parallel: ``prefill`` and
``decode_step`` return the whole (B, V) rows on every rank (all-gathered
over the model group, then the data ranks); greedy ``generate`` takes the
argmax across the vocabulary shards (a max over the model group, then the
smallest global index among ties: ``torch.argmax`` of the whole row) and
sampling draws from the gathered row with the engine's generator, the
same draws on every model rank.  ``generate`` returns the whole (B,
n_new) on every rank.  Unlike the reference's ``generate``, which sizes
its state at tp 1 (``init_decode_state(cfg, b, max_len)``) and so cannot
hold a ``pad_kv`` model's padded KV heads, the engine sizes it at the
mesh's model axis, as the reference's ``abstract_decode_state`` does.

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
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.launch.comm import Comm, mesh_comms
from repro_torch.launch.sharding import model_axis_shards, shard_leaf
from repro_torch.launch.tensor_parallel import ModelParallel
from repro_torch.models import transformer as tfm
from repro_torch.models.common import abstract_params, flatten_tree

__all__ = ["ServeEngine", "DEFAULT_WINDOW", "grow_caches", "main"]

DEFAULT_WINDOW = 8192  # sliding window for full-attention archs on long_500k


class ServeEngine:
    """Prefill/decode steps and a generation loop for one architecture, on
    one card or as one rank of a data × model mesh."""

    def __init__(self, cfg: ArchConfig, device=None, mesh=None, model_comm=None,
                 data_comm=None):
        """``mesh``: a ``launch/mesh.Mesh`` whose "model" axis shards each
        replica and whose other axes hold replicas.  ``model_comm`` and
        ``data_comm``: this rank's ``Comm``s of its replica's model group and
        of its shard index's data group (``launch/comm.mesh_comms``); left
        out, they are built from the initialised world when its size is the
        mesh's.  A model axis > 1 needs a model group."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tp_size = 1 if mesh is None else mesh.shape.get("model", 1)
        if mesh is not None and model_comm is None and data_comm is None \
                and mesh.size > 1 and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() == mesh.size:
            data_comm, model_comm = mesh_comms(Comm(self.device), mesh.size // self.tp_size,
                                               self.tp_size)
        if self.tp_size > 1 and model_comm is None:
            raise ValueError(f"a mesh with a model axis of {self.tp_size} needs a world of "
                             f"{mesh.size} ranks, or a model_comm")
        self.model_comm, self.data_comm = model_comm, data_comm
        self.tp = ModelParallel(model_comm) if self.tp_size > 1 else None
        self.full_defs = tfm.model_defs(cfg, self.tp_size)
        self.shardings = None
        self.defs = self.full_defs
        if self.tp is not None:
            self.shardings, self.defs = model_axis_shards(self.full_defs, self.tp_size)

    # -- weights and the batch ------------------------------------------------------
    def shard_params(self, full: Mapping) -> dict[str, torch.Tensor]:
        """This rank's shards of the full (padded: ``model_defs(cfg, tp)``)
        flat parameter dict, numpy arrays or tensors, on the engine's
        device (on one card, the leaves as they are)."""
        out = {}
        for name, d in self.full_defs.items():
            leaf = torch.as_tensor(full[name])
            if tuple(leaf.shape) != tuple(d.shape):
                raise ValueError(f"{name}: shape {tuple(leaf.shape)} != {tuple(d.shape)}")
            out[name] = self._shard(name, leaf.to(self.device))
        return out

    def _shard(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        if self.shardings is None:
            return leaf
        return shard_leaf(leaf, self.shardings[name], {"model": self.tp.rank}).contiguous()

    def init_params(self, seed: int = 0) -> dict[str, torch.Tensor]:
        """Random weights from ``seed``, made on the engine's device: the
        draws of ``tfm.init_model(cfg, ..., tp_size)``, each leaf cut to this
        rank's shard as it is made."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return {k: self._shard(k, d.init(gen, d.shape, d.dtype, self.device))
                for k, d in self.full_defs.items()}

    @property
    def data_size(self) -> int:
        return 1 if self.data_comm is None else self.data_comm.world

    def batch_rows(self, b: int) -> slice:
        """The rows of a batch of ``b`` this rank serves: its data rank's
        share where the data ranks divide ``b``, else all of them.  A MoE
        model serves all of them on every data rank: its experts' capacity,
        and so which assignments drop, follows the tokens of the whole
        batch, as the reference's global step computes it."""
        n = self.data_size
        if n == 1 or b % n or self.cfg.n_experts:
            return slice(0, b)
        k = b // n
        return slice(self.data_comm.rank * k, (self.data_comm.rank + 1) * k)

    def _whole(self, x: torch.Tensor, b: int, *, vocab: bool) -> torch.Tensor:
        """This rank's (rows, ...) share put together: the vocabulary
        columns over the model group (``vocab``), the rows over the data
        ranks that split the batch."""
        if vocab and self.tp is not None and x.shape[-1] < self.cfg.vocab:
            x = self.tp.gather(x, -1)
        if x.shape[0] < b:
            x = self.data_comm.all_gather(x.contiguous(), dim=0)
        return x

    # -- prefill -----------------------------------------------------------------
    def _prefill_cfg(self) -> ArchConfig:
        # reference attention materializes (B, H, S, S) — never at 32k.
        # an explicit chunked-family override (e.g. chunked_skip) is honored.
        if self.cfg.attn_impl.startswith("chunked"):
            return self.cfg
        return dataclasses.replace(self.cfg, attn_impl="chunked")

    def prefill_fn(self):
        """The prefill of this rank's rows: (its last-token logits (its
        vocabulary columns on a model axis), its decode state)."""
        cfg, tp = self._prefill_cfg(), self.tp

        @torch.no_grad()
        def fn(params, tokens, patch_embeds=None):
            return tfm.prefill(params, cfg, tokens, patch_embeds=patch_embeds, tp=tp)

        return fn

    def prefill(self, params, tokens, *, patch_embeds=None):
        """The prompt (B, S) of the whole batch (a VLM's patches first):
        (last-token logits (B, V), whole on every rank; the decode state of
        this rank's rows)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b = tokens.shape[0]
        rows = self.batch_rows(b)
        last, state = self.prefill_fn()(params, tokens[rows], None if patch_embeds is None
                                        else patch_embeds[rows])
        return self._whole(last, b, vocab=True), state

    # -- decode ------------------------------------------------------------------
    def decode_window(self, shape: InputShape) -> Optional[int]:
        """Sliding window if this arch needs one at this context length."""
        if self.cfg.family in ("ssm",):
            return None
        if shape.seq_len > 100_000:
            return self.cfg.sliding_window or DEFAULT_WINDOW
        return None

    def decode_fn(self, window: Optional[int]):
        """One decode step of this rank's rows: (its logits (its vocabulary
        columns on a model axis), its state, updated in place)."""
        cfg, tp = self.cfg, self.tp

        @torch.no_grad()
        def fn(params, tokens, pos, state):
            return tfm.decode_step(params, cfg, tokens, pos, state, window=window, tp=tp)

        return fn

    def decode_step(self, params, tokens, pos: int, state, *, window: Optional[int] = None):
        """One token (B, 1) of the whole batch: (logits (B, V), whole on
        every rank; this rank's state, updated in place)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b = tokens.shape[0]
        last, state = self.decode_fn(window)(params, tokens[self.batch_rows(b)], pos, state)
        return self._whole(last, b, vocab=True), state

    def init_decode_state(self, batch: int, seq_len: int, *, window: Optional[int] = None,
                          device=None):
        """The empty decode state of this rank's rows of a batch of
        ``batch``, sized at the mesh's model axis."""
        rows = self.batch_rows(batch)
        return tfm.init_decode_state(self.cfg, rows.stop - rows.start, seq_len, window=window,
                                     device=self.device if device is None else device,
                                     tp_size=self.tp_size,
                                     tp_rank=0 if self.tp is None else self.tp.rank)

    def abstract_decode_state(self, shape: InputShape):
        """(this rank's decode state of ``shape`` on ``meta``, its window)."""
        window = self.decode_window(shape)
        return (self.init_decode_state(shape.global_batch, shape.seq_len, window=window,
                                       device="meta"), window)

    # -- the dry run ---------------------------------------------------------------------
    def lower_prefill(self, shape: InputShape) -> dict:
        """The dry run of this rank's prefill of ``shape``
        (``configs.input_specs``; its rows of the global batch) on
        ``meta``: the record of ``launch/hlo_analysis.step_record``."""
        from repro_torch.configs.base import input_specs
        from repro_torch.launch.hlo_analysis import step_record

        params = abstract_params(self.defs)
        batch = input_specs(self.cfg, shape)
        rows = self.batch_rows(shape.global_batch)
        patches = batch.get("patch_embeds")
        return step_record(self.prefill_fn(), params, batch["tokens"][rows],
                           patch_embeds=None if patches is None else patches[rows],
                           arguments=list(flatten_tree(params).values()))

    def lower_decode(self, shape: InputShape) -> dict:
        """The dry run of one decode step of this rank's rows against the
        ``shape.seq_len``-deep decode state on ``meta``.  The position is a
        host integer in the port, so the step decodes at the last position,
        ``seq_len - 1`` (the reference's traced ``pos``): on ``meta`` the
        work is the same at every position.  The record's ``memory`` counts
        the parameters and the decode state as arguments."""
        from repro_torch.configs.base import input_specs
        from repro_torch.launch.hlo_analysis import step_record

        state, window = self.abstract_decode_state(shape)
        params = abstract_params(self.defs)
        batch = input_specs(self.cfg, shape)
        tokens = batch["tokens"][self.batch_rows(shape.global_batch)]
        state_leaves = [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
        return step_record(self.decode_fn(window), params, tokens, shape.seq_len - 1, state,
                           arguments=list(flatten_tree(params).values()) + state_leaves)

    # -- concrete serving loop ----------------------------------------------------------
    def _next_token(self, last: torch.Tensor, temperature: float, generator) -> torch.Tensor:
        """(rows, 1) next tokens from this rank's last logits (its
        vocabulary columns on a model axis)."""
        split = self.tp is not None and last.shape[-1] < self.cfg.vocab
        if temperature > 0.0 and generator is not None:
            row = self.tp.gather(last, -1) if split else last
            probs = torch.softmax(row.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)
        if not split:
            return torch.argmax(last, dim=-1)[:, None]
        # the argmax across the vocabulary shards: the largest value, then
        # the smallest global index that holds it (exact in float32 below 2^24)
        lf = last.float()
        idx = torch.argmax(lf, dim=-1)
        val = lf.gather(-1, idx[:, None])[:, 0]
        top = self.tp.max(val)
        cand = torch.where(val == top, (idx + self.tp.rank * lf.shape[-1]).float(),
                           torch.full_like(val, float(self.cfg.vocab)))
        return (-self.tp.max(-cand)).long()[:, None]

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
        sampled) generation: (B, S0) prompts -> (B, n_new) tokens, whole on
        every rank.

        As in the reference, a text prompt's prefill is run and discarded;
        the prompt is then replayed token by token into a ``max_len``
        state.  A VLM prompt with ``patch_embeds`` (B, n_patches, D) keeps
        its prefill instead (decode steps take tokens, not patches): the
        prefill's caches grow to ``max_len`` slots (n_patches + S0 + n_new
        by default) and decoding continues at position n_patches + S0."""
        cfg = self.cfg
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s0 = prompts.shape
        rows = self.batch_rows(b)
        local = prompts[rows]
        vlm = cfg.input_kind == "vlm" and patch_embeds is not None
        n_patches = cfg.n_patches if vlm else 0
        max_len = max_len or (s0 + n_patches + n_new)
        prefill, step = self.prefill_fn(), self.decode_fn(None)
        last, state = prefill(params, local, None if patch_embeds is None
                              else patch_embeds[rows])
        if vlm:
            state = grow_caches(state, max_len)
            pos = n_patches + s0
        else:
            state = self.init_decode_state(b, max_len)
            last = None
            pos = 0
            for t in range(s0):
                last, state = step(params, local[:, t : t + 1], pos, state)
                pos += 1
        out = []
        for _ in range(n_new):
            tok = self._next_token(last, temperature, generator)
            out.append(tok)
            last, state = step(params, tok, pos, state)
            pos += 1
        # the data ranks' rows (token ids are exact in float32)
        return self._whole(torch.cat(out, dim=1).float(), b, vocab=False).long()


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
