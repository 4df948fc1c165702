"""Architecture and input-shape schema: the counterpart of ``repro/configs/base.py``.

``ArchConfig`` keeps the reference's fields and ``reduced()`` rule (the
CPU smoke-test variant of the same family: ≤2 layers, d_model ≤ 256,
float32); only ``dtype`` is a torch dtype here.  The layout knobs of the
reference's model axis: ``pad_heads``/``pad_kv`` pad the heads at the
mesh's tensor-parallel size (``models/transformer.attn_dims``; nothing at
1); ``moe_impl="manual_ep"`` runs the explicit expert-parallel schedule
(``models/moe.apply_moe_manual_ep``); ``moe_buf_constraint`` pins a GSPMD
buffer and changes nothing here; ``moe_shard_ff`` puts the experts' d_ff
over the "data" axis too (``models/moe.moe_defs``; the ranks engine gathers
it at use over a node's data ranks).  ``scan_layers`` is the reference's
``lax.scan`` over layers, a Python loop here either way.  ``InputShape`` and
``SHAPES`` are the reference's benchmark inputs (serving reads their
context lengths); ``input_specs`` gives a step's data inputs at a shape as
``meta`` tensors, the stand-ins the dry run (``launch/dryrun.py``) builds
its steps on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["ArchConfig", "InputShape", "SHAPES", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0             # 0 for attention-free
    n_kv: int = 0
    d_head: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    act: str = "silu"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # SSM / hybrid
    ssm_state: int = 0
    attn_every: int = 0          # hybrid: shared attn block every N-th block
    # modality stubs
    input_kind: str = "tokens"   # tokens | vlm
    n_patches: int = 0
    # impl knobs
    attn_impl: str = "reference"  # reference | chunked | chunked_skip
    attn_chunk: int = 1024
    pad_heads: bool = False      # pad GQA groups so heads shard on a model axis
    pad_kv: bool = False         # also pad kv heads to the model axis
    sliding_window: Optional[int] = None
    rec_chunk: int = 64          # recurrence chunk (ssm/hybrid)
    scan_layers: bool = True
    remat: bool = True           # checkpoint every layer (the reference's default)
    remat_policy: str = "full"   # full | dots (keep the matrix products' outputs)
    moe_shard_ff: bool = False   # expert d_ff over the data axis too
    moe_buf_constraint: bool = False  # layout only: pin the dispatch buffer
    moe_impl: str = "gather"     # gather | manual_ep
    dtype: Any = torch.bfloat16
    # citation for the config numbers
    source: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant of the same family."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv, max(n_heads // 2, 1)) if self.n_kv else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2) if not self.attn_every
            else min(self.n_layers, self.attn_every + 1),
            d_model=d_model,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            n_heads=n_heads,
            n_kv=n_kv,
            d_head=(d_model // n_heads if n_heads else 0),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            rec_chunk=8,
            attn_chunk=64,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def input_specs(cfg: ArchConfig, shape: InputShape, *, n_nodes: int = 1
                ) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins for the step function's data inputs, with the
    reference's shapes and dtypes (int32 tokens, as the port's forward
    takes them).

    Training batches carry the gossip-node axis (G, per_node_batch, S) when
    ``n_nodes > 1``; serving batches are flat (B, ...).  A VLM's patch
    embeddings arrive precomputed, in ``cfg.dtype``.
    """
    meta = lambda shp, dtype=torch.int32: torch.empty(shp, dtype=dtype, device="meta")
    if shape.kind == "train":
        if shape.global_batch % n_nodes:
            raise ValueError(
                f"{shape.name}: global_batch {shape.global_batch} not divisible "
                f"by {n_nodes} gossip nodes"
            )
        b = shape.global_batch // n_nodes
        lead = (n_nodes, b) if n_nodes > 1 else (b,)
        specs = {"tokens": meta(lead + (shape.seq_len,)),
                 "targets": meta(lead + (shape.seq_len,))}
        if cfg.input_kind == "vlm":
            specs["patch_embeds"] = meta(lead + (cfg.n_patches, cfg.d_model), cfg.dtype)
        return specs
    b = shape.global_batch
    if shape.kind == "prefill":
        specs = {"tokens": meta((b, shape.seq_len))}
        if cfg.input_kind == "vlm":
            specs["patch_embeds"] = meta((b, cfg.n_patches, cfg.d_model), cfg.dtype)
        return specs
    # decode: one new token against a seq_len-deep cache/state
    return {"tokens": meta((b, 1)), "pos": meta(())}
