"""A model comes in as new files: its configuration names a reference
module of its own (``perfbench/references/<name>.py``), which the harness
reads for the leaves, the weights' draw, the loss, the FLOP count and the
port's fields.  The manifest requires the module, and the program's
leaves are held to the module's table, dtypes included."""
import hashlib
import json
import shutil

import pytest
import torch

from perfbench import manifest, program, reference
from perfbench.cell import run_cell

# the port's MoE with one always-on gated-SiLU MLP of width d_ff beside
# the routed experts (``repro_torch.models.moe`` ``_shared_experts``)
MOE_SHARED = '''"""A decoder whose MoE layers add shared experts: an always-on
gated-SiLU MLP of width n_shared_experts x d_ff beside the routed ones."""
import math

import torch.nn.functional as F

from perfbench.references import decoder


def leaf_table(cfg):
    n, d, f = cfg["n_layers"], cfg["d_model"], cfg["n_shared_experts"] * cfg["d_ff"]
    shared = {"blocks.ffn.shared.w_down": ((n, f, d), math.sqrt(2.0 / f), None),
              "blocks.ffn.shared.w_gate": ((n, d, f), math.sqrt(2.0 / d), None),
              "blocks.ffn.shared.w_up": ((n, d, f), math.sqrt(2.0 / d), None)}
    return dict(sorted({**decoder.leaf_table(cfg), **shared}.items()))


def _ffn(x, p, l, cfg, mm):
    out, aux = decoder.ffn(x, p, l, cfg, mm)
    hid = F.silu(mm("bsd,df->bsf", x, p["blocks.ffn.shared.w_gate"][l])) \\
        * mm("bsd,df->bsf", x, p["blocks.ffn.shared.w_up"][l])
    return out + mm("bsf,fd->bsd", hid, p["blocks.ffn.shared.w_down"][l]), aux


def loss_fn(p, cfg, tokens, targets, quant=None):
    return decoder.loss_fn(p, cfg, tokens, targets, quant, ffn=_ffn)


def model_flops_per_step(cfg, *, nodes, per_node_batch, seq, causal=True):
    shared = 3 * cfg["d_model"] * cfg["n_shared_experts"] * cfg["d_ff"] * cfg["n_layers"]
    return decoder.model_flops_per_step(cfg, nodes=nodes, per_node_batch=per_node_batch,
                                        seq=seq, causal=causal) \\
        + 6 * shared * nodes * per_node_batch * seq


def arch_fields(cfg):
    rest = {k: v for k, v in cfg.items() if k != "n_shared_experts"}
    return {**decoder.arch_fields(rest), "n_shared_experts": cfg["n_shared_experts"]}


def tiny(cfg):
    return {**decoder.tiny(cfg), "n_shared_experts": 1}
'''

# the decoder with one float32 leaf declared bfloat16
DECLARED_BF16 = '''from perfbench.references import decoder
from perfbench.references.decoder import arch_fields, loss_fn, model_flops_per_step, tiny


def leaf_table(cfg):
    table = decoder.leaf_table(cfg)
    shape, init, _ = table["final_norm.g"]
    table["final_norm.g"] = (shape, init, "bfloat16")
    return table
'''

# the decoder with a field the port's ArchConfig does not have
EXTRA_FIELD = '''from perfbench.references import decoder
from perfbench.references.decoder import leaf_table, loss_fn, model_flops_per_step, tiny


def arch_fields(cfg):
    return {**decoder.arch_fields(cfg), "n_shared_heads": 2}
'''


def _digests(root):
    files = [root / "BENCHMARK.json"] + [
        p for p in sorted((root / "perfbench").rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts]
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


class _HalfBatch:
    """The trainer stepping on half of every node's batch."""

    def __init__(self, trainer):
        self._t = trainer

    def __getattr__(self, name):
        return getattr(self._t, name)

    def train_step(self, state, batch, lr, **kw):
        half = batch["tokens"].shape[1] // 2
        return self._t.train_step(state, {k: v[:, :half] for k, v in batch.items()}, lr, **kw)


def _add_model(root, name, module_text, base_config, **keys):
    """A configuration named ``name`` from ``base_config``'s file, whose
    reference is ``module_text``: new files alone."""
    bench = root / "perfbench"
    (bench / "references" / f"{name.replace('-', '_')}.py").write_text(module_text)
    cfg = json.loads((bench / "configs" / f"{base_config}.json").read_text())
    cfg.update(name=name, reference=name.replace("-", "_"), **keys)
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    return cfg


def test_a_shared_expert_model_from_new_files_alone(tiny_root):
    repo = _digests(manifest.ROOT)
    tmp = _digests(tiny_root)
    cfg = _add_model(tiny_root, "moe-shared", MOE_SHARED, "phi3.5-moe-x1-g4",
                     n_shared_experts=1)
    bench = tiny_root / "perfbench"
    shutil.copy(bench / "limits" / "phi35moe-g4-b4x1024.json",
                bench / "limits" / "moe-shared-b4x1024.json")
    man = manifest.load(tiny_root)
    man["configs"].append({"name": "moe-shared", "source": cfg["source"],
                           "file": "perfbench/configs/moe-shared.json", "reduced": [],
                           "why": "routed experts beside an always-on shared expert"})
    man["workloads"].append({"name": "moe-shared-b4x1024", "config": "moe-shared",
                             "traffic": "d_ring-b4x1024", "chips": 1,
                             "why": "the shared expert in every MoE layer"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man, root=tiny_root) == []

    assert program.arch_config(cfg, tiny_root).n_shared_experts == 1
    assert "blocks.ffn.shared.w_up" in reference.model(cfg, tiny_root).leaf_table(cfg)
    out = run_cell("moe-shared-b4x1024", 13, 0.05, False, root=tiny_root, device="cpu",
                   log=lambda _: None)
    assert out["correct"] is True and out["failed"] == 0
    broken = run_cell("moe-shared-b4x1024", 14, 0.05, False, root=tiny_root, device="cpu",
                      fault=_HalfBatch, log=lambda _: None)
    assert broken["correct"] is False
    after = _digests(tiny_root)
    assert {k: v for k, v in after.items() if k in tmp and k.name != "BENCHMARK.json"} == \
        {k: v for k, v in tmp.items() if k.name != "BENCHMARK.json"}
    assert _digests(manifest.ROOT) == repo


@pytest.mark.parametrize("keys", [{"n_shared_experts": 1}, {"ssm_state": 64},
                                  {"family": "dense"}, {"norm": "layernorm"}],
                         ids=lambda k: next(iter(k)))
def test_the_decoder_refuses_what_it_does_not_compute(keys):
    cfg = json.loads((manifest.ROOT / "perfbench/configs/phi3.5-moe-x1-g4.json").read_text())
    assert program.arch_config(cfg).n_experts == 16
    with pytest.raises(ValueError, match="decoder"):
        program.arch_config({**cfg, **keys})


def test_a_field_the_port_lacks_is_an_error(tiny_root):
    cfg = _add_model(tiny_root, "extra-field", EXTRA_FIELD, "granite-8b-x2-g4")
    with pytest.raises(TypeError, match="n_shared_heads"):
        program.arch_config(cfg, tiny_root)


def test_a_missing_reference_module_is_named(tiny_root):
    man = manifest.load(tiny_root)
    path = tiny_root / "perfbench" / "configs" / "granite-8b-x2-g4.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "reference": "absent"}))
    assert manifest.problems(man, root=tiny_root) == [
        "configuration granite-8b-x2-g4: missing perfbench/references/absent.py"]


def test_a_leaf_of_another_dtype_is_refused(tiny_root):
    """A float32 leaf of the program declared bfloat16 in the table: set-up
    refuses the pair before a step runs."""
    cfg = _add_model(tiny_root, "declared-bf16", DECLARED_BF16, "granite-8b-x2-g4")
    assert {dt for *_, dt in reference.leaves(cfg, tiny_root)} == {torch.float32,
                                                                   torch.bfloat16}
    weights = reference.draw_weights(cfg, 3, "cpu", root=tiny_root)
    traffic = manifest.traffic("d_ring-b2x512", tiny_root)
    with pytest.raises(ValueError, match="differ"):
        program.build(cfg, traffic, weights, "cpu", tiny_root)


# the decoder with the final norm's gain drawn by a callable, in float32
CALLABLE_INIT = '''import torch

from perfbench.references import decoder
from perfbench.references.decoder import arch_fields, loss_fn, model_flops_per_step, tiny


def _uniform(gen, shape, device):
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=device)


def leaf_table(cfg):
    table = decoder.leaf_table(cfg)
    table["final_norm.g"] = (table["final_norm.g"][0], _uniform, "float32")
    return table
'''


def test_a_callable_init_draws_from_the_same_generator(tiny_bf16_root):
    """A callable init takes the next draws of the one generator, in table
    order, and its leaf keeps its own dtype: the leaves before it are drawn
    as the decoder draws them, the one after it differs."""
    cfg = _add_model(tiny_bf16_root, "callable-init", CALLABLE_INIT, "granite-8b-x2-g4")
    plain = reference.draw_weights({**cfg, "reference": "decoder"}, 5, "cpu",
                                   root=tiny_bf16_root)
    drawn = reference.draw_weights(cfg, 5, "cpu", root=tiny_bf16_root)
    names = list(plain)
    at = names.index("final_norm.g")
    assert all(torch.equal(drawn[k], plain[k]) for k in names[:at])
    gen = torch.Generator().manual_seed(reference.sub_seed(5, "weights"))
    for k in names[:at]:
        if not torch.all(plain[k] == 1):
            torch.randn(plain[k].shape, generator=gen)
    assert drawn["final_norm.g"].dtype == torch.float32
    assert torch.equal(drawn["final_norm.g"], torch.rand(plain["final_norm.g"].shape,
                                                          generator=gen))
    assert drawn["head"].dtype == torch.bfloat16
    assert not torch.equal(drawn["head"], plain["head"])
    assert reference.param_bytes(cfg, tiny_bf16_root) == \
        2 * sum(reference.leaf_sizes(cfg, tiny_bf16_root)) + 2 * plain["final_norm.g"].numel()
