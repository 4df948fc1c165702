"""The decoder's plain reference lives in its own module
(``references/decoder.py``), found through ``reference.model``, and reads
as the one-file reference did: the weights drawn, the reference's float32
losses and probe norms, the model FLOPs and the parameter bytes are the
values frozen here from the harness before the split (CPU, one thread)."""
import hashlib

import numpy as np
import pytest
import torch

from perfbench import check, generator, manifest, reference

# each frozen case: its configuration and traffic files, labelled by the cell
# that ran them when the values were frozen
CELLS = {"granite8b-g4-b2x512": ("granite-8b-x2-g4", "d_ring-b2x512"),
         "phi35moe-g4-b4x1024": ("phi3.5-moe-x1-g4", "d_ring-b4x1024")}
SEEDS = (7, 2**31 + 9)

# sha256 of the drawn weights (each leaf's name, dtype and bytes in leaf order)
WEIGHTS = {
    ("granite8b-g4-b2x512", "float32", 7):
        "49edbced0e7bc78592c7df13e2db4d18373fd7c7892f83ee08373570accd787f",
    ("granite8b-g4-b2x512", "float32", 2**31 + 9):
        "c08f1d0a1c12c0adfb726325fcb97c966bfb9242939510b5817ea19a321b89a7",
    ("phi35moe-g4-b4x1024", "float32", 7):
        "0ef518bec704f01f9a1456eb57922cecbb27f34b22cd6a77fc71a6c790f5dbdd",
    ("phi35moe-g4-b4x1024", "float32", 2**31 + 9):
        "718004be3d2666256e9ee092e71c3e8a294ec0238bfa3ddf310d150b2adddf4a",
    ("granite8b-g4-b2x512", "bfloat16", 7):
        "844cfd58e1fa2266cb28c8db3a93edde473a801588dd76a3087f8c84df3d9e44",
    ("granite8b-g4-b2x512", "bfloat16", 2**31 + 9):
        "46814928a8949fb374902d01199bc5504ac381cc2da810467a609132a39c847c",
    ("phi35moe-g4-b4x1024", "bfloat16", 7):
        "82fbbc964c449d3bb27b8f74f9697812cdb8d00374ee30bdff8ba657b5f5c1bb",
    ("phi35moe-g4-b4x1024", "bfloat16", 2**31 + 9):
        "4d055b6703b47a4b8750baaf76886e1e47a7f4f215a4eb48f6666df607f309f1",
}
# sha256 of the reference's (steps, G) losses and (steps, G, L) probe
# norms over the checked steps, float64 bytes
READINGS = {
    ("granite8b-g4-b2x512", 7):
        ("27b34d6b2253011d4118f0fdbf52ab0de6facdd82fae8081211ef94b2e11e9c3",
         "63e7991083a27d8316c61157b7920bd4b8ccf5c8ba4c1503b620e08b252f665c"),
    ("granite8b-g4-b2x512", 2**31 + 9):
        ("a5a0770220c71a123a009fda22ca4e35b3bc18fb534192886dc21a9e2fd0bedf",
         "baaf9f4ca110456409d3fdfe6783540f46dcf0333393d21a3755a435755b6bfb"),
    ("phi35moe-g4-b4x1024", 7):
        ("19cb16e7685bd6b0dc9659ba6cd40847a9ce7d3a2a70ed15a4742c8f6f25c41b",
         "1f25f0a1a41975bb5fafb729efcd9e4a5d36ec931d33533666006aab0760fe3a"),
    ("phi35moe-g4-b4x1024", 2**31 + 9):
        ("d7b94c7788e6b3262123e6ae7ba326c7de1b52f18d1dabb7c9537eed0b8fb240",
         "fd15e0773807c70c9025bde5dfef7e5a7df15eda782d3a4f31f5111225fa2fab"),
}
# model FLOPs of one step of each full-size cell, and its parameters a node
FLOPS = {"granite8b-g4-b2x512": 15_771_321_237_504, "phi35moe-g4-b4x1024": 32_914_884_526_080}
PARAMS = {"granite8b-g4-b2x512": 838_881_280, "phi35moe-g4-b4x1024": 1_562_980_352}


def _digest(weights) -> str:
    h = hashlib.sha256()
    for name, v in weights.items():
        h.update(name.encode())
        h.update(str(v.dtype).encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes()
                 if v.dtype == torch.bfloat16 else v.numpy().tobytes())
    return h.hexdigest()


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.float64).tobytes()).hexdigest()


def _cell(root, name):
    config, traffic = CELLS[name]
    return manifest.config(manifest.load(root), config, root), manifest.traffic(traffic, root)


@pytest.mark.parametrize("cell,dtype,seed", sorted(WEIGHTS, key=str))
def test_weights_are_drawn_as_before(request, cell, dtype, seed):
    root = request.getfixturevalue("tiny_root" if dtype == "float32" else "tiny_bf16_root")
    cfg, _ = _cell(root, cell)
    weights = reference.draw_weights(cfg, seed, "cpu", root=root)
    assert {str(v.dtype) for v in weights.values()} == {f"torch.{dtype}"}
    assert _digest(weights) == WEIGHTS[cell, dtype, seed]


@pytest.mark.parametrize("cell,seed", sorted(READINGS, key=str))
def test_the_reference_reads_as_before(tiny_root, cell, seed):
    cfg, traffic = _cell(tiny_root, cell)
    weights = reference.draw_weights(cfg, seed, "cpu", root=tiny_root)
    pool = generator.make_pool(traffic, vocab=cfg["vocab"], nodes=cfg["nodes"], seed=seed,
                               device="cpu")
    got = reference.run_reference(cfg, weights, pool[:check.CHECKED_STEPS], nodes=cfg["nodes"],
                                  lr=cfg["optimizer"]["lr"],
                                  beta=cfg["optimizer"]["momentum"],
                                  topology=traffic["topology"], root=tiny_root)
    assert got["losses"].shape == (check.CHECKED_STEPS, cfg["nodes"])
    assert (_sha(got["losses"]), _sha(got["probe"])) == READINGS[cell, seed]


@pytest.mark.parametrize("cell", CELLS)
def test_model_flops_as_before(cell):
    cfg, traffic = _cell(manifest.ROOT, cell)
    mod = reference.model(cfg)
    assert mod.__name__ == "perfbench_reference_decoder"
    assert mod.model_flops_per_step(cfg, nodes=cfg["nodes"],
                                    per_node_batch=traffic["per_node_batch"],
                                    seq=traffic["seq_len"]) == FLOPS[cell]


@pytest.mark.parametrize("cell", CELLS)
def test_param_bytes_of_one_dtype(cell):
    cfg, _ = _cell(manifest.ROOT, cell)
    params = sum(reference.leaf_sizes(cfg))
    assert params == PARAMS[cell]
    assert reference.param_bytes(cfg) == params * reference.DTYPES[cfg["dtype"]].itemsize
