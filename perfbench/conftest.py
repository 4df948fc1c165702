"""Fixtures of the benchmark's CPU tests: a checkout-like directory whose
manifest holds tiny cells of the benchmarked families."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TRAFFIC = {"per_node_batch": 2, "seq_len": 16, "pool": 4}


def make_tiny_root(tmp: Path, dtype: str = "float32") -> Path:
    """A copy of the benchmark's files under ``tmp`` whose configurations
    (in ``dtype``; each cut by its reference module's ``tiny``) and traffic
    are cut to CPU size, with float32 limits."""
    from perfbench import reference

    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*.py"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in man["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(reference.model(cfg, tmp).tiny(cfg), dtype=dtype)
        path.write_text(json.dumps(cfg))
    for path in (tmp / "perfbench" / "traffic").glob("*.json"):
        path.write_text(json.dumps({**json.loads(path.read_text()), **TINY_TRAFFIC}))
    for w in man["workloads"]:
        lim = {"loss_gap": 1e-4, "grad_norm_gap": 1e-4, "change_gap": 1e-3, "probe_gap": 1e-5}
        (tmp / "perfbench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps({"limits": lim}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny shapes run fastest on one thread; the worker's setting is
    restored after each test."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def tiny_bf16_root(tmp_path):
    return make_tiny_root(tmp_path, "bfloat16")
