"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax``, the reference package ``repro`` or
``ml_dtypes`` (which the card's machine does not have)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_forbidden(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_loads_no_jax():
    """Import every port module in a fresh interpreter, then check
    ``sys.modules``."""
    mods = list(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD=' + ','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout, out.stdout
    assert len(mods) >= 42
    for m in ("repro_torch.core.consensus", "repro_torch.core.faults",
              "repro_torch.core.mixing", "repro_torch.core.simulator",
              "repro_torch.models.paper_models", "repro_torch.models.recurrence",
              "repro_torch.models.moe", "repro_torch.models.rwkv6",
              "repro_torch.models.mamba2", "repro_torch.configs.zamba2_7b",
              "repro_torch.configs.phi35_moe_42b", "repro_torch.configs.rwkv6_1b6",
              "repro_torch.configs.internvl2_2b", "repro_torch.configs.kimi_k2_1t",
              "repro_torch.configs.stablelm_12b", "repro_torch.configs.musicgen_medium",
              "repro_torch.configs.starcoder2_7b", "repro_torch.configs.qwen25_14b"):
        assert m in mods
