"""A new configuration, traffic mix and per-layer metric are found by
name from new files and new manifest entries, with no file edited."""
import hashlib
import json
import shutil

from perfbench import manifest
from perfbench.cell import run_cell


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and p.name != "BENCHMARK.json"}


def test_new_cell_from_files_alone(tiny_root):
    before = _digests(tiny_root)
    bench = tiny_root / "perfbench"
    cfg = json.loads((bench / "configs" / "granite-8b-x2-g4.json").read_text())
    cfg.update(name="wide-x2-g4", d_ff=128)
    (bench / "configs" / "wide-x2-g4.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "d_ring-b2x512.json").read_text())
    traffic.update(per_node_batch=4, seq_len=8)
    (bench / "traffic" / "d_ring-b4x8.json").write_text(json.dumps(traffic))
    shutil.copy(bench / "limits" / "granite8b-g4-b4x1024.json",
                bench / "limits" / "wide-b4x8.json")
    (bench / "metrics" / "steps.count.py").write_text(
        "def read(ctx):\n    return ctx['window']['steps'] if ctx['window'] else None\n")
    man = manifest.load(tiny_root)
    man["configs"].append({"name": "wide-x2-g4", "source": cfg["source"],
                           "file": "perfbench/configs/wide-x2-g4.json", "reduced": [],
                           "why": "a wider MLP"})
    man["workloads"].append({"name": "wide-b4x8", "config": "wide-x2-g4",
                             "traffic": "d_ring-b4x8", "chips": 1, "why": "short rows"})
    man["end_to_end"].append({"name": "steps.count", "unit": "steps", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["wide-b4x8"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man, root=tiny_root) == []
    out = run_cell("wide-b4x8", 7, 0.05, False, root=tiny_root, device="cpu",
                   log=lambda _: None)
    assert out["correct"]
    assert out["metrics"]["steps.count"]["value"] >= 1
    assert set(out["metrics"]) == {"tokens_per_s", "step_ms_p90", "setup_s", "steps.count"}
    after = _digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
