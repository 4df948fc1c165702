"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference loads nothing of the program (checked in fresh interpreters)."""
import json
import subprocess
import sys

from perfbench import manifest

ROOT = manifest.ROOT


def _top_level_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    code = ("import perfbench.run, perfbench.calibrate\n"
            "from perfbench import cell, program, trace, manifest\n"
            "program.import_program()\n"
            "man = manifest.load()\n"
            "[manifest.reader(m['name']) for m in man['end_to_end'] + man['per_layer']]")
    loaded = _top_level_after(code)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_after("import perfbench.reference, perfbench.check, "
                              "perfbench.generator, perfbench.yardstick, "
                              "perfbench.references.decoder")
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
