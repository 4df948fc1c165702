"""The port's ``examples/train_100m.py`` (``repro_torch.examples.train_100m``)
at its smoke preset on a (4 data × 2 model) world of 8 gloo ranks on the
CPU: 4 steps uninterrupted, then 2 steps with a checkpoint and a fresh
world resumed from it to step 4, whose every rank ends bit for bit at the
uninterrupted run's shard row.  Each run also prints the reference
example's lines (the Gini of the parameter norms included)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import train_100m  # noqa: E402

TIMEOUT = 300


def _run(argv, tmp_path):
    return train_100m.main(argv + ["--timeout", str(TIMEOUT)], device="cpu")


def test_smoke_preset_resumes_bit_for_bit(tmp_path):
    full = _run(["--steps", "4", "--ckpt-every", "0", "--ckpt-dir", str(tmp_path / "a")],
                tmp_path)
    assert len(full) == 8 and all(r["start"] == 0 for r in full)
    assert all(np.isfinite(r["losses"]).all() and len(r["losses"]) == 4 for r in full)
    # every rank of a node reports the node's losses; the nodes diverged
    assert full[0]["losses"] == full[1]["losses"]
    assert full[0]["gini"] is not None and full[0]["gini"][1] > 0
    first = _run(["--steps", "2", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "b")],
                 tmp_path)
    assert all(len(r["losses"]) == 2 for r in first)
    resumed = _run(["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "b")],
                   tmp_path)
    assert all(r["start"] == 2 for r in resumed)
    for a, b in zip(resumed, full):
        assert np.array_equal(a["theta"], b["theta"])
        assert a["losses"] == b["losses"][2:]
    assert full[0]["n_params"] == resumed[0]["n_params"]
