"""The traced stretch's reduction: kernels given to the steps that
launched them, busy time as a union, idle gaps named by the host's op."""
from types import SimpleNamespace as NS

import pytest

from perfbench.trace import STEP, WINDOW, summarize


def _ev(name, a, b, *, device=False, i=0, link=0, annotation=False):
    return NS(name=name, time_range=NS(start=a, end=b), is_async=False, id=i,
              device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
              linked_correlation_id=link, is_user_annotation=annotation)


def test_summarize():
    events = [
        _ev(WINDOW, 0, 1000), _ev(STEP, 0, 100), _ev(STEP, 100, 400), _ev(STEP, 400, 700),
        _ev(STEP, 100, 400, device=True, annotation=True),
        _ev("aten::mm", 110, 120, i=5), _ev("aten::add", 410, 420, i=6),
        _ev("cudaStreamSynchronize", 700, 1000),
        _ev("void program_update_kernel<bf16>", 90, 150, device=True),     # step 0's
        _ev("nvjet_tst_256x128", 150, 300, device=True, link=5),           # step 1
        _ev("nvjet_tst_256x128", 320, 330, device=True, link=5),           # step 1
        _ev("elementwise_kernel", 500, 600, device=True, link=6),          # step 2
    ]
    out = summarize(events)
    assert out["steps"] == 2
    assert out["window_s"] == pytest.approx(900e-6)
    assert out["busy_s"] == pytest.approx((50 + 150 + 10 + 100) * 1e-6)
    assert out["group_ms"] == pytest.approx({"matmul": 0.08, "other": 0.05})
    assert out["device_ops"][0] == ["nvjet_tst_256x128", pytest.approx(160e-6)]
    gaps = dict(out["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(400e-6)
    assert gaps["aten::add"] == pytest.approx(170e-6)
    assert gaps["no op on the host"] == pytest.approx(20e-6)
