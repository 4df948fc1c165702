"""The 90th percentile of the window's step durations, each taken between
the CUDA events recorded on the stream at its step boundaries, so a stall
or an idle device between steps counts."""
import numpy as np


def read(ctx):
    w = ctx["window"]
    if not w or not w["step_ms"]:
        return None
    return float(np.percentile(np.asarray(w["step_ms"]), 90))
