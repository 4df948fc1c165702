"""The host's time inside ``SPMDTrainer.train_step`` a step, each step
started on an idle device so no full launch queue blocks the host: the
cost of dispatching one step (mean of the traced run's host stretch)."""
import numpy as np


def read(ctx):
    t = ctx["trace"]
    if not t or not t["host_step_ms"]:
        return None
    return float(np.mean(t["host_step_ms"]))
