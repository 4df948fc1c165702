"""Model FLOPs a step (the count of the configuration's reference module,
``model_flops_per_step``, from its shapes) over the step time of the
traced run's profiler-off stretch, over the card's dense bf16 peak, in %."""
from perfbench.yardstick import PEAK_BF16_FLOPS


def read(ctx):
    t = ctx["trace"]
    if not t or not t.get("untraced_step_ms"):
        return None
    seconds = t["untraced_step_ms"] / 1e3
    return 100.0 * ctx["model_flops_per_step"] / seconds / PEAK_BF16_FLOPS
