"""Model FLOPs a step (the yardstick's count from the configuration's
shapes) over the step time of the traced run's profiler-off stretch, over
the card's dense bf16 peak, in %."""
from perfbench.yardstick import PEAK_BF16_FLOPS, model_flops_per_step


def read(ctx):
    t = ctx["trace"]
    if not t or not t.get("untraced_step_ms"):
        return None
    tr = ctx["traffic"]
    flops = model_flops_per_step(ctx["cfg"], nodes=ctx["nodes"],
                                 per_node_batch=tr["per_node_batch"], seq=tr["seq_len"])
    return 100.0 * flops / (t["untraced_step_ms"] / 1e3) / PEAK_BF16_FLOPS
