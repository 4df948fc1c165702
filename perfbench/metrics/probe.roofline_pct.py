"""The least time of the DBench probe (θ read once, each leaf at its
own dtype, the (G, leaves) float32 norms written once) at the card's
memory rate, over K3's device time a step, in %."""
from perfbench.yardstick import least_seconds, probe_least_bytes

GROUP = "probe"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["group_ms"].get(GROUP):
        return None
    nbytes = probe_least_bytes(ctx["nodes"], ctx["param_bytes"], ctx["n_leaves"])
    return 100.0 * least_seconds(nbytes) / (t["group_ms"][GROUP] / 1e3)
