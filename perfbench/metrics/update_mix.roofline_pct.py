"""The least time of the update and the gossip mix (θ, the gradient and
the momentum read once, θ' and m' written once, each leaf at its own
dtype: 14 B a bf16 parameter of every node) at the card's memory rate,
over K1's device time a step, in %.  The count is of the work, not of
K1's inputs, so a kernel that also does the wire's job still reads at most
100 %.  The plain wire's kernels (the sent rows' products, casts and adds)
are left out of the time: without a span of the program's they cannot be
told from other elementwise ops, and ``device.other_ms`` holds them."""
from perfbench.yardstick import least_seconds, update_mix_least_bytes

GROUP = "update_mix"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["group_ms"].get(GROUP):
        return None
    nbytes = update_mix_least_bytes(ctx["nodes"], ctx["params"], ctx["param_bytes"])
    return 100.0 * least_seconds(nbytes) / (t["group_ms"][GROUP] / 1e3)
