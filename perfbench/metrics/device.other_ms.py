"""Device time a step of every operation that is neither a matmul nor K1
nor K3: the plain wire, softmax, norms, the MoE dispatch, casts, copies."""

GROUP = "other"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["group_ms"].get(GROUP):
        return None
    return t["group_ms"][GROUP]
