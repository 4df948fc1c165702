"""Device time a step of the matrix-multiply kernels (the yardstick's
``matmul`` group of kernel names: cuBLAS's and CUTLASS's), nearly all of
them the per-node forward and backward."""

GROUP = "matmul"


def read(ctx):
    t = ctx["trace"]
    if not t or not t["group_ms"].get(GROUP):
        return None
    return t["group_ms"][GROUP]
