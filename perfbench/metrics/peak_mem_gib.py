"""``torch.cuda.max_memory_allocated()`` over the window, reset once the
state and the warm-up were done, in GiB."""


def read(ctx):
    if not ctx["window"] or not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2**30
