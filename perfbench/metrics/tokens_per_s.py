"""All nodes' trained tokens in the window over the window's wall time
(from the first timed step's dispatch to the synchronize after the last)."""


def read(ctx):
    w = ctx["window"]
    if not w:
        return None
    return w["steps"] * ctx["tokens_per_step"] / w["seconds"]
