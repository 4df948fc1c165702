"""Device ms a step of the program's ``fwd_bwd`` span (the per-node
forward and backward with the gradient copies: every op of it, not the
matmuls alone), over the span stretch: steps back to back, profiler off
(``spans.py``)."""

SPAN = "fwd_bwd"


def read(ctx):
    spans = (ctx["trace"] or {}).get("spans")
    if not spans or SPAN not in spans:
        return None
    return spans[SPAN]["device_ms"]
