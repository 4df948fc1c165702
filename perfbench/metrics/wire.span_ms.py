"""Device ms a step of the program's ``wire`` span (the plain wire: the
senders' post-update rows, in column chunks of eager ops, before K1),
over the span stretch: steps back to back, profiler off (``spans.py``)."""

SPAN = "wire"


def read(ctx):
    spans = (ctx["trace"] or {}).get("spans")
    if not spans or SPAN not in spans:
        return None
    return spans[SPAN]["device_ms"]
