"""The device's idle share of the idle stretch (``spans.py``): steps back
to back under a profiler of CUDA activity and user ranges alone, from the
first counted step's start to the last one's end on the host, in %."""


def read(ctx):
    idle = (ctx["trace"] or {}).get("idle")
    if not idle or not idle["window_s"]:
        return None
    return 100.0 * (1.0 - idle["busy_s"] / idle["window_s"])
