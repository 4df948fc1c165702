"""The least time of the update and the gossip mix (θ, the gradient and
the momentum read once, θ' and m' written once, each leaf at its own
dtype: 14 B a bf16 parameter of every node) at the card's memory rate,
over the device ms a step of the program's ``wire`` and ``update_mix``
spans together (the plain wire and K1), over the span stretch
(``spans.py``), in %."""
from perfbench.yardstick import least_seconds, update_mix_least_bytes

SPANS = ("wire", "update_mix")


def read(ctx):
    spans = (ctx["trace"] or {}).get("spans")
    if not spans or not all(s in spans for s in SPANS):
        return None
    ms = sum(spans[s]["device_ms"] for s in SPANS)
    nbytes = update_mix_least_bytes(ctx["nodes"], ctx["params"], ctx["param_bytes"])
    return 100.0 * least_seconds(nbytes) / (ms / 1e3)
