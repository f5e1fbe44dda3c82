"""build_repair_s (device_trace): the wall time of the program's
``build.repair`` spans (``ensure_navigable``, the navigability repair) in
the traced chunk, in s a traced chunk, overlaps counted once: the repair's
host work and its device time together. None without a trace or where the
program records no ``build.repair`` span."""

from benchmark.tracing import union_ns

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None or not t["calls"]:
        return None
    lo, hi = t["window_ns"]
    spans = [(max(s, lo), min(e, hi)) for n, s, e in t["host"] if n == "build.repair"]
    if not spans:
        return None
    return union_ns(spans) / t["calls"] / 1e9
