"""search_device_ms.batch (device_trace): the device's busy time per traced
call (the union of the profiler's device intervals over the traced calls,
divided by their number): the search program's work on one 10,000-query
call, B1 and the exact rerank included."""

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None or not t["calls"] or t["busy_s"] <= 0:
        return None
    return t["busy_s"] / t["calls"] * 1e3
