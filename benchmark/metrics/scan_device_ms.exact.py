"""scan_device_ms.exact (device_trace): the device's busy time per traced
call (the union of the profiler's device intervals over the traced calls,
divided by their number): the exact program's scan (B2), top-k and refine
of one call."""

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None or not t["calls"] or t["busy_s"] <= 0:
        return None
    return t["busy_s"] / t["calls"] * 1e3
