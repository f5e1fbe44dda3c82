"""device_idle_pct.build (device_trace): the share of the traced chunk in
which no device interval runs: 100 (1 - busy / traced window), busy the
union of the device's intervals. The chunks of a window differ in size, so
the traced one is measured against its own span."""

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
