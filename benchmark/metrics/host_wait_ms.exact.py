"""host_wait_ms.exact (device_trace): the device's idle time in the traced
calls that the program's ``search.call`` spans cover, in ms a call: the
stretches of the traced window in which no device interval runs
(``tracing.gaps``) cut to the union of the spans, each instant counted once
(``tracing.union_ns``), over the traced calls. It is the card's wait on a
call's host stages: thread start, staging, dispatch, fetch and the host
work on the answers. None without a trace or where the program records no
``search.call`` span."""

from benchmark.tracing import gaps, union_ns

SOURCE = "device_trace"


def idle_under_ns(t: dict, names) -> int | None:
    """The idle stretches of the traced window that the host operations
    named ``names`` cover (ns; overlaps once), or None where none ran."""
    lo, hi = t["window_ns"]
    spans = [(max(s, lo), min(e, hi)) for n, s, e in t["host"] if n in names]
    if not spans:
        return None
    idle = gaps([(s, e) for _, s, e in t["device"]], lo, hi)
    # |spans n idle| = |spans| + |idle| - |spans u idle|
    return union_ns(spans) + union_ns(idle) - union_ns(spans + idle)


def read(rec):
    t = rec.trace
    if t is None or not t["calls"]:
        return None
    ns = idle_under_ns(t, {"search.call"})
    return None if ns is None else ns / t["calls"] / 1e6
