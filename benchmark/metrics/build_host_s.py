"""build_host_s (device_trace): the device's idle time in the traced chunk
under the build's host stages, in s a traced chunk: the program's
``build.setup``, ``build.plan``, ``build.flush``, ``build.repair`` and
``program.capture`` spans, their union cut to the stretches in which no
device interval runs, each instant counted once (``host_wait_ms.exact``'s
``idle_under_ns``). None without a trace or where the program records none
of the spans."""

from benchmark.harness import reader

SOURCE = "device_trace"
SPANS = {"build.setup", "build.plan", "build.flush", "build.repair", "program.capture"}


def read(rec):
    t = rec.trace
    if t is None or not t["calls"]:
        return None
    ns = reader("host_wait_ms.exact").idle_under_ns(t, SPANS)
    return None if ns is None else ns / t["calls"] / 1e9
