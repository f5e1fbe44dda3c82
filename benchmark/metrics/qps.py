"""qps (host_clock): all queries answered in the window over the window's
seconds, from the first call's submission to the last call's return
(``harness.window_rate``)."""

from benchmark.harness import window_rate

SOURCE = "host_clock"


def read(rec):
    return window_rate(rec.calls)
