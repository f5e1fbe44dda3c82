"""build_rows_per_s (host_clock): the job's rows inserted in the window over
the seconds from the window's start to the synchronize that ends its last
chunk (``harness.window_rate``)."""

from benchmark.harness import window_rate

SOURCE = "host_clock"


def read(rec):
    return window_rate(rec.calls)
