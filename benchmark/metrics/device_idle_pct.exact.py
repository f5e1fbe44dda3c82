"""device_idle_pct.exact (device_trace): ``device_idle_pct.serve`` in the
exact engine's cells, which report ``qps.exact``."""

from benchmark.harness import reader

SOURCE = "device_trace"
read = reader("device_idle_pct.serve").read
