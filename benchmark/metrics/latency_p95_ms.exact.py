"""latency_p95_ms.exact (host_clock): ``latency_p95_ms`` in the exact
engine's cells, a metric of its own so that its bound follows its own runs'
spread."""

from benchmark.harness import reader

SOURCE = "host_clock"
read = reader("latency_p95_ms").read
