"""host_wait_ms.batch (device_trace): ``host_wait_ms.exact`` in the graph
search's batch cells, which report ``qps``: the device's idle time under
the program's ``search.call`` spans, in ms a traced call. The profiler
doubles a graph launch's host time, so the traced reading is above the
untraced calls' wait."""

from benchmark.harness import reader

SOURCE = "device_trace"
read = reader("host_wait_ms.exact").read
