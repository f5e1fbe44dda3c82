"""device_idle_pct.cards (device_trace): the share of the traced window in
which no card works: 100 (1 - busy / traced window), busy the union of every
card's device intervals, since the trace record keeps no card index. Not
``device_idle_pct.serve``'s form (busy per traced call over the untraced
calls' wall): under the profiler the host launches each card's chunks later,
the cards' intervals overlap less, and their union per traced call came out
longer than an untraced call's whole wall (a reading of -4.96% on four
NVIDIA H100 80GB HBM3). Busy and window here come from the same traced
calls, so the share stays within 0-100; the profiler's slower host stages
count in it."""

from benchmark.harness import reader

SOURCE = "device_trace"
read = reader("device_idle_pct.build").read
