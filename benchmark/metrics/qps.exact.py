"""qps.exact (host_clock): ``qps`` in the exact engine's cells, a metric of
its own so that its bound follows its own runs' spread: a third of each
exact call is host work, which spreads far wider than the graph search."""

from benchmark.harness import reader

SOURCE = "host_clock"
read = reader("qps").read
