"""lockstep_ms.cards (device_trace): the stretches under the program's
``shard.poll`` spans in which no card works, overlaps counted once, in ms a
traced call. A poll is the host reading each running shard's ``done`` after
a chunk: it returns when the slowest shard has finished the chunk, and the
cards work through most of it, so the poll's whole wall would read mostly
the search's own device time. What is left once every card's device
intervals are taken out (``host_wait_ms.exact``'s ``idle_under_ns``) is the
lockstep's own cost: no card working while the host reads the flags. The
trace record keeps no card index, so a card that waits while another works
counts as busy. Read under the profiler, which slows the host's launches
and polls, so it reads above what an untraced call holds. None without a
trace or where the program records no ``shard.poll`` span."""

from benchmark.harness import reader

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None or not t["calls"]:
        return None
    ns = reader("host_wait_ms.exact").idle_under_ns(t, {"shard.poll"})
    return None if ns is None else ns / t["calls"] / 1e6
