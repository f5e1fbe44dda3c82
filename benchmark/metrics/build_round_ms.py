"""build_round_ms (device_trace): the device's busy time over the traced
chunk (the union of the profiler's device intervals) divided by the build
rounds it ran (the program's counter ``build.rounds``). The ``build.round``
span is not used: it times the host's enqueue of a round."""

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    rounds = t["counters"].get("build.rounds", 0)
    if not rounds or t["busy_s"] <= 0:
        return None
    return t["busy_s"] / rounds * 1e3
