"""device_idle_pct.serve (device_trace): the share of a call in which no
device interval runs: 100 (1 - busy per traced call / mean wall of the
window's untraced calls), busy the union of the device's intervals over the
traced calls. A serving call is one fixed shape, so the traced calls' busy
stands for every call's; their walls do not, being slowed by the profiler
(cudaGraphLaunch with CUPTI recording each of a graph's kernels)."""

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None or not t["calls"] or t["busy_s"] <= 0 or not t.get("untraced_wall_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["calls"] / t["untraced_wall_s"])
