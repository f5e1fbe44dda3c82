"""sort_share_pct.batch (device_trace): the share of the device's busy time
in the traced calls that sort kernels cover: the union of the intervals of
every device operation whose name holds "sort" in any case (cub's radix and
segmented sorts, torch's bitonic, warp-merge and radix key-value sorts and
the sort's post-processing) over the union of all device intervals."""

from benchmark.tracing import union_ns

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    busy = union_ns([(s, e) for _, s, e in t["device"]])
    sort = union_ns([(s, e) for n, s, e in t["device"] if "sort" in n.lower()])
    if busy <= 0 or sort <= 0:
        return None
    return 100.0 * sort / busy
