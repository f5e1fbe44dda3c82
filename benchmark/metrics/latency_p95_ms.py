"""latency_p95_ms (host_clock): the 95th percentile of every call's wall
time in the window, queries handed in to ids and distances back on the
host (numpy's linear interpolation between order statistics)."""

import numpy as np

SOURCE = "host_clock"


def read(rec):
    if not rec.calls:
        return None
    return float(np.percentile([t1 - t0 for t0, t1, _ in rec.calls], 95)) * 1e3
