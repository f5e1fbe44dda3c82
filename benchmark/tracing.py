"""The traced run's records: ``torch.profiler`` over a fixed run of steady
calls inside the window, read into device intervals, host operations and
counters that the per-layer readers (``metrics/``) take their numbers from.

Device time is the union of the device's intervals (kernels, copies, sets):
records that overlap count once, so busy never exceeds the window. The
window is the span of the host annotation ``bench.traced``, from just
before the first traced call to the synchronize after the last.
"""

from __future__ import annotations

import heapq
import time

import torch

WINDOW = "bench.traced"
TOP = 10


def union_ns(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo: int, hi: int) -> list:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Tracer:
    """Profiles calls ``first`` .. ``first + calls - 1`` of the window and
    keeps the launch counts and program counters around them."""

    def __init__(self, first: int, calls: int, device, launches: dict, counters):
        self.first, self.last = first, first + calls - 1
        self.device = device
        self._launches, self._counters = launches, counters
        self.prof = self._ann = None
        self.before = self.after = None

    def pending(self, i: int) -> bool:
        return i <= self.last

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, i: int):
        if i != self.first:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.before = (dict(self._launches), self._counters())
        self._ann = torch.profiler.record_function(WINDOW)
        self._ann.__enter__()

    def stop(self, i: int):
        if i != self.last or self.prof is None:
            return
        self._sync()
        self._ann.__exit__(None, None, None)
        self.after = (dict(self._launches), self._counters())
        self.prof.stop()

    def record(self) -> dict:
        """The traced window's device intervals and host operations (ns, the
        profiler's clock), its length, the device's busy time, and the
        launches and counters that the traced calls added."""
        t0 = time.perf_counter()
        dev, host, win = [], [], None
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append((e.name(), s, s + d))
            elif e.name() == WINDOW:
                win = (s, s + d)
            else:
                host.append((e.name(), s, s + d))
        lo, hi = win
        dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
        host = [(n, s, e) for n, s, e in host if e > lo and s < hi]
        busy = union_ns([(s, e) for _, s, e in dev])
        la, ca = self.after
        lb, cb = self.before
        return {"device": dev, "host": host, "window_ns": (lo, hi),
                "window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
                "calls": self.last - self.first + 1,
                "launches": {k: la[k] - lb.get(k, 0) for k in la},
                "counters": {k: ca.get(k, 0) - cb.get(k, 0) for k in ca},
                "read_s": time.perf_counter() - t0}


def breakdown(rec: dict) -> dict:
    """The device operations that took most time, and the longest idle
    stretches by the host operation under them (the innermost one that
    covers most of the stretch; ``host`` where none is recorded)."""
    by_op: dict = {}
    for name, s, e in rec["device"]:
        by_op[name] = by_op.get(name, 0) + (e - s)
    lo, hi = rec["window_ns"]
    idle: dict = {}
    host = sorted(rec["host"], key=lambda h: h[1])
    j, active = 0, []  # heap of the host operations open at the stretch
    for a, b in gaps([(s, e) for _, s, e in rec["device"]], lo, hi):
        while j < len(host) and host[j][1] < b:
            name, s, e = host[j]
            heapq.heappush(active, (e, s, name))
            j += 1
        while active and active[0][0] <= a:
            heapq.heappop(active)
        under = [(e - s, name) for e, s, name in active if 2 * (min(e, b) - max(s, a)) >= b - a]
        name = min(under)[1] if under else "host"
        idle[name] = idle.get(name, 0) + (b - a)
    top = lambda d: [[n[:160], v / 1e9] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(idle)}
