"""b2_roofline_pct (device_trace): the least time the traced calls' B2
launches could take (``roofline.b2_bound_s`` at the call's shape: B
queries over the corpus' N rows of d, k; times the launches the program
counted, ``scan_topk``) over the time the profiler saw B2 run (the union of
the intervals of ``scan_topk.cu``'s kernels: ``scan_tile_kernel`` and
``scan_kloop_kernel`` with the packed epilogue, ``scan_topk_kernel``; the
unpacked scan, B5, excluded)."""

from benchmark.roofline import b2_bound_s
from benchmark.tracing import union_ns

SOURCE = "device_trace"
KERNELS = ("scan_tile_kernel", "scan_kloop_kernel", "scan_topk_kernel")


def _b2(name: str) -> bool:
    return any(k in name for k in KERNELS) and "npacked" not in name


def read(rec):
    t, sh = rec.trace, rec.shapes
    if t is None or "N" not in sh:
        return None
    launches = t["launches"].get("scan_topk", 0)
    ran = union_ns([(s, e) for n, s, e in t["device"] if _b2(n)])
    if not launches or ran <= 0:
        return None
    bound = launches * b2_bound_s(sh["B"], sh["N"], sh["d"], sh["k"])
    return 100.0 * bound / (ran / 1e9)
