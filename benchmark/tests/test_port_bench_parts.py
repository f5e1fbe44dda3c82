"""The benchmark's arithmetic on the CPU: the generator, the end-to-end
rates over all calls, recall against a NumPy fp64 brute force (ties
included), the roofline counts and the device-busy union."""

import types

import numpy as np
import pytest
import torch

from benchmark import datagen, harness, judge, references, roofline, tracing

GAUSS = {"recipe": "gauss", "intrinsic": 16, "noise": 0.02}


def test_generator_is_deterministic_per_seed():
    a = datagen.make(GAUSS, 500, 50, 24, 2**31 + 12345, "cpu")
    b = datagen.make(GAUSS, 500, 50, 24, 2**31 + 12345, "cpu")
    c = datagen.make(GAUSS, 500, 50, 24, 2**31 + 12346, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (500, 24) and a[1].shape == (50, 24) and a[0].dtype == torch.float32


def _rec(calls):
    return types.SimpleNamespace(calls=calls)


@pytest.mark.parametrize("name", ["qps", "qps.exact", "build_rows_per_s"])
def test_rates_take_every_call_and_the_whole_window(name):
    steady = [(i * 0.1, i * 0.1 + 0.1, 100) for i in range(20)]
    stalled = steady[:10] + [(1.0, 3.0, 100)] + [(t0 + 2.0, t1 + 2.0, n) for t0, t1, n in steady[11:]]
    read = harness.reader(name).read
    assert read(_rec(steady)) == pytest.approx(2000 / 2.0)
    assert read(_rec(stalled)) == pytest.approx(2000 / 4.0)


@pytest.mark.parametrize("name", ["latency_p95_ms", "latency_p95_ms.exact"])
def test_latency_p95_is_over_all_calls(name):
    calls = [(0.0, 0.010, 1)] * 90 + [(0.0, 0.050, 1)] * 10
    read = harness.reader(name).read
    assert read(_rec(calls)) == pytest.approx(np.percentile([10.0] * 90 + [50.0] * 10, 95))
    calls[-20:-10] = [(0.0, 0.050, 1)] * 10  # a planted stall moves the tail
    assert read(_rec(calls)) == pytest.approx(50.0)


def _numpy_recall(X, Q, qidx, ids, k):
    """fp64 brute force, tie-aware, each returned row counted once."""
    X64, hits = X.astype(np.float64), 0
    for a, q in enumerate(qidx):
        d2 = ((X64 - Q[q].astype(np.float64)) ** 2).sum(1)
        kth = np.sort(d2)[k - 1]
        seen = set()
        for i in ids[a]:
            if 0 <= i < len(X) and i not in seen and d2[i] <= kth * (1 + 1e-6):
                hits += 1
            seen.add(int(i))
    return hits / (len(qidx) * k)


def test_recall_against_numpy_fp64_with_ties():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((400, 16)).astype(np.float32)
    X[200:300] = X[100:200]  # every row of 100..199 has an exact twin
    Q = rng.standard_normal((40, 16)).astype(np.float32)
    Q[:20] = X[100:120] + np.float32(1e-3)
    k = 10
    ref = references.for_metric("L2")
    Xt, Qt = torch.as_tensor(X), torch.as_tensor(Q)
    truth = ref.truth(Xt, Qt, k)
    qidx = np.repeat(np.arange(40), 2)
    t_ids = truth[0].numpy()[qidx].copy()
    # swap each row for its twin (a tie: still a hit), drop one answer, repeat one
    twin = (t_ids >= 100) & (t_ids < 300)
    ids = np.where(twin, np.where(t_ids < 200, t_ids + 100, t_ids - 100), t_ids)
    assert (ids != t_ids).any()
    ids[1, 9] = -1
    ids[3, 9] = ids[3, 8]
    d = np.sqrt(((X[np.clip(ids, 0, None)].astype(np.float64) - Q[qidx][:, None]) ** 2).sum(-1))
    order = np.argsort(d, 1, kind="stable")
    ids, d = np.take_along_axis(ids, order, 1), np.take_along_axis(d, order, 1)
    got = judge.judge(ref, Xt, Qt, truth, qidx, ids, d.astype(np.float32))
    assert got["recall_at_10"] == pytest.approx(_numpy_recall(X, Q, qidx, ids, k))
    assert got["recall_at_10"] == pytest.approx(1 - 2 / (80 * k))
    assert got["bad_rows"] == 2
    assert got["dist_gap"] < 1e-6


def test_b1_bound_counts_blocks_ids_and_queries():
    B, E, M0, rid, d = 10000, 4, 56, 8, 128
    nbytes = (B * E * (M0 * d + 4 * M0) + B * d * 4 + B * 4 + B * E * 4 + B * E * M0 * 8)
    assert roofline.b1_bound_s(B, E, M0, rid, d) == pytest.approx(nbytes / 3.35e12)
    assert roofline.b1_bound_s(B, E, M0, 0, d) == pytest.approx(
        (B * E * M0 * d + B * d * 4 + B * 4 + B * E * 4 + B * E * M0 * 4) / 3.35e12)


def test_b2_bound_is_operations_at_the_bf16_peak():
    B, N, d, k = 1000, 1_000_000, 960, 10
    assert roofline.b2_bound_s(B, N, d, k) == pytest.approx(2 * B * N * d / 989e12)
    # a single query is bound by the corpus' bytes
    assert roofline.b2_bound_s(1, N, d, k) == pytest.approx((2 * N * d + 4 * d + 80) / 3.35e12)


def test_union_counts_overlaps_once():
    assert tracing.union_ns([(0, 10), (5, 15), (20, 30), (22, 25), (30, 31)]) == 26
    assert tracing.union_ns([]) == 0
    assert tracing.gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]


def test_busy_idle_and_roofline_readers_on_a_planted_trace():
    dev = [("void codec_scores_bulk_kernel<1>(int)", 0, 300), ("radixSortKVInPlace", 300, 700),
           ("cub::DeviceSegmentedSortKernel", 900, 1000)]
    t = {"device": dev, "host": [("aten::copy_", 700, 900)], "window_ns": (0, 2000),
         "window_s": 2e-6, "busy_s": tracing.union_ns([(s, e) for _, s, e in dev]) / 1e9,
         "calls": 2, "walls_s": 3e-6, "untraced_wall_s": 1e-6, "launches": {"codec_scores_ids": 3}, "counters": {}}
    rec = types.SimpleNamespace(trace=t, shapes={"B": 8, "E": 4, "M0": 4, "rid": 1, "d": 16},
                                infos=[{"capture_s": 1.0}, None, {"capture_s": 3.0}], calls=[])
    # a call's busy (400 ns) against the untraced calls' wall (1000 ns); the
    # traced window (2000 ns for two calls) against the build's
    assert harness.reader("device_idle_pct.serve").read(rec) == pytest.approx(100 * (1 - 400 / 1000))
    assert harness.reader("device_idle_pct.build").read(rec) == pytest.approx(100 * (1 - 800 / 2000))
    assert harness.reader("sort_share_pct.batch").read(rec) == pytest.approx(100 * 500 / 800)
    assert harness.reader("search_device_ms.batch").read(rec) == pytest.approx(800e-9 / 2 * 1e3)
    assert harness.reader("build_capture_s").read(rec) == pytest.approx(2.0)  # per chunk
    assert harness.reader("device_idle_pct.exact").read(rec) == pytest.approx(100 * (1 - 400 / 1000))
    bd = tracing.breakdown(t)
    assert bd["device_ops"][0][0].startswith("radixSort")
    assert ["aten::copy_", 200e-9] in bd["idle_gaps"]


def test_readers_find_nothing_without_a_trace():
    rec = types.SimpleNamespace(trace=None, shapes={}, infos=[None], calls=[])
    for name in ("search_device_ms.batch", "sort_share_pct.batch",
                 "scan_device_ms.exact", "b2_roofline_pct", "build_round_ms", "build_capture_s",
                 "device_idle_pct.serve", "device_idle_pct.build"):
        assert harness.reader(name).read(rec) is None
