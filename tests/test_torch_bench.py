"""The port's benchmark (``hnsw_tpu_torch/bench.py``) on the CPU: its
corpora against the root ``bench.py``'s array for array, its pool ground truth
against the host fp64 oracle and the JAX package's interpreted scan, the
recall scorer on constructed ties, the block timer under an injected clock,
the ef sweep on cases worked out from ``bench.py:389-423``, the knobs, the
entry check, and one small end-to-end run through ``main``."""

import ast
import os
import pathlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import bench as root_bench
from hnsw_tpu.ops.pallas_topk import pad_corpus as j_pad_corpus
from hnsw_tpu.ops.pallas_topk import pallas_l2_topk_stream
from hnsw_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _root_bench_keys():
    """The keys of the JSON line the root bench.py prints, in order, read
    from its ``json.dumps({...})`` call (``**`` entries: both arms' dicts)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps")
    keys = []

    def walk(d):
        for k, v in zip(d.keys, d.values):
            if k is None:
                walk(v.body)  # **({...} if cond else {})
            else:
                keys.append(k.value)
    walk(call.args[0])
    return keys


@pytest.mark.parametrize("kind", ["gauss", "clustered"])
def test_make_dataset_equals_root_bench(monkeypatch, kind):
    monkeypatch.setenv("BENCH_CLUSTERS", "24")
    got = bench.make_dataset(kind, np.random.default_rng(1234), 5000, 300, 32, 8)
    want = root_bench.make_dataset(kind, np.random.default_rng(1234), 5000, 300, 32, 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def _gt_data():
    """tests/test_bench_gt.py's data: low intrinsic dimension, near ties."""
    rng = np.random.default_rng(99)
    n, d, nq = 5000, 64, 64
    A = rng.standard_normal((8, d)).astype(np.float32) / np.sqrt(8)
    X = (rng.standard_normal((n, 8), dtype=np.float32) @ A
         + 0.02 * rng.standard_normal((n, d), dtype=np.float32))
    Q = (rng.standard_normal((nq, 8), dtype=np.float32) @ A
         + 0.02 * rng.standard_normal((nq, d), dtype=np.float32))
    return X, Q


def test_pool_ground_truth_equals_host_oracle_and_jax_pool():
    X, Q = _gt_data()
    k, pool = 10, 40
    oracle = np.empty(len(Q))
    for b in range(len(Q)):  # direct-form fp64 over the whole corpus
        dv = X.astype(np.float64) - Q[b].astype(np.float64)
        oracle[b] = np.sqrt(np.partition((dv * dv).sum(-1), k - 1)[k - 1])
    scan = bench.scan_corpus(X, CPU)
    kth_port = bench.pool_kth(scan, X, Q, k, pool, batch=32)
    Xp, xsq, perm = j_pad_corpus(X, tn=256)
    _, j_ids = pallas_l2_topk_stream(Q, jnp.asarray(Xp), jnp.asarray(xsq), pool, tn=256,
                                     group=8, acc=2, batch=32, interpret=True)
    kth_jax = bench.kth_from_pool(X, Q, perm[np.clip(j_ids, 0, len(X) - 1)], k)
    np.testing.assert_allclose(kth_port, oracle, rtol=0, atol=0)
    np.testing.assert_allclose(kth_port, kth_jax, rtol=0, atol=0)
    # BENCH_GT=host: the norm-form oracle, within its documented 1e-6 margin
    np.testing.assert_allclose(bench.host_kth(X, Q, k), oracle, rtol=1e-6, atol=0)


def test_recall_fp64_ties():
    X = np.zeros((6, 4), np.float32)
    X[:, 0] = [1, 2, 3, 4, 5, 6]
    Q = np.zeros((1, 4), np.float32)
    kth = np.array([3.0])  # k = 3: rows 0-2 are the truth
    assert bench.recall_fp64(X, Q, kth, np.array([[0, 1, 2]]), 3) == 1.0
    # a candidate exactly at the k-th distance counts, one at kth(1 + 2e-6) does not
    X[3, 0] = np.float32(3.0)
    X[4, 0] = np.float32(3.0 * (1 + 2e-6))
    assert float(X[4, 0]) > 3.0 * (1 + 1e-6) + 1e-12
    assert bench.recall_fp64(X, Q, kth, np.array([[3, 0, 1]]), 3) == 1.0
    assert bench.recall_fp64(X, Q, kth, np.array([[4, 0, 1]]), 3) == pytest.approx(2 / 3)
    # -1 never counts, though it would clip onto row 0
    assert bench.recall_fp64(X, Q, kth, np.array([[-1, 1, 2]]), 3) == pytest.approx(2 / 3)
    # only the first len(kth) queries are scored
    assert bench.recall_fp64(X, np.concatenate([Q, Q]), kth,
                             np.array([[0, 1, 2], [5, 5, 5]]), 3) == 1.0


class _Clock:
    """A clock that moves only when the timed work runs: each ``run_once``
    call takes the next duration of the list."""

    def __init__(self, durations):
        self.t, self.durations, self.calls = 0.0, list(durations), 0

    def __call__(self):
        return self.t

    def run_once(self):
        self.t += self.durations[self.calls]
        self.calls += 1


def test_median_blocks_warmup_stops_at_first_agreeing_pair():
    # first call 1 s -> one call a 1 s block; warm-up blocks 2.0, 1.5, 1.45 s:
    # 1.5 vs 1.45 agree within 5%, so the fourth warm-up block never runs
    c = _Clock([1.0, 2.0, 1.5, 1.45, 1.0, 1.25, 1.0])
    med, spread, per, disc = bench.median_blocks(c.run_once, 100, 3, 1.0, clock=c)
    assert c.calls == 7 and disc == 0
    assert per == [100.0, 80.0, 100.0]
    assert med == pytest.approx(100.0) and spread == pytest.approx(0.2)


def test_median_blocks_min_block_sets_reps():
    # first call 0.3 s -> ceil(1.0 / 0.3) = 4 calls a block
    c = _Clock([0.3] + [0.25] * 4 * 4)
    med, spread, per, disc = bench.median_blocks(c.run_once, 10, 2, 1.0, clock=c)
    assert c.calls == 1 + 4 * 2 + 4 * 2  # two warm-up blocks agree, two timed
    assert med == pytest.approx(40.0) and per == [40.0, 40.0] and spread == 0.0


def test_median_blocks_stall_is_retried_and_counted():
    # warm-up 1, 1 (agree); blocks 1, 1, then a 2 s block (QPS 50 < 0.6 x 100)
    # is discarded from the third on, and the next one is kept
    c = _Clock([1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 1.1])
    med, spread, per, disc = bench.median_blocks(c.run_once, 100, 3, 1.0, clock=c)
    assert disc == 1 and c.calls == 7
    assert per == [100.0, 100.0, round(100 / 1.1, 1)]
    assert med == pytest.approx(100.0)
    assert spread == pytest.approx((100 - 100 / 1.1) / 100)


def test_median_blocks_retries_stop_at_blocks():
    # every block after the first two stalls: 3 retries, then the stall is kept
    c = _Clock([1.0, 1.0, 1.0, 1.0, 1.0] + [5.0] * 4)
    med, spread, per, disc = bench.median_blocks(c.run_once, 100, 3, 1.0, clock=c)
    assert disc == 3 and c.calls == 9
    assert per == [100.0, 100.0, 20.0]
    assert med == pytest.approx(100.0) and spread == pytest.approx(0.8)


def _sweep(table, k=10, pool=None, floor=0.98, target=None):
    target = max(floor + 0.005, 0.985) if target is None else target
    asked = []

    def recall_at(ef):
        asked.append(ef)
        return table[ef]
    return bench.choose_ef(recall_at, k, pool, floor, target), asked


def test_choose_ef_monotone():
    table = {16: 0.90, 24: 0.95, 32: 0.97, 48: 0.982, 64: 0.988, 72: 0.991, 80: 0.993}
    ch, asked = _sweep(table)
    assert asked == [16, 24, 32, 48, 64, 72]  # 72 meets the target and 0.99
    assert (ch.ef, ch.recall) == (64, 0.988)  # first at the target 0.985
    assert (ch.floor_ef, ch.floor_recall) == (48, 0.982)
    assert (ch.ef99, ch.recall99) == (72, 0.991)
    assert ch.sweep == [(ef, table[ef]) for ef in asked]


def test_choose_ef_dip_keeps_the_better_earlier_point():
    table = {16: 0.90, 24: 0.96, 32: 0.95, 48: 0.97, 64: 0.99, 72: 0.995}
    ch, asked = _sweep(table)
    assert asked == [16, 24, 32, 48, 64]
    assert (ch.ef, ch.recall) == (64, 0.99) and (ch.floor_ef, ch.ef99) == (64, 64)
    # a dip while hunting does not displace the better earlier point
    table = {16: 0.90, 24: 0.96, 32: 0.95}
    table.update({ef: 0.955 for ef in bench.EF_LADDER if ef > 32})
    ch, asked = _sweep(table)
    assert (ch.ef, ch.recall) == (24, 0.96) and asked == list(bench.EF_LADDER)


def test_choose_ef_tops_out_below_the_target():
    table = dict(zip(bench.EF_LADDER, np.linspace(0.90, 0.983, len(bench.EF_LADDER))))
    ch, asked = _sweep(table)
    assert asked == list(bench.EF_LADDER)
    assert (ch.ef, ch.recall) == (512, table[512])  # the best, below the target
    first = next(ef for ef in bench.EF_LADDER if table[ef] >= 0.98)
    assert ch.floor_ef == first and ch.ef99 is None


def test_choose_ef_skips_ef_below_k_without_a_pool():
    table = {ef: 0.999 for ef in bench.EF_LADDER}
    ch, asked = _sweep(table, k=100, floor=0.99)
    assert asked == [128] and ch.ef == 128
    ch, asked = _sweep(table, k=100, pool=256, floor=0.99)
    assert asked == [16] and ch.ef == 16


def test_choose_ef_stops_three_steps_past_the_target():
    # the goal (0.985) is met at 48 but 0.99 never: three more steps, then stop
    table = {16: 0.95, 24: 0.97, 32: 0.98, 48: 0.986, 64: 0.987, 72: 0.988,
             80: 0.989, 88: 0.9905}
    ch, asked = _sweep(table, floor=0.95)
    assert asked == [16, 24, 32, 48, 64, 72, 80]
    assert (ch.ef, ch.floor_ef, ch.ef99) == (48, 16, None)
    # with floor 0.99 the target is 0.995: ef99 follows every ef at >= 0.99
    table = {16: 0.97, 24: 0.991, 32: 0.993, 48: 0.996}
    ch, asked = _sweep(table, floor=0.99)
    assert asked == [16, 24, 32, 48]
    assert (ch.ef, ch.floor_ef, ch.ef99, ch.recall99) == (48, 24, 48, 0.996)


@pytest.mark.parametrize("env, want", [
    ({}, dict(n=200_000, batch=16384, qdtype="f16", pool=None, target=0.985, kernel=True)),
    ({"BENCH_N": "3000"}, dict(batch=2048)),
    ({"BENCH_N": "100000"}, dict(batch=8192)),
    ({"BENCH_N": "1000000", "BENCH_RECALL": "0.99"}, dict(batch=16384, target=0.995)),
    ({"BENCH_N": "3000", "BENCH_BATCH": "16384"}, dict(batch=16384)),
    ({"BENCH_QDTYPE": "f32", "BENCH_POOL": "256", "BENCH_KERNEL": "0",
      "BENCH_TARGET": "0.97"}, dict(qdtype=None, pool=256, kernel=False, target=0.97)),
])
def test_config_reads_bench_py_knobs(monkeypatch, env, want):
    for name in [v for v in os.environ if v.startswith("BENCH_")]:
        monkeypatch.delenv(name)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg = bench.Config(device="cpu")
    for field, value in want.items():
        got = getattr(cfg, field)
        assert got == (pytest.approx(value) if isinstance(value, float) else value), field
    assert cfg.min_block_s == 4.0 and cfg.device == "cpu"


def test_entry_faults():
    codec = SimpleNamespace(M0=56, id_rows=8)
    before = {k: 0 for k in bench.kernel_lib.LAUNCHES}
    good = dict(before, **{"codec_scores_ids": 18, "codec_scores_ids.bulk": 18,
                           "scan_topk": 4, "scan_topk.wgmma": 4})
    assert bench.entry_faults(before, good, 128, codec) == []
    bad = dict(good, **{"codec_scores_ids.bulk": 17, "codec_scores_ids.rows": 1})
    assert bench.entry_faults(before, bad, 128, codec) == [
        "B1: 17 of 18 launches took the bulk entry"]
    none = dict(good, **{"scan_topk": 0, "scan_topk.wgmma": 0})
    assert bench.entry_faults(before, none, 128, codec) == ["B2 never launched"]
    # without an id-row codec the beam loop has no B1 to launch
    assert bench.entry_faults(before, dict(none, codec_scores_ids=0), 128, None) == [
        "B2 never launched"]
    simt = dict(good, **{"scan_topk.wgmma": 0, "scan_topk.simt": 4})
    assert bench.entry_faults(before, simt, 128, codec) == [
        "B2: 0 of 4 launches took the wgmma entry"]
    # the entries follow the shape: at d=40 B2 takes wgmma (its bf16 copy padded
    # to 48 columns) and B1 rows
    assert bench.entry_faults(before, simt, 40, codec) == [
        "B2: 0 of 4 launches took the wgmma entry",
        "B1: 0 of 18 launches took the rows entry"]
    rows = dict(good, **{"codec_scores_ids.bulk": 0, "codec_scores_ids.rows": 18})
    assert bench.entry_faults(before, rows, 40, codec) == []
    # at d=784 the codec carries no id rows (d % 128 != 0): B2 alone, wgmma
    assert bench.entry_faults(before, dict(none, **{"scan_topk": 4, "scan_topk.wgmma": 4}),
                              784, SimpleNamespace(M0=48, id_rows=0)) == []


def test_main_end_to_end_on_cpu(monkeypatch):
    for name, value in {"BENCH_N": "3000", "BENCH_QBATCH": "256", "BENCH_BLOCKS": "2",
                        "BENCH_KERNEL_S": "2", "BENCH_D": "32", "BENCH_M": "12",
                        "BENCH_EFC": "64"}.items():
        monkeypatch.setenv(name, value)
    choices = []
    choose = bench.choose_ef
    monkeypatch.setattr(bench, "choose_ef", lambda *a, **kw: choices.append(
        choose(*a, **kw)) or choices[-1])
    rec = bench.main(bench.Config(device="cpu", min_block_s=0.05))
    assert bench.KEYS == tuple(_root_bench_keys()) + ("device",)
    # every conditional key is measured at this size
    assert list(rec) == list(bench.KEYS)
    assert rec["device"] == {"name": "cpu"}
    assert rec["exact_recall"] >= 0.999
    (ch,) = choices
    assert rec["hnsw_recall"] == round(dict(ch.sweep)[rec["hnsw_ef"]], 4)
    assert rec["hnsw99_recall"] >= 0.99 and rec["hnsw_recall"] >= 0.98
    assert len(rec["hnsw_blocks"]) == len(rec["exact_blocks"]) == 2
    assert rec["build_backend"] == "device" and rec["layer0_width"] >= 24


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(bench.Config())
