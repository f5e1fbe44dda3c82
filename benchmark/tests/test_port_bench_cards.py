"""The four-card cell ``sift4m.cards`` on the CPU at a small size: its whole
run through ``harness.run``, four shards on the one CPU device, is correct
when sound and not correct with ``ShardedHnsw.search_stream`` broken
underneath; and its three readers on planted traces, which find nothing
without the program's ``shard.*`` spans and counters."""

import types

import pytest

from benchmark import harness, tracing
from test_port_bench_faults import _answer_altered, _half_left_out, _patch_answers

CELL = "sift4m.cards"
SMALL = {"config": {"n": 4800, "d": 32,
                    "index": {"engine": "ShardedHnsw", "shards": 4, "max_nb_connection": 12,
                              "ef_construction": 64, "level_scale": 0.5, "keep_pruned": True,
                              "build_batch": 512},
                    "search": {"ef": 64, "expand": 4, "query_dtype": "f32"}},
         "workload": {"per_call": 100, "pool": 500, "warm_calls": 1}}
TARGET = ("hnsw_tpu_torch.parallel.sharded", "ShardedHnsw", "search_stream")


def _run(seed=2**31 + 91):
    return harness.run(CELL, seed, 0.5, False, "cpu", 0.0, overrides=SMALL)


def test_sound_sharded_run_is_correct():
    out = _run()
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["device"]["count"] == 4
    assert {"qps", "latency_p95_ms", "recall_at_10", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered], ids=["half", "altered"])
def test_a_broken_sharded_answer_is_not_correct(monkeypatch, fault):
    _patch_answers(monkeypatch, TARGET, fault)
    out = _run()
    assert not out["correct"], out["compared"]


def _rec(host, counters, device=(), window=(0, 10_000), calls=2, untraced_wall_s=None):
    lo, hi = window
    busy = tracing.union_ns([(s, e) for _, s, e in device])
    t = {"device": list(device), "host": host, "window_ns": window,
         "window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9, "calls": calls,
         "launches": {}, "counters": counters, "untraced_wall_s": untraced_wall_s}
    return types.SimpleNamespace(trace=t, shapes={}, infos=[], calls=[])


def test_lockstep_takes_the_idle_under_the_poll_spans():
    host = [("search.call", 0, 9000), ("shard.step", 100, 200),
            ("shard.poll", 200, 1200), ("shard.poll", 1000, 1500),  # overlapping: once
            ("shard.poll", -500, 50),                                # cut to the window
            ("shard.merge", 1500, 2000)]
    read = harness.reader("lockstep_ms.cards").read
    assert read(_rec(host, {})) == pytest.approx((1300 + 50) / 2 / 1e6)
    # two cards busy over [300, 900) and [600, 1100): of the polls' 1350 ns
    # only [0, 50), [200, 300) and [1100, 1500) have no card working
    device = [("k", 300, 900), ("k", 600, 1100), ("k", 2000, 3000)]
    assert read(_rec(host, {}, device)) == pytest.approx((50 + 100 + 400) / 2 / 1e6)


def test_straggler_share_of_the_chunk_slots():
    got = harness.reader("straggler_pct.cards").read(
        _rec([], {"shard.steps": 30.0, "shard.idle_steps": 10.0}))
    assert got == pytest.approx(25.0)
    assert harness.reader("straggler_pct.cards").read(
        _rec([], {"shard.steps": 8.0, "shard.idle_steps": 0.0})) == 0.0


def test_idle_share_of_the_cards_union():
    # busy [1000, 3000) and [2000, 4000) on two cards: 3000 ns of a 10,000 ns window,
    # whatever the untraced calls' walls
    device = [("k", 1000, 3000), ("k", 2000, 4000)]
    for wall in (None, 1e-6):
        got = harness.reader("device_idle_pct.cards").read(
            _rec([], {}, device, untraced_wall_s=wall))
        assert got == pytest.approx(70.0)


@pytest.mark.parametrize("name", ["lockstep_ms.cards", "straggler_pct.cards",
                                  "device_idle_pct.cards"])
def test_cards_readers_find_nothing_without_their_records(name):
    read = harness.reader(name).read
    assert read(types.SimpleNamespace(trace=None, shapes={}, infos=[], calls=[])) is None
    # the parent program's trace: a one-card search's spans and counters, no
    # device interval, no shard span or counter
    parent = _rec([("search.call", 0, 9000), ("stream.dispatch", 100, 8000)],
                  {"stream.queries": 200.0}, untraced_wall_s=None)
    assert read(parent) is None
