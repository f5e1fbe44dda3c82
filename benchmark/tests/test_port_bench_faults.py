"""A whole run of each cell on the CPU at a small size, the chip's look
skipped, with the program broken underneath: ``correct`` must come out
false for each fault the cell can have, and true without one."""

import importlib

import numpy as np
import pytest

from benchmark import harness

SMALL_HNSW = {"n": 3000, "d": 32, "index": {
    "engine": "Hnsw", "max_nb_connection": 12, "ef_construction": 64, "level_scale": 0.5,
    "keep_pruned": True, "build_batch": 512, "build_max_iters": None}}
CELLS = {
    "sift1m.batch": ({"config": SMALL_HNSW,
                      "workload": {"per_call": 200, "pool": 1000, "warm_calls": 1}},
                     ("hnsw_tpu_torch.ops.beam_search", None, "device_search_stream")),
    "sift1m.build": ({"config": SMALL_HNSW,
                      "workload": {"rows": 2000, "chunk": 1000, "warm_rows": 1000, "check_queries": 200,
                                   "pool": 200}},
                     ("hnsw_tpu_torch.ops.beam_search", None, "device_search_stream")),
    "gist1m.exact": ({"config": {"n": 3000, "d": 64},
                      "workload": {"per_call": 100, "pool": 1000, "warm_calls": 1}},
                     ("hnsw_tpu_torch.models.brute", "BruteForceIndex", "search_batch")),
}


def _half_left_out(ids, d):
    """The second half of the batch gets the first half's answers."""
    h = len(ids) // 2
    ids, d = ids.copy(), d.copy()
    ids[h:2 * h], d[h:2 * h] = ids[:h], d[:h]
    if len(ids) == 1:  # a batch of one: its answer is left out
        ids[:], d[:] = -1, np.inf
    return ids, d


def _answer_altered(ids, d):
    """One id of the first answer replaced where it is produced."""
    ids = ids.copy()
    ids[0, 0] = ids[0, 0] + 1 if ids[0, 0] + 1 not in ids[0] else ids[0, 0] + 2
    return ids, d


def _patch_answers(monkeypatch, target, fault):
    """Break the program's function that produces the answers: ``target``
    is (module, class or None, name)."""
    module, cls, name = target
    owner = importlib.import_module(module)
    owner = getattr(owner, cls) if cls else owner
    orig = getattr(owner, name)

    def broken(*a, **kw):
        ids, d = orig(*a, **kw)
        return fault(np.asarray(ids), np.asarray(d))

    monkeypatch.setattr(owner, name, broken)


def _run(cell, seed=2**31 + 77):
    over, _ = CELLS[cell]
    return harness.run(cell, seed, 0.5, False, "cpu", 0.0, overrides=over)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared" and out["attempted"] > 0


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered], ids=["half", "altered"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_answer_is_not_correct(monkeypatch, cell, fault):
    _patch_answers(monkeypatch, CELLS[cell][1], fault)
    out = _run(cell)
    print(cell, fault.__name__, out["compared"])
    assert not out["correct"], out["compared"]


def test_the_ingest_job_is_fixed_and_the_deadline_only_a_cap():
    """Time to spare adds no work; a deadline that passes stops the job after
    the chunk in flight."""
    over, _ = CELLS["sift1m.build"]
    wl = over["workload"]
    for seconds, rows in ((60.0, wl["rows"]), (1e-3, wl["chunk"])):
        out = harness.run("sift1m.build", 2**31 + 78, seconds, False, "cpu", 0.0, overrides=over)
        assert out["correct"] and out["attempted"] == rows


def test_a_build_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from hnsw_tpu_torch.models.hnsw import Hnsw

    monkeypatch.setattr(Hnsw, "parallel_insert", lambda self, *a, **kw: None)
    out = _run("sift1m.build")
    assert not out["correct"] and out["failed"] == out["attempted"] > 0
