"""The port's measurement tools (``hnsw_tpu_torch/tools/``) on the CPU at a
tiny size: ``exp_iter``'s parts of a beam iteration and ``exp_search``'s grid
on a snapshot, each printing its JSON line; ``exp_search``'s recall is the
recall of ``device_search_stream`` on the same snapshot."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hnsw_tpu_torch import Hnsw, load_native, save_native
from hnsw_tpu_torch.bench import f32_dataset, pool_kth, recall_fp64, scan_corpus
from hnsw_tpu_torch.ops.beam_search import device_search_stream
from hnsw_tpu_torch.tools import exp_iter, exp_search

PARTS = ("score", "merge", "masks", "tbl_gather", "topk_E", "body")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_exp_iter_tiny(monkeypatch, capsys):
    """``exp_iter`` at B=64, N=2000, d=32, REPS=2 prints one JSON line with
    every part's ms, the sort parts' share of the body and the device."""
    for k, v in dict(IB=64, IN=2000, ID=32, REPS=2).items():
        monkeypatch.setenv(k, str(v))
    out = exp_iter.main(["--device", "cpu"])
    line = _last_json(capsys)
    assert line == json.loads(json.dumps(out))
    assert line["sort_parts_share_of_parts"] <= 1
    assert (line["B"], line["N"], line["d"], line["REPS"], line["K"]) == (64, 2000, 32, 2, 224)
    assert (32 * line["id_rows"]) >= 4 * 56 and (56 + line["id_rows"]) % 8 == 0
    for p in PARTS:
        assert line[p]["ms"] > 0, p
    assert line["score"]["gbps"] > 0 and line["sort_parts_share_of_body"] > 0
    assert line["device"] == {"name": "cpu"}
    for shape, (ef, E, K) in (("serving", (128, 4, 384)), ("build", (800, 8, 768))):
        row = line["bookkeeping"][shape]
        assert (row["B"], row["ef"], row["E"], row["K"]) == (64, ef, E, K)
        for k in ("select_ms", "merge_ms", "plain_select_ms", "plain_merge_ms",
                  "bound_select_ms", "bound_merge_ms"):
            assert row[k] > 0, (shape, k)


def test_exp_iter_chains_are_the_beam_pieces():
    """The score part's table carries its links in the codec's id rows: the
    plain codec scores return them as the neighbour ids."""
    from hnsw_tpu_torch.ops.codec_scores import codec_scores
    blocks, tbl = exp_iter.make_table(300, 12, 32, torch.device("cpu"))
    src = torch.tensor([[0, 5], [7, 299]], dtype=torch.int32)
    q = torch.randn(2, 32)
    _, ids = codec_scores(src, q, (q * q).sum(-1, keepdim=True), torch.tensor(0.01),
                          blocks, 12)
    assert torch.equal(ids, tbl[src.long()].reshape(2, 24))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A 3000 x 32 gauss index of the bench's corpus (seed 1234), saved with
    ``save_native``."""
    X, _ = f32_dataset("gauss", np.random.default_rng(1234), 3000, 256, 32, 16)
    h = Hnsw(max_nb_connection=12, max_elements=len(X), ef_construction=64, dist="L2",
             device="cpu")
    h.parallel_insert(X, mode="device", batch_size=512)
    path = str(tmp_path_factory.mktemp("snap") / "idx.npz")
    save_native(h, path)
    return path


def test_exp_search_grid_on_snapshot(snapshot, monkeypatch, capsys):
    """``exp_search`` on the snapshot prints its grid on one JSON line, and
    each point's recall equals ``device_search_stream``'s on the reloaded
    snapshot, scored the same way."""
    grid = "32,4,0,4,128;48,4,10,2,256"
    for k, v in dict(EXP_SNAP=snapshot, EXP_N=3000, EXP_D=32, EXP_GRID=grid,
                     EXP_BLOCKS=1).items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.setattr(exp_search, "NQ", 256)
    monkeypatch.setattr(exp_search, "BLOCK_S", 0.01)
    rows = exp_search.main(["--device", "cpu"])
    line = _last_json(capsys)
    assert line["grid"] == json.loads(json.dumps(rows)) and len(rows) == 2
    assert line["queries_scored"] == 256 and line["device"] == {"name": "cpu"}
    X, Q = f32_dataset("gauss", np.random.default_rng(1234), 3000, 256, 32, 16)
    kth = pool_kth(scan_corpus(X, torch.device("cpu")), X, Q, 10, 64, 2048)
    h = load_native(snapshot, device="cpu")
    for spec, row in zip(grid.split(";"), rows):
        p = exp_search.parse_spec(spec)
        assert (row["ef"], row["qb"], row["seeds"]) == (p["ef"], p["qbatch"], p["seeds"])
        ids, _ = device_search_stream(h, Q, 10, p["ef"], batch=min(p["qbatch"], 256),
                                      expand=p["expand"], max_iters=p["max_iters"],
                                      seeds=p["seeds"], query_dtype="f16")
        oid = np.where(ids >= 0, h._origin[np.clip(ids, 0, h._nb_point - 1)], -1)
        assert row["recall"] == recall_fp64(X, Q, kth, oid, 10) > 0.9
        assert row["qps"] > 0 and row["kernel_qps"] > 0 and row["spread"] >= 0
