"""The sharded tier's placement over several cards
(``hnsw_tpu_torch/parallel/sharded.py``): how the shards are dealt over the
visible cards, each card's share of the programs' pools, the launch counts
and peak memory read by card, and the trace arithmetic of ``chip_smoke.py``'s
``cards`` phase. The CPU checks patch ``torch.cuda`` inside each test; the
``cuda``-marked test holds a search over the cards equal to the same shards
on ``cuda:0`` and skips below two visible cards."""

import contextlib
import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hnsw_tpu_torch import ShardedHnsw
from hnsw_tpu_torch.ops import codec_scores, kernel_lib, program, scan_topk
from hnsw_tpu_torch.ops.program import POOL_SHARE
from hnsw_tpu_torch.parallel import sharded
from hnsw_tpu_torch.parallel.sharded import default_devices, pool_shares

ROOT = Path(__file__).resolve().parents[1]


def _cards(monkeypatch, count, current=0):
    """A machine with ``count`` visible cards, ``current`` the current one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)


def _cuda(*indices):
    return [torch.device("cuda", i) for i in indices]


@pytest.mark.parametrize("n_shards,count,want", [
    (4, 4, (0, 1, 2, 3)),                # one shard a card
    (8, 4, (0, 1, 2, 3, 0, 1, 2, 3)),    # two a card, dealt round-robin
    (4, 2, (0, 1, 0, 1)),                # the two-card fallback of the cards phase
    (None, 4, (0, 1, 2, 3)),             # default: one shard a visible card
    (3, 1, (0, 0, 0)),
])
def test_default_devices_deal_shards_over_the_cards(monkeypatch, n_shards, count, want):
    _cards(monkeypatch, count)
    assert default_devices(n_shards) == _cuda(*want)
    assert default_devices(n_shards, "cuda") == _cuda(*want)
    # a named card takes every shard: nothing is dealt elsewhere
    assert default_devices(n_shards, "cuda:1") == _cuda(*([1] * (n_shards or 1)))


@pytest.mark.parametrize("devices,want", [
    (_cuda(0, 1, 2, 3), [POOL_SHARE] * 4),                     # the card's whole share
    (_cuda(0, 1, 0, 1), [POOL_SHARE / 2] * 4),                 # two shards a card
    (_cuda(0, 0, 0, 0), [POOL_SHARE / 4] * 4),                 # path 5 on one card
    (_cuda(0, 1, 2, 3, 0, 1, 2, 3), [POOL_SHARE / 2] * 8),
    (_cuda(0, 1, 1), [POOL_SHARE, POOL_SHARE / 2, POOL_SHARE / 2]),
    ([torch.device("cpu")] * 8, [POOL_SHARE / 8] * 8),
])
def test_pool_share_is_taken_per_card(devices, want):
    """Each shard's share of its card: the card's ``POOL_SHARE`` split over
    the shards that card holds, not over all the shards."""
    assert pool_shares(devices) == pytest.approx(want)


def test_bare_cuda_counts_as_the_current_card(monkeypatch):
    """A shard named by a bare ``"cuda"`` is placed on the current card by
    index, so it shares that card's pool with the shards named by index."""
    _cards(monkeypatch, 4, current=1)
    devs = [sharded._card_device(d) for d in ("cuda", "cuda:1", "cuda:0", torch.device("cuda"))]
    assert devs == _cuda(1, 1, 0, 1)
    assert pool_shares(devs) == pytest.approx([POOL_SHARE / 3, POOL_SHARE / 3, POOL_SHARE,
                                               POOL_SHARE / 3])
    assert sharded._card_device("cpu") == torch.device("cpu")


def test_card_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded._card_device("cuda:2")


def test_mesh_build_takes_each_shards_card_share(monkeypatch):
    """The mesh build asks ``round_programs`` for each shard's card share
    (CPU shards: the round programs are stubbed to record and run eager)."""
    asked = []
    monkeypatch.setattr(program, "round_programs",
                        lambda device, share=POOL_SHARE: asked.append((device, share)))
    rng = np.random.default_rng(5)
    X = rng.random((4 * 40, 8)).astype(np.float32)
    sh = ShardedHnsw(n_shards=4, device="cpu", max_nb_connection=8, max_elements=48,
                     ef_construction=16, dist="L2")
    sh.parallel_insert(X, mode="mesh", batch_size=16)
    assert asked == [(torch.device("cpu"), POOL_SHARE / 4)] * 4
    assert [c.share for c in sh._programs] == [POOL_SHARE / 4] * 4


@pytest.fixture
def counts():
    kernel_lib.reset_launch_counts()
    yield
    kernel_lib.reset_launch_counts()


def test_launches_counted_by_card(counts, monkeypatch):
    """``launch`` counts on the card it was given, beside the per-process
    counters; a refused launch counts nowhere; a reset clears both."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "no card")
    kernel_lib.launch("codec_scores", "bulk", lambda: 0, card=2)
    kernel_lib.launch("codec_scores", "bulk", lambda: 0, card=2)
    kernel_lib.launch("scan_topk", "wgmma", lambda: 0, card=0)
    kernel_lib.launch("scan_topk", "wgmma", lambda: 0)  # no card given
    with pytest.raises(RuntimeError):
        kernel_lib.launch("scan_topk", "simt", lambda: 1, card=1)
    assert kernel_lib.LAUNCHES["codec_scores"] == 2 and kernel_lib.LAUNCHES["scan_topk"] == 2
    assert kernel_lib.CARD_LAUNCHES == {(2, "codec_scores"): 2, (2, "codec_scores.bulk"): 2,
                                        (0, "scan_topk"): 1, (0, "scan_topk.wgmma"): 1}
    kernel_lib.reset_launch_counts()
    assert kernel_lib.CARD_LAUNCHES == {} and sum(kernel_lib.LAUNCHES.values()) == 0


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@contextlib.contextmanager
def _stub_capture(graph):
    yield


def test_piece_replays_add_launches_on_their_card(counts):
    """A capture counts nothing on any card; every replay adds the launches
    it recorded on the card each was made on, as the sharded search's
    programs replay on their shards' cards."""
    kernel_lib.launch("scan_topk", "wgmma", lambda: 0, card=3)  # before: kept as it was

    def fn():
        kernel_lib.launch("codec_scores", "bulk", lambda: 0, card=1)
        kernel_lib.launch("codec_scores", "bulk", lambda: 0, card=1)
        kernel_lib.launch("scan_topk", "wgmma", lambda: 0, card=3)

    piece = program.Piece(fn, _StubGraph(), _stub_capture)
    assert kernel_lib.CARD_LAUNCHES == {(3, "scan_topk"): 1, (3, "scan_topk.wgmma"): 1}
    assert piece.card_launches == {(1, "codec_scores"): 2, (1, "codec_scores.bulk"): 2,
                                   (3, "scan_topk"): 1, (3, "scan_topk.wgmma"): 1}
    piece.replay()
    piece.replay()
    assert kernel_lib.CARD_LAUNCHES[(1, "codec_scores.bulk")] == 4
    assert kernel_lib.CARD_LAUNCHES[(3, "scan_topk")] == 3
    assert kernel_lib.LAUNCHES["codec_scores"] == 4


def test_failed_capture_restores_card_counts(counts):
    def fn():
        kernel_lib.launch("codec_scores", "bulk", lambda: 0, card=1)
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        program.Piece(fn, _StubGraph(), _stub_capture)
    assert kernel_lib.CARD_LAUNCHES == {}


@pytest.mark.parametrize("mod", [codec_scores, scan_topk], ids=["codec_scores", "scan_topk"])
def test_wrappers_launch_on_the_tensors_card(mod):
    """Each wrapper launches with its tensors' card current (the library
    plans and launches on the current card) and counts on that card."""
    src = inspect.getsource(mod)
    assert src.count("kernel_lib.launch(") == 2
    assert src.count("with torch.cuda.device(dev):") == 2
    assert src.count("card=dev.index)") == 2


def test_peak_memory_read_by_card(monkeypatch):
    """``peak_memory_by_card`` reads every card of a device list once, each
    with the peaks a build's measurements reset on that card kept."""
    peaks = {0: 100, 1: 300, 2: 50}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda c: peaks[c])
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda c: 2 * peaks[c])
    monkeypatch.setattr(program, "_PEAKS", {2: (70, 80)})
    got = program.peak_memory_by_card(_cuda(1, 0, 1, 2))
    assert got == {0: (100, 200), 1: (300, 600), 2: (70, 100)}
    assert program.cards(_cuda(2, 0, 2)) == [0, 2]
    assert program.peak_memory(1) == got[1]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_busy_by_card_is_the_union_of_each_cards_intervals():
    """The cards phase's busy time: overlapping activities of one card count
    once, each card apart."""
    cs = _chip_smoke()
    ms = 1_000_000
    spans = [(0, 0, 4 * ms), (0, 2 * ms, 5 * ms), (0, 7 * ms, 8 * ms),  # 5 + 1 ms
             (1, 1 * ms, 2 * ms), (1, 1 * ms, 2 * ms), (1, 3 * ms, 3 * ms),
             (3, 0, 10 * ms), (3, 1 * ms, 9 * ms)]
    assert cs.busy_by_card(spans) == {"cuda:0": 6.0, "cuda:1": 1.0, "cuda:3": 10.0}
    assert cs.busy_by_card([]) == {}


def test_cards_phase_refuses_fewer_than_two_cards(monkeypatch, capsys):
    """Asked for on one visible card, ``chip_smoke.py`` stops before any
    phase with a non-zero exit and says why; it never falls back to one card."""
    cs = _chip_smoke()
    _cards(monkeypatch, 1)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--phases", "env,cards"])
    monkeypatch.setattr(cs, "phase_env", lambda *a: pytest.fail("a phase ran"))
    assert cs.main() != 0
    err = capsys.readouterr()
    assert "at least 2 cards" in err.err and "shows 1" in err.err
    assert '"ok": true' not in err.out


@pytest.mark.cuda
def test_sharded_search_over_cards_equals_one_card():
    """Four shards, one a card (two a card on two cards), build and answer
    bit for bit what the same shards answer on ``cuda:0``: the mesh build,
    the codec search (B3), a filter, the exact search (B2), the stream."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more visible cards")
    rng = np.random.default_rng(11)
    X = rng.random((4 * 1500, 16)).astype(np.float32)
    Q = rng.random((64, 16)).astype(np.float32)
    evens = np.arange(0, len(X), 2)
    got = []
    for devs in ([torch.device("cuda", 0)] * 4, default_devices(4)):
        sh = ShardedHnsw(devices=devs, max_nb_connection=12, max_elements=1508,
                         ef_construction=64, dist="L2")
        sh.set_traversal_codec("i8")
        sh.parallel_insert(X, mode="mesh", batch_size=128)
        got.append([sh.search_batch(Q, 10, 48), sh.search_batch(Q, 10, 48, filter=evens),
                    sh.exact_search_batch(Q, 10), sh.search_stream(Q, 10, 48, batch=16)])
    for a, b in zip(*got):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
