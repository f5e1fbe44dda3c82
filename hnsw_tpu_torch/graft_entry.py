"""The graft entry points of the port, the counterparts of the root
``__graft_entry__.py`` (the JAX package's).

``entry(device=None)``               the batched HNSW search program over a
                                     real (small) index and its arguments;
                                     ``compiled(fn, args)`` captures it as a
                                     ``SearchProgram`` (CUDA graphs), as the
                                     reference's ``jax.jit(fn)`` compiles it.
``dryrun_multichip(n, device=None)`` the sharded build (one synchronized
                                     insertion round per shard a step, through
                                     each shard's round programs on the card)
                                     and the sharded searches on ``n`` shards.

Both run on the card unless ``device="cpu"`` is asked for.
``dryrun_multichip`` needs no child process: torch has no backend to pin, so
the shards are a device list (``default_devices(n, device)``: ``cuda:0..n-1``
round-robin over the visible cards, n copies of ``"cpu"`` on the CPU).

    python -m hnsw_tpu_torch.graft_entry [--device cpu] [--shards 8]
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from .models.hnsw import Hnsw
from .ops.beam_search import search_program
from .ops.program import SearchProgram
from .parallel.sharded import ShardedHnsw, default_devices
from .utils.device import resolve_device


def _small_index(n=384, d=32, metric="L2", seed=3, device=None):
    """The reference's index: ``n`` uniform rows, M=12, efC 64, built serially."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    h = Hnsw(max_nb_connection=12, max_elements=n, ef_construction=64, dist=metric,
             device=resolve_device(device))
    for i, v in enumerate(X):
        h.insert(v, i)
    return h, X, rng


def entry(device=None):
    """(fn, args): the raw batched search program
    (``functools.partial(search_program, ef=32, knbn=10, expand=4,
    use_mask=False)``) and its (GraphArrays, queries [8, 32], mask)
    arguments on ``device``. ``compiled(fn, args)`` is the production
    single-card query step."""
    h, X, rng = _small_index(device=device)
    g = h.device_graph()
    q = torch.as_tensor(rng.random((8, X.shape[1])).astype(np.float32), device=h.device)
    mask = torch.zeros((g.cap1,), dtype=torch.bool, device=h.device)
    fn = functools.partial(search_program, ef=32, knbn=10, expand=4, use_mask=False)
    return fn, (g, q, mask)


def compiled(fn, args):
    """``fn`` (``entry``'s, or one with more of ``search_program``'s static
    arguments bound) captured as a ``SearchProgram`` for ``args``' graph,
    batch, dtype and device; returns the program's ``run(q, mask)`` as a
    function of ``args``, as ``jax.jit(fn)`` is called."""
    g, q, mask = args
    kw = dict(fn.keywords)
    prog = SearchProgram(g, kw.pop("codec", None), q.shape[0], q.dtype, q.device, **kw)
    return lambda g_, q_, mask_: prog.run(q_, mask_)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The reference's ``_dryrun_multichip_impl`` on ``ShardedHnsw`` over
    ``default_devices(n_devices, device)``: the mesh build at batch 32, the
    sharded search, self-retrieval, the per-shard int8 codec (kernel B3 on
    the card), an even-id filter, the exact search in ``"tiled"`` and
    ``"pallas"`` (kernel B2) modes and the pipelined stream; the
    reference's assertions, word for word where they apply. The reference
    runs the body on 8 devices; at 4 and 2 its int8-codec self-retrieval
    assertion fails in both packages alike (at 4, query 5 finds 136)."""
    devices = default_devices(n_devices, device)
    D = n_devices
    n_per, d = 112, 16
    rng = np.random.default_rng(0)

    # --- the mesh build: each round advances every shard's tables, through
    # the shards' round programs on the card ---
    sh = ShardedHnsw(devices=devices, max_nb_connection=8, max_elements=n_per + 8,
                     ef_construction=32, dist="L2")
    X = rng.random((D * n_per, d)).astype(np.float32)
    sh.parallel_insert(list(zip(X, range(len(X)))), mode="mesh", batch_size=32)
    assert len(sh) == D * n_per
    for s in sh.shards:  # every shard's layer-0 table must have advanced
        assert (s._layers[0].counts[1: s._nb_point] > 0).any(), "no links built"

    # --- the sharded search (merged on devices[0]) ---
    Q = rng.random((8, d)).astype(np.float32)
    ids, dists = sh.search_batch(Q, knbn=5, ef=24)
    assert ids.shape == (8, 5)
    assert (ids[:, 0] >= 0).all()
    # exactness sanity: self-query must find itself across shards
    ids2, d2 = sh.search_batch(X[:8], knbn=1, ef=24)
    assert all(int(ids2[i, 0]) == i for i in range(8)), ids2[:, 0]

    # --- per-shard int8 codec + exact rerank + in-search filter ---
    sh.set_traversal_codec("i8")
    ids3, _ = sh.search_batch(X[:8], knbn=1, ef=24)
    assert all(int(ids3[i, 0]) == i for i in range(8)), ids3[:, 0]
    evens = np.arange(0, D * n_per, 2)
    ids4, _ = sh.search_batch(Q, knbn=5, ef=24, filter=evens)
    assert (ids4[ids4 >= 0] % 2 == 0).all(), "filtered sharded search leaked ids"

    # --- the sharded exact scan: tiled, and the per-shard scan kernel ---
    ids5, _ = sh.exact_search_batch(X[:8], 1, mode="tiled", tile=64)
    assert all(int(ids5[i, 0]) == i for i in range(8)), ids5[:, 0]
    ids6, _ = sh.exact_search_batch(X[:8], 1, mode="pallas")
    assert all(int(ids6[i, 0]) == i for i in range(8)), ids6[:, 0]

    # --- the pipelined sharded stream: several batches and a ragged tail, in
    # input order (>= 23/24 self-hits: the int8 codec's quantized traversal
    # can drop one near-tie on tiny uniform corpora) ---
    ids7, _ = sh.search_stream(X[:24], knbn=1, ef=48, batch=8)
    assert sum(int(ids7[i, 0]) == i for i in range(24)) >= 23, ids7[:, 0]
    print(f"dryrun_multichip({n_devices}): mesh rounds + sharded search "
          f"(incl. int8-codec + filtered fast path) + sharded exact scan "
          f"(tiled + pallas) + sharded stream OK on {[str(x) for x in devices]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)
    fn, xs = entry(args.device)
    ids, dists = compiled(fn, xs)(*xs)
    print("entry ok:", [tuple(o.shape) for o in (ids, dists)])
    dryrun_multichip(args.shards, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
