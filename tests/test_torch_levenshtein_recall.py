"""Levenshtein on uniform random words: the port and the JAX package build
the same device index and answer at the same recall.

Uniform strings of 3-12 letters are all about equally far apart, so recall
falls as the set grows; this shows the fall is the method's and not the
port's. Run as a script for a larger set (readings of both packages):

    JAX_PLATFORMS=cpu python tests/test_torch_levenshtein_recall.py --n 8000 --nq 512 --batch 1024
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hnsw_tpu as J  # noqa: E402
import hnsw_tpu_torch as T  # noqa: E402
from hnsw_tpu_torch.ops.distances import scores_levenshtein  # noqa: E402


def uniform_words(rng, m, width=12):
    """Zero-padded uint16 words of 3-12 letters drawn uniformly from a-z."""
    L = rng.integers(3, width + 1, m)
    letters = rng.integers(ord("a"), ord("z") + 1, (m, width)).astype(np.uint16)
    return np.where(np.arange(width)[None] < L[:, None], letters, 0).astype(np.uint16)


def exact_distances(X, Q, chunk=64):
    out = []
    C = torch.from_numpy(X.astype(np.float32))
    for s in range(0, len(Q), chunk):
        q = torch.from_numpy(Q[s:s + chunk].astype(np.float32))
        out.append(scores_levenshtein(q, C[None].expand(len(q), -1, -1)).numpy())
    return np.concatenate(out)


def recalls(n, nq, batch, efs=(64, 128), k=10, seed=1241):
    """{package: {"build_s", "ids": {ef: ids}, "recall": {ef: recall@10}}},
    recall tie-aware: a candidate counts when its distance <= the k-th."""
    rng = np.random.default_rng(seed)
    X, Q = uniform_words(rng, n), uniform_words(rng, nq)
    D = exact_distances(X, Q)
    kth = np.sort(D, 1)[:, k - 1]
    out = {}
    for name, H, kw in (("port", T.Hnsw, {"device": "cpu"}), ("jax", J.Hnsw, {})):
        t0 = time.time()
        h = H(max_nb_connection=16, max_elements=n, ef_construction=100,
              dist="Levenshtein", dtype=np.uint16, **kw)
        h.parallel_insert((X, np.arange(n)), mode="device", batch_size=batch)
        row = {"build_s": time.time() - t0, "ids": {}, "recall": {}}
        for ef in efs:
            ids, _ = h.search_batch(Q, k, ef)
            o = np.asarray(h._origin)[ids]
            row["ids"][ef] = o
            row["recall"][ef] = sum(int((D[b][o[b]] <= kth[b]).sum())
                                    for b in range(nq)) / (nq * k)
        out[name] = row
    return out


def test_levenshtein_uniform_words_recall_matches_reference():
    r = recalls(n=1000, nq=200, batch=500)
    for ef in (64, 128):
        assert abs(r["port"]["recall"][ef] - r["jax"]["recall"][ef]) <= 0.002, \
            (ef, r["port"]["recall"], r["jax"]["recall"])
        same = (r["port"]["ids"][ef] == r["jax"]["ids"][ef]).all(1).mean()
        assert same >= 0.98, (ef, same)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--nq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1024)
    a = ap.parse_args()
    r = recalls(a.n, a.nq, a.batch)
    for name, row in r.items():
        print(name, {"n": a.n, "nq": a.nq, "batch": a.batch, "build_s": row["build_s"],
                     "recall_at_10": row["recall"]})
    for ef in (64, 128):
        same = (r["port"]["ids"][ef] == r["jax"]["ids"][ef]).all(1).mean()
        print("ef", ef, "rows with equal ids", same)
