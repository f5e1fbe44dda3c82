"""Minimal smoke demo — analog of the reference's ``examples/random.rs`` (1k random
25-d vectors, insert + knn search): build, search, dump, reload, verify.

    python -m hnsw_tpu_torch.examples.random_demo [--device cuda|cpu] [--n 1000]
"""

import argparse
import tempfile

import numpy as np

from hnsw_tpu_torch import Hnsw, HnswIo


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1000)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    n, d, k = args.n, 25, 10
    X = rng.random((n, d)).astype(np.float32)
    h = Hnsw(max_nb_connection=16, max_elements=n, ef_construction=200, dist="L2",
             device=args.device)
    h.parallel_insert(list(zip(X, range(n))))
    q = rng.random(d).astype(np.float32)
    for r in h.search(q, k, 32):
        print(f"  id {r.d_id:4d}  dist {r.distance:.4f}  p_id {r.p_id}")
    ids, _ = h.search_batch(X[:8], 1, 32)  # batched search on the device
    assert (h._origin[ids[:, 0]] == np.arange(8)).all()
    tmp = tempfile.mkdtemp()
    base = h.file_dump(tmp, "random_demo")
    r = HnswIo(tmp, base).load_hnsw(device=args.device)
    assert h.check_graph_equality(r)
    print(f"dump/reload OK -> {tmp}/{base}.hnsw.graph")


if __name__ == "__main__":
    main()
