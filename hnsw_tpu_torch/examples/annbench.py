"""ann-benchmarks runner — analog of the reference's examples
(``examples/ann-mnist-784-euclidean.rs``, ``ann-sift1m-128-euclidean.rs``,
``ann-glove25-angular.rs`` and their HDF5 loader ``examples/utils/annhdf5.rs``).

Loads an ann-benchmarks HDF5 file when given one (datasets ``train``, ``test``,
``neighbors``, ``distances``; needs ``h5py``), else generates a synthetic
stand-in with the dataset's shape and a low intrinsic dimension. Reports
recall@k and QPS over an ef sweep for one backend: ``device`` (batched build
and search), ``serial`` (the host oracle), ``scan`` (``BruteForceIndex``) or
``auto`` (``AutoIndex``).

    python -m hnsw_tpu_torch.examples.annbench --dataset sift --backend device --m 64 --efc 400
    python -m hnsw_tpu_torch.examples.annbench --hdf5 /path/fashion-mnist-784-euclidean.hdf5
"""

import argparse
import time

import numpy as np
import torch

DATASETS = {
    # name: (n, dim, metric, normalized) — shapes of the reference's benchmark tables
    "mnist": (70_000, 784, "L2", False),
    "sift": (1_000_000, 128, "L2", False),
    "glove25": (1_183_514, 25, "Dot", True),
    "random": (1_000, 25, "L2", False),  # the reference's random.rs smoke config
}


def load_hdf5(path, metric_hint=None):
    """ann-benchmarks HDF5 reader — analog of the reference's
    ``examples/utils/annhdf5.rs:17-214`` (datasets ``train``/``test``/
    ``neighbors``/``distances``, root attribute ``distance``)."""
    import h5py  # optional; ann-benchmarks files carry their ground truth

    with h5py.File(path, "r") as f:
        train = np.asarray(f["train"], np.float32)
        test = np.asarray(f["test"], np.float32)
        neighbors = np.asarray(f["neighbors"], np.int64)
        distances = np.asarray(f["distances"], np.float32)
        dist_attr = f.attrs.get("distance", "euclidean")
        if isinstance(dist_attr, bytes):
            dist_attr = dist_attr.decode()
    metric = metric_hint or {"euclidean": "L2", "angular": "Cosine",
                             "hamming": "Hamming", "jaccard": "Jaccard",
                             "dot": "Dot"}.get(str(dist_attr), "L2")
    return train, test, neighbors, distances, metric


def synthesize(n, dim, nq=1000, k=100, metric="L2", normalized=False, seed=1234,
               intrinsic=16, device="cuda"):
    """A corpus of ``n`` x ``dim`` rows of intrinsic dimension ``intrinsic``,
    ``nq`` queries, and their exact top-``k`` (one matmul per 256 queries on
    ``device``)."""
    from hnsw_tpu_torch.ops.beam_search import smallest
    from hnsw_tpu_torch.ops.distances import get_metric, l2_normalize

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((intrinsic, dim)).astype(np.float32) / np.float32(np.sqrt(intrinsic))
    mk = lambda m: (rng.standard_normal((m, intrinsic)).astype(np.float32) @ A
                    + np.float32(0.02) * rng.standard_normal((m, dim)).astype(np.float32))
    X, Q = mk(n), mk(nq)
    if normalized:
        X, Q = l2_normalize(X), l2_normalize(Q)
    Xd = torch.as_tensor(X, device=device)
    m = get_metric(metric)
    nb, dd = [], []
    for s in range(0, nq, 256):
        d = m.matmul_scores(torch.as_tensor(Q[s:s + 256], device=device), Xd)
        v, idx = smallest(d, min(k, n))
        nb.append(idx.cpu().numpy())
        dd.append(v.cpu().numpy())
    return X, Q, np.concatenate(nb), np.concatenate(dd)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="random", choices=sorted(DATASETS))
    ap.add_argument("--hdf5", default=None)
    ap.add_argument("--backend", default="device",
                    choices=["device", "serial", "scan", "auto"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=24)
    ap.add_argument("--efc", type=int, default=400)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--scale-mod", type=float, default=1.0)
    ap.add_argument("--n", type=int, default=None, help="subsample the corpus")
    ap.add_argument("--nq", type=int, default=1000, help="synthetic queries")
    ap.add_argument("--efs", type=int, nargs="*", default=[16, 24, 48, 64, 128])
    args = ap.parse_args(argv)

    from hnsw_tpu_torch import AutoIndex, BruteForceIndex, Hnsw
    if args.hdf5:
        X, Q, neighbors, gt_d, metric = load_hdf5(args.hdf5)
    else:
        n, dim, metric, normalized = DATASETS[args.dataset]
        n = args.n or min(n, 100_000)  # keep synthetic runs tractable by default
        X, Q, neighbors, gt_d = synthesize(n, dim, nq=args.nq, metric=metric,
                                           normalized=normalized, device=args.device)
    if args.n:
        X = X[: args.n]
    k = min(args.k, gt_d.shape[1])  # files carry a finite ground-truth depth
    kth = gt_d[:, k - 1]
    print(f"corpus {X.shape}, {len(Q)} queries, metric {metric}, backend {args.backend}")

    t0 = time.time()
    pairs = list(zip(X, range(len(X))))
    if args.backend == "scan":
        h = BruteForceIndex(dist=metric, device=args.device)
        h.parallel_insert(pairs)
    elif args.backend == "auto":
        h = AutoIndex(dist=metric, max_nb_connection=args.m, ef_construction=args.efc,
                      device=args.device)
        h.parallel_insert(pairs)
        h.build()
        print(f"auto engine: {h.engine_name}")
    else:
        h = Hnsw(max_nb_connection=args.m, max_elements=len(X),
                 ef_construction=args.efc, dist=metric, device=args.device)
        if args.scale_mod != 1.0:
            h.modify_level_scale(args.scale_mod)
        h.parallel_insert(pairs, mode=args.backend)
    print(f"build: {time.time() - t0:.1f}s ({len(X) / (time.time() - t0):.0f} pts/s)")

    for ef in args.efs:
        ids, dists = h.search_batch(Q, k, ef)
        t0 = time.time()
        reps = 5
        for _ in range(reps):
            ids, dists = h.search_batch(Q, k, ef)
        dt = (time.time() - t0) / reps
        recall = float((dists <= kth[:, None] + 1e-6).sum() / (len(Q) * k))
        print(f"  ef={ef:4d}  recall@{k}={recall:.4f}  {len(Q) / dt:8.0f} QPS")


if __name__ == "__main__":
    main()
