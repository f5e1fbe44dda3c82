"""The port's examples (``hnsw_tpu_torch/examples``) at tiny sizes on the CPU,
each through its ``main(argv)`` as ``python -m hnsw_tpu_torch.examples.<name>``
runs it: the random demo (build, search, dump, reload), word search under
Levenshtein (serial and batched), and the ann-benchmarks runner on a
synthetic set for each backend and on a generated HDF5 file in the
ann-benchmarks layout (skipped without ``h5py``)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hnsw_tpu_torch.examples import annbench, levenshtein_words, random_demo


def _recalls(out):
    return [float(line.split("recall@10=")[1].split()[0])
            for line in out.splitlines() if "recall@10=" in line]


def test_random_demo(capsys):
    random_demo.main(["--device", "cpu", "--n", "300"])
    assert "dump/reload OK" in capsys.readouterr().out


def test_levenshtein_words(capsys):
    levenshtein_words.main(["--device", "cpu", "--n-words", "300"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "batched search on the device" in out


@pytest.mark.parametrize("backend", ["device", "serial", "scan", "auto"])
def test_annbench_synthetic(capsys, backend):
    annbench.main(["--dataset", "random", "--n", "800", "--nq", "64", "--backend", backend,
                   "--device", "cpu", "--m", "12", "--efc", "64", "--efs", "16", "64"])
    out = capsys.readouterr().out
    assert "metric L2" in out and f"backend {backend}" in out
    rec = _recalls(out)
    assert len(rec) == 2 and rec[-1] >= (0.999 if backend in ("scan", "auto") else 0.9), out


def test_annbench_hdf5(tmp_path, rng, capsys):
    h5py = pytest.importorskip("h5py")
    n, nq, d, k = 2000, 32, 16, 25
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((nq, d)).astype(np.float32)
    D = np.sqrt(np.maximum((Q * Q).sum(1)[:, None] + (X * X).sum(1)[None, :]
                           - 2.0 * (Q @ X.T), 0.0))
    nb = np.argsort(D, axis=1, kind="stable")[:, :k]
    p = str(tmp_path / "tiny-euclidean.hdf5")
    with h5py.File(p, "w") as f:
        f.create_dataset("train", data=X)
        f.create_dataset("test", data=Q)
        f.create_dataset("neighbors", data=nb.astype(np.int64))
        f.create_dataset("distances", data=np.take_along_axis(D, nb, 1).astype(np.float32))
        f.attrs["distance"] = "euclidean"
    train, test, neighbors, _, metric = annbench.load_hdf5(p)
    assert metric == "L2"
    np.testing.assert_array_equal(train, X)
    np.testing.assert_array_equal(neighbors, nb)
    annbench.main(["--hdf5", p, "--backend", "device", "--device", "cpu", "--m", "12",
                   "--efc", "100", "--efs", "16", "64"])
    rec = _recalls(capsys.readouterr().out)
    assert len(rec) == 2 and rec[-1] >= 0.95
