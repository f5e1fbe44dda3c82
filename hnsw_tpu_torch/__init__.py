"""hnsw_tpu_torch — the PyTorch/CUDA port of ``hnsw_tpu``.

HNSW graph build, search, dump and reload, and the exact scan, on an NVIDIA
card (Hopper), with a hand-written CUDA kernel for each of the JAX package's
five Pallas kernels:

  * ``ops/codec_scores.py``: the int8 codec scores of every beam iteration —
    fused gather + score (``csrc/codec_scores.cu``: B1; B3 without id rows)
    and scores over pre-gathered blocks (``csrc/codec_scores_gathered.cu``:
    B4, ``allow_fused=False``);
  * ``ops/scan_topk.py``: the exact L2 scan — packed (``csrc/scan_topk.cu``:
    B2) and unpacked (``csrc/scan_topk_unpacked.cu``: B5, ``packed=False``).

Beside the graph, the exact scan (``BruteForceIndex``) and inverted lists
(``IvfFlatIndex``) serve the same search surface, and ``AutoIndex`` picks one
of the three for a corpus. Every metric of the JAX package is here, with
``UserMetric`` for a user's own. Everything else is PyTorch, and persistence
(``io/``) is numpy. The package
mirrors ``hnsw_tpu``'s layout, imports neither ``jax`` nor ``hnsw_tpu``, and
runs on ``"cuda"`` unless an entry point is given ``device="cpu"``.
``KERNEL_LAUNCHES`` counts kernel launches per wrapper
(``reset_launch_counts()`` zeroes them).
"""

from .models.hnsw import Hnsw, Neighbour, PointIdWithOrder, NB_LAYER_MAX
from .models.flatten import FlatPoint, FlatNeighborhood
from .models.brute import BruteForceIndex
from .models.auto import AutoIndex
from .models.ivf import IvfFlatIndex
from .ops.distances import DISTANCES, Metric, UserMetric, get_metric, l2_normalize
from .filter import FilterT, SortedIdFilter, CallableFilter
from .api import AnnT
from .io.hnswio import (HnswIo, ReloadOptions, Description, load_description,
                        file_dump, save_native, load_native)
from .io.datamap import DataMap
from .utils.profiling import enable_profiling, profiling_report, PROFILER
from .utils.logging import init_logging
from .convert import from_arrays, to_arrays, ivf_from_arrays, ivf_to_arrays
from .ops.kernel_lib import LAUNCHES as KERNEL_LAUNCHES, reset_launch_counts

__version__ = "0.1.0"

__all__ = [
    "Hnsw", "Neighbour", "PointIdWithOrder", "NB_LAYER_MAX", "BruteForceIndex",
    "AutoIndex", "IvfFlatIndex", "UserMetric",
    "FlatPoint", "FlatNeighborhood", "AnnT",
    "HnswIo", "ReloadOptions", "Description", "load_description", "file_dump",
    "save_native", "load_native", "DataMap",
    "DISTANCES", "Metric", "get_metric", "l2_normalize",
    "FilterT", "SortedIdFilter", "CallableFilter",
    "enable_profiling", "profiling_report", "PROFILER", "init_logging",
    "from_arrays", "to_arrays", "ivf_from_arrays", "ivf_to_arrays",
    "KERNEL_LAUNCHES", "reset_launch_counts",
]
