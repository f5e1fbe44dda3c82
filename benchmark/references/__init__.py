"""Plain references, one module per metric (``references/<metric>.py``), found
by the configuration's ``metric``. A reference is plain PyTorch: it imports
nothing of the program and works every answer out from the corpus and the
queries alone.

Each module gives ``truth`` (the exact top-k), ``pair_d2`` and ``norms`` (the
fp64 distances and terms the judge reads), ``gap`` (how far a returned
distance lies from the fp64 one, over the terms it was computed from) and
``control`` (the same top-k computed one precision below what the
configuration states: the check's control).
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _matmul_tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def exact_fp32():
    """float32 matrix products in full float32 (TF32 off)."""
    return _matmul_tf32(False)


def tf32():
    """float32 matrix products in TF32 on the tensor cores (the control)."""
    return _matmul_tf32(True)


def for_metric(name: str):
    return importlib.import_module(f"{__name__}.{name}")
