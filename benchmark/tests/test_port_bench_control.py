"""The check's control on the card: the reference computed in TF32 in the
program's place must come out not correct (``control.py``; its readings at
the cells' own sizes are in PERF.md). Here at a size a test run holds."""

import pytest
import torch

from benchmark import control


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sift1m.batch", "gist1m.exact"])
def test_tf32_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    small = {"config": {"n": 200_000}, "workload": {"pool": 2000}}
    got = control.control_run(cell, 2**31 + 5, "cuda:0", overrides=small)
    assert not got["correct"], got["compared"]
    assert not got["compared"]["dist_gap"]["pass"]
