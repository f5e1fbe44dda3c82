"""The benchmark's own tests: ``python3 -m pytest benchmark/tests -q`` from
the repository's root (CPU); the ``cuda``-marked ones run on the card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips where torch.cuda.is_available() is false)")
