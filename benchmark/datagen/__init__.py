"""Corpus and query pool of a cell, made on the device from the run's seed.

A configuration's ``data`` block names its recipe: a module
``datagen/<recipe>.py`` whose ``make(g, n, nq, d, device, **args)`` draws
(X [n, d], Q [nq, d]) float32 on ``device`` from the generator ``g``, the
block's other keys its arguments. A recipe draws every number from that one
generator in a fixed order and in a few large calls, so one seed gives the
same corpus and queries in every run on the same card, and every seed gives
the same sizes. A new recipe is a new file.
"""

from __future__ import annotations

import importlib

import torch


def seeded(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make(data: dict, n: int, nq: int, d: int, seed: int, device):
    """The corpus and query pool a configuration's ``data`` block names."""
    recipe = importlib.import_module(f"{__name__}.{data['recipe']}")
    args = {k: v for k, v in data.items() if k != "recipe"}
    return recipe.make(seeded(seed, device), n, nq, d, device, **args)
