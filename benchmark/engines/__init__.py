"""The system under test, made from a configuration's ``index`` block. Its
``engine`` names a module ``engines/<engine>.py`` that gives
``build(cfg, X, device)``, the engine holding the whole host corpus ``X``
(each row inserted under its place in the corpus), and ``rows(engine, ids)``,
an answer's ids as the corpus rows they were inserted under (-1 stays -1).
A new engine is a new file."""

from __future__ import annotations

import importlib


def module(cfg: dict):
    return importlib.import_module(f"{__name__}.{cfg['index']['engine']}")


def built(cfg: dict, X, device):
    """The configuration's engine holding the whole corpus ``X``."""
    return module(cfg).build(cfg, X, device)


def rows(cfg: dict, engine, ids):
    """The configuration's engine's answer ``ids`` as corpus rows."""
    return module(cfg).rows(engine, ids)
