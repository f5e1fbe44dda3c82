"""Connected components of the layer-0 link table — min-label flooding.

Counterpart of ``hnsw_tpu/ops/components.py``. The diversity prune can
fracture layer 0 into islands on clustered corpora; ``component_labels``
finds them (label = smallest member row) and ``select_pivots`` spreads the
search's entry pivots over every island. ``.at[].min`` becomes
``scatter_reduce_(..., "amin")`` and ``lax.while_loop`` a Python loop of
sweeps that reads the host once per ``CHUNK`` sweeps and stops once the last
sweep changed nothing: a sweep past the fixpoint changes nothing (min-label
flooding is idempotent there), so the labels are the reference's. Nothing is
captured: there is one call per snapshot.
"""

from __future__ import annotations

import numpy as np
import torch

from .program import CHUNK


def _label_prop(tbl, live, max_sweeps: int = 512):
    """Min-label flooding over the undirected closure of a padded link table.

    tbl: [R, W] int32 neighbour ids, -1 padded. live: [R] bool.
    Returns [R] int64: the smallest live row reachable through the
    symmetrized graph; dead rows get R."""
    R = tbl.shape[0]
    dev = tbl.device
    tbl = tbl.to(torch.int64)
    labels = torch.where(live, torch.arange(R, device=dev), R)
    nbr_ok = tbl >= 0
    scat_idx = torch.where(nbr_ok, tbl, R).reshape(-1)
    safe = torch.clamp(tbl, 0, R - 1)
    for lo in range(0, max_sweeps, CHUNK):
        for _ in range(lo, min(lo + CHUNK, max_sweeps)):
            g = torch.where(nbr_ok, labels[safe], R)
            fwd = torch.minimum(labels, g.min(dim=1).values)
            fwd = torch.where(live, fwd, R)
            pushed = torch.full((R + 1,), R, dtype=torch.int64, device=dev)
            pushed.scatter_reduce_(0, scat_idx, fwd[:, None].expand_as(tbl).reshape(-1),
                                   reduce="amin")
            nxt = torch.where(live, torch.minimum(fwd, pushed[:R]), R)
            changed = (nxt != labels).any()
            labels = nxt
        if not bool(changed):
            break
    return labels


def component_labels(layer0_ids, n: int, device=None) -> np.ndarray:
    """Component label per live point (label = smallest member id). Rows
    >= n are ignored. Runs on ``device`` (default: where the table lies)."""
    tbl = torch.as_tensor(np.asarray(layer0_ids) if not torch.is_tensor(layer0_ids)
                          else layer0_ids, dtype=torch.int32)
    if device is not None:
        tbl = tbl.to(device)
    live = torch.arange(tbl.shape[0], device=tbl.device) < n
    return _label_prop(tbl, live).cpu().numpy()[:n]


def component_summary(labels: np.ndarray):
    roots, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts)
    return roots[order], counts[order]


def select_pivots(levels, layer0_ids, n: int, need: int, device=None) -> np.ndarray:
    """Entry-pivot set: the hierarchy's level>=1 points plus a
    component-aware corpus fill (quota ~ size * need / n per island)."""
    pv = np.flatnonzero(np.asarray(levels[:n]) >= 1).astype(np.int32)
    labels = component_labels(layer0_ids, n, device)
    roots, counts = np.unique(labels, return_counts=True)
    if len(roots) > 1:
        order = np.argsort(labels, kind="stable")
        starts = np.searchsorted(labels[order], roots)
        fills = [pv]
        for s0, c in zip(starts, counts):
            q = max(1, int(c) * need // max(n, 1))
            members = order[s0:s0 + c]
            fills.append(members[:: max(1, len(members) // q)][:q]
                         .astype(np.int32))
        return np.unique(np.concatenate(fills))
    if need > len(pv):
        step = max(1, n // max(need - len(pv), 1))
        fill = np.arange(0, n, step, dtype=np.int32)
        pv = np.unique(np.concatenate([pv, fill]))[:need]
    return pv
