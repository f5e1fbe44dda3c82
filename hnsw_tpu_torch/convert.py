"""Carry an index's state across as plain numpy arrays.

``to_arrays(hnsw)`` flattens an index into ``dict[str, np.ndarray]`` and
``from_arrays(state, params)`` rebuilds one: the point data and bookkeeping
(``_data``, ``_origin``, ``_level``, ``_rank_in_layer``, ``_layer_npoints``,
``_entry``, ``_nb_point``), the per-layer tables (``layer{l}_ids``,
``layer{l}_dists``, ``layer{l}_counts``) and the level sampler's state
(``sampler_state``, a JSON string of the numpy PCG64 state, and
``sampler_scale``). The keys are the attribute names the JAX package's
``Hnsw`` uses too, so a test can lift the same dict out of either package and
search one graph with both.

``params``: ``M``, ``efC``, ``max_layer``, ``scale`` (level scale), ``metric``,
``keep_pruned``, ``extend``.

``ivf_to_arrays(ix)`` / ``ivf_from_arrays(state, ...)`` do the same for an
``IvfFlatIndex``'s built state: ``centroids``, the packed f32 rows
(``packed``, list-major, ``cap`` rows a list), ``xsq`` (inf on padding rows),
``row2idx``, ``cap``, ``X`` and ``ids``. ``ivf_to_arrays`` reads either
package's index, so the port can serve a JAX-built index's lists as they are
(k-means alone would drift with the f32 summation order).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .models.hnsw import Hnsw, _LayerTable
from .models.ivf import IvfFlatIndex

_POINT_KEYS = ("_data", "_origin", "_level", "_rank_in_layer", "_layer_npoints")


def to_arrays(hnsw) -> dict:
    n = hnsw._nb_point
    out = {k: np.array(getattr(hnsw, k)[:n] if k != "_layer_npoints"
                       else getattr(hnsw, k)) for k in _POINT_KEYS}
    out["_entry"] = np.array(hnsw._entry, np.int64)
    out["_nb_point"] = np.array(n, np.int64)
    for l, t in sorted(hnsw._layers.items()):
        out[f"layer{l}_ids"] = np.array(t.ids[:n])
        out[f"layer{l}_dists"] = np.array(t.dists[:n])
        out[f"layer{l}_counts"] = np.array(t.counts[:n])
    ls = hnsw.level_sampler
    out["sampler_state"] = np.array(json.dumps(ls._rng.bit_generator.state))
    out["sampler_scale"] = np.array(ls.get_scale(), np.float64)
    return out


def params_of(hnsw) -> dict:
    return {"M": hnsw.max_nb_connection, "efC": hnsw.ef_construction,
            "max_layer": hnsw.max_layer, "scale": hnsw.get_level_scale(),
            "metric": hnsw.get_distance_name(), "keep_pruned": hnsw.keep_pruned,
            "extend": hnsw.extend_candidates}


def from_arrays(state: dict, params: dict, device=None) -> Hnsw:
    n = int(state["_nb_point"])
    h = Hnsw(max_nb_connection=int(params["M"]), max_elements=max(n, 8),
             max_layer=int(params["max_layer"]), ef_construction=int(params["efC"]),
             dist=params["metric"], level_scale=float(params["scale"]),
             device=device)
    h.set_keeping_pruned(bool(params.get("keep_pruned", False)))
    h.set_extend_candidates(bool(params.get("extend", False)))
    data = np.asarray(state["_data"])
    if n:
        h._set_dim(data.shape[1])
    for k in ("_data", "_origin", "_level", "_rank_in_layer"):
        getattr(h, k)[:n] = np.asarray(state[k])[:n]
    h._layer_npoints[:] = np.asarray(state["_layer_npoints"])
    layers = sorted(int(k[5:-4]) for k in state if k.startswith("layer") and k.endswith("_ids"))
    for l in layers:
        ids = np.asarray(state[f"layer{l}_ids"], np.int32)
        t = _LayerTable(h._cap, max(ids.shape[1], h._layer_width(l)))
        t.ids[:n, : ids.shape[1]] = ids[:n]
        t.dists[:n, : ids.shape[1]] = np.asarray(state[f"layer{l}_dists"], np.float32)[:n]
        t.counts[:n] = np.asarray(state[f"layer{l}_counts"], np.int32)[:n]
        h._layers[l] = t
    h._entry = int(state["_entry"])
    h._nb_point = n
    h._version += 1
    if "sampler_state" in state:
        h.level_sampler._rng.bit_generator.state = json.loads(str(state["sampler_state"]))
    if "sampler_scale" in state:
        h.level_sampler.scale = float(state["sampler_scale"])
    return h


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ivf_to_arrays(ix) -> dict:
    """The built state of an IVF-Flat index (either package's) as numpy arrays."""
    ix.build()
    cent, _, _, Xf3, xsq3, row2idx, cap = ix._built
    Xf = _host(Xf3).astype(np.float32)
    return {"centroids": _host(cent).astype(np.float32),
            "packed": Xf.reshape(-1, Xf.shape[-1]),
            "xsq": _host(xsq3).astype(np.float32).reshape(-1),
            "row2idx": np.asarray(row2idx, np.int64),
            "cap": np.array(int(cap), np.int64),
            "X": np.asarray(ix._X, np.float32),
            "ids": np.asarray(ix._ids, np.int64)}


def ivf_from_arrays(state: dict, dist="L2", nprobe: int = 8,
                    device=None) -> IvfFlatIndex:
    """An ``IvfFlatIndex`` serving the lists of ``state`` (``ivf_to_arrays``)."""
    ix = IvfFlatIndex(dist=dist, n_clusters=len(state["centroids"]), nprobe=nprobe,
                      device=device)
    ix._X = np.asarray(state["X"], np.float32)
    ix._ids = np.asarray(state["ids"], np.int64)
    ix._set_built(state["centroids"], state["packed"], state["xsq"],
                  state["row2idx"], int(state["cap"]))
    return ix
