"""The port's graft entry points (``hnsw_tpu_torch/graft_entry.py``) on the
CPU, against the root ``__graft_entry__.py`` (the JAX package's): ``entry``'s
search program on the reference's index, its captured form, and
``dryrun_multichip`` on eight CPU shards."""

import functools

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import __graft_entry__ as jentry
from hnsw_tpu_torch import from_arrays, graft_entry, to_arrays
from hnsw_tpu_torch.convert import params_of


def _id_sets_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    for i, (x, y) in enumerate(zip(a, b)):
        assert set(x[x >= 0].tolist()) == set(y[y >= 0].tolist()), i


def test_entry_matches_jax_entry():
    """``entry(device="cpu")``'s ``fn(*args)`` gives the id sets the JAX
    ``entry()``'s ``jax.jit(fn)(*args)`` gives: on the reference's index
    carried across with ``convert``, and on the port's own serial build of
    it, with the same queries; distances within 1e-5."""
    jfn, jargs = jentry.entry()
    jids, jd = (np.asarray(o) for o in jax.jit(jfn)(*jargs))
    fn, (g, q, mask) = graft_entry.entry(device="cpu")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jargs[1]))
    hj, _, _ = jentry._small_index()
    carried = from_arrays(to_arrays(hj), params_of(hj), device="cpu")
    for graph in (carried.device_graph(), g):
        ids, d = fn(graph, q, mask)
        assert ids.shape == (8, 10) and np.isfinite(d[:, 0].numpy()).all()
        _id_sets_equal(ids.numpy(), jids)
        np.testing.assert_allclose(np.sort(d.numpy(), 1), np.sort(jd, 1), rtol=1e-5,
                                   atol=1e-5)


def test_entry_compiled_equals_direct():
    """``compiled(fn, args)``, the counterpart of ``jax.jit(fn)`` (a
    ``SearchProgram``; its pieces uncaptured on the CPU), answers the direct
    call bit for bit, with and without the int8 codec bound in."""
    from hnsw_tpu_torch.ops.graph_arrays import BeamCodec
    fn, args = graft_entry.entry(device="cpu")
    for f in (fn, functools.partial(fn, codec=BeamCodec.build(args[0], "i8"))):
        want = f(*args)
        got = graft_entry.compiled(f, args)(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_entry_needs_the_card_unless_cpu_is_asked(monkeypatch):
    """The entry points run on the card by default, and raise where there is
    none rather than moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)


def test_dryrun_multichip_eight_cpu_shards(capsys):
    """``dryrun_multichip(8, device="cpu")`` passes every assertion of the
    reference's body on eight CPU shards."""
    graft_entry.dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8)" in capsys.readouterr().out


def test_dryrun_multichip_four_shards_stops_as_the_reference():
    """At four shards the reference's body stops at its int8-codec
    self-retrieval assertion (a query finds a near neighbour in place of
    itself): the port's body stops at the same assertion with the same ids
    as the JAX package's on its 4-device CPU mesh."""
    with pytest.raises(AssertionError) as want:
        jentry._dryrun_multichip_impl(4)
    with pytest.raises(AssertionError) as got:
        graft_entry.dryrun_multichip(4, device="cpu")
    np.testing.assert_array_equal(np.asarray(got.value.args[0]),
                                  np.asarray(want.value.args[0]))
    assert np.asarray(got.value.args[0]).tolist() == [0, 1, 2, 3, 4, 136, 6, 7]
