"""Three-stage host pipeline for batched device serving.

Counterpart of ``hnsw_tpu/ops/stream.py``. ``pipelined_stream`` keeps the
JAX package's contract — ``fetch(item, dispatch(item, upload(item)))`` for
every item, with upload, dispatch and fetch on three threads — and the CUDA
specifics live in two helpers the stages use:

  * ``upload_batch`` copies a host batch into pinned memory and sends it to
    the card on a side stream, recording an event; the dispatcher waits on
    that event (not on the host), so the next batch's copy overlaps the
    current batch's kernels.
  * ``fetch_host`` records an event after the dispatched work; the fetcher
    thread waits on it from a second side stream, copies the results into
    pinned host memory and hands back numpy arrays.

CPU tensors pass straight through both helpers.

The helper owns the shutdown/error contract: an exception in any stage
propagates to the caller, a blocked uploader is drained, and the fetcher
always receives its sentinel.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..utils.profiling import PROFILER

_side_streams: dict = {}


def _side_stream(device, role: str):
    key = (str(device), role)
    s = _side_streams.get(key)
    if s is None:
        s = _side_streams[key] = torch.cuda.Stream(device=device)
    return s


class _Staged:
    def __init__(self, tensor, event=None, host=None):
        self.tensor, self.event, self._host = tensor, event, host

    def wait(self):
        """The staged tensor, ordered before work on the current stream."""
        if self.event is not None:
            cur = torch.cuda.current_stream(self.tensor.device)
            cur.wait_event(self.event)
            self.tensor.record_stream(cur)
        return self.tensor


def upload_batch(arr: np.ndarray, device) -> _Staged:
    device = torch.device(device)
    with PROFILER.span("stream.stage"):
        if device.type != "cuda":
            return _Staged(torch.from_numpy(np.array(arr)).to(device))
        host = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                           pin_memory=True)
        host.numpy()[...] = arr
    side = _side_stream(device, "upload")
    with torch.cuda.stream(side):
        dev = host.to(device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(side)
    return _Staged(dev, ev, host)


class _Pending:
    def __init__(self, tensors, event=None):
        self.tensors, self.event = tensors, event

    def get(self):
        """Block until the results are on the host; returns numpy arrays."""
        if self.event is None:
            return tuple(t.numpy() for t in self.tensors)
        dev = self.tensors[0].device
        side = _side_stream(dev, "fetch")
        with torch.cuda.stream(side):
            side.wait_event(self.event)
            hosts = []
            for t in self.tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                hosts.append(h)
        with PROFILER.span("stream.sync"):
            side.synchronize()
        self.tensors = None
        return tuple(h.numpy() for h in hosts)


def fetch_host(tensors) -> _Pending:
    """Mark dispatched results for the fetcher thread (call on the thread that
    launched the work)."""
    tensors = tuple(tensors)
    if tensors[0].device.type != "cuda":
        return _Pending(tensors)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(tensors[0].device))
    return _Pending(tensors, ev)


def pipelined_stream(work, upload, dispatch, fetch, depth: int = 2):
    """Run ``fetch(item, dispatch(item, upload(item)))`` for every item of
    ``work`` with the three stages overlapped.

    ``upload`` runs on the uploader thread (host->device staging),
    ``dispatch`` on the calling thread, ``fetch`` on the fetcher thread
    (device->host + writing into preallocated outputs, which makes result
    ordering irrelevant). The workers' spans carry the caller's call id.
    """
    staged = queue.Queue(maxsize=depth)
    results = queue.Queue(maxsize=depth)
    errs: list[BaseException] = []
    within = PROFILER.current()

    def _uploader():
        try:
            for it in work:
                if errs:
                    break
                with PROFILER.span("stream.upload", within):
                    dev = upload(it)
                staged.put((it, dev))
        except BaseException as e:  # surface in the caller
            staged.put(e)
        staged.put(None)

    def _fetcher():
        while True:
            r = results.get()
            if r is None:
                break
            if errs:
                continue  # keep draining so the dispatcher never blocks
            try:
                with PROFILER.span("stream.fetch", within):
                    fetch(*r)
            except BaseException as e:
                errs.append(e)

    with PROFILER.span("stream.start"):
        up = threading.Thread(target=_uploader, daemon=True)
        ft = threading.Thread(target=_fetcher, daemon=True)
        up.start()
        ft.start()
    done_staging = False
    try:
        while True:
            with PROFILER.span("stream.wait"):
                item = staged.get()
            if isinstance(item, BaseException):
                done_staging = True  # uploader already sent its sentinel next
                raise item
            if item is None:
                done_staging = True
                break
            if errs:
                done_staging = False
                break
            it, dev = item
            with PROFILER.span("stream.dispatch"):
                out = dispatch(it, dev)
            results.put((it, out))
        with PROFILER.span("stream.drain"):
            results.put(None)
            ft.join()
        if errs:
            raise errs[0]
    finally:
        if ft.is_alive():
            results.put(None)
            ft.join(timeout=30.0)
        while not done_staging:  # drain a blocked uploader
            try:
                nxt = staged.get(timeout=5.0)
                if nxt is None or isinstance(nxt, BaseException):
                    break
            except queue.Empty:
                break
