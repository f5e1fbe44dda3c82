"""Build and bind the hand-written CUDA kernels (``hnsw_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library with
a plain C interface (no PyTorch headers: seconds to build instead of minutes),
loaded with ``ctypes``. Libraries land in ``build/hnsw_tpu_torch/`` at the repo
root, named by a hash of their source and of the ``csrc/*.cuh`` headers it
includes, so an edited source or header rebuilds and an unchanged one is
reused. Nothing here runs at import time: the CPU tests import
every module of the package on a machine without ``nvcc``.

``LAUNCHES`` counts kernel launches per wrapper. A wrapper launches through
``launch``, which counts exactly the launches that CUDA accepted, so a
caller can reset the counts, drive a path, and read which kernels that path
went through. Every kernel has two or three entries, named by its wrapper
from the shapes alone (``scan_topk.scan_entry``, ``codec_scores.codec_entry``
and ``gathered_entry``, ``id_scores.id_scores_entry``): beside the wrapper's
own count, ``<name>.<entry>`` says which entry each launch took
(``wgmma``/``tf32x3``/``simt`` for the scans, ``bulk``/``rows`` for the fused
codec scores, ``stream``/``rows`` for the gathered ones, ``f32``/``bf16`` for
the id-named row scores, ``fused``/``merge`` for the beam's bookkeeping,
``beam_step``, which takes its entry from the caller). ``CARD_LAUNCHES``
counts the same launches by card, ``(card index, counter)``, for a caller
that spreads work over several cards (the sharded tier): every card's share
of a path is read there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hnsw_tpu_torch"
SOURCES = ("beam_step", "codec_scores", "codec_scores_gathered", "id_scores", "scan_topk",
           "scan_topk_unpacked")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the launch functions' ``entry`` argument is the index into these
SCAN_ENTRIES = ("simt", "wgmma", "tf32x3")
CODEC_ENTRIES = ("rows", "bulk")
GATHERED_ENTRIES = ("rows", "stream")
ID_SCORES_ENTRIES = ("f32", "bf16")
BEAM_STEP_ENTRIES = ("fused", "merge")
ENTRIES = {"beam_step": BEAM_STEP_ENTRIES, "codec_scores_ids": CODEC_ENTRIES,
           "codec_scores": CODEC_ENTRIES, "codec_scores_gathered": GATHERED_ENTRIES, "id_scores": ID_SCORES_ENTRIES,
           "scan_topk": SCAN_ENTRIES, "scan_topk_unpacked": SCAN_ENTRIES}
LAUNCHES = {**{name: 0 for name in ENTRIES},
            **{f"{name}.{entry}": 0 for name, entries in ENTRIES.items()
               for entry in entries}}
# {(card index, counter): launches}, the counters of ``LAUNCHES`` by card
CARD_LAUNCHES: dict = {}

_lock = threading.Lock()
_libs: dict = {}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    CARD_LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set NVCC to its path)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def _source_bytes(path: Path, seen=None) -> bytes:
    """A source's bytes followed by those of every ``csrc`` header it
    includes (``#include "x.cuh"``), headers of headers too, each once."""
    seen = set() if seen is None else seen
    seen.add(path.name)
    src = path.read_bytes()
    out = [src]
    for inc in _INCLUDE.findall(src):
        header = CSRC / inc.decode()
        if header.name not in seen and header.exists():
            out.append(_source_bytes(header, seen))
    return b"".join(out)


def _lib_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu")
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` process per source, all
    started together. Returns {name: path}; raises with nvcc's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        # nvcc's ptxas report (registers, shared memory, spills) beside the library
        out.with_suffix(".ptxas.txt").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _lib_path(name) for name in names}


def ptxas_report(names=SOURCES) -> dict:
    """{source: [{"entry", "registers", "spill_stores", "spill_loads"}, ...]}
    read from the ptxas report nvcc wrote beside each built library (``-Xptxas
    -v``: one "Compiling entry function" block per kernel entry)."""
    report = {}
    for name in names:
        log = _lib_path(name).with_suffix(".ptxas.txt")
        entries = []
        if log.exists():
            for block in log.read_text().split("Compiling entry function")[1:]:
                entry = re.search(r"'([^']+)'", block)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
                regs = re.search(r"Used (\d+) registers", block)
                entries.append({"entry": entry.group(1) if entry else "",
                                "registers": int(regs.group(1)) if regs else None,
                                "spill_stores": int(spill.group(1)) if spill else None,
                                "spill_loads": int(spill.group(2)) if spill else None})
        report[name] = entries
    return report


def load(name: str):
    """The ctypes handle of kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            _bind(name, lib)
            _libs[name] = lib
        return lib


_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(name: str, lib):
    if name == "codec_scores":
        # (src, q, qsn, scale_ptr, blocks, B, E, M0, RID, d, form, entry,
        #  out, out_ids, stream)
        lib.codec_scores_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                            _I, _I, _I, _P, _P, _P]
        lib.codec_scores_launch.restype = _I
    elif name == "scan_topk":
        # (q, X, xsq, B, Np, d, tn, group, acc, LB, bf16, entry, layout, out,
        #  stream)
        lib.scan_topk_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _I, _I, _I, _I, _P, _P]
        lib.scan_topk_launch.restype = _I
    elif name == "codec_scores_gathered":
        # (q, blk, csq, qsn, scale_ptr, B, K, d, form, entry, out, stream)
        lib.codec_scores_gathered_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                                     _I, _I, _I, _P, _P]
        lib.codec_scores_gathered_launch.restype = _I
    elif name == "id_scores":
        # (q, vectors, sqnorms, ids, B, K, N, d, ld, form, bf16, out, stream)
        lib.id_scores_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
                                         _I, _I, _P, _P]
        lib.id_scores_launch.restype = _I
    elif name == "beam_step":
        # (beam_ids, beam_d, B, W, hist, H, slot, E, done, done_out, src_out,
        #  slack_m1, slack_one, cap1, tbl, ld, M, new_ids, K, threads, log_t,
        #  stream)
        lib.beam_step_launch.argtypes = [_P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                                         ctypes.c_float, _I, _I, _P, ctypes.c_longlong, _I,
                                         _P, _I, _I, _I, _P]
        lib.beam_step_launch.restype = _I
        # (beam_ids, beam_d, B, W, cand_ids, cand_d, K, ef, threads, n_pad,
        #  out_ids, out_d, stream)
        lib.beam_step_merge_launch.argtypes = [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P]
        lib.beam_step_merge_launch.restype = _I
        # shared memory bytes of a launch: (W, K, E, log_t), (W, n_pad)
        lib.beam_step_smem.argtypes = [_I, _I, _I, _I]
        lib.beam_step_smem.restype = ctypes.c_longlong
        lib.beam_step_merge_smem.argtypes = [_I, _I]
        lib.beam_step_merge_smem.restype = ctypes.c_longlong
    elif name == "scan_topk_unpacked":
        # (q, X, xsq, B, Np, d, tn, group, acc, bf16, entry, layout, outd, outi,
        #  stream)
        lib.scan_topk_unpacked_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I,
                                                  _I, _I, _I, _I, _P, _P, _P]
        lib.scan_topk_unpacked_launch.restype = _I


def check(rc: int, what: str):
    if rc != 0:
        import torch
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


def launch(name: str, entry: str, fn, *args, card=None):
    """Call a library's launch function and count the launch, for the wrapper
    ``name`` and for the ``entry`` it took, and on ``card`` (the index of the
    card it launched on) in ``CARD_LAUNCHES``. A launch that CUDA refused
    (non-zero return) raises and is not counted."""
    check(fn(*args), f"{name}.{entry}")
    for key in (name, f"{name}.{entry}"):
        LAUNCHES[key] += 1
        if card is not None:
            CARD_LAUNCHES[(card, key)] = CARD_LAUNCHES.get((card, key), 0) + 1
