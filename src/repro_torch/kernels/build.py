"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

The kernels are CUDA C++ with a plain C interface, compiled by ``nvcc``
for ``sm_90a`` into one shared library and bound with ``ctypes``.  The
build runs at first use, one ``nvcc`` per source started together, into
``<repo>/build/kernels-<digest>/``, where the digest covers the sources
and the flags, so an edited source rebuilds and an unchanged one loads.
``ptxas -v``'s report of each source (registers, spills, and any
warning that a wgmma pipeline was serialized) is kept beside the library
as ``<source>.log`` and read by ``ptxas_registers``.  Nothing here runs
at import time: the CPU tests import every module on a machine without
``nvcc``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .. import trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("segment_sum.cu", "join_probe.cu", "filter_compact.cu",
           "radix_partition.cu", "flash_attention.cu",
           "flash_attention_sm90.cu", "flash_attention_bwd.cu")
HEADERS = ("sm90_common.cuh",)   # included by the sources: in the digest
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the build this process ran, if any

_P = ctypes.c_void_p
_SIGNATURES = {
    # vals, ids, out, n, d, num_segments, scratch_vals, scratch_ids, stream
    "restore_segment_sum": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, _P, _P, _P],
    "restore_segment_sum_tile": [],
    # left, right, pos, n, r, bits, keys, dir, n_sm, stream
    "restore_join_probe": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, _P, _P, ctypes.c_int, _P],
    # mask, n, block_counts, offsets, total, stream
    "restore_compact_offsets": [_P, ctypes.c_longlong, _P, _P, _P, _P],
    # src, mask, dst, n, w, offsets, total, stream
    "restore_compact_scatter": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                                _P, _P, _P],
    # h, valid, pid, hist, n, tile_n, n_parts, stream
    "restore_radix_partition": [_P, _P, _P, _P, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_int, _P],
    # h, valid, slot, ovf, status, n, n_segs, n_parts, bucket, stream
    "restore_partition_scatter": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  _P],
    "restore_partition_scatter_tile": [],
    # q, k, v, o, kv_len, q_offset, kv_len_val, q_offset_val, B, Hq,
    # Hkv, Sq, Skv, D, Dv, strides, causal, scale, lse, lse_ld, stream
    "restore_flash_attention": [_P] * 6 + [ctypes.c_int] * 9 + [
        _P, ctypes.c_int, ctypes.c_float, _P, ctypes.c_int, _P],
    # the same with Dv after D, then scale_log2, scratch, n_split, lse,
    # lse_ld, stream
    "restore_flash_attention_sm90": [_P] * 6 + [ctypes.c_int] * 9 + [
        _P, ctypes.c_int, ctypes.c_float, _P, ctypes.c_int, _P,
        ctypes.c_int, _P],
    # q, k, v, o, dout, dq, dk, dv, lse, delta, ld, lse_given, kv_len,
    # q_offset, kv_len_val, q_offset_val, B, Hq, Hkv, Sq, Skv, D, Dv,
    # strides, causal, scale, stream
    "restore_flash_attention_bwd": [_P] * 10 + [ctypes.c_int] * 2 + [
        _P] * 2 + [ctypes.c_int] * 9 + [_P, ctypes.c_int, ctypes.c_float,
                                        _P],
    # q, k, v, o, dout, dq, dk, dv, lse, delta, ld, kv_len, q_offset,
    # kv_len_val, q_offset_val, B, Hq, Hkv, Sq, Skv, D, Dv, strides,
    # causal, scale_log2, scale, stream
    "restore_flash_attention_bwd_sm90": [_P] * 10 + [ctypes.c_int] + [
        _P] * 2 + [ctypes.c_int] * 9 + [_P, ctypes.c_int, ctypes.c_float,
                                        ctypes.c_float, _P],
}


class LaunchCounter:
    """Launches of one kernel wrapper: the wrapper adds one where it
    launches its kernel, and nowhere else.  A launch's ``shape``, where the
    wrapper gives one, is tallied in ``shapes``.  The counter registers
    itself under ``name`` in ``repro_torch.trace``, which reports its
    launches as ``launches.<name>`` and finds it by that name."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self.shapes = collections.Counter()
        self._mu = threading.Lock()
        trace.register_launches(self)

    def add(self, shape=None) -> None:
        with self._mu:
            self._n += 1
            if shape is not None:
                self.shapes[shape] += 1

    @property
    def count(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._mu:
            self._n = 0
            self.shapes.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch kernels: nvcc not found "
                           "(set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    """Compile every source in parallel, then link one .so."""
    global build_seconds
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(str(out_dir) + f".tmp-{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = tmp / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, errors = [], []
    for name, obj, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{name}:\n{out.decode(errors='replace')}")
        (tmp / (name + ".log")).write_bytes(out)
        objs.append(str(obj))
    if errors:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    so_tmp = tmp / "librestore_kernels.so"
    link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], *objs,
                           "-o", str(so_tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    for log in tmp.glob("*.log"):
        os.replace(log, out_dir / log.name)
    so = out_dir / "librestore_kernels.so"
    os.replace(so_tmp, so)           # atomic against a concurrent build
    shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / f"kernels-{_digest()}"
            so = out_dir / "librestore_kernels.so"
            if not so.exists():
                so = _build(out_dir)
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = lib
        return _lib


def ptxas_registers(source: str) -> dict:
    """{kernel: registers per thread} from the build's ``ptxas -v``
    report of ``source`` (e.g. "flash_attention_bwd.cu"), kernels named
    as "namespace::name<template args>" where the mangled name allows,
    and under "serialized" the report's lines that say a wgmma pipeline
    was serialized.  Builds the library first if needed."""
    library()
    text = (BUILD_ROOT / f"kernels-{_digest()}" / (source + ".log")) \
        .read_text(errors="replace")
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _readable(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = int(m.group(1))
            name = None
    out["serialized"] = [ln.strip() for ln in text.splitlines()
                         if "serialized" in ln]
    return out


def _readable(mangled: str) -> str:
    """A kernel's mangled name as "namespace::name<args>" (int template
    arguments and float), or as it is if it does not parse."""
    m = re.search(r"(sm90|simt)(\d+)", mangled)
    if m is None:
        return mangled
    n, at = int(m.group(2)), m.end()
    args = re.match(r"I((?:Li\d+E|f)+)E", mangled[at + n:])
    targs = [a or "float" for a, _ in re.findall(r"Li(\d+)E|(f)",
                                                  args.group(1))] \
        if args else []
    return f"{m.group(1)}::{mangled[at:at + n]}<{', '.join(targs)}>"


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
