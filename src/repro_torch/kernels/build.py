"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

The kernels are CUDA C++ with a plain C interface, compiled by ``nvcc``
for ``sm_90a`` into one shared library and bound with ``ctypes``.  The
build runs at first use, one ``nvcc`` per source started together, into
``<repo>/build/kernels-<digest>/``, where the digest covers the sources
and the flags, so an edited source rebuilds and an unchanged one loads.
Nothing here runs at import time: the CPU tests import every module on
a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("segment_sum.cu", "join_probe.cu", "filter_compact.cu",
           "radix_partition.cu", "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the build this process ran, if any

_P = ctypes.c_void_p
_SIGNATURES = {
    # vals, ids, out, n, d, num_segments, scratch_vals, scratch_ids, stream
    "restore_segment_sum": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, _P, _P, _P],
    "restore_segment_sum_tile": [],
    # left, right, pos, n, r, n_sm, stream
    "restore_join_probe": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, _P],
    # mask, n, block_counts, offsets, total, stream
    "restore_compact_offsets": [_P, ctypes.c_longlong, _P, _P, _P, _P],
    # src, mask, dst, n, w, offsets, total, stream
    "restore_compact_scatter": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                                _P, _P, _P],
    # h, valid, pid, hist, n, n_segs, tile_n, n_parts, stream
    "restore_radix_partition": [_P, _P, _P, _P, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    # h, valid, slot, ovf, scratch, n, n_segs, tile_n, n_parts, bucket,
    # stream
    "restore_partition_scatter": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, _P],
    # q, k, v, o, kv_len, q_offset, B, Hq, Hkv, Sq, Skv, D, strides,
    # causal, scale, bf16, stream
    "restore_flash_attention": [_P, _P, _P, _P, _P, _P, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                                ctypes.c_float, ctypes.c_int, _P],
}


class LaunchCounter:
    """Launches of one kernel wrapper: the wrapper adds one where it
    launches its kernel, and nowhere else."""

    def __init__(self):
        self._n = 0
        self._mu = threading.Lock()

    def add(self) -> None:
        with self._mu:
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._mu:
            self._n = 0


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
    for name in SOURCES:
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


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
