"""Cold storage tiers (DESIGN.md §15), ported for the serving path's
KV store (``serve/kv_store.py``); wiring them into ``ArtifactStore`` is
ROADMAP queue 1 item 12.

The store's hierarchy is device → pinned host → local disk → remote
object store.  This module holds the two tiers that are NOT the
existing device cache / disk backend:

  * ``HostCache`` — a bytes-bounded LRU of numpy-resident column
    payloads.  The device cache demotes into it on eviction, so an
    artifact squeezed out of device memory is one host→device transfer
    away instead of a disk read (or a remote fetch).  Entries are pure
    caches: dropping one can never lose data.
  * ``RemoteObjectStore`` — an S3-style object store emulated on a
    local directory: whole-artifact blobs, atomic publish (tmp file +
    rename), per-request latency and bandwidth injection so benchmarks
    see realistic cold-fetch costs, and **batched** multi-object fetch
    (``get_many``/``head_many`` charge one round-trip for the batch —
    the reason a speculative prefetcher beats on-demand reads even
    when it fetches the same bytes).

Blob format (one object per artifact): a JSON header carrying the
artifact's manifest plus a column directory, followed by each data
file's columns individually compressed with the lossless columnar
codec in ``train/compression.py``.  Values round-trip bit-exactly —
the tier-transition property suite gates promote→demote→promote on
bit-identity, so a lossy codec is structurally impossible here.
"""
from __future__ import annotations

import collections
import json
import os
import struct
import tempfile
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..train.compression import decode_array, encode_array

_BLOB_MAGIC = b"RSB1"


# --------------------------------------------------------------- host tier
class HostCache:
    """Bytes-bounded LRU of host-resident artifact payloads.

    A payload is ``{col: array}``, numpy arrays or CPU tensors (both
    report ``nbytes``).  Thread-safe: a store may demote from whichever
    thread triggered the eviction."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._entries: "collections.OrderedDict[str, Tuple[dict, int]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def payload_nbytes(payload: dict) -> int:
        return sum(int(a.nbytes) for a in payload.values())

    def put(self, name: str, payload: dict,
            nbytes: Optional[int] = None) -> None:
        nb = self.payload_nbytes(payload) if nbytes is None else int(nbytes)
        with self._lock:
            if name in self._entries:
                self.total_bytes -= self._entries.pop(name)[1]
            if nb > self.max_bytes:
                return                    # oversized: not cacheable here
            self._entries[name] = (payload, nb)
            self.total_bytes += nb
            while self.total_bytes > self.max_bytes and len(self._entries) > 1:
                _, (_p, n) = self._entries.popitem(last=False)
                self.total_bytes -= n

    def get(self, name: str) -> Optional[dict]:
        with self._lock:
            ent = self._entries.get(name)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(name)
            self.hits += 1
            return ent[0]

    def drop(self, name: str) -> None:
        with self._lock:
            ent = self._entries.pop(name, None)
            if ent is not None:
                self.total_bytes -= ent[1]

    def recount(self) -> int:
        """Independent ledger recount (the accounting audits assert
        ``total_bytes == recount()``)."""
        with self._lock:
            return sum(nb for _p, nb in self._entries.values())

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# ----------------------------------------------------------- blob encoding
def encode_artifact_blob(manifest: dict,
                         files: Dict[str, Dict[str, np.ndarray]],
                         level: int = 1) -> bytes:
    """Pack an artifact (manifest + per-file column arrays) into one
    self-describing blob.  Columns are compressed independently so the
    directory in the header can say exactly what a ranged read would
    need — and so corruption is detectable per column (crc32 of the
    encoded bytes)."""
    import zlib
    directory: List[dict] = []
    payloads: List[bytes] = []
    off = 0
    for fname in sorted(files):
        for col in sorted(files[fname]):
            enc = encode_array(files[fname][col], level)
            directory.append({"file": fname, "col": col, "off": off,
                              "len": len(enc), "crc": zlib.crc32(enc)})
            payloads.append(enc)
            off += len(enc)
    header = json.dumps({"manifest": manifest,
                         "columns": directory}).encode()
    return (_BLOB_MAGIC + struct.pack("<I", len(header)) + header
            + b"".join(payloads))


def decode_blob_header(blob: bytes) -> dict:
    if blob[:4] != _BLOB_MAGIC:
        raise ValueError("artifact blob: bad magic")
    (hlen,) = struct.unpack_from("<I", blob, 4)
    return json.loads(blob[8:8 + hlen].decode())


def decode_artifact_blob(blob: bytes, verify: bool = True
                         ) -> Tuple[dict, Dict[str, Dict[str, np.ndarray]]]:
    """Inverse of ``encode_artifact_blob``; raises ValueError on any
    structural or checksum damage (the caller quarantines)."""
    import zlib
    head = decode_blob_header(blob)
    (hlen,) = struct.unpack_from("<I", blob, 4)
    base = 8 + hlen
    files: Dict[str, Dict[str, np.ndarray]] = {}
    for ent in head["columns"]:
        raw = blob[base + ent["off"]:base + ent["off"] + ent["len"]]
        if len(raw) != ent["len"]:
            raise ValueError("artifact blob: truncated payload")
        if verify and zlib.crc32(raw) != ent["crc"]:
            raise ValueError(f"artifact blob: column {ent['col']!r} "
                             f"checksum mismatch")
        files.setdefault(ent["file"], {})[ent["col"]] = decode_array(raw)
    return head["manifest"], files


def verify_blob(blob: bytes) -> bool:
    try:
        decode_artifact_blob(blob, verify=True)
        return True
    except Exception:
        return False


# ---------------------------------------------------------- remote tier
class RemoteObjectStore:
    """Local-directory emulation of an S3-like object store.

    One file per object, atomic publish (write to ``.tmp-*`` then
    rename), injectable per-request latency and bandwidth so cold
    fetches cost what a real remote costs.  Batched operations charge
    ONE latency for the whole batch — the economics that make
    speculative prefetch (which batches) beat demand paging (which
    cannot)."""

    def __init__(self, root: str, latency_s: float = 0.0,
                 bandwidth_bytes_s: Optional[float] = None):
        self.root = root
        self.latency_s = float(latency_s)
        self.bandwidth_bytes_s = bandwidth_bytes_s
        os.makedirs(root, exist_ok=True)
        self.stats = {"requests": 0, "objects_out": 0, "objects_in": 0,
                      "bytes_out": 0, "bytes_in": 0, "deletes": 0}
        self._lock = threading.Lock()

    # names reuse the store's injective dir encoding via the caller; the
    # remote itself only needs a flat, filesystem-safe key
    def path(self, key: str) -> str:
        return os.path.join(self.root, key + ".blob")

    def _charge(self, nbytes: int, n_requests: int = 1) -> None:
        d = self.latency_s * n_requests
        if self.bandwidth_bytes_s:
            d += nbytes / self.bandwidth_bytes_s
        if d > 0:
            time.sleep(d)

    def put_object(self, key: str, data: bytes) -> str:
        """Atomically publish ``data`` under ``key``; returns the final
        path (the store's fault choke point corrupts through it)."""
        self._charge(len(data))
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.rename(tmp, self.path(key))
        except BaseException:
            # SimulatedCrash cannot reach here (raised by the caller's
            # choke points), so any failure mid-write reaps the tmp
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self.stats["requests"] += 1
            self.stats["objects_in"] += 1
            self.stats["bytes_in"] += len(data)
        return self.path(key)

    def get_object(self, key: str) -> bytes:
        p = self.path(key)
        try:
            with open(p, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise KeyError(key)
        self._charge(len(data))
        with self._lock:
            self.stats["requests"] += 1
            self.stats["objects_out"] += 1
            self.stats["bytes_out"] += len(data)
        return data

    def get_many(self, keys: Iterable[str]) -> Dict[str, bytes]:
        """Batched fetch: one latency charge for the whole batch,
        bandwidth on the summed bytes.  Missing keys are simply absent
        from the result (a prefetcher must tolerate races with
        deletes)."""
        out: Dict[str, bytes] = {}
        for k in keys:
            try:
                with open(self.path(k), "rb") as f:
                    out[k] = f.read()
            except FileNotFoundError:
                continue
        total = sum(len(v) for v in out.values())
        self._charge(total, n_requests=1)
        with self._lock:
            self.stats["requests"] += 1
            self.stats["objects_out"] += len(out)
            self.stats["bytes_out"] += total
        return out

    def head_many(self, keys: Iterable[str]) -> Dict[str, dict]:
        """Batched header read (the blob's JSON header only — an S3
        ranged GET): one latency charge, bandwidth on header bytes.
        Used by store open to index a remote population without paying
        a full cold fetch per artifact."""
        out: Dict[str, dict] = {}
        nbytes = 0
        for k in keys:
            try:
                with open(self.path(k), "rb") as f:
                    pre = f.read(8)
                    if len(pre) < 8 or pre[:4] != _BLOB_MAGIC:
                        continue
                    (hlen,) = struct.unpack_from("<I", pre, 4)
                    hdr = f.read(hlen)
            except OSError:
                continue
            try:
                out[k] = json.loads(hdr.decode())
            except ValueError:
                continue
            nbytes += 8 + len(hdr)
        self._charge(nbytes, n_requests=1)
        with self._lock:
            self.stats["requests"] += 1
            self.stats["bytes_out"] += nbytes
        return out

    def exists(self, key: str) -> bool:
        return os.path.exists(self.path(key))

    def delete(self, key: str) -> None:
        try:
            os.unlink(self.path(key))
        except FileNotFoundError:
            pass
        with self._lock:
            self.stats["deletes"] += 1

    def keys(self) -> List[str]:
        return sorted(fn[:-5] for fn in os.listdir(self.root)
                      if fn.endswith(".blob") and not fn.startswith(".tmp-"))

    def gc_tmp(self) -> int:
        """Reap orphaned ``.tmp-*`` upload files (a killed demotion
        leaks them, exactly like the disk tier's publish dirs)."""
        reaped = 0
        for fn in os.listdir(self.root):
            if fn.startswith(".tmp-"):
                try:
                    os.unlink(os.path.join(self.root, fn))
                    reaped += 1
                except OSError:
                    continue
        return reaped

    def total_bytes(self) -> int:
        return sum(os.path.getsize(self.path(k)) for k in self.keys())
