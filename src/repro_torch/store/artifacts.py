"""Artifact store: the HDFS analogue, with a device-resident cache tier.

Stores Tables under content-addressed names.  Storage hierarchy
(DESIGN.md §3):

  * **device cache** — a bytes-bounded LRU of live Tables whose tensors
    stay on the card.  ``get()`` of a recently produced artifact
    returns them without touching numpy or disk;
  * in-memory backend — used by tests (models Hadoop's case where
    intermediate data fits the page cache);
  * on-disk backend — one directory per artifact: ``data.npz`` +
    ``manifest.json`` (schema, capacity, row count, byte size, creation
    time, crc32).  Writes are **write-behind**: ``put()`` records
    metadata and caches the table synchronously, then a background
    flusher thread compacts the table (on the card, through the
    ``filter_project`` kernel, for a CUDA table), copies the surviving
    rows to the host and writes the npz off the timed path.
    Publication stays atomic (tmp dir + rename).  ``flush()`` is the
    durability barrier.

Partitioned artifacts (the mesh path, DESIGN.md §11) are written as one
``shard_%05d.npz`` per partition, each compacted to a common shard
capacity, and ``get_partitioned`` re-partitions an artifact on read for
a consumer whose shard count or keys differ, caching the result as a
derived ``<name>#repart...`` view.  Their slicing runs in numpy on the
host, as in the reference, so the shard files are the reference's.

A store built with a ``GroupMesh`` (``mesh=``) is one of the ranks'
views of a root they share.  A rank's tables are its row blocks: it
writes the shard file of its own partition and reads it back; the shard
capacity, row counts and crc32s are gathered so every rank holds the
same manifest, and rank 0 alone writes it, publishes and deletes.  A
monolithic artifact is every rank's rows gathered and written by rank 0;
a rank reads its block of it.  These writes run inline on the caller's
thread, since their collectives must run in one order on every rank.

The on-disk format is the JAX reference's byte for byte, so a store
either package writes reopens in the other.  ``append`` and
``merge_shards`` refresh a stored artifact from a delta (DESIGN.md §12),
``fault_injector`` reaches the disk and remote tiers' IO choke points
(DESIGN.md §13), and ``read_log`` feeds the speculative prefetcher.

Below the device cache sit the reference's two cold tiers (DESIGN.md
§15, ``store/tiers.py``): with ``host_bytes > 0`` an artifact the device
cache squeezes out is demoted to a host LRU, on the card into pinned
host tensors (one synchronisation a demotion, and a ``non_blocking``
copy back on reuse); with ``remote=`` a published disk artifact can be
demoted to an RSB1 blob in a remote object store and promoted back, and
reopening after a crash mid-transition leaves exactly one durable owner.
The blobs are the reference's byte for byte.
"""
from __future__ import annotations

import atexit
import collections
import io
import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..dataflow.table import (Table, concat_tables, partition_ids_device,
                               slice_valid, to_tensor)
from ..device import resolve
from .tiers import (HostCache, decode_artifact_blob, encode_artifact_blob,
                    table_files_to_payloads, verify_blob)

# Default byte bound for the device-resident cache tier.
DEFAULT_CACHE_BYTES = int(os.environ.get("RESTORE_CACHE_BYTES",
                                         256 * 1024 * 1024))
# Bounded write-behind queue: puts block (backpressure) once this many
# distinct artifact names are waiting to be flushed.
DEFAULT_QUEUE_DEPTH = 64
# Orphaned ``.tmp-*`` publish dirs older than this are reaped when a
# store opens (DESIGN.md §13).
DEFAULT_TMP_GC_AGE_S = float(os.environ.get("RESTORE_TMP_GC_AGE_S", 900))
# Derived re-partitioned views kept per base artifact: each is a
# full-size copy competing with real artifacts for device bytes.
DEFAULT_MAX_DERIVED_VIEWS = 4
# Transient-IO retry policy (capped exponential backoff).
READ_ATTEMPTS = 5
WRITE_ATTEMPTS = 4
RETRY_BASE_S = 0.002
RETRY_CAP_S = 0.1


class ArtifactError(Exception):
    """Base for artifact-level failures the driver can degrade around:
    reuse is an optimization, so every subclass maps to "quarantine the
    artifact and recompute cold" (DESIGN.md §13)."""

    def __init__(self, name: Optional[str], msg: Optional[str] = None):
        self.name = name
        super().__init__(msg or str(name))


class ArtifactMissingError(ArtifactError, KeyError):
    """Artifact not in the store (subclasses KeyError for callers of the
    pre-§13 API)."""


class CorruptArtifactError(ArtifactError):
    """On-disk bytes fail checksum/parse verification — deterministic
    damage, never retried, always quarantined."""


class TransientStoreError(ArtifactError):
    """IO kept failing after the capped-backoff retries."""


class ArtifactFlushError(ArtifactError, OSError):
    """One or more write-behind flushes failed permanently.  Raised by
    ``flush()`` — the durability barrier can never silently succeed
    after a failed write.  ``failures`` maps artifact name -> the
    exception that killed its write; the named artifacts have been
    de-advertised (a later run recomputes them).  Subclasses OSError:
    pre-§13 callers caught the propagated write error directly."""

    def __init__(self, failures: Dict[str, BaseException]):
        self.failures = dict(failures)
        ArtifactError.__init__(
            self, None, f"write-behind flush failed for "
                        f"{sorted(self.failures)}")


class SimulatedCrash(BaseException):
    """Raised by a FaultInjector to model process death mid-operation.
    Deliberately NOT an ``Exception``: retry wrappers must not absorb
    it, and the publish path must leave its tmp dir in place exactly
    like a real kill would (the crash-recovery suites assert the
    reopened store GCs it)."""


def _encode_name(name: str) -> str:
    """Injective artifact-name -> directory-name encoding.

    ``/`` is illegal in a path component so it becomes ``__``; a literal
    underscore is escaped to ``_u`` so names like ``art/q__v2`` survive a
    store re-open (the old ``replace("__", "/")`` decode corrupted them).
    """
    return name.replace("_", "_u").replace("/", "__")


def _decode_name(enc: str) -> str:
    out = []
    i = 0
    while i < len(enc):
        if enc.startswith("__", i):
            out.append("/")
            i += 2
        elif enc.startswith("_u", i):
            out.append("_")
            i += 2
        else:
            out.append(enc[i])
            i += 1
    return "".join(out)


def _pow2ceil(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    """Serialize arrays to npz bytes in memory, so the crc32 recorded in
    the manifest covers exactly the bytes written to disk."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _partition_ids(table: Table, keys, n_parts: int) -> np.ndarray:
    """Host partition ids: the same ``partition_hash(keys) % P`` the mesh
    exchange routes by (DESIGN.md §11), computed on the table's device,
    with -1 for invalid rows — so the ids and the validity mask cross to
    the host in ONE copy of 4 bytes a row (``pid >= 0`` is the mask)."""
    pid = partition_ids_device(table, keys, n_parts)
    pid = torch.where(table.valid, pid, torch.full_like(pid, -1))
    return pid.to(torch.int32).cpu().numpy().astype(np.int64)


def _partition_layout(table: Table, keys, n_parts: int, mesh=None):
    """(pid, per-partition valid row counts, shard capacity) for storing
    ``table`` as ``n_parts`` equal-capacity partition shards (pid as
    ``_partition_ids`` gives it).  With a ``mesh`` of several processes
    ``table`` is this rank's block and the counts are every rank's
    summed, so the capacity is the whole table's."""
    pid = _partition_ids(table, keys, n_parts)
    counts = np.bincount(pid[pid >= 0], minlength=n_parts)
    if mesh is not None:
        counts = mesh.sum_ranks(torch.from_numpy(counts)).numpy()
    m = int(counts.max()) if counts.size else 1
    # capacity granularity of 1/8th of the pow2 octave: padding stays
    # under 12.5% while the shape-class count stays bounded
    g = max(8, _pow2ceil(max(m, 1)) // 8)
    shard_cap = max(8, -(-m // g) * g)
    return pid, counts, shard_cap


def _slice_partitions(host_cols: Dict[str, np.ndarray], mask: np.ndarray,
                      pid: np.ndarray, n_parts: int, shard_cap: int):
    """Slice host columns into per-partition blocks, each truncated and
    zero-padded to ``shard_cap`` rows.  The ONE implementation of the
    block layout — the sharded writer and re-partition-on-read must stay
    bit-identical (and identical to the reference's).  One stable
    argsort of the partition ids, then per-partition view slicing.
    Returns ({col: [block per partition]}, [valid rows per partition]).
    """
    rows = np.flatnonzero(mask)
    pr = pid[rows]
    order = np.argsort(pr, kind="stable")     # within-partition row order
    rows_s, pr_s = rows[order], pr[order]
    starts = np.searchsorted(pr_s, np.arange(n_parts))
    rank = np.arange(len(rows_s)) - starts[pr_s.astype(np.intp)]
    keep = rank < shard_cap                   # truncate overfull shards
    pos = (pr_s * shard_cap + rank)[keep]
    rows_k = rows_s[keep]
    counts = [int(c) for c in
              np.minimum(np.bincount(pr_s, minlength=n_parts), shard_cap)]
    blocks: Dict[str, list] = {}
    for n, a in host_cols.items():
        out = np.zeros((n_parts * shard_cap,) + a.shape[1:], a.dtype)
        out[pos] = a[rows_k]
        blocks[n] = [out[p * shard_cap:(p + 1) * shard_cap]
                     for p in range(n_parts)]
    return blocks, counts


class DeviceCache:
    """Bytes-bounded LRU over live (device-resident) Tables.

    Thread-safe: the write-behind flusher swaps in the compacted version
    of an artifact after publishing it, concurrently with reader
    ``get``s on the engine thread.

    ``on_evict`` (optional callable ``(name, table, nbytes)``) is
    invoked for every entry squeezed out by byte pressure — the store
    demotes those to the pinned-host tier (DESIGN.md §15) and prunes
    derived-view metadata.  It fires AFTER the cache lock is released
    (the callback copies to the host and takes other locks) and only for
    pressure evictions: explicit ``drop``/``drop_prefix`` mean the data
    is stale or deleted, which must not demote."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._entries: "collections.OrderedDict[str, Tuple[Table, int]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.on_evict = None

    @property
    def bytes_used(self) -> int:
        return self.total_bytes

    def recount(self) -> int:
        """Independent recount of the byte ledger from the entries
        themselves.  The accounting audits assert
        ``total_bytes == recount()`` after mutation storms — a drifted
        ledger silently mis-sizes every eviction decision."""
        with self._lock:
            return sum(nb for _t, nb in self._entries.values())

    def get(self, name: str) -> Optional[Table]:
        with self._lock:
            ent = self._entries.get(name)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(name)
            self.hits += 1
            return ent[0]

    def _put_locked(self, name: str, table: Table, nbytes: int) -> list:
        """Insert/replace under the lock.  Returns the entries evicted by
        byte pressure so the caller can run ``on_evict`` outside the
        lock.  A replaced entry's bytes are subtracted before the new
        size is added, so a re-put charges exactly the delta, never both
        versions."""
        evicted = []
        if name in self._entries:
            self.total_bytes -= self._entries.pop(name)[1]
        # an artifact larger than the whole cache is not cached at all —
        # but it still displaces nothing, so it is reported as one
        # eviction of itself (the host tier may hold what device cannot)
        if nbytes > self.max_bytes:
            self.evictions += 1
            return [(name, table, nbytes)]
        self._entries[name] = (table, nbytes)
        self._entries.move_to_end(name)
        self.total_bytes += nbytes
        while (self.total_bytes > self.max_bytes
               and len(self._entries) > 1):
            k, (t, nb) = self._entries.popitem(last=False)
            self.total_bytes -= nb
            self.evictions += 1
            evicted.append((k, t, nb))
        return evicted

    def _notify(self, evicted: list) -> None:
        cb = self.on_evict
        if cb is None:
            return
        for name, table, nb in evicted:
            try:
                cb(name, table, nb)
            except Exception:
                pass        # a demotion failure must never break a put

    def put(self, name: str, table: Table, nbytes: int):
        with self._lock:
            evicted = self._put_locked(name, table, nbytes)
        self._notify(evicted)

    def swap_if(self, name: str, expected: Optional[Table],
                table: Table, nbytes: int):
        """Atomically insert ``table`` only if the current entry is
        ``expected``: the flusher uses this so its compacted version can
        never clobber a newer put that raced past it.  An entry the LRU
        already evicted is NOT resurrected — re-inserting it would evict
        recently-used entries to make room for one nobody asked for
        (it is on disk now; the next get re-caches it on demand)."""
        with self._lock:
            ent = self._entries.get(name)
            if ent is None or ent[0] is not expected:
                return
            evicted = self._put_locked(name, table, nbytes)
        self._notify(evicted)

    def drop(self, name: str):
        with self._lock:
            ent = self._entries.pop(name, None)
            if ent is not None:
                self.total_bytes -= ent[1]

    def drop_prefix(self, prefix: str):
        """Drop every entry whose key starts with ``prefix`` (derived
        re-partitioned views of a deleted artifact)."""
        with self._lock:
            for k in [k for k in self._entries if k.startswith(prefix)]:
                self.total_bytes -= self._entries.pop(k)[1]

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class _WriteBehind:
    """Background flusher: bounded, coalescing queue of pending artifact
    writes.  The caller thread enqueues (table, meta); this thread does
    device→host transfer + np.savez + atomic rename."""

    def __init__(self, store: "ArtifactStore", max_depth: int):
        self._store = store
        self._max_depth = max_depth
        self._cv = threading.Condition()
        # name -> (table, meta) — newest data wins
        self._jobs: Dict[str, Tuple] = {}
        self._order: "collections.deque[str]" = collections.deque()
        self._queued = set()
        self._writing: Optional[str] = None
        # name -> exception of a permanently failed write.  Tracked
        # per artifact so one bad write can't hide behind a later good
        # one: flush() raises ArtifactFlushError listing every failure
        # since the last barrier (DESIGN.md §13).  Healed by a
        # successful re-put of the same name, or by cancel/delete.
        self.failures: Dict[str, BaseException] = {}
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self.flushed_count = 0

    # ------------------------------------------------------------- caller
    def _ensure_thread(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="artifact-flusher", daemon=True)
            self._thread.start()
            # drain pending writes before interpreter shutdown kills the
            # daemon thread (callers should still flush() explicitly at
            # durability points)
            atexit.register(self._flush_quietly)

    def _flush_quietly(self):
        # atexit drain: failures are still *recorded* (and the artifacts
        # de-advertised by the flusher) — only the raise is suppressed,
        # with a stderr warning so a failed write is never invisible
        try:
            self.flush()
        except BaseException as e:
            import sys
            print(f"restore: write-behind flush failed at exit: {e!r}",
                  file=sys.stderr)

    def submit(self, name: str, table: Table, meta: dict, pid=None):
        with self._cv:
            if self._closed:
                raise RuntimeError("store is closed")
            while (len(self._order) >= self._max_depth
                   and name not in self._queued):
                self._cv.wait()
            self._jobs[name] = (table, meta, pid)
            if name not in self._queued:
                self._queued.add(name)
                self._order.append(name)
            self._ensure_thread()
            self._cv.notify_all()

    def pending(self, name: str) -> Optional[Table]:
        with self._cv:
            job = self._jobs.get(name)
            return job[0] if job is not None else None

    def cancel(self, name: str):
        """Drop a queued write and wait out any in-flight write of the
        same name (so delete() cannot race with a publish)."""
        with self._cv:
            self._jobs.pop(name, None)
            self.failures.pop(name, None)   # deleted names owe no report
            if name in self._queued:
                self._queued.discard(name)
                try:        # stale names must not count toward backpressure
                    self._order.remove(name)
                except ValueError:
                    pass
                self._cv.notify_all()
            while self._writing == name:
                self._cv.wait()

    def flush(self):
        """Durability barrier.  Returns only when the queue is drained
        AND every write since the last barrier succeeded; otherwise
        raises ArtifactFlushError naming each failed artifact (already
        de-advertised by the flusher).  Reported failures are cleared —
        each barrier reports what broke since the previous one."""
        with self._cv:
            while self._jobs or self._writing is not None:
                self._cv.wait()
            if self.failures:
                failed, self.failures = self.failures, {}
                raise ArtifactFlushError(failed)

    def close(self):
        try:
            self.flush()
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=5)
                # the atexit hook would otherwise pin the store (and its
                # device cache) in memory for the process lifetime
                atexit.unregister(self._flush_quietly)
                self._thread = None

    # ------------------------------------------------------------ flusher
    def _run(self):
        # a CUDA table is compacted on this thread: bind it to the
        # store's card (the job that produced the table already
        # synchronised before put())
        if self._store.device.type == "cuda":
            torch.cuda.set_device(self._store.device)
        while True:
            with self._cv:
                while not self._order and not self._closed:
                    self._cv.wait()
                if self._closed and not self._order:
                    return
                name = self._order.popleft()
                self._queued.discard(name)
                job = self._jobs.get(name)
                if job is None:          # cancelled while queued
                    self._cv.notify_all()
                    continue
                self._writing = name
                self._cv.notify_all()
            err = None
            compacted = None
            for attempt in range(WRITE_ATTEMPTS):
                try:
                    compacted = self._store._write_to_disk(
                        name, job[0], job[1], pid=job[2])
                    err = None
                    break
                except OSError as e:     # transient IO: capped backoff
                    err = e
                    if attempt + 1 < WRITE_ATTEMPTS:
                        self._store.stats["write_retries"] += 1
                        time.sleep(min(RETRY_CAP_S,
                                       RETRY_BASE_S * (2 ** attempt)))
                except BaseException as e:
                    # SimulatedCrash and programming errors are not
                    # transient — never retried, surfaced at flush()
                    err = e
                    break
            with self._cv:
                if self._jobs.get(name) is job:
                    del self._jobs[name]     # no newer put superseded us
                    if compacted is not None:
                        self.failures.pop(name, None)   # healed
                        # swap the compacted table into the device cache
                        # so reuse paths see the truncated capacity —
                        # unless a newer put already cached fresher data
                        self._store.cache.swap_if(name, job[0], compacted,
                                                  job[1]["nbytes"])
                    elif err is not None:
                        # the write is lost (retries exhausted): record
                        # the failure for flush() and stop advertising
                        # the artifact, or later runs would "reuse" data
                        # that will never be on disk
                        self.failures[name] = err
                        self._store.meta.pop(name, None)
                        self._store.cache.drop(name)
                # a superseded job's failure is irrelevant — the newer
                # put will be written (or fail) on its own turn
                self._writing = None
                self.flushed_count += 1
                self._cv.notify_all()



class ArtifactStore:
    def __init__(self, root: Optional[str] = None,
                 cache_bytes: int = DEFAULT_CACHE_BYTES,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 write_behind: bool = True,
                 fault_injector=None,
                 tmp_gc_age_s: float = DEFAULT_TMP_GC_AGE_S,
                 host_bytes: int = 0,
                 remote=None,
                 cost_model=None,
                 max_derived_views: int = DEFAULT_MAX_DERIVED_VIEWS,
                 device=None, mesh=None):
        self.root = root
        # a GroupMesh whose ranks share this store's root: each rank
        # holds its own row blocks, writes its own shard files and reads
        # its own shard back; rank 0 alone writes manifests, publishes
        # and deletes.  None (or a LocalMesh): one process holds it all
        self.mesh = mesh if mesh is not None and mesh.spans_processes \
            else None
        # tables loaded from disk, the host tier or the remote are placed
        # here
        self.device = resolve(device)
        self.mem: Dict[str, Table] = {}
        self.meta: Dict[str, dict] = {}
        self.aliases: Dict[str, str] = {}
        # service.faults.FaultInjector (or None): called at the IO choke
        # points ("read"/"write"/"publish"/"published" on the disk tier,
        # "remote_read"/"remote_write"/"remote_published" on the remote
        # tier) so the fault suites can model torn writes, crashes and
        # flaky IO without monkeypatching store internals (DESIGN.md §13)
        self.fault_injector = fault_injector
        self.tmp_gc_age_s = float(tmp_gc_age_s)
        # robustness and tier-transition counters
        self.stats = {"quarantined": 0, "read_retries": 0,
                      "write_retries": 0, "tmp_gc": 0, "corrupt_on_open": 0,
                      "demotions": 0, "promotions": 0, "host_demotions": 0,
                      "remote_reconciled": 0}
        # guards compound metadata transitions (put's record-then-submit,
        # delete's cancel-then-unlink, alias rewrites).  The flusher
        # thread must NEVER take this lock: delete() holds it while
        # waiting out an in-flight write.
        self._lock = threading.RLock()
        # measured transfer samples (bytes moved, seconds on the caller's
        # clock) per serving tier — the repository cost model calibrates
        # its bandwidth estimates from these (DESIGN.md §9/§15).  Disk
        # reads under load_*, device-cache/memory hits under memload_*,
        # host-tier promotions under hostload_*, remote fetches under
        # remoteload_*.
        self._io = {"load_bytes": 0, "load_s": 0.0,
                    "memload_bytes": 0, "memload_s": 0.0,
                    "hostload_bytes": 0, "hostload_s": 0.0,
                    "remoteload_bytes": 0, "remoteload_s": 0.0,
                    "store_bytes": 0, "store_s": 0.0}
        self.cache = DeviceCache(cache_bytes)
        self.cache.on_evict = self._on_device_evict
        # host tier: payloads demoted from the device cache (§15)
        self.host = HostCache(host_bytes) if host_bytes > 0 else None
        # remote object-store tier (tiers.RemoteObjectStore or None)
        self.remote = remote
        # duck-typed CostModel; optional (store must not depend on core)
        self.cost_model = cost_model
        self.max_derived_views = int(max_derived_views)
        # recent read log (name, tier) — the speculative prefetcher
        # mines this for popularity; deque ops are atomic under the GIL
        self.read_log: "collections.deque" = collections.deque(maxlen=1024)
        # effective partitioning of cached re-partitioned views (keyed by
        # the derived "<name>#repart..." cache names), and the insertion
        # order of live views per base artifact (oldest goes first)
        self._repart_meta: Dict[str, dict] = {}
        self._derived_order: Dict[str, list] = {}
        self._wb = _WriteBehind(self, queue_depth) if write_behind else None
        if root:
            os.makedirs(root, exist_ok=True)
            if self._rank0:
                self.gc_tmp(self.tmp_gc_age_s)
            for name in self._scan_disk():
                try:
                    self.meta[name] = self._read_manifest(name)
                except (json.JSONDecodeError, OSError, ValueError):
                    # a torn manifest means the artifact can never be
                    # loaded: reap it now rather than advertise it
                    self.stats["corrupt_on_open"] += 1
                    shutil.rmtree(self._path(name), ignore_errors=True)
        if self.remote is not None:
            self._reconcile_remote()

    @property
    def _rank0(self) -> bool:
        """Whether this process writes manifests and publishes."""
        return self.mesh is None or self.mesh.rank == 0

    def _resolve(self, name: str) -> str:
        seen = set()
        while name in self.aliases and name not in seen:
            seen.add(name)
            name = self.aliases[name]
        return name

    def alias(self, name: str, target: str):
        if name != target:
            with self._lock:
                self.aliases[name] = target

    # ------------------------------------------------------------------ disk
    def _path(self, name: str) -> str:
        return os.path.join(self.root, _encode_name(name))

    def _fault(self, point: str, name: str, path: Optional[str] = None):
        """Fault-injection choke point (no-op without an injector)."""
        if self.fault_injector is not None:
            self.fault_injector.on(point, name, path=path)

    def gc_tmp(self, age_s: Optional[float] = None) -> int:
        """Reap orphaned ``.tmp-*`` publish dirs older than ``age_s``
        seconds (a crashed writer leaks them forever otherwise)."""
        if not self.root:
            return 0
        if age_s is None:
            age_s = self.tmp_gc_age_s
        now = time.time()
        reaped = 0
        for d in os.listdir(self.root):
            if not d.startswith(".tmp-"):
                continue
            p = os.path.join(self.root, d)
            try:
                if now - os.path.getmtime(p) < age_s:
                    continue
                shutil.rmtree(p)
                reaped += 1
            except OSError:
                continue        # racing writer published/cleaned it
        self.stats["tmp_gc"] += reaped
        return reaped

    def _scan_disk(self):
        out = []
        for d in os.listdir(self.root):
            if d.startswith(".tmp-"):    # unpublished write, never decode
                continue
            if _encode_name(_decode_name(d)) != d:
                continue
            if os.path.exists(os.path.join(self.root, d, "manifest.json")):
                out.append(_decode_name(d))
        return out

    def _read_manifest(self, name: str) -> dict:
        with open(os.path.join(self._path(name), "manifest.json")) as f:
            return json.load(f)

    def _host_table(self, cols: Dict[str, np.ndarray],
                    valid: np.ndarray) -> Table:
        """numpy arrays -> Table on the store's device."""
        return Table({n: to_tensor(a, self.device) for n, a in cols.items()},
                     to_tensor(np.asarray(valid, bool), self.device))

    def _write_to_disk(self, name: str, table: Table, meta: dict,
                       pid=None) -> Table:
        """Compact, serialize, atomically publish one artifact.  Runs on
        the flusher thread (write-behind) or inline; either way a crash
        mid-write leaves only an unpublished tmp dir, never a torn
        artifact.  Returns the compacted table for the device-cache
        swap.  Partitioned artifacts go to ``_write_sharded``."""
        if meta.get("partitioning") is not None:
            return self._write_sharded(name, table, meta, pid)
        packed = table.host_compact(meta["capacity"], meta["rows"])
        valid = packed.pop("__valid__")
        final = self._path(name)
        self._fault("write", name)
        tmp = tempfile.mkdtemp(dir=self.root, prefix=".tmp-")
        try:
            data = _npz_bytes(dict(__valid__=valid, **packed))
            # checksums land in the SAME meta dict put() advertised, so
            # in-memory readers and the disk manifest agree after flush
            meta["checksums"] = {"data.npz": zlib.crc32(data)}
            with open(os.path.join(tmp, "data.npz"), "wb") as f:
                f.write(data)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            self._fault("publish", name, path=tmp)
            self._publish(tmp, final)
        except SimulatedCrash:
            raise   # a real kill leaves its tmp dir; the injected one must
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._fault("published", name, path=final)
        return self._host_table(packed, valid)

    def _write_sharded(self, name: str, table: Table, meta: dict,
                       pid=None) -> Table:
        """One ``shard_%05d.npz`` per partition, each compacted to the
        common ``shard_capacity``.  The returned table concatenates the
        shards in partition order: exactly the block layout the mesh
        splits by (DESIGN.md §11)."""
        part = meta["partitioning"]
        n_parts, shard_cap = part["n_parts"], part["shard_capacity"]
        if pid is None:     # write_behind=False path recomputes inline
            pid = _partition_ids(table, part["keys"], n_parts)
        host = {n: c.cpu().numpy() for n, c in table.columns.items()}
        blocks, counts = _slice_partitions(host, pid >= 0, pid, n_parts,
                                           shard_cap)
        vblocks = [np.arange(shard_cap) < c for c in counts]
        final = self._path(name)
        self._fault("write", name)
        tmp = tempfile.mkdtemp(dir=self.root, prefix=".tmp-")
        try:
            checks = {}
            for p in range(n_parts):
                fn = f"shard_{p:05d}.npz"
                data = _npz_bytes(dict(
                    __valid__=vblocks[p],
                    **{n: blocks[n][p] for n in host}))
                checks[fn] = zlib.crc32(data)
                with open(os.path.join(tmp, fn), "wb") as f:
                    f.write(data)
            meta["checksums"] = checks
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            self._fault("publish", name, path=tmp)
            self._publish(tmp, final)
        except SimulatedCrash:
            raise   # a real kill leaves its tmp dir; the injected one must
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._fault("published", name, path=final)
        return self._host_table(
            {n: np.concatenate(bs) for n, bs in blocks.items()},
            np.concatenate(vblocks))

    def _write_group(self, name: str, table: Table, meta: dict,
                     pid) -> Table:
        """The write of a GroupMesh's artifact, on every rank at once
        and inline (its collectives run on the caller's thread, in the
        order every rank issues them).  Partitioned: rank r writes
        ``shard_{r:05d}.npz`` from its own block (whose valid rows all
        belong to partition r) into the ``.tmp-`` directory rank 0 made,
        the crc32s are gathered, rank 0 writes the manifest and
        publishes.  Monolithic: every rank's block is gathered and rank 0
        writes the whole table.  A barrier ends both.  Returns this
        rank's block of the stored (compacted) artifact."""
        mesh = self.mesh
        part = meta.get("partitioning")
        self._fault("write", name)
        if part is None:
            whole = mesh.gather_rows(table)
            packed = whole.host_compact(meta["capacity"], meta["rows"])
            valid = packed.pop("__valid__")
            if self._rank0:
                tmp = tempfile.mkdtemp(dir=self.root, prefix=".tmp-")
                data = _npz_bytes(dict(__valid__=valid, **packed))
                meta["checksums"] = {"data.npz": zlib.crc32(data)}
                with open(os.path.join(tmp, "data.npz"), "wb") as f:
                    f.write(data)
                self._publish_manifest(name, tmp, meta)
            mesh.barrier()
            return mesh.local_table(self._host_table(packed, valid))
        n_parts, shard_cap = part["n_parts"], part["shard_capacity"]
        tmp = mesh.agree(tempfile.mkdtemp(dir=self.root, prefix=".tmp-")
                         if self._rank0 else None)
        host = {n: c.cpu().numpy() for n, c in table.columns.items()}
        blocks, counts = _slice_partitions(host, pid >= 0, pid, n_parts,
                                           shard_cap)
        r = mesh.rank
        mine = {n: blocks[n][r] for n in host}
        vmine = np.arange(shard_cap) < part["shard_rows"][r]
        fn = f"shard_{r:05d}.npz"
        data = _npz_bytes(dict(__valid__=vmine, **mine))
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(data)
        crcs = mesh.gather_rows(torch.tensor([zlib.crc32(data)],
                                             dtype=torch.int64))
        meta["checksums"] = {f"shard_{p:05d}.npz": int(c)
                             for p, c in enumerate(crcs.tolist())}
        if self._rank0:
            self._publish_manifest(name, tmp, meta)
        mesh.barrier()
        return self._host_table(mine, vmine)

    def _publish_manifest(self, name: str, tmp: str, meta: dict):
        try:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            self._fault("publish", name, path=tmp)
            self._publish(tmp, self._path(name))
        except SimulatedCrash:
            raise
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._fault("published", name, path=self._path(name))

    def _publish(self, tmp: str, final: str):
        """Atomically swap ``tmp`` into place.  An existing version is
        renamed aside first (itself atomic), so a concurrent reader
        never observes a half-deleted directory."""
        if os.path.exists(final):
            aside = tempfile.mkdtemp(dir=self.root, prefix=".tmp-old-")
            os.rename(final, os.path.join(aside, "d"))
            os.rename(tmp, final)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.rename(tmp, final)

    # ------------------------------------------------------------------ api
    def exists(self, name: str) -> bool:
        name = self._resolve(name)
        if name in self.mem or name in self.cache or name in self.meta:
            return True
        if self.host is not None and name in self.host:
            return True
        return self._on_disk(name) or self._on_remote(name)

    def _on_disk(self, name: str) -> bool:
        return bool(self.root) and os.path.exists(
            os.path.join(self._path(name), "manifest.json"))

    def _on_remote(self, name: str) -> bool:
        return self.remote is not None and self.remote.exists(
            self._remote_key(name))

    def io_stats(self) -> dict:
        """Measured transfer totals for cost-model calibration."""
        out = dict(self._io)
        out["has_disk"] = bool(self.root)
        return out

    def put(self, name: str, table: Table,
            partitioning: Optional[dict] = None) -> dict:
        """Store ``table`` under ``name``.  Stored artifacts shrink to
        the live row count (next power of 2): this is what makes reusing
        a selective Filter/Project output cheaper than recomputing it
        (paper Figs 16/17).  The compaction itself happens on the
        flusher thread; the only on-clock work here is one read of the
        table's live-row count.

        ``partitioning`` (``{"keys": [...], "n_parts": P, "scheme":
        "hash_mod"}`` or a ``core.plan.Partitioning``) records the
        partition property of the value: the artifact is then written as
        P shard files (row r in shard ``hash(keys)(r) % P``), each
        compacted to a common shard capacity, and the property lands in
        the manifest so a consumer co-partitioned on the same keys loads
        it shuffle-free (DESIGN.md §11).  Its on-clock work is one pass
        of the partition hash and one device-to-host copy of the ids and
        the mask together."""
        if table.device != self.device:
            raise ValueError(f"put({name!r}): table on {table.device}, "
                             f"store on {self.device}")
        t_start = time.perf_counter()
        name = self._resolve(name)
        pid = None
        if partitioning is not None:
            if hasattr(partitioning, "to_dict"):
                partitioning = partitioning.to_dict()
            part = {"keys": [str(k) for k in partitioning["keys"]],
                    "n_parts": int(partitioning["n_parts"]),
                    "scheme": partitioning.get("scheme", "hash_mod")}
            pid, counts, shard_cap = _partition_layout(
                table, part["keys"], part["n_parts"], self.mesh)
            mask = pid >= 0
            nvalid = int(counts.sum())
            # the live table is served from the device cache as-is, so
            # the claimed property must already hold physically: valid
            # row r lives in block r // (capacity/P); on a GroupMesh
            # rank r's block is partition r.  A violated claim would let
            # a consumer skip an exchange it actually needs.
            P_ = part["n_parts"]
            if self.mesh is not None:
                ok = P_ == self.mesh.n_shards and bool(
                    (pid[mask] == self.mesh.rank).all())
            else:
                blk = table.capacity // P_ if table.capacity % P_ == 0 \
                    else 0
                ok = blk > 0 and np.array_equal(
                    pid[mask], np.arange(table.capacity)[mask] // blk)
            if not ok:
                raise ValueError(
                    f"put({name!r}): table layout does not match claimed "
                    f"partitioning {part['keys']} x {P_}")
            part["shard_capacity"] = int(shard_cap)
            part["shard_rows"] = [int(c) for c in counts]
            storecap = shard_cap * P_
        else:
            part = None
            nvalid = table.num_valid()
            capacity = table.capacity
            if self.mesh is not None:
                # the whole table: every rank's block
                nvalid = self.mesh.sum_ranks(nvalid.to(torch.int64))
                capacity *= self.mesh.n_shards
            nvalid = int(nvalid)
            storecap = min(capacity,
                           max(8, 1 << (max(nvalid, 1) - 1).bit_length()))
        # manifest capacity/nbytes describe the *stored* (compacted)
        # artifact, so they always agree with the data files on reload
        nbytes = storecap
        for c in table.columns.values():
            width = int(c.shape[1]) if c.ndim == 2 else 1
            nbytes += c.element_size() * storecap * width
        created = time.time()
        if self.mesh is not None:
            created = self.mesh.agree(created)
        meta = dict(name=name, capacity=storecap, rows=nvalid,
                    nbytes=int(nbytes), created=created)
        if part is not None:
            meta["partitioning"] = part
        with self._lock:
            # a re-put replaces the artifact's data, so any cached
            # re-partitioned views derived from the OLD data are stale
            self._drop_derived(name)
            # cache the live (uncompacted) table: the flusher swaps in
            # the compacted version once it is published.  meta is
            # recorded BEFORE submit so the flusher's failed-write
            # de-advertising (meta.pop) can never be overwritten here.
            self.cache.put(name, table, table.nbytes())
            self.meta[name] = meta
            try:
                if self.root and self.mesh is not None:
                    stored = self._write_group(name, table, meta, pid)
                    self.cache.put(name, stored, stored.nbytes())
                elif self.root:
                    if self._wb is not None:
                        self._wb.submit(name, table, meta, pid)
                    else:
                        compacted = self._write_to_disk(name, table, meta,
                                                        pid=pid)
                        self.cache.put(name, compacted, meta["nbytes"])
                else:
                    self.mem[name] = table
            except BaseException:
                # a failed put must not leave a phantom artifact
                self.cache.drop(name)
                self.meta.pop(name, None)
                raise
        self._io["store_bytes"] += meta["nbytes"]
        self._io["store_s"] += time.perf_counter() - t_start
        return meta

    def get(self, name: str) -> Table:
        """Serve ``name`` from the warmest tier holding it — device →
        host → memory backend → pending write → disk → remote —
        promoting into the device cache on the way up and tagging the IO
        sample with the serving tier (DESIGN.md §15)."""
        t_start = time.perf_counter()
        name = self._resolve(name)
        hit = self.cache.get(name)
        if hit is not None:
            self._sample_load(name, t_start, tier="memload")
            return hit
        if self.host is not None:
            payload = self.host.get(name)
            if payload is not None:
                t = self._table_from_host(payload)
                self.cache.put(name, t, t.nbytes())
                self._sample_load(name, t_start, tier="hostload")
                return t
        if name in self.mem:
            self._sample_load(name, t_start, tier="memload")
            return self.mem[name]
        if not self.root and self.remote is None:
            raise ArtifactMissingError(name)
        if self._wb is not None:
            pend = self._wb.pending(name)
            if pend is not None:         # evicted from cache, not yet on disk
                return pend
        if self._on_disk(name):
            t = self._load_disk_retry(name)
            tier = "load"
        elif self._on_remote(name):
            t = self._load_remote(name)
            tier = "remoteload"
        elif self.root:
            # the disk path classifies what nothing else holds as missing
            # or corrupt, with its retry ladder
            t = self._load_disk_retry(name)
            tier = "load"
        else:
            raise ArtifactMissingError(name)
        self.cache.put(name, t, t.nbytes())
        self._sample_load(name, t_start, tier=tier)
        return t

    def _load_disk_retry(self, name: str) -> Table:
        """Disk load with capped-backoff retries over transient OSErrors.
        Deterministic damage (checksum/parse failure) and genuinely
        absent artifacts raise immediately."""
        last: Optional[BaseException] = None
        for attempt in range(READ_ATTEMPTS):
            try:
                return self._load_disk(name)
            except (ArtifactMissingError, CorruptArtifactError):
                raise
            except OSError as e:
                last = e
                if attempt + 1 < READ_ATTEMPTS:
                    self.stats["read_retries"] += 1
                    time.sleep(min(RETRY_CAP_S,
                                   RETRY_BASE_S * (2 ** attempt)))
        raise TransientStoreError(
            name, f"load({name!r}) failed after {READ_ATTEMPTS} "
                  f"attempts: {last!r}")

    def _load_disk(self, name: str) -> Table:
        self._fault("read", name)
        m = self.meta.get(name)
        if m is None:
            try:
                m = self.meta[name] = self._read_manifest(name)
            except FileNotFoundError:
                raise ArtifactMissingError(name)
            except (json.JSONDecodeError, ValueError) as e:
                raise CorruptArtifactError(
                    name, f"manifest unreadable: {e}")
        checks = m.get("checksums") or {}
        # a partitioned artifact (written by the reference's mesh path)
        # reads as its shards concatenated in partition order; a rank of
        # a GroupMesh reads its own shard, or its block of a monolithic
        # artifact
        files = self._data_files(m)
        if self.mesh is not None and m.get("partitioning") is not None:
            self._check_parts(m["partitioning"])
            files = [files[self.mesh.rank]]
        return self._read_files(name, m, files, checks)

    def _check_parts(self, part: dict) -> None:
        if part["n_parts"] != self.mesh.n_shards:
            raise ValueError(f"a {part['n_parts']}-shard artifact on a "
                             f"{self.mesh.n_shards}-rank mesh: read it "
                             "through get_partitioned")

    def _read_files(self, name, m, files, checks, whole=False) -> Table:
        """The table of ``files`` of artifact ``name`` concatenated;
        on a GroupMesh a monolithic artifact's block of this rank
        unless ``whole``."""
        cols: Dict[str, list] = {}
        valids = []
        for fn in files:
            z = self._read_npz_verified(name, fn, checks.get(fn))
            valids.append(z["__valid__"])
            for n in z.files:
                if n != "__valid__":
                    cols.setdefault(n, []).append(z[n])
        t = self._host_table({n: np.concatenate(bs)
                              for n, bs in cols.items()},
                             np.concatenate(valids))
        if self.mesh is not None and not whole and \
                m.get("partitioning") is None:
            t = self.mesh.local_table(t)
        return t

    def _read_npz_verified(self, name: str, fname: str,
                           crc: Optional[int]):
        """Read one data file whole, crc-verify against the manifest
        (when recorded), and parse from memory.  Any mismatch is
        CorruptArtifactError: the caller quarantines and recomputes."""
        path = os.path.join(self._path(name), fname)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            if not os.path.exists(
                    os.path.join(self._path(name), "manifest.json")):
                raise ArtifactMissingError(name)   # whole artifact gone
            raise CorruptArtifactError(
                name, f"{fname} missing from published artifact")
        if crc is not None and zlib.crc32(data) != crc:
            raise CorruptArtifactError(
                name, f"{fname} checksum mismatch")
        try:
            return np.load(io.BytesIO(data))
        except Exception as e:      # BadZipFile / ValueError / pickle junk
            raise CorruptArtifactError(name, f"{fname} unreadable: {e}")

    def _drop_derived(self, name: str) -> None:
        """Invalidate cached ``<name>#repart...`` views (put/delete of
        the base artifact makes them stale)."""
        self.cache.drop_prefix(name + "#repart")
        for k in [k for k in self._repart_meta
                  if k.startswith(name + "#repart")]:
            del self._repart_meta[k]
        self._derived_order.pop(name, None)

    def _register_derived(self, name: str, ck: str, part: dict,
                          table: Table) -> None:
        """Record one derived re-partitioned view, bounded to
        ``max_derived_views`` live views per base artifact (oldest view
        evicted first): probes cycling through distinct mesh sizes would
        otherwise keep one full-size copy per size."""
        with self._lock:
            order = self._derived_order.setdefault(name, [])

            def forget_evicted():
                # views whose data the device cache has evicted
                for k in [k for k in order if k not in self.cache]:
                    order.remove(k)
                    self._repart_meta.pop(k, None)

            forget_evicted()
            if ck in order:
                order.remove(ck)
            while len(order) >= max(self.max_derived_views, 1):
                old = order.pop(0)
                self._repart_meta.pop(old, None)
                self.cache.drop(old)
            self._repart_meta[ck] = part
            order.append(ck)
            self.cache.put(ck, table, table.nbytes())
            forget_evicted()            # the put itself may evict a view

    def column_names(self, name: str) -> Tuple[str, ...]:
        """Column names of a stored artifact WITHOUT materializing it:
        cache/memory tables answer directly; on disk only the npz
        directory is read.  The mesh executor needs schemas for its
        static partition propagation (DESIGN.md §11)."""
        name = self._resolve(name)
        t = self.cache.get(name)
        if t is None:
            t = self.mem.get(name)
        if t is None and self._wb is not None:
            t = self._wb.pending(name)
        if t is not None:
            return tuple(t.names)
        if not self.root:
            raise ArtifactMissingError(name)
        part = self.partitioning(name)
        fn = "shard_00000.npz" if part is not None else "data.npz"
        path = os.path.join(self._path(name), fn)
        if not os.path.exists(path):
            raise ArtifactMissingError(name)
        try:
            with np.load(path) as z:
                return tuple(sorted(n for n in z.files
                                    if n != "__valid__"))
        except Exception as e:
            raise CorruptArtifactError(name, f"{fn} unreadable: {e}")

    # ------------------------------------------------------- partitioning
    def partitioning(self, name: str) -> Optional[dict]:
        """The stored partition property of an artifact (None when the
        artifact is monolithic or unknown)."""
        m = self.meta.get(self._resolve(name))
        return (m or {}).get("partitioning")

    def get_partitioned(self, name: str, keys, n_parts: int
                        ) -> Tuple[Table, dict]:
        """Load an artifact arranged for an exchange on ``keys`` across
        ``n_parts`` shards.  If the stored partitioning already covers
        the request it is returned as-is (the shuffle-free path);
        otherwise the table is re-partitioned on read — one pass of the
        partition hash on the device, the slicing in numpy on the host —
        and cached as a derived view, instead of a device exchange every
        time the artifact is consumed (DESIGN.md §11).  Returns (table,
        effective partitioning)."""
        name = self._resolve(name)
        keys = [str(k) for k in keys]
        stored = self.partitioning(name)
        if stored is not None and stored["n_parts"] == n_parts \
                and set(stored["keys"]) <= set(keys):
            return self.get(name), stored
        ck = f"{name}#repart{n_parts}:{','.join(keys)}"
        hit = self.cache.get(ck)
        if hit is not None and ck in self._repart_meta:
            return hit, self._repart_meta[ck]
        t = self.get(name) if self.mesh is None else self._whole(name)
        pid, _counts, shard_cap = _partition_layout(t, keys, n_parts)
        host = {n: c.cpu().numpy() for n, c in t.columns.items()}
        blocks, counts = _slice_partitions(host, pid >= 0, pid, n_parts,
                                           shard_cap)
        t2 = self._host_table(
            {n: np.concatenate(bs) for n, bs in blocks.items()},
            np.concatenate([np.arange(shard_cap) < c for c in counts]))
        part = {"keys": keys, "n_parts": int(n_parts), "scheme": "hash_mod",
                "shard_capacity": int(shard_cap),
                "shard_rows": [int(c) for c in counts]}
        if self.mesh is not None:
            t2 = self.mesh.local_table(t2)     # this rank's partition
        self._register_derived(name, ck, part, t2)
        return t2, part

    def _whole(self, name: str) -> Table:
        """Every rank's rows of an artifact, in rank order (a GroupMesh
        re-partitions on read from the whole table): its files when
        published, else every rank's block gathered."""
        name = self._resolve(name)
        m = self.meta.get(name)
        if m is not None and self._on_disk(name):
            return self._read_files(name, m, self._data_files(m),
                                    m.get("checksums") or {}, whole=True)
        return self.mesh.gather_rows(self.get(name))

    def _sample_load(self, name: str, t_start: float, tier: str):
        m = self.meta.get(name)
        if m is not None:
            self._io[tier + "_bytes"] += m["nbytes"]
            self._io[tier + "_s"] += time.perf_counter() - t_start
        if "#repart" not in name:
            self.read_log.append((name, tier))

    # ------------------------------------------------------------- tiers
    def _remote_key(self, name: str) -> str:
        return _encode_name(name)

    def _host_payload(self, table: Table) -> dict:
        """The host tier's copy of a Table, keyed as the reference's
        numpy payload (columns, then ``__valid__``).  On the card each
        column and the mask land in pinned host tensors, all copies
        queued without blocking and then one synchronisation; a failure
        to pin raises (there is no quiet pageable fallback).  A CPU
        store's tensors are host memory already and are held as they are
        (the store never writes a stored tensor in place)."""
        cols = dict(table.columns)
        cols["__valid__"] = table.valid
        if self.device.type != "cuda":
            return cols
        out = {}
        for n, c in cols.items():
            h = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
            h.copy_(c, non_blocking=True)
            out[n] = h
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _table_from_host(self, payload: dict) -> Table:
        """A host-tier payload back on the store's device (from pinned
        memory, without blocking the host)."""
        if self.device.type != "cuda":
            return Table({n: a for n, a in payload.items()
                          if n != "__valid__"}, payload["__valid__"])
        return Table({n: a.to(self.device, non_blocking=True)
                      for n, a in payload.items() if n != "__valid__"},
                     payload["__valid__"].to(self.device, non_blocking=True))

    def _on_device_evict(self, name: str, table: Table, nbytes: int):
        """Pressure-eviction hook from the device cache: derived views
        just drop their metadata (they are rebuildable); real artifacts
        demote their columns to the host tier so the next get is a
        host→device transfer, not a disk read (DESIGN.md §15)."""
        if "#repart" in name:
            self._repart_meta.pop(name, None)
            base = name.split("#repart", 1)[0]
            order = self._derived_order.get(base)
            if order and name in order:
                order.remove(name)
            return
        if self.host is None or name not in self.meta:
            return
        if self.cost_model is not None and not self._admit_host(name, nbytes):
            return
        self.host.put(name, self._host_payload(table))
        self.stats["host_demotions"] += 1

    def _admit_host(self, name: str, nbytes: int) -> bool:
        """Price host admission with the attached cost model: demote
        only when re-reading from the serving tier below (disk or
        remote) would cost more than the host round-trip saves.  With no
        model attached, always admit (the host tier is a cache — wrong
        answers cost time, never correctness)."""
        below = "remote" if (self._on_remote(name)
                             and not self._on_disk(name)) else "disk"
        try:
            return bool(self.cost_model.should_promote(nbytes, below, "host"))
        except Exception:
            return True

    def residency(self, name: str) -> Optional[str]:
        """The warmest tier currently able to serve ``name``: "device" /
        "host" / "memory" / "pending" / "disk" / "remote", or None when
        the artifact does not exist anywhere."""
        name = self._resolve(name)
        if name in self.cache:
            return "device"
        if self.host is not None and name in self.host:
            return "host"
        if name in self.mem:
            return "memory"
        if self._wb is not None and self._wb.pending(name) is not None:
            return "pending"
        if self._on_disk(name):
            return "disk"
        if self._on_remote(name):
            return "remote"
        return None

    def authoritative_tier(self, name: str) -> Optional[str]:
        """The durable tier that OWNS the artifact's bytes ("disk",
        "remote", "memory", or "pending" while a write-behind flush is
        in flight; "conflict" only mid-crash, which reopening heals).
        Device and host copies are caches, never owners."""
        name = self._resolve(name)
        on_disk, on_remote = self._on_disk(name), self._on_remote(name)
        if on_disk and on_remote:
            return "conflict"
        if on_disk:
            return "disk"
        if on_remote:
            return "remote"
        if name in self.mem:
            return "memory"
        if self._wb is not None and self._wb.pending(name) is not None:
            return "pending"
        return None

    def _reconcile_remote(self) -> None:
        """Open-time reconciliation of the disk/remote ownership
        invariant after a crash mid-transition (DESIGN.md §15): a
        verified remote copy wins (a crash between remote publish and
        local delete was a demotion about to commit); an unverifiable
        remote blob is garbage from a torn upload and is deleted,
        leaving the disk copy authoritative.  Remote-only artifacts are
        indexed by one batched header fetch."""
        self.remote.gc_tmp()
        keys = self.remote.keys()
        if not keys:
            return
        heads = self.remote.head_many(keys)
        for key in keys:
            name = _decode_name(key)
            if self._on_disk(name):
                try:
                    ok = verify_blob(self.remote.get_object(key))
                except KeyError:
                    continue
                if not ok:
                    self.remote.delete(key)
                    continue
                shutil.rmtree(self._path(name), ignore_errors=True)
                self.meta.pop(name, None)
                self.stats["remote_reconciled"] += 1
            head = heads.get(key)
            if head is None:
                # unreadable header and no disk copy: the artifact is
                # lost and must not be advertised
                if not self._on_disk(name):
                    self.remote.delete(key)
                    self.stats["corrupt_on_open"] += 1
                continue
            m = dict(head["manifest"])
            m["tier"] = "remote"
            self.meta[name] = m

    def _data_files(self, m: dict) -> list:
        part = m.get("partitioning")
        return ([f"shard_{p:05d}.npz" for p in range(part["n_parts"])]
                if part is not None else ["data.npz"])

    def demote_to_remote(self, name: str) -> dict:
        """Move a disk-resident artifact to the remote tier: its data
        files, column-compressed, as one blob published atomically, THEN
        the local copy removed.  A crash before the publish leaves the
        disk copy untouched; after it, reopening makes the remote copy
        authoritative.  Returns the updated meta."""
        name = self._resolve(name)
        with self._lock:
            self.flush()                 # the disk copy must be complete
            m = self.meta.get(name)
            if m is None or not self._on_disk(name):
                raise ArtifactMissingError(name)
            if self.remote is None:
                raise ArtifactError(name, "store has no remote tier")
            manifest = self._read_manifest(name)
            payloads = table_files_to_payloads(self._path(name),
                                               self._data_files(m))
            blob = encode_artifact_blob(manifest, payloads)
            key = self._remote_key(name)
            self._fault("remote_write", name)
            blob_path = self.remote.put_object(key, blob)
            # the commit point: a crash before this fault leaves both
            # copies (reopening completes the demotion)
            self._fault("remote_published", name, path=blob_path)
            shutil.rmtree(self._path(name), ignore_errors=True)
            m = dict(manifest)
            m["tier"] = "remote"
            self.meta[name] = m
            # device and host copies stay valid caches of the same bytes
            self.stats["demotions"] += 1
            return m

    def promote_from_remote(self, name: str) -> dict:
        """Rehydrate a remote artifact onto local disk (atomic publish,
        fresh checksums), then delete the remote copy so exactly one
        durable tier owns it.  A crash between the local publish and the
        remote delete leaves both; reopening's verified-remote-wins rule
        demotes again, which loses nothing."""
        name = self._resolve(name)
        with self._lock:
            if self.remote is None:
                raise ArtifactError(name, "store has no remote tier")
            if not self.root:
                raise ArtifactError(name, "store has no disk tier")
            key = self._remote_key(name)
            manifest, files = self._fetch_remote(name, key)
            final = self._path(name)
            tmp = tempfile.mkdtemp(dir=self.root, prefix=".tmp-")
            try:
                checks = {}
                for fn, cols in sorted(files.items()):
                    data = _npz_bytes(cols)
                    checks[fn] = zlib.crc32(data)
                    with open(os.path.join(tmp, fn), "wb") as f:
                        f.write(data)
                manifest = dict(manifest)
                manifest["checksums"] = checks
                manifest.pop("tier", None)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                self._fault("publish", name, path=tmp)
                self._publish(tmp, final)
            except SimulatedCrash:
                raise
            except Exception:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._fault("published", name, path=final)
            self.remote.delete(key)
            self.meta[name] = manifest
            self.stats["promotions"] += 1
            return manifest

    def _fetch_remote(self, name: str, key: str):
        """Fetch and decode one remote blob (fault-injectable; checksum
        damage quarantines like the disk tier's)."""
        self._fault("remote_read", name)
        try:
            blob = self.remote.get_object(key)
        except KeyError:
            raise ArtifactMissingError(name)
        try:
            return decode_artifact_blob(blob)
        except ValueError as e:
            raise CorruptArtifactError(name, f"remote blob: {e}")

    def _table_from_payloads(self, manifest: dict, files: dict) -> Table:
        part = manifest.get("partitioning")
        order = (self._data_files(manifest) if part is not None
                 else sorted(files))
        cols: Dict[str, list] = {}
        valids = []
        for fn in order:
            z = files[fn]
            valids.append(z["__valid__"])
            for n, a in z.items():
                if n != "__valid__":
                    cols.setdefault(n, []).append(a)
        return self._host_table({n: np.concatenate(bs)
                                 for n, bs in cols.items()},
                                np.concatenate(valids))

    def _load_remote(self, name: str) -> Table:
        key = self._remote_key(name)
        manifest, files = self._fetch_remote(name, key)
        m = dict(manifest)
        m["tier"] = "remote"
        self.meta.setdefault(name, m)
        t = self._table_from_payloads(manifest, files)
        # priced promotion: rehydrate to disk when the model predicts
        # future reads make the cheaper disk tier worth the write
        if self.cost_model is not None and self.root:
            try:
                if self.cost_model.should_promote(
                        m.get("nbytes", t.nbytes()), "remote", "disk"):
                    self.promote_from_remote(name)
            except (ArtifactError, OSError):
                pass        # promotion is an optimization, never required
        return t

    def prewarm(self, names) -> list:
        """Warm artifacts into the device cache ahead of a predicted
        probe — the speculative prefetcher's workhorse.  Remote-resident
        artifacts are fetched with ONE batched request; authoritative
        tiers are untouched (warming is a cache fill, not a migration).
        Returns the names actually warmed."""
        warmed = []
        remote_batch = []
        for name in names:
            name = self._resolve(name)
            r = self.residency(name)
            if r in (None, "device"):
                continue
            if r == "remote":
                remote_batch.append(name)
                continue
            try:
                self.get(name)
                warmed.append(name)
            except ArtifactError:
                continue
        if remote_batch and self.remote is not None:
            blobs = self.remote.get_many(
                [self._remote_key(n) for n in remote_batch])
            for name in remote_batch:
                blob = blobs.get(self._remote_key(name))
                if blob is None:
                    continue
                try:
                    manifest, files = decode_artifact_blob(blob)
                except ValueError:
                    continue
                t = self._table_from_payloads(manifest, files)
                m = dict(manifest)
                m["tier"] = "remote"
                self.meta.setdefault(name, m)
                self.cache.put(name, t, t.nbytes())
                warmed.append(name)
        return warmed

    def drop_caches(self) -> int:
        """Release every cached (non-authoritative) copy: device entries,
        derived views (plus their metadata) and the host tier.  Durable
        tiers are untouched — the next ``get`` reloads from memory, disk
        or the remote.  Models external memory pressure (other tenants
        claiming the card between this stream's bursts).  Returns
        entries dropped."""
        with self._lock:
            with self.cache._lock:
                names = list(self.cache._entries)
            n = len(names)
            for k in names:
                self.cache.drop(k)
                if "#repart" in k:
                    self._repart_meta.pop(k, None)
                    order = self._derived_order.get(
                        k.split("#repart", 1)[0])
                    if order and k in order:
                        order.remove(k)
            if self.host is not None:
                with self.host._lock:
                    hnames = list(self.host._entries)
                n += len(hnames)
                for k in hnames:
                    self.host.drop(k)
        return n

    # ------------------------------------------------------------- refresh
    def append(self, name: str, delta: Table) -> dict:
        """Delta-refresh an artifact: merge ``delta``'s valid rows into
        the stored value (DESIGN.md §12).  Monolithic artifacts
        concatenate column-wise on the store's device into NEW tensors
        (an artifact's value is its valid rows, so holes need no
        compaction here): a service worker or the flusher may still hold
        the old Table, and tensors, unlike JAX arrays, can be written in
        place, so the old ones are never touched.  Partitioned artifacts
        take the shard-local `merge_shards` path.  Either way the write
        goes through `put`, which replaces the device-cache entry,
        coalesces over any pending write-behind job and invalidates every
        derived `get_partitioned` view of the old value."""
        name = self._resolve(name)
        # the read-merge-write must be atomic against a concurrent
        # append/merge of the same artifact: interleaved get→merge→put
        # loses whichever delta merged first.  RLock: put() retakes it
        # reentrantly; the flusher never takes it.
        with self._lock:
            if self.partitioning(name) is not None:
                return self.merge_shards(name, delta)
            old = self.get(name)
            if set(old.names) != set(delta.names):
                raise ValueError(f"append({name!r}): schema mismatch")
            cols = {n: torch.cat([old.col(n), delta.col(n)])
                    for n in old.names}
            return self.put(name, Table(cols, torch.cat([old.valid,
                                                         delta.valid])))

    def merge_shards(self, name: str, delta: Table, merge_fn=None) -> dict:
        """Shard-local refresh of a partitioned artifact: each ``delta``
        row is routed to its shard by the stored partition hash, and the
        shard is merged locally — pure append when ``merge_fn`` is None,
        else ``merge_fn(old_shard, delta_shard) -> Table`` (the
        re-aggregation operator of a refreshed GROUPBY/DISTINCT artifact,
        whose partition keys co-locate each group with its partial).  No
        cross-shard exchange happens (DESIGN.md §11/§12).  The merged
        value is re-put under the same partition property, so the layout
        validation in `put` re-checks the claim."""
        name = self._resolve(name)
        with self._lock:     # same atomicity contract as append()
            return self._merge_shards_locked(name, delta, merge_fn)

    def _merge_shards_locked(self, name: str, delta: Table,
                             merge_fn=None) -> dict:
        part = self.partitioning(name)
        if part is None:
            raise ValueError(
                f"merge_shards({name!r}): artifact is not partitioned")
        n_parts = int(part["n_parts"])
        old = self.get(name)
        shard_cap = old.capacity // n_parts
        names_ = old.names
        if set(delta.names) != set(names_):
            raise ValueError(f"merge_shards({name!r}): schema mismatch")
        # ids and mask in one copy (-1 marks an invalid delta row)
        pid = _partition_ids(delta, part["keys"], n_parts)
        dhost = {n: delta.col(n).cpu().numpy() for n in names_}
        ohost = {n: old.col(n).cpu().numpy() for n in names_}
        omask = old.valid.cpu().numpy().astype(bool)
        # per-shard delta tables share one capacity, as in the reference
        d_counts = np.bincount(pid[pid >= 0], minlength=n_parts)
        dcap = max(8, _pow2ceil(int(d_counts.max()) if d_counts.size else 1))
        merged_np = []
        for p in range(n_parts):
            sl = slice(p * shard_cap, (p + 1) * shard_cap)
            rows = np.flatnonzero(pid == p)
            if merge_fn is None:
                m = {n: np.concatenate([ohost[n][sl][omask[sl]],
                                        dhost[n][rows]]) for n in names_}
            else:
                old_p = self._host_table({n: ohost[n][sl] for n in names_},
                                         omask[sl])
                delta_p = Table.from_numpy(
                    {n: dhost[n][rows] for n in names_}, capacity=dcap,
                    device=self.device)
                mt = merge_fn(old_p, delta_p)
                mm = mt.valid.cpu().numpy().astype(bool)
                m = {n: mt.col(n).cpu().numpy()[mm] for n in names_}
            merged_np.append(m)
        counts = [len(next(iter(m.values()))) for m in merged_np]
        new_cap = max(8, _pow2ceil(max(counts) if counts else 1))
        blocks = {}
        for n in names_:
            padded = []
            for m in merged_np:
                a = m[n]
                pad = [(0, new_cap - len(a))] + [(0, 0)] * (a.ndim - 1)
                padded.append(np.pad(a, pad))
            blocks[n] = np.concatenate(padded)
        valid = np.concatenate([np.arange(new_cap) < c for c in counts])
        return self.put(name, self._host_table(blocks, valid),
                        partitioning={"keys": list(part["keys"]),
                                      "n_parts": n_parts,
                                      "scheme": part.get("scheme",
                                                         "hash_mod")})

    def delete(self, name: str):
        with self._lock:
            # cancel the pending/in-flight write FIRST: the flusher
            # re-inserts the compacted table into the cache after
            # publishing, so dropping the cache entry before the cancel
            # could resurrect the artifact
            if self.root and self._wb is not None:
                self._wb.cancel(name)
            # drop any alias FROM this name: put() resolves aliases, so a
            # dangling mapping would silently redirect a later re-store
            self.aliases.pop(name, None)
            self.mem.pop(name, None)
            self.meta.pop(name, None)
            self.cache.drop(name)
            if self.host is not None:
                self.host.drop(name)
            # derived re-partitioned views of the artifact are stale too
            self._drop_derived(name)
            if self.root and self._rank0:
                p = self._path(name)
                if os.path.exists(p):
                    shutil.rmtree(p, ignore_errors=True)
            if self.remote is not None:
                self.remote.delete(self._remote_key(name))

    def quarantine(self, name: str):
        """Remove a damaged/missing artifact everywhere and count it.
        The caller then recomputes cold — reuse is an optimization,
        never a correctness dependency (DESIGN.md §13)."""
        with self._lock:
            self.stats["quarantined"] += 1
            self.delete(name)

    def verify(self, name: str) -> bool:
        """Integrity check of the on-disk bytes of ``name`` — crc32 of
        every data file against the manifest (parse-check for
        pre-checksum artifacts), or of its remote blob when that is the
        owner — without building a Table."""
        name = self._resolve(name)
        if self.remote is not None and not self._on_disk(name):
            key = self._remote_key(name)
            if self.remote.exists(key):
                try:
                    return verify_blob(self.remote.get_object(key))
                except KeyError:
                    return False
        if not self.root:
            return name in self.mem
        try:
            m = self._read_manifest(name)
        except (OSError, ValueError):
            return False
        checks = m.get("checksums") or {}
        for fn in self._data_files(m):
            try:
                with open(os.path.join(self._path(name), fn), "rb") as f:
                    data = f.read()
            except OSError:
                return False
            crc = checks.get(fn)
            if crc is not None:
                if zlib.crc32(data) != crc:
                    return False
            else:
                try:
                    np.load(io.BytesIO(data)).close()
                except Exception:
                    return False
        return True

    def flush(self):
        """Durability barrier: returns once every accepted put() has been
        atomically published to disk (no-op for the memory backend); on
        a GroupMesh, every rank's."""
        if self._wb is not None:
            self._wb.flush()
        if self.mesh is not None:
            self.mesh.barrier()

    def close(self):
        if self._wb is not None:
            self._wb.close()

    def nbytes(self, name: str) -> int:
        return self.meta[self._resolve(name)]["nbytes"]

    def total_bytes(self) -> int:
        return sum(m["nbytes"] for m in self.meta.values())

    def names(self):
        return sorted(self.meta)


class Catalog:
    """Source-dataset catalog with version stamps (eviction rule R4:
    modifying a dataset bumps its version, so old fingerprints never match
    and dependent artifacts are invalidated).

    Beyond the paper, the catalog distinguishes *append* deltas from
    arbitrary rewrites (DESIGN.md §12): ``append`` bumps the version like
    ``register`` but records the per-version valid-row count on an
    append lineage, so incremental maintenance can extract the delta
    rows (and the pre-append snapshot) of any version still on the
    lineage and refresh stale artifacts instead of R4-deleting them.
    ``register`` is an arbitrary rewrite and resets the lineage."""

    def __init__(self, store: ArtifactStore, device=None):
        self.store = store
        # the device every registered source table lives on
        self.device = resolve(device)
        self.versions: Dict[str, int] = {}
        self.sources: Dict[str, Table] = {}
        # name -> [(version, n_valid_rows), ...] for the run of
        # consecutive append()s since the last register()
        self._lineage: Dict[str, list] = {}
        # datasets whose source table is prefix-valid (valid rows form
        # a leading contiguous block) — true by construction for
        # append()-built tables, and what lets delta/snapshot slicing
        # be a direct row-range view instead of an O(n) mask pass
        self._compact: set = set()

    def register(self, name: str, table: Table):
        if table.device != self.device:
            raise ValueError(f"register({name!r}): table on {table.device}"
                             f", catalog on {self.device}")
        self.versions[name] = self.versions.get(name, -1) + 1
        self.sources[name] = table
        self._compact.discard(name)
        n = int(table.num_valid())
        self._lineage[name] = [(self.versions[name], n)]

    def append(self, name: str, delta: Table) -> int:
        """Append-only ingest: the new version extends the old one by
        exactly ``delta``'s valid rows, prefix-stable (the first n_old
        valid rows of the new version ARE the old version's rows).
        Returns the new version."""
        if name not in self.sources:
            raise KeyError(f"append to unregistered dataset {name!r}")
        merged = concat_tables([self.sources[name], delta])
        n = int(merged.num_valid())
        v = self.versions.get(name, 0) + 1
        self.versions[name] = v
        self.sources[name] = merged
        self._compact.add(name)      # concat_tables output is compacted
        self._lineage.setdefault(name, [(v - 1, n - int(
            delta.num_valid()))]).append((v, n))
        return v

    # -- append-lineage queries (incremental maintenance, DESIGN.md §12)
    def rows_at(self, name: str, version: int) -> Optional[int]:
        """Valid-row count of ``name`` at ``version``, or None when the
        version is not on the recorded append lineage."""
        for v, n in self._lineage.get(name, []):
            if v == version:
                return n
        return None

    def is_append_since(self, name: str, version: int) -> bool:
        """True iff the dataset's current version extends ``version`` by
        appends only (both versions on the recorded lineage)."""
        return self.rows_at(name, version) is not None

    def _slice_rows(self, name: str, lo: int,
                    hi: Optional[int], cols) -> Table:
        """Valid rows [lo:hi] of a source.  A prefix-valid (append-built)
        table slices by direct row range — a view plus one small copy —
        instead of slice_valid's mask pass.  Capacities round to the
        next power of two: real append sizes vary run to run, and an
        exact capacity would hand the delta plan a fresh input shape
        (and a full jit retrace) per refresh."""
        t = self.sources[name]
        if name not in self._compact:
            return slice_valid(t, lo, hi, cols=cols, round_pow2=True)
        names = t.names if cols is None else sorted(cols)
        out = {n: t.col(n)[lo:hi].cpu().numpy() for n in names}
        nvalid = len(out[names[0]])
        cap = 1 << (max(nvalid, 8) - 1).bit_length()
        return Table.from_numpy(out, nvalid=nvalid, capacity=cap,
                                device=t.device)

    def delta_table(self, name: str, version: int,
                    cols=None) -> Optional[Table]:
        """The rows appended since ``version`` (None off-lineage).
        ``cols`` restricts to the columns the consumer needs."""
        n_old = self.rows_at(name, version)
        n_cur = self.rows_at(name, self.version(name))
        if n_old is None or n_cur is None:
            return None
        # explicit upper bound: a compact table may carry a few invalid
        # padding rows past n_cur (min-capacity floor), which a direct
        # row-range slice must not resurrect
        return self._slice_rows(name, n_old, n_cur, cols)

    def snapshot_table(self, name: str, version: int,
                       cols=None) -> Optional[Table]:
        """The dataset as it was at ``version`` (prefix snapshot)."""
        n_old = self.rows_at(name, version)
        if n_old is None:
            return None
        return self._slice_rows(name, 0, n_old, cols)

    def delta_fraction(self, name: str, version: int) -> float:
        """Appended rows as a fraction of the base at ``version``."""
        n_old = self.rows_at(name, version)
        n_cur = self.rows_at(name, self.version(name))
        if n_old is None or n_cur is None:
            return 1.0
        return (n_cur - n_old) / max(n_old, 1)

    def version(self, name: str) -> int:
        return self.versions.get(name, 0)

    def get(self, name: str) -> Table:
        if name in self.sources:
            return self.sources[name]
        return self.store.get(name)

    def has(self, name: str) -> bool:
        return name in self.sources or self.store.exists(name)

