"""Tiered store for serving-time KV state (DESIGN.md §17), the port of
``src/repro/serve/kv_store.py``.

The hot tier is the device: the snapshot's tensors on the card, ready
for a decode step.  The warm tier is the §15 ``HostCache`` (CPU tensors,
pinned when they came from the card), and the cold tier the §15
``RemoteObjectStore`` with one compressed ``RSB1`` blob per snapshot,
byte for byte the blob the reference writes for the same arrays.

Snapshots are immutable.  The reference relies on JAX arrays never
changing; the port's caches are written in place by the model, so
``put`` stores a copy, and a caller that writes into a cache it got
from ``get`` must copy it first (``serve/session.py`` does).

The surfaces the §15 machinery expects from an artifact store are kept:
``prewarm`` (one batched remote fetch), tier-tagged ``io_stats`` for
``CostModel.calibrate_io``, and ``delete`` for budget eviction through
``Repository.bind_store(..., kind="prefix")``.  The tier of each read is
counted in ``stats`` (``*_hits``) and traced as the span
``kvstore.get.<tier>`` (``repro_torch.trace``).  The ``injector`` is
duck-typed: anything with ``on(point, name, path=...)``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import torch

from .. import trace
from ..store.tiers import (HostCache, RemoteObjectStore,
                           decode_artifact_blob, encode_artifact_blob)
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a card tensor, in pinned memory; a CPU tensor as
    it is (snapshots are immutable, so the tiers may share it)."""
    if not t.is_cuda:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _to_device(a, device) -> torch.Tensor:
    """A host payload column (CPU tensor, or numpy array from a blob)
    on ``device``.  A bf16 column read back from a blob is a ``|V2``
    array, which ``torch.from_numpy`` refuses with TypeError, as
    ``jnp.asarray`` does in the reference (ROADMAP queue 3)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(a)
    return a.to(device)


class KVTierStore:
    def __init__(self, host_bytes: int = 1 << 30,
                 remote_root: Optional[str] = None,
                 remote_latency_s: float = 0.0,
                 remote_bandwidth_bytes_s: Optional[float] = None,
                 injector=None):
        # name -> (cache tree of tensors, logits or None)
        self._device: Dict[str, Tuple[object, object]] = {}
        # name -> {"spec", "nbytes", "n_leaves", "device"}: kept for
        # every stored name (tiny) so a remote blob can be rebuilt
        self._meta: Dict[str, dict] = {}
        self.host = HostCache(host_bytes)
        self.remote = (RemoteObjectStore(remote_root,
                                         latency_s=remote_latency_s,
                                         bandwidth_bytes_s=(
                                             remote_bandwidth_bytes_s))
                       if remote_root else None)
        self.injector = injector
        self._lock = threading.RLock()
        self.stats = {"puts": 0, "deletes": 0, "quarantined": 0,
                      "device_hits": 0, "host_hits": 0, "remote_hits": 0,
                      "misses": 0, "demotions": 0, "prewarmed": 0}
        self._io = {"memload_bytes": 0, "memload_s": 0.0,
                    "hostload_bytes": 0, "hostload_s": 0.0,
                    "remoteload_bytes": 0, "remoteload_s": 0.0,
                    "store_bytes": 0, "store_s": 0.0}

    # --------------------------------------------------------------- util
    def _fault(self, point: str, name: str, path: Optional[str] = None):
        if self.injector is not None:
            self.injector.on(point, name, path=path)

    @staticmethod
    def _nbytes(leaves, logits) -> int:
        nb = sum(int(a.nbytes) for a in leaves)
        if logits is not None:
            nb += int(logits.nbytes)
        return nb

    def _key(self, name: str) -> str:
        return name.replace("/", "_")

    # ---------------------------------------------------------------- put
    def put(self, name: str, cache, logits=None) -> int:
        """Register a copy of the snapshot in the device tier; returns
        its byte size (what the repository entry charges to the
        budget)."""
        cache = tree_map(torch.clone, cache)
        logits = None if logits is None else logits.clone()
        leaves, spec = tree_flatten(cache)
        nb = self._nbytes(leaves, logits)
        with self._lock:
            self._device[name] = (cache, logits)
            self._meta[name] = {"spec": spec, "nbytes": nb,
                                "n_leaves": len(leaves),
                                "device": leaves[0].device}
            self.stats["puts"] += 1
        return nb

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._meta

    def nbytes(self, name: str) -> int:
        with self._lock:
            return self._meta[name]["nbytes"]

    def residency(self, name: str) -> Optional[str]:
        with self._lock:
            if name in self._device:
                return "device"
            if name in self.host:
                return "host"
            if name in self._meta and self.remote is not None \
                    and self.remote.exists(self._key(name)):
                return "remote"
            return None

    # ---------------------------------------------------------------- get
    def get(self, name: str):
        """Fetch ``(cache, logits)``, promoting cold copies to the
        device tier.  The tensors are the store's: copy before writing.
        Raises KeyError on a miss; a corrupt remote blob is quarantined
        (deleted + un-advertisable) and reads as a miss — the caller
        falls back to a cold prefill."""
        t0 = time.perf_counter()
        with self._lock:
            ent = self._device.get(name)
            meta = self._meta.get(name)
        if ent is not None:
            with trace.span("kvstore.get.device"):
                self.stats["device_hits"] += 1
                self._io["memload_bytes"] += meta["nbytes"]
                self._io["memload_s"] += time.perf_counter() - t0
                return ent
        if meta is None:
            self.stats["misses"] += 1
            raise KeyError(name)
        payload = self.host.get(name)
        if payload is not None:
            with trace.span("kvstore.get.host"):
                out = self._rebuild(name, meta, payload)
                self.stats["host_hits"] += 1
                self._io["hostload_bytes"] += meta["nbytes"]
                self._io["hostload_s"] += time.perf_counter() - t0
                return out
        with trace.span("kvstore.get.remote"):
            payload = self._fetch_remote(name)
            if payload is None:
                self.stats["misses"] += 1
                raise KeyError(name)
            out = self._rebuild(name, meta, payload)
            self.stats["remote_hits"] += 1
            self._io["remoteload_bytes"] += meta["nbytes"]
            self._io["remoteload_s"] += time.perf_counter() - t0
            return out

    def _rebuild(self, name: str, meta: dict, payload: dict):
        """Host payload -> tensors on the snapshot's device."""
        dev = meta["device"]
        leaves = [_to_device(payload[f"leaf{i:05d}"], dev)
                  for i in range(meta["n_leaves"])]
        logits = payload.get("logits")
        if logits is not None:
            logits = _to_device(logits, dev)
        cache = tree_unflatten(meta["spec"], leaves)
        with self._lock:
            self._device[name] = (cache, logits)
        return cache, logits

    def _payload(self, name: str) -> Optional[dict]:
        """Device snapshot as a flat host payload (host/blob form)."""
        with self._lock:
            ent = self._device.get(name)
        if ent is None:
            return None
        cache, logits = ent
        payload = {f"leaf{i:05d}": _to_host(a)
                   for i, a in enumerate(tree_leaves(cache))}
        if logits is not None:
            payload["logits"] = _to_host(logits)
        return payload

    def _fetch_remote(self, name: str) -> Optional[dict]:
        if self.remote is None:
            return None
        key = self._key(name)
        if not self.remote.exists(key):
            return None
        self._fault("remote_read", name)
        blob = self.remote.get_object(key)
        try:
            _manifest, files = decode_artifact_blob(blob, verify=True)
            return files["kv"]
        except (ValueError, KeyError):
            self.quarantine(name)
            return None

    # -------------------------------------------------------------- tiers
    def demote_to_host(self, name: str) -> bool:
        payload = self._payload(name)
        if payload is None:
            return False
        with self._lock:
            self.host.put(name, payload)
            self._device.pop(name, None)
            self.stats["demotions"] += 1
        return True

    def demote_to_remote(self, name: str) -> bool:
        """Push the snapshot down to the remote blob tier (RSB1 codec,
        per-column checksums, atomic publish) and drop the warm copies."""
        if self.remote is None:
            raise RuntimeError("KVTierStore has no remote tier")
        payload = self._payload(name)
        if payload is None:
            payload = self.host.get(name)
        if payload is None:
            return False
        with self._lock:
            meta = self._meta[name]
        t0 = time.perf_counter()
        blob = encode_artifact_blob(
            {"name": name, "n_leaves": meta["n_leaves"]},
            {"kv": payload})
        self._fault("remote_write", name)
        path = self.remote.put_object(self._key(name), blob)
        self._fault("remote_published", name, path=path)
        self._io["store_bytes"] += len(blob)
        self._io["store_s"] += time.perf_counter() - t0
        with self._lock:
            self._device.pop(name, None)
            self.host.drop(name)
            self.stats["demotions"] += 1
        return True

    def prewarm(self, names) -> list:
        """Batched cache fill from the remote tier: every cold name
        rides ONE ``get_many`` (one latency charge for the batch)."""
        cold = [n for n in names
                if n in self._meta and n not in self._device
                and n not in self.host]
        if not cold or self.remote is None:
            return []
        blobs = self.remote.get_many([self._key(n) for n in cold])
        warmed = []
        for n in cold:
            blob = blobs.get(self._key(n))
            if blob is None:
                continue
            try:
                _m, files = decode_artifact_blob(blob, verify=True)
            except (ValueError, KeyError):
                self.quarantine(n)
                continue
            self.host.put(n, files["kv"])
            warmed.append(n)
        self.stats["prewarmed"] += len(warmed)
        return warmed

    # ------------------------------------------------------------- delete
    def delete(self, name: str) -> None:
        """Drop a snapshot from every tier (idempotent — budget eviction
        and quarantine may race on the same name)."""
        with self._lock:
            self._device.pop(name, None)
            self._meta.pop(name, None)
            self.host.drop(name)
            self.stats["deletes"] += 1
        if self.remote is not None:
            self.remote.delete(self._key(name))

    def quarantine(self, name: str) -> None:
        """A damaged blob was detected: delete the bytes everywhere so
        the next read is an honest cold miss (DESIGN.md §13)."""
        self.stats["quarantined"] += 1
        self.delete(name)

    # ------------------------------------------------------------ pricing
    def io_stats(self) -> dict:
        s = dict(self._io)
        s["has_disk"] = False
        return s

    def total_stored_bytes(self) -> int:
        with self._lock:
            return sum(m["nbytes"] for m in self._meta.values())

    def __contains__(self, name: str) -> bool:
        return self.exists(name)

    def __len__(self) -> int:
        with self._lock:
            return len(self._meta)
