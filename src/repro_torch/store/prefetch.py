"""Speculative artifact prefetch (DESIGN.md §15).

The stream drivers replay zipfian multi-tenant workloads: a few hot
templates dominate every tenant's traffic, and dataset appends arrive
on a fixed cadence.  Both regularities are visible in the store's own
``read_log`` — the prefetcher mines it, no workload schema required:

  * **popularity** — an exponentially-weighted count per artifact name.
    Zipfian traffic makes the top-k of this EWMA a high-precision
    predictor of the next probe's loads; decay keeps it honest across
    popularity drift (a formerly-hot artifact fades in a handful of
    observations).
  * **append cadence** — the driver notifies ``observe_append`` when a
    source dataset grows.  The prefetcher immediately (a) asks its
    ``maintainer`` callback to delta-refresh the predicted-hot
    artifacts *ahead of the next probe* (the refresh that would
    otherwise run inside the probe's timed window), and (b) re-warms
    them, since refresh rewrites bytes.

Warming is a pure cache fill through ``ArtifactStore.prewarm``: the
authoritative tier never moves (the reference also batches remote
fetches; the port's store has no remote tier yet), and a wrong
prediction costs only evictable cache bytes.
Accuracy is accounted: a predicted name actually probed before its
warm entry ages out counts as a hit; ``hit_rate`` is what the tier
benchmark and the service stats report.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

__all__ = ["SpeculativePrefetcher"]


class SpeculativePrefetcher:
    """Mines an ``ArtifactStore.read_log`` for recurrence and warms the
    predicted-next artifacts.  Thread-safe: the service runs it on a
    background cadence beside the maintenance loop."""

    def __init__(self, store, k: int = 4, decay: float = 0.85,
                 maintainer: Optional[Callable[[set], dict]] = None):
        self.store = store
        self.k = int(k)
        self.decay = float(decay)
        # called with the predicted-hot artifact names on each observed
        # append; typically ``lambda names: rs.maintain(only=names)`` —
        # the ahead-of-arrival delta refresh
        self.maintainer = maintainer
        self._lock = threading.Lock()
        self._score: Dict[str, float] = {}
        self._warmed: set = set()
        self.hits = 0            # predicted AND subsequently probed
        self.observed = 0        # read_log records consumed
        self.appends = 0         # append notifications
        self.prefetched = 0      # names actually warmed
        self.refreshed_ahead = 0  # entries delta-refreshed pre-arrival
        self._events_seen = 0    # poll count, for cadence tracking
        self._last_append_at = None
        self.append_gap = None   # EWMA of polls between appends

    # ------------------------------------------------------------ signals
    def poll(self) -> int:
        """Drain the store's read log into the popularity EWMA.  Also
        settles prediction accuracy: a read of a warmed name is a hit."""
        n = 0
        while True:
            try:
                name, _tier = self.store.read_log.popleft()
            except IndexError:
                break
            n += 1
            with self._lock:
                if name in self._warmed:
                    self.hits += 1
                    self._warmed.discard(name)
                for k in self._score:
                    self._score[k] *= self.decay
                self._score[name] = self._score.get(name, 0.0) + 1.0
        with self._lock:
            self.observed += n
            self._events_seen += 1
        return n

    def observe_append(self, dataset: str = "") -> dict:
        """A source dataset grew: refresh the predicted-hot artifacts
        before the next probe arrives, then re-warm them (refresh moves
        bytes out from under any cached copy).  Returns the maintainer's
        report (empty dict when no maintainer is wired)."""
        self.poll()
        with self._lock:
            self.appends += 1
            if self._last_append_at is not None:
                gap = self._events_seen - self._last_append_at
                self.append_gap = (gap if self.append_gap is None
                                   else 0.5 * self.append_gap + 0.5 * gap)
            self._last_append_at = self._events_seen
        report: dict = {}
        hot = set(self.predict())
        if self.maintainer is not None and hot:
            try:
                report = self.maintainer(hot) or {}
            except Exception:
                report = {}
            self.refreshed_ahead += int(report.get("refreshed", 0))
        self.prefetch()
        return report

    # -------------------------------------------------------- predictions
    def _predict_locked(self) -> List[str]:
        ranked = sorted(self._score.items(),
                        key=lambda kv: (-kv[1], kv[0]))
        return [name for name, s in ranked[:self.k] if s > 0.0]

    def predict(self) -> List[str]:
        """Top-k artifact names by popularity score."""
        with self._lock:
            return self._predict_locked()

    def prefetch(self) -> List[str]:
        """Warm the current predictions into the device cache.  Returns
        the names newly warmed this call."""
        self.poll()
        names = self.predict()
        if not names:
            return []
        warmed = self.store.prewarm(names)
        with self._lock:
            self.prefetched += len(warmed)
            self._warmed.update(names)
        return warmed

    # -------------------------------------------------------------- stats
    @property
    def hit_rate(self) -> float:
        denom = self.hits + len(self._warmed)
        return self.hits / denom if denom else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "observed": self.observed,
                    "appends": self.appends, "prefetched": self.prefetched,
                    "refreshed_ahead": self.refreshed_ahead,
                    "outstanding": len(self._warmed),
                    "append_gap": self.append_gap,
                    "hit_rate": self.hit_rate,
                    "predictions": self._predict_locked()}
