"""Seeded fault injection for the artifact store (DESIGN.md §13).

The store calls ``injector.on(point, name, path=...)`` at its IO
choke points:

  ``read``       top of every disk load attempt;
  ``write``      before an artifact's data files are written;
  ``publish``    after the tmp dir is fully written, before the atomic
                 rename — a crash here leaves an orphaned ``.tmp-*``;
  ``published``  after the rename, with ``path`` = the final dir — a
                 point where the injector may corrupt real bytes.

The remote object tier (DESIGN.md §15) adds three more:

  ``remote_read``       before a remote blob fetch;
  ``remote_write``      before the blob upload of a demotion — a crash
                        here leaves the disk copy authoritative;
  ``remote_published``  after the atomic remote publish, BEFORE the
                        local delete that commits the demotion, with
                        ``path`` = the blob file — a crash here leaves
                        both copies (reopen reconciles to the remote),
                        and corruptions land on the published blob.

A ``FaultSchedule`` decides, from a seed, which calls fault and how.
Determinism is the contract: the same seed produces the same fault
sequence, so every failure found by the sweep replays exactly.

Fault kinds:

  ``crash``      raise SimulatedCrash (process death; at ``publish`` the
                 tmp dir survives like a real kill);
  ``transient``  raise OSError (flaky IO — the retry path absorbs it);
  ``latency``    sleep a few ms (stragglers; surfaces races);
  ``truncate``   cut the tail off one published ``.npz`` (torn write);
  ``flip``       XOR one byte of a published file (bit rot);
  ``manifest``   garble the published ``manifest.json``.

Corruptions only apply at ``published``; raise-kinds apply anywhere
else.  ``max_faults`` bounds the total injected so every schedule
eventually goes quiet and queries terminate.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional

from ..store.artifacts import SimulatedCrash

RAISE_KINDS = ("crash", "transient", "latency")
CORRUPT_KINDS = ("truncate", "flip", "manifest")


class FaultSchedule:
    """Seeded decision source: at each store IO event, draw whether to
    fault and which kind.  ``rates`` maps fault kind -> per-event
    probability; kinds absent from the map never fire."""

    def __init__(self, seed: int, rates: Optional[Dict[str, float]] = None,
                 max_faults: int = 4):
        self.seed = int(seed)
        self.rates = dict(rates if rates is not None else {
            "transient": 0.05, "latency": 0.05,
            "truncate": 0.02, "flip": 0.02, "manifest": 0.01,
        })
        self.max_faults = int(max_faults)
        self._rng = random.Random(self.seed)

    def draw(self, point: str) -> Optional[str]:
        """The fault kind to inject at this event, or None.  The rng is
        advanced exactly once per event regardless of outcome, keeping
        the sequence aligned across store-side code changes."""
        u = self._rng.random()
        acc = 0.0
        for kind, rate in sorted(self.rates.items()):
            acc += rate
            if u < acc:
                return kind
        return None


class FaultInjector:
    """Store-side shim: translates schedule draws into real damage.

    Thread-safe — service workers and the write-behind flusher hit the
    same injector.  Counters record what was actually injected so the
    suites can assert coverage (a sweep that never fired a fault proves
    nothing)."""

    def __init__(self, schedule: FaultSchedule,
                 latency_s: float = 0.003):
        self.schedule = schedule
        self.latency_s = float(latency_s)
        self.injected: Dict[str, int] = {}
        self._lock = threading.Lock()
        # one-shot arming: "crash at the next publish" for the crash
        # harness (deterministic kill point, not a probability draw)
        self._armed: Optional[str] = None

    def arm(self, point: str) -> None:
        """Force a SimulatedCrash at the next event of ``point``."""
        self._armed = point

    def total_injected(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    # ------------------------------------------------------------- hook
    def on(self, point: str, name: str, path: Optional[str] = None):
        if self._armed == point:
            self._armed = None
            with self._lock:
                self.injected["crash"] = self.injected.get("crash", 0) + 1
            raise SimulatedCrash(f"armed crash at {point}({name})")
        with self._lock:
            if sum(self.injected.values()) >= self.schedule.max_faults:
                return
            kind = self.schedule.draw(point)
            if kind is None:
                return
            # a corruption can only land on published bytes (local dir
            # or remote blob); a raise after publish would be attributed
            # to a write that in fact succeeded — both are no-ops,
            # decided (and NOT counted) atomically with the draw so the
            # budget stays exact
            published = point in ("published", "remote_published")
            if kind in CORRUPT_KINDS and (not published or path is None):
                return
            if kind in RAISE_KINDS and published:
                return
            self.injected[kind] = self.injected.get(kind, 0) + 1
        if kind in CORRUPT_KINDS:
            self._corrupt(kind, path)
            return
        if kind == "latency":
            time.sleep(self.latency_s)
            return
        if kind == "crash":
            raise SimulatedCrash(f"injected crash at {point}({name})")
        raise OSError(f"injected transient IO error at {point}({name})")

    # ------------------------------------------------------- corruption
    def _corrupt(self, kind: str, path: str) -> None:
        rng = random.Random(self.schedule.seed ^ 0x5EED)
        if os.path.isfile(path):
            # remote tier: ``path`` is the published blob file itself.
            # "manifest" garbles the JSON header region (first bytes),
            # the others damage the body like their npz counterparts.
            self._corrupt_file(kind, path, rng)
            return
        if kind == "manifest":
            mpath = os.path.join(path, "manifest.json")
            try:
                with open(mpath, "r+b") as f:
                    data = bytearray(f.read())
                    if not data:
                        return
                    i = rng.randrange(len(data))
                    data[i] ^= 0xFF
                    f.seek(0)
                    f.write(bytes(data))
                    f.truncate()
            except OSError:
                pass
            return
        npz = sorted(fn for fn in os.listdir(path) if fn.endswith(".npz"))
        if not npz:
            return
        target = os.path.join(path, rng.choice(npz))
        try:
            size = os.path.getsize(target)
            if size < 2:
                return
            with open(target, "r+b") as f:
                if kind == "truncate":
                    f.truncate(rng.randrange(1, size))
                else:                       # flip one byte
                    i = rng.randrange(size)
                    f.seek(i)
                    b = f.read(1)
                    f.seek(i)
                    f.write(bytes([b[0] ^ 0xFF]))
        except OSError:
            pass

    @staticmethod
    def _corrupt_file(kind: str, path: str, rng: random.Random) -> None:
        try:
            size = os.path.getsize(path)
            if size < 16:
                return
            with open(path, "r+b") as f:
                if kind == "truncate":
                    f.truncate(rng.randrange(1, size))
                elif kind == "manifest":
                    # damage the self-describing header: any byte in the
                    # first 64 makes the JSON (or magic) unreadable
                    i = rng.randrange(min(64, size))
                    f.seek(i)
                    b = f.read(1)
                    f.seek(i)
                    f.write(bytes([b[0] ^ 0xFF]))
                else:                       # flip one byte anywhere
                    i = rng.randrange(size)
                    f.seek(i)
                    b = f.read(1)
                    f.seek(i)
                    f.write(bytes([b[0] ^ 0xFF]))
        except OSError:
            pass
