"""Durable repository journal (WAL-style, DESIGN.md §13).

Repository state — which artifacts exist, what produced them, their use
statistics — must survive process death: the paper's premise is reuse
across workflows submitted over days.  The journal lives beside the
artifacts it describes::

    <store_root>/_journal/snapshot.json    periodic full state (atomic)
    <store_root>/_journal/journal.jsonl    one JSON record per mutation

(``_journal`` fails the store's round-trip name check, so a store scan
never mistakes it for an artifact.)  Every repository mutation appends
one line BEFORE the mutating call returns; ``rotate`` compacts — atomic
snapshot write, then atomic journal truncate, in that order, so a crash
between the two merely replays records the snapshot already contains
(every record is idempotent: ``use`` carries post-update totals, ``add``
is keyed by signature).

Recovery (``RepositoryJournal.recover``) rebuilds state from snapshot +
journal, tolerating a corrupt/missing snapshot (the journal is the
source of truth) and a torn final journal line (a crash mid-append).
It then **reconciles against reality**: entries whose artifacts are
missing from disk or fail checksum verification are dropped, and
orphaned ``.tmp-*`` publish dirs are reaped — the recovered repository
never advertises bytes that don't exist.  Pins are run-scoped (their
owning workflows died with the process) and pending refreshes are
re-derived by the next ``maintain`` sweep, so neither is restored live.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

JOURNAL_DIRNAME = "_journal"
DEFAULT_ROTATE_EVERY = 4096


class RepositoryJournal:
    """Append-only mutation log for one Repository.

    Bind with ``repo.bind_journal(journal)`` (and ``journal.repo =
    repo`` for auto-rotation); the repository then logs every add /
    use / drop / refresh / pin / unpin / pending transition."""

    def __init__(self, root: str,
                 rotate_every: int = DEFAULT_ROTATE_EVERY):
        self.dir = os.path.join(root, JOURNAL_DIRNAME)
        os.makedirs(self.dir, exist_ok=True)
        self.journal_path = os.path.join(self.dir, "journal.jsonl")
        self.snapshot_path = os.path.join(self.dir, "snapshot.json")
        self.rotate_every = int(rotate_every)
        self.repo = None                # bound for auto-rotation
        self._lock = threading.Lock()
        self._fh = open(self.journal_path, "a")
        self._n_since_rotate = self._count_lines()
        self.appended = 0
        self.rotations = 0

    def _count_lines(self) -> int:
        try:
            with open(self.journal_path) as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    # ---------------------------------------------------------- appends
    def _append(self, rec: dict) -> None:
        rec["ts"] = time.time()
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()            # to the OS: survives SIGKILL
            self._n_since_rotate += 1
            self.appended += 1
            due = (self.repo is not None
                   and self._n_since_rotate >= self.rotate_every)
        if due:
            self.rotate(self.repo)

    def record_add(self, entry) -> None:
        from ..core.serialize import entry_to_json
        self._append({"t": "add", "e": entry_to_json(entry)})

    def record_use(self, entry, saved_s: float, kind: str) -> None:
        # post-update totals, not deltas: replay is idempotent even if
        # a crash lands between the append and the in-memory update
        self._append({"t": "use", "sig": entry.signature,
                      "last_used": entry.last_used,
                      "use_count": entry.use_count,
                      "semantic_uses": entry.semantic_uses,
                      "saved_s_total": entry.saved_s_total,
                      "kind": kind, "saved_s": saved_s})

    def record_drop(self, signatures: List[str]) -> None:
        self._append({"t": "drop", "sigs": list(signatures)})

    def record_refresh(self, old_sig: str, entry) -> None:
        from ..core.serialize import entry_to_json
        self._append({"t": "refresh", "old": old_sig,
                      "e": entry_to_json(entry)})

    def record_pin(self, artifacts) -> None:
        self._append({"t": "pin", "arts": sorted(artifacts)})

    def record_unpin(self, artifacts) -> None:
        self._append({"t": "unpin", "arts": sorted(artifacts)})

    def record_pending(self, signature: str) -> None:
        self._append({"t": "pending", "sig": signature})

    # --------------------------------------------------------- rotation
    def rotate(self, repo) -> None:
        """Compact: atomically snapshot full state, then atomically
        truncate the journal.  Crash-ordering safe — see module doc."""
        from ..core.serialize import repository_to_json
        with repo._lock:
            payload = repository_to_json(repo)
        with self._lock:
            fd, tmp = tempfile.mkstemp(dir=self.dir)
            with os.fdopen(fd, "w") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
            # truncate via rename of an empty file: a reader (or a
            # crash) never sees a half-truncated journal
            self._fh.close()
            fd, tmp = tempfile.mkstemp(dir=self.dir)
            os.close(fd)
            os.replace(tmp, self.journal_path)
            self._fh = open(self.journal_path, "a")
            self._n_since_rotate = 0
            self.rotations += 1

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    # --------------------------------------------------------- recovery
    @classmethod
    def recover(cls, store, repository=None,
                rotate_every: int = DEFAULT_ROTATE_EVERY,
                tmp_gc: bool = True):
        """Rebuild repository state from the journal beside ``store``'s
        root, reconcile against the artifacts actually on disk, and
        return ``(repository, journal)`` with the journal bound and
        freshly rotated.  ``repository`` supplies policy/budget config
        (a default Repository otherwise); its entry list is replaced."""
        from ..core.repository import Repository
        repo = repository if repository is not None else Repository()
        root = store.root
        if root is None:
            raise ValueError("recover() needs an on-disk store")
        journal = cls(root, rotate_every=rotate_every)
        entries = _replay_dir(journal.dir)
        # reconcile: every surviving entry must point at verified bytes
        dropped = 0
        kept = []
        for e in entries.values():
            if store.exists(e.artifact) and store.verify(e.artifact):
                kept.append(e)
            else:
                store.quarantine(e.artifact)
                dropped += 1
        with repo._lock:
            repo.entries = kept
            repo.by_sig = {e.signature: e for e in kept}
            repo.pinned = {}
            repo.pending_refresh = {}
            repo._ordered_dirty = True
            repo.bind_store(store)
            repo.rebalance()            # budget applies to survivors too
        if tmp_gc:
            store.gc_tmp(0)             # no writer survived the crash
        repo.bind_journal(journal)
        journal.repo = repo
        journal.rotate(repo)            # recovered state becomes snapshot
        journal.recovered_entries = len(kept)
        journal.reconciled_drops = dropped
        return repo, journal


# ---------------------------------------------------------------- replay
def _iter_records(path: str):
    """Yield parsed journal records, stopping at the first torn line
    (a crash mid-append tears only the tail)."""
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    return              # torn tail: everything after is gone
    except OSError:
        return


def _replay_dir(journal_dir: str) -> Dict[str, object]:
    """Entries-by-signature from snapshot + journal in ``journal_dir``.
    A corrupt snapshot is skipped (the journal since the last rotation
    still holds every live mutation... of entries added since; older
    state is lost only if BOTH files are damaged)."""
    from ..core.serialize import entry_from_json
    entries: Dict[str, object] = {}
    snap = os.path.join(journal_dir, "snapshot.json")
    try:
        with open(snap) as f:
            data = json.load(f)
        for d in data.get("entries", []):
            try:
                e = entry_from_json(d)
            except (KeyError, TypeError, ValueError):
                continue
            if e is not None:
                entries[e.signature] = e
    except (OSError, ValueError):
        pass                            # journal replay is the fallback
    for rec in _iter_records(os.path.join(journal_dir, "journal.jsonl")):
        t = rec.get("t")
        try:
            if t == "add" or t == "refresh":
                e = entry_from_json(rec["e"])
                if e is not None:
                    if t == "refresh":
                        entries.pop(rec.get("old"), None)
                    entries[e.signature] = e
            elif t == "use":
                e = entries.get(rec["sig"])
                if e is not None:
                    e.last_used = rec["last_used"]
                    e.use_count = rec["use_count"]
                    e.semantic_uses = rec.get("semantic_uses",
                                              e.semantic_uses)
                    e.saved_s_total = rec.get("saved_s_total",
                                              e.saved_s_total)
            elif t == "drop":
                for sig in rec.get("sigs", []):
                    entries.pop(sig, None)
            # pin/unpin/pending: run-scoped, not restored (module doc)
        except (KeyError, TypeError, ValueError):
            continue                    # one bad record never kills replay
    return entries


def replay_journal(path: str, repo=None):
    """Standalone replay for ``serialize.load_repository``'s corrupt-
    state fallback.  ``path`` is a journal directory (or a store root
    containing one).  Entries are installed via ``repo.add`` so the
    caller's keep-rules/budget apply."""
    from ..core.repository import Repository
    repo = repo if repo is not None else Repository()
    d = path
    if os.path.basename(d) != JOURNAL_DIRNAME:
        cand = os.path.join(d, JOURNAL_DIRNAME)
        if os.path.isdir(cand):
            d = cand
    for e in _replay_dir(d).values():
        repo.add(e)
    return repo


def journal_dir(store_root: str) -> str:
    return os.path.join(store_root, JOURNAL_DIRNAME)


def has_journal(store_root: Optional[str]) -> bool:
    return bool(store_root) and os.path.isdir(
        os.path.join(store_root, JOURNAL_DIRNAME))
