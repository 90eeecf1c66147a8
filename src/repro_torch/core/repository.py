"""The ReStore repository (paper §2.2, §3 ordering rules, §5 management;
budget economics in DESIGN.md §9).

One entry per stored job/sub-job output: the physical plan that produced
it, the artifact name in the store, and execution statistics.  Entries are
kept partially ordered so that the *first* match found during the
sequential scan is the best match:

  rule 1 — plan A before plan B if A subsumes B (B contained in A);
  rule 2 — otherwise, higher input:output byte ratio first, then longer
           producing-job execution time first.

Eviction (paper §5 rules):
  R1  keep only if |output| < |input|                       (optional)
  R2  keep only if reuse is predicted to save time          (optional)
  R3  evict entries unused within a time window
  R4  evict entries whose source datasets changed (handled structurally:
      Load fingerprints embed dataset versions, so stale entries can never
      match — ``evict_stale`` garbage-collects them; ``maintain`` instead
      delta-refreshes append-stale entries and reserves R4 for entries
      with no derivable delta plan, DESIGN.md §12)

Byte budget (DESIGN.md §9): when ``budget_bytes`` is set, ``add`` is no
longer an unconditional put.  Admission may evict lower-value entries to
make room (deleting their artifacts from the bound store) and rejects the
newcomer when the incumbents are worth more.  Two ranking policies:

  * ``"cost"`` — benefit-per-byte density from the `CostModel` (greedy
    knapsack: keep the entries whose predicted future time savings per
    stored byte are highest);
  * ``"lru"``  — recency only (the unconditional-keep baseline: always
    admit, evict least-recently-used to fit).

Entries whose artifacts are **pinned** (the driver pins a workflow's
job-boundary artifacts while it runs, since downstream jobs load them)
are never chosen as budget-eviction victims and always admitted; the
driver calls ``rebalance`` after unpinning to settle back under budget.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from .cost_model import CostModel
from .matcher import match_bottom_up
from .plan import PhysicalPlan, plan_signature


@dataclasses.dataclass
class RepositoryEntry:
    plan: PhysicalPlan            # Load...→op→Store, original (unrewritten)
    #                               form — or a PrefixPlan (kind="prefix")
    artifact: str                 # dataset name in the artifact store
    signature: str                # fingerprint of the output operator
    bytes_in: int = 0
    bytes_out: int = 0
    rows_out: int = 0
    exec_time_s: float = 0.0      # ET of the producing job (whole job)
    producer_cost_s: float = 0.0  # cumulative cost of this entry's sub-job
    created_at: float = 0.0
    last_used: float = 0.0
    use_count: int = 0
    # executions of this operator observed BEFORE materialization (each
    # was a missed reuse): seeds the expected-uses estimate so a fresh
    # entry for a known-hot operator is not ranked below incumbents and
    # store-then-rejected every event
    history_uses: float = 0.0
    # of use_count, hits where the entry only *covered* the query and a
    # compensation chain re-derived the exact value (DESIGN.md §10)
    semantic_uses: int = 0
    saved_s_total: float = 0.0    # realized savings credited on each reuse
    source_versions: Dict[str, int] = dataclasses.field(default_factory=dict)
    # physical partition property of the stored artifact (DESIGN.md §11):
    # {"keys": [...], "n_parts": P, "scheme": "hash_mod"} or None.  Not
    # part of the signature — a partitioned and a monolithic artifact of
    # the same value match identically — but a rewrite that splices a
    # co-partitioned artifact also skips the consumer's exchange.
    partitioning: Optional[Dict] = None
    # artifact-kind axis (DESIGN.md §17): "plan" = analytics job output,
    # "prefix" = serving-time KV/recurrent state.  One repository, one
    # budget, one economics engine — the kind only routes store deletes
    # and scopes the paper's plan-specific keep rules (R1/R2).
    kind: str = "plan"

    @property
    def reduction(self) -> float:
        return self.bytes_in / max(self.bytes_out, 1)

    def n_ops(self) -> int:
        return self.plan.n_ops()


class Repository:
    def __init__(self, keep_only_reducing: bool = False,
                 keep_only_time_saving: bool = False,
                 load_bandwidth_bytes_s: float = 2e9,
                 budget_bytes: Optional[int] = None,
                 policy: str = "cost",
                 cost_model: Optional[CostModel] = None,
                 clock=None):
        if policy not in ("cost", "lru"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        # injectable time source: every recency stamp and eviction "now"
        # flows through it, so tests (and the serve path, which defaults
        # to a logical event counter) get deterministic eviction order
        # instead of wall-clock-dependent LRU ties (DESIGN.md §17)
        self._now = clock if clock is not None else time.time
        self.entries: List[RepositoryEntry] = []
        self.by_sig: Dict[str, RepositoryEntry] = {}
        self.keep_only_reducing = keep_only_reducing
        self.keep_only_time_saving = keep_only_time_saving
        self.load_bw = load_bandwidth_bytes_s
        self.budget_bytes = budget_bytes
        self.policy = policy
        self.cost_model = cost_model or CostModel(
            load_bandwidth_bytes_s=load_bandwidth_bytes_s)
        # artifact name -> pin refcount.  Counting (not a set) lets
        # concurrent service workflows pin a shared artifact without one
        # run's unpin releasing another's protection; membership and
        # emptiness read exactly like the old set.
        self.pinned: Dict[str, int] = {}
        self.evictions = 0            # budget evictions (not R3/R4)
        self.rejections = 0           # budget admission rejections
        self.exact_hits = 0           # record_use(kind="exact")
        self.semantic_hits = 0        # record_use(kind="semantic")
        self.refreshes = 0            # delta-refreshed entries (§12)
        # per-artifact-kind hit counters, surfaced by stats()
        self._hits_by_kind: Dict[str, Dict[str, int]] = {}
        # artifact-kind -> store: non-"plan" kinds bind their own tier
        # store here so eviction routes deletes to the right backend
        self._stores: Dict[str, object] = {}
        # stale-but-refreshable entries deferred by the cost model:
        # old entry signature -> RefreshSpec, executed on the next probe
        # whose plan would match the refreshed signature (DESIGN.md §12)
        self.pending_refresh: Dict[str, object] = {}
        self._store = None            # bound by the ReStore driver
        # WAL journal (service.journal.RepositoryJournal) or None: every
        # state transition that must survive process death is appended
        # before this method returns (DESIGN.md §13)
        self.journal = None
        # one lock around every compound state transition: service
        # workers share a single Repository.  Reentrant because
        # add -> _admit -> _apply_eviction -> _replace nest.
        self._lock = threading.RLock()
        self._ordered_dirty = True
        self._ordered: List[RepositoryEntry] = []

    # ------------------------------------------------------------- binding
    def bind_store(self, store, kind: str = "plan") -> None:
        """Attach the artifact store so budget eviction (and R3/R4 when
        called without an explicit store) can delete evicted artifacts.
        Non-"plan" kinds (e.g. ``"prefix"`` KV snapshots, DESIGN.md §17)
        bind their own backend; eviction routes each dropped entry's
        delete to its kind's store."""
        if kind == "plan":
            self._store = store
        else:
            self._stores[kind] = store

    def bind_journal(self, journal) -> None:
        """Attach a WAL journal; subsequent mutations are logged."""
        self.journal = journal

    def pin(self, artifacts) -> None:
        with self._lock:
            for a in artifacts:
                self.pinned[a] = self.pinned.get(a, 0) + 1
            if self.journal is not None:
                self.journal.record_pin(artifacts)

    def unpin(self, artifacts) -> None:
        with self._lock:
            for a in artifacts:
                n = self.pinned.get(a, 0) - 1
                if n > 0:
                    self.pinned[a] = n
                else:
                    self.pinned.pop(a, None)
            if self.journal is not None:
                self.journal.record_unpin(artifacts)

    # ------------------------------------------- known-uses hints (§16)
    def set_known_uses(self, hints) -> None:
        """Install batch-optimizer materialization hints (key: structural
        fingerprint or artifact name -> queries known to consume it) on
        the cost model this repository admits/evicts by."""
        with self._lock:
            self.cost_model.set_known_uses(hints)

    def clear_known_uses(self, keys=None) -> None:
        with self._lock:
            self.cost_model.clear_known_uses(keys)

    # ------------------------------------------------------------- insert
    def add(self, entry: RepositoryEntry) -> bool:
        """Apply keep-rules R1/R2 and the byte-budget admission policy,
        then insert (idempotent by signature).  Returns True iff the
        entry is now in the repository."""
        with self._lock:
            if entry.signature in self.by_sig:
                return False
            # R1/R2 are the paper's *plan* keep-rules (output vs input
            # bytes of a relational job); prefix entries have no input
            # byte mass and are governed by the budget economics alone
            if entry.kind == "plan":
                if self.keep_only_reducing \
                        and entry.bytes_out >= entry.bytes_in:
                    return False        # rule R1
                if self.keep_only_time_saving:
                    load_time = entry.bytes_out / self.load_bw
                    if entry.exec_time_s <= load_time:
                        return False    # rule R2 (Eq. 1/2 estimate)
            entry.created_at = entry.created_at or self._now()
            if self.budget_bytes is not None and not self._admit(entry):
                self.rejections += 1
                return False
            self.entries.append(entry)
            self.by_sig[entry.signature] = entry
            self._ordered_dirty = True
            if self.journal is not None:
                self.journal.record_add(entry)
            return True

    # ------------------------------------------------------------- budget
    def _score(self, e: RepositoryEntry, now: float) -> float:
        """Eviction rank (ascending = evicted first)."""
        if self.policy == "lru":
            return e.last_used or e.created_at
        return self.cost_model.benefit_per_byte(e, now)

    def _select_victims(self, need_bytes: int, now: float,
                        stop_score: Optional[float] = None):
        """Pick unpinned entries in ascending `_score` order until
        ``need_bytes`` would be freed (or, with ``stop_score``, until
        the next victim would rank at/above it).  Selection only — the
        caller applies `_apply_eviction` once its condition holds.
        Returns (victims, bytes_freed)."""
        victims, freed = [], 0
        for e in sorted((e for e in self.entries
                         if e.artifact not in self.pinned),
                        key=lambda e: self._score(e, now)):
            if freed >= need_bytes:
                break
            if stop_score is not None and self._score(e, now) >= stop_score:
                break               # incumbents from here on are worth more
            victims.append(e)
            freed += e.bytes_out
        return victims, freed

    def _apply_eviction(self, victims) -> None:
        if not victims:
            return
        # expand to every entry sharing a victim's artifact: alias
        # entries (intermediate prefix lengths, bytes_out=0) share the
        # parent snapshot's arrays, so they must die with it — a
        # dangling alias would advertise bytes the store deleted
        arts = {v.artifact for v in victims}
        drop = [e for e in self.entries if e.artifact in arts]
        self._replace([e for e in self.entries if e.artifact not in arts],
                      drop, self._store)
        self.evictions += len(drop)

    def _admit(self, entry: RepositoryEntry) -> bool:
        """Knapsack-style admission: free enough bytes by evicting
        entries ranked below the newcomer; reject the newcomer when the
        incumbents are worth more (cost policy) or nothing evictable is
        left (both policies).  Pinned entries always enter — their
        artifacts exist regardless (workflow outputs), registration just
        makes them matchable — and are reconciled by `rebalance`."""
        if entry.artifact in self.pinned:
            return True
        need = self.total_stored_bytes() + entry.bytes_out - self.budget_bytes
        if need <= 0:
            return True
        if entry.bytes_out > self.budget_bytes:
            return False
        now = self._now()
        stop = self._score(entry, now) if self.policy == "cost" else None
        victims, freed = self._select_victims(need, now, stop_score=stop)
        if freed < need:
            return False            # incumbents worth more: reject newcomer
        self._apply_eviction(victims)
        return True

    def rebalance(self) -> int:
        """Evict lowest-ranked unpinned entries until the repository fits
        its byte budget again (no-op without a budget).  Called by the
        driver after unpinning a finished workflow's artifacts."""
        with self._lock:
            if self.budget_bytes is None:
                return 0
            excess = self.total_stored_bytes() - self.budget_bytes
            if excess <= 0:
                return 0
            victims, _ = self._select_victims(excess, self._now())
            self._apply_eviction(victims)
            return len(victims)

    # ------------------------------------------------------------- ordering
    def ordered(self) -> List[RepositoryEntry]:
        """Entries in scan order per the two ordering rules."""
        with self._lock:
            if not self._ordered_dirty:
                return self._ordered
            # subsumption partial order: A subsumes B iff B's plan is
            # contained in A's plan.  n_ops is a cheap necessary condition.
            es = sorted(self.entries,
                        key=lambda e: (-e.n_ops(), -e.reduction,
                                       -e.exec_time_s))
            # stable insertion respecting subsumption (larger plans first
            # already guarantees a subsumer precedes what it subsumes,
            # since a subsumer has strictly more operators unless equal)
            self._ordered = es
            self._ordered_dirty = False
            return self._ordered

    def subsumes(self, a: RepositoryEntry, b: RepositoryEntry) -> bool:
        if a.kind == "prefix" or b.kind == "prefix":
            # prefix containment IS the subsumption analog (§17)
            return (a.kind == b.kind == "prefix"
                    and b.plan.is_prefix_of(a.plan))
        return match_bottom_up(a.plan, b.plan) is not None

    # ------------------------------------------------------------- use/evict
    def record_use(self, entry: RepositoryEntry,
                   saved_s: float = 0.0, kind: str = "exact") -> None:
        """Record a reuse hit: bumps recency/hit-count (feeding both LRU
        and the cost model's expected-uses estimate) and credits the
        realized time savings to the entry.  ``kind="semantic"`` marks a
        subsumption hit (DESIGN.md §10): callers pass savings net of the
        compensation compute, and the split counters let the economics
        of covering-but-inexact artifacts be audited separately."""
        if kind not in ("exact", "semantic"):
            raise ValueError(f"unknown reuse kind {kind!r}")
        with self._lock:
            entry.last_used = self._now()
            entry.use_count += 1
            entry.saved_s_total += saved_s
            hk = self._hits_by_kind.setdefault(
                entry.kind, {"exact": 0, "semantic": 0})
            hk[kind] += 1
            if kind == "semantic":
                entry.semantic_uses += 1
                self.semantic_hits += 1
            else:
                self.exact_hits += 1
            if self.journal is not None:
                self.journal.record_use(entry, saved_s, kind)

    # backwards-compatible alias (pre-§9 API)
    def touch(self, entry: RepositoryEntry):
        self.record_use(entry)

    def evict_unused(self, window_s: float, store=None) -> int:
        """Rule R3: drop entries not used within ``window_s`` seconds
        (artifacts deleted from ``store``, defaulting to the bound one)."""
        with self._lock:
            now = self._now()
            keep, drop = [], []
            for e in self.entries:
                ref = e.last_used or e.created_at
                (keep if now - ref <= window_s else drop).append(e)
            self._replace(keep, drop,
                          store if store is not None else self._store)
            return len(drop)

    def evict_stale(self, catalog, store=None, kinds=None) -> int:
        """Rule R4 garbage collection: an entry whose recorded source
        versions no longer match the catalog can never match again.  Its
        artifact is deleted from ``store`` (default: the bound store).
        ``kinds`` restricts the sweep to entries of those artifact kinds
        — the serve path invalidates a model-version bump against its
        own catalog without evaluating analytics entries (§17)."""
        with self._lock:
            keep, drop = [], []
            for e in self.entries:
                if kinds is not None and e.kind not in kinds:
                    keep.append(e)
                    continue
                stale = any(catalog.version(ds) != v
                            for ds, v in e.source_versions.items())
                (drop if stale else keep).append(e)
            self._replace(keep, drop,
                          store if store is not None else self._store)
            return len(drop)

    def drop_artifact(self, name: str) -> int:
        """Drop every entry whose artifact is ``name`` WITHOUT touching
        the store — the quarantine path already deleted the damaged
        bytes; what remains is un-advertising them (DESIGN.md §13)."""
        with self._lock:
            keep = [e for e in self.entries if e.artifact != name]
            drop = [e for e in self.entries if e.artifact == name]
            self._replace(keep, drop, None, route=False)
            return len(drop)

    def _replace(self, keep, drop, store, route=True):
        """Swap the entry list; deletes dropped artifacts.  ``store`` is
        the plan-kind backend (explicit or the bound default); with
        ``route`` (the normal case) non-plan entries delete from their
        kind's bound store instead.  An artifact still referenced by a
        kept entry is never deleted (alias entries share artifacts)."""
        with self._lock:
            self.entries = keep
            self.by_sig = {e.signature: e for e in keep}
            self._ordered_dirty = True
            for e in drop:           # evicted entries owe no lazy refresh
                self.pending_refresh.pop(e.signature, None)
            if self.journal is not None and drop:
                self.journal.record_drop([e.signature for e in drop])
            kept_by_art: Dict[str, List[RepositoryEntry]] = {}
            for e in keep:
                kept_by_art.setdefault(e.artifact, []).append(e)
            for e in drop:
                survivors = kept_by_art.get(e.artifact)
                if survivors:
                    # shared artifact survives; the byte charge moves to
                    # the largest surviving entry so the budget still
                    # counts the stored arrays exactly once
                    if e.bytes_out:
                        heir = max(survivors, key=lambda s: s.bytes_out)
                        heir.bytes_out += e.bytes_out
                    continue
                st = self._stores.get(e.kind, store) if route else store
                if st is not None:
                    st.delete(e.artifact)

    # ------------------------------------------------- incremental refresh
    def maintain(self, catalog, engine, store=None,
                 mode: str = "auto", only=None) -> Dict[str, int]:
        """Incremental maintenance sweep (DESIGN.md §12): where
        ``evict_stale`` (rule R4) deletes every entry whose source
        versions moved, this refreshes append-stale entries from the
        dataset delta instead.  Per stale entry: `derive_refresh`
        produces a delta plan + merge operator (None ⇒ not incrementally
        maintainable ⇒ R4 delete as before); the cost model then
        arbitrates refresh-now / lazy (refresh on next probe) / delete
        (``mode="auto"``; ``"refresh"``/``"lazy"``/``"delete"`` force
        the decision — "delete" reproduces the pre-§12 behavior).
        ``only`` (a set of artifact names) restricts the sweep to those
        entries — the speculative prefetcher's ahead-of-arrival refresh
        (DESIGN.md §15) targets just the artifacts it predicts the next
        probe will touch, leaving the rest for the regular sweep.
        Returns counters {refreshed, lazy, deleted}."""
        from .delta import derive_refresh
        with self._lock:
            store = store if store is not None else self._store
            report = {"refreshed": 0, "lazy": 0, "deleted": 0}
            drop = []
            for e in list(self.entries):
                if only is not None and e.artifact not in only:
                    continue
                stale = any(catalog.version(ds) != v
                            for ds, v in e.source_versions.items())
                if not stale:
                    continue
                spec = derive_refresh(e, catalog)
                if spec is None:
                    drop.append(e)
                    continue
                if spec.refreshed_signature in self.by_sig:
                    # a probe already recomputed (and registered) the
                    # new-version value: refreshing would index two
                    # entries under one signature — the stale entry is
                    # plain R4
                    drop.append(e)
                    continue
                decision = mode if mode != "auto" else \
                    self.cost_model.refresh_decision(e, spec.delta_fraction)
                if decision == "delete":
                    drop.append(e)
                elif decision == "lazy":
                    self.pending_refresh[e.signature] = spec
                    if self.journal is not None:
                        self.journal.record_pending(e.signature)
                    report["lazy"] += 1
                else:
                    self.apply_refresh(spec, engine, store, catalog)
                    report["refreshed"] += 1
            drop_ids = {id(e) for e in drop}
            self._replace([e for e in self.entries
                           if id(e) not in drop_ids], drop, store)
            report["deleted"] = len(drop)
            return report

    def reindex(self, entry: RepositoryEntry, old_sig: str) -> None:
        """Re-key an entry that was refreshed/extended in place: the
        caller already mutated ``entry`` (plan, signature, bytes, ...)
        and this re-indexes it under the new signature, journalling the
        transition as a refresh.  Shared by §12 delta refresh and the
        §17 append-style prefix extension (a multi-turn conversation
        growing a stored prefix rides this instead of re-storing)."""
        with self._lock:
            self.by_sig.pop(old_sig, None)
            self.by_sig[entry.signature] = entry
            self.pending_refresh.pop(old_sig, None)
            self._ordered_dirty = True
            self.refreshes += 1
            if self.journal is not None:
                self.journal.record_refresh(old_sig, entry)

    def apply_refresh(self, spec, engine, store, catalog) -> None:
        """Execute one derived refresh and re-index the entry under its
        refreshed signature (the semantic/exact matchers then see it as
        an exact producer of the new-version value)."""
        from .delta import execute_refresh
        with self._lock:
            entry = spec.entry
            old_sig = entry.signature
            execute_refresh(spec, engine, store, catalog)
            self.reindex(entry, old_sig)

    def refresh_pending(self, plan, engine, catalog, store=None) -> int:
        """Lazy-refresh hook: execute every pending refresh whose
        *refreshed* signature appears in ``plan``'s fingerprints (the
        probe that was deferred for has arrived).  A spec whose catalog
        versions moved again since derivation is re-derived; one that is
        no longer derivable is R4-dropped.  Returns refreshes applied."""
        if not self.pending_refresh:
            return 0
        from .delta import derive_refresh
        self._lock.acquire()
        try:
            return self._refresh_pending_locked(
                plan, engine, catalog,
                store if store is not None else self._store,
                derive_refresh)
        finally:
            self._lock.release()

    def _refresh_pending_locked(self, plan, engine, catalog, store,
                                derive_refresh) -> int:
        fps = set(plan.fingerprints().values())
        n = 0
        for old_sig, spec in list(self.pending_refresh.items()):
            entry = spec.entry
            if any(catalog.version(ds) != v
                   for ds, v in spec.new_versions.items()):
                # catalog moved again since derivation: re-derive (the
                # delta grew) before the fingerprint probe below, or
                # drop to R4 when no longer derivable
                del self.pending_refresh[old_sig]
                spec = derive_refresh(entry, catalog)
                if spec is None:
                    drop_ids = {id(entry)}
                    self._replace([e for e in self.entries
                                   if id(e) not in drop_ids], [entry],
                                  store)
                    continue
                self.pending_refresh[entry.signature] = spec
            if spec.refreshed_signature in self.by_sig:
                # the new-version value was recomputed+registered while
                # the refresh was parked: the stale entry is redundant
                del self.pending_refresh[entry.signature]
                self._replace([e for e in self.entries if e is not entry],
                              [entry], store)
                continue
            if spec.refreshed_signature not in fps:
                continue
            self.apply_refresh(spec, engine, store, catalog)
            n += 1
        return n

    # ------------------------------------------------------------- helpers
    def __len__(self):
        return len(self.entries)

    def total_stored_bytes(self) -> int:
        return sum(e.bytes_out for e in self.entries)

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-artifact-kind accounting: entry/byte counts plus the hit
        split — the audit surface for "KV state and analytics artifacts
        share one budget" (DESIGN.md §17)."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for e in self.entries:
                k = out.setdefault(e.kind, {
                    "entries": 0, "bytes": 0,
                    "exact_hits": 0, "semantic_hits": 0})
                k["entries"] += 1
                k["bytes"] += e.bytes_out
            for kind, hk in self._hits_by_kind.items():
                k = out.setdefault(kind, {
                    "entries": 0, "bytes": 0,
                    "exact_hits": 0, "semantic_hits": 0})
                k["exact_hits"] = hk["exact"]
                k["semantic_hits"] = hk["semantic"]
            return out


def make_entry(plan: PhysicalPlan, artifact: str, *, bytes_in=0, bytes_out=0,
               rows_out=0, exec_time_s=0.0, producer_cost_s=0.0,
               history_uses=0.0,
               source_versions: Optional[Dict[str, int]] = None,
               partitioning: Optional[Dict] = None,
               kind: str = "plan") -> RepositoryEntry:
    return RepositoryEntry(plan=plan, artifact=artifact,
                           signature=plan_signature(plan),
                           bytes_in=bytes_in, bytes_out=bytes_out,
                           rows_out=rows_out, exec_time_s=exec_time_s,
                           producer_cost_s=producer_cost_s,
                           history_uses=history_uses,
                           created_at=time.time(),
                           source_versions=dict(source_versions or {}),
                           partitioning=dict(partitioning)
                           if partitioning else None,
                           kind=kind)
