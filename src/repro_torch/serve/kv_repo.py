"""Serving-time prefix reuse on the ReStore repository (DESIGN.md §17),
the port of ``src/repro/serve/kv_repo.py`` over the port's
``Repository`` and ``CostModel``.

`KVRepository` is the serve-path adapter over the SAME machinery that
manages analytics artifacts — not a parallel class:

  * entries are `RepositoryEntry(kind="prefix")` over a `PrefixPlan`,
    admitted and evicted by `CostModel.benefit_per_byte` under the
    repository's (possibly shared) ``budget_bytes``;
  * the verbs mirror the analytics rewriter: ``probe`` (longest stored
    prefix — the semantic-subsumption analog, side-effect free),
    ``splice`` (materialize the stored state from the tier store),
    ``record_use`` (credit the hit: "exact" for a full-prompt match,
    "semantic" for a covering prefix that needs residual-suffix
    compensation);
  * ``store_prefix`` registers snapshots (with ``every_k`` sub-prefix
    aliases, the sub-job-enumeration analog); ``extend`` grows a stored
    conversation in place via the §12 delta-refresh path
    (`Repository.reindex`) instead of re-storing from scratch;
  * R4 is literal: prefix entries carry the model-version epoch as a
    source version and ``invalidate_version`` runs ``evict_stale``
    against the model catalog.

By default the repository clock is a logical event counter, so recency
and eviction order are deterministic under test — the pre-§17
`PrefixRepository` stamped ``time.time()`` inside ``match`` and its
eviction order depended on the wall clock.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

from ..core.cost_model import CostModel
from ..core.prefix_plan import (PrefixPlan, make_prefix_entry,
                                prefix_fingerprints)
from ..core.repository import Repository, RepositoryEntry
from .kv_store import KVTierStore


class LogicalClock:
    """Monotonic event counter: deterministic recency for tests and
    single-process serving (wall-clock ties broke LRU determinism)."""

    def __init__(self):
        self._c = itertools.count(1)

    def __call__(self) -> float:
        return float(next(self._c))


class _ModelCatalog:
    """Catalog shim for rule R4: the serve path's one "source dataset"
    is the model weights; its version is an epoch bumped on change."""

    MODEL = "__model__"

    def __init__(self):
        self.epoch = 0

    def version(self, dataset: str) -> int:
        return self.epoch


@dataclasses.dataclass
class PrefixHit:
    """A probe result: the matched entry plus the covered length.
    ``splice`` fills ``cache``/``logits`` from the tier store."""
    entry: RepositoryEntry
    length: int
    exact: bool
    cache: object = None
    logits: object = None


class KVRepository:
    def __init__(self, model_version: str = "v0",
                 budget_bytes: Optional[int] = 1 << 34,
                 repository: Optional[Repository] = None,
                 cost_model: Optional[CostModel] = None,
                 store: Optional[KVTierStore] = None,
                 clock=None):
        self.model_version = str(model_version)
        self.clock = clock if clock is not None else LogicalClock()
        if repository is not None:
            self.repository = repository
            self.cost_model = repository.cost_model
        else:
            self.cost_model = cost_model or CostModel()
            self.repository = Repository(budget_bytes=budget_bytes,
                                         cost_model=self.cost_model,
                                         clock=self.clock)
        # `is not None`, not truthiness: an empty KVTierStore has
        # len() == 0 and would be silently replaced
        self.store = store if store is not None else KVTierStore()
        self.repository.bind_store(self.store, kind="prefix")
        self.catalog = _ModelCatalog()
        # artifact -> token length of the FULL stored snapshot: stored
        # last-token logits are only valid for a hit of exactly that
        # length (an alias hit must re-derive its logits)
        self._full_len: Dict[str, int] = {}

    # ------------------------------------------------------------- verbs
    def probe(self, tokens) -> Optional[PrefixHit]:
        """Longest stored prefix of ``tokens`` — scan from the full
        length down, so the first match is the best match (the ordering
        rule).  Pure: no recency mutation (that is ``record_use``'s
        job, exactly as in the analytics path)."""
        fps = prefix_fingerprints(tokens, self.model_version)
        by_sig = self.repository.by_sig
        for i in range(len(fps) - 1, -1, -1):
            e = by_sig.get(fps[i])
            if e is not None and e.kind == "prefix":
                return PrefixHit(entry=e, length=i + 1,
                                 exact=(i + 1 == len(fps)))
        return None

    def splice(self, hit: PrefixHit) -> Optional[PrefixHit]:
        """Materialize the hit's stored state (promoting through the
        tiers).  A quarantined/vanished snapshot un-advertises its
        entries and returns None — the caller prefills cold."""
        try:
            cache, logits = self.store.get(hit.entry.artifact)
        except KeyError:
            self.repository.drop_artifact(hit.entry.artifact)
            self._full_len.pop(hit.entry.artifact, None)
            return None
        hit.cache = cache
        # stored last-token logits belong to the FULL stored prefix;
        # an alias (shorter) hit must not reuse them
        hit.logits = logits \
            if self._full_len.get(hit.entry.artifact) == hit.length \
            else None
        return hit

    def record_use(self, hit: PrefixHit, saved_s: Optional[float] = None
                   ) -> None:
        """Credit a reuse: an exact full-prompt hit is an "exact" hit;
        a covering prefix (residual suffix still prefilled — the
        compensation compute) is a "semantic" hit, same split the
        analytics rewriter reports (DESIGN.md §10)."""
        if saved_s is None:
            saved_s = max(
                self.cost_model.prefill_cost_s(hit.length)
                - self.cost_model.tier_load_cost_s(
                    hit.entry.bytes_out, "device"), 0.0)
        self.repository.record_use(
            hit.entry, saved_s=saved_s,
            kind="exact" if hit.exact else "semantic")

    # ------------------------------------------------------------- store
    def store_prefix(self, tokens, cache, *, logits=None,
                     every_k: int = 0, history_uses: float = 0.0
                     ) -> Optional[RepositoryEntry]:
        """Register a prefill snapshot.  With ``every_k > 0``, ALSO
        register alias entries for intermediate prefix lengths sharing
        the same snapshot (paper §4 sub-job enumeration) — positional
        caches only; a recurrent state is exact-length only, so SSM/
        hybrid callers must pass ``every_k=0``.  Aliases charge zero
        bytes (the arrays are shared, charged once on the parent) and
        are evicted with their parent."""
        plan = PrefixPlan(tokens, self.model_version)
        existing = self.repository.by_sig.get(plan.signature)
        if existing is not None:
            return existing
        name = "kv-" + plan.signature
        nbytes = self.store.put(name, cache, logits)
        entry = make_prefix_entry(
            plan, name, nbytes=nbytes,
            producer_cost_s=self.cost_model.prefill_cost_s(plan.n_ops()),
            created_at=self.clock(), history_uses=history_uses,
            source_versions={_ModelCatalog.MODEL: self.catalog.epoch})
        if not self.repository.add(entry):
            self.store.delete(name)     # rejected by the budget
            return None
        self._full_len[name] = plan.n_ops()
        if every_k:
            for ln in range(every_k, plan.n_ops(), every_k):
                sub = plan.prefix(ln)
                if sub.signature in self.repository.by_sig:
                    continue
                alias = make_prefix_entry(
                    sub, name, nbytes=0,
                    producer_cost_s=self.cost_model.prefill_cost_s(ln),
                    created_at=self.clock(),
                    source_versions={
                        _ModelCatalog.MODEL: self.catalog.epoch})
                self.repository.add(alias)
        return entry

    def extend(self, hit: PrefixHit, tokens, cache, *, logits=None
               ) -> Optional[RepositoryEntry]:
        """Append-style prefix extension: a multi-turn conversation
        grew a stored prefix, so the entry rides the §12 refresh path —
        mutated in place and re-keyed (`Repository.reindex`) — instead
        of storing a second snapshot of mostly-identical state.  The
        hit's aliases keep pointing at the old artifact only if any
        exist; otherwise the superseded snapshot's bytes are freed."""
        entry = hit.entry
        plan = PrefixPlan(tokens, self.model_version)
        if not entry.plan.is_prefix_of(plan):
            raise ValueError("extend: stored entry is not a prefix of "
                             "the new tokens")
        existing = self.repository.by_sig.get(plan.signature)
        if existing is not None:
            return existing
        old_sig, old_name = entry.signature, entry.artifact
        name = "kv-" + plan.signature
        nbytes = self.store.put(name, cache, logits)
        entry.plan = plan
        entry.signature = plan.signature
        entry.artifact = name
        entry.bytes_out = nbytes
        entry.rows_out = plan.n_ops()
        entry.producer_cost_s = self.cost_model.prefill_cost_s(
            plan.n_ops())
        self.repository.reindex(entry, old_sig)
        self._full_len[name] = plan.n_ops()
        if not any(e.artifact == old_name
                   for e in self.repository.entries):
            self.store.delete(old_name)
            self._full_len.pop(old_name, None)
        self.repository.rebalance()
        return entry

    # ----------------------------------------------------------- pinning
    def pin(self, entry: RepositoryEntry) -> None:
        """Pin a spliced snapshot for the duration of a decode — a
        pinned artifact is never a budget-eviction victim."""
        self.repository.pin([entry.artifact])

    def unpin(self, entry: RepositoryEntry) -> None:
        self.repository.unpin([entry.artifact])

    # ---------------------------------------------------------- eviction
    def evict_unused(self, window_s: float) -> int:
        """Rule R3 over prefix entries (window in clock units)."""
        return self.repository.evict_unused(window_s)

    def invalidate_version(self, new_version: str) -> int:
        """Rule R4: the decode path's input dataset (the model weights)
        changed — every stored state is unreachable garbage.  Bump the
        model catalog epoch and run the same ``evict_stale`` sweep
        analytics entries get, scoped to the prefix kind."""
        n_before = self._n_prefix_entries()
        self.model_version = str(new_version)
        self.catalog.epoch += 1
        self.repository.evict_stale(self.catalog, kinds=("prefix",))
        return n_before - self._n_prefix_entries()

    # ------------------------------------------------------------ helpers
    def calibrate(self) -> None:
        """Refresh the cost model's tier prices from the KV store's
        measured transfers (same loop the analytics driver runs)."""
        self.cost_model.calibrate_io(self.store)

    def _n_prefix_entries(self) -> int:
        return sum(1 for e in self.repository.entries
                   if e.kind == "prefix")

    @property
    def entries(self):
        """Prefix entries keyed by signature (fingerprint)."""
        return {e.signature: e for e in self.repository.entries
                if e.kind == "prefix"}

    @property
    def total_bytes(self) -> int:
        return sum(e.bytes_out for e in self.repository.entries
                   if e.kind == "prefix")

    def stats(self) -> dict:
        return self.repository.stats().get("prefix", {
            "entries": 0, "bytes": 0,
            "exact_hits": 0, "semantic_hits": 0})

    def __len__(self) -> int:
        return self._n_prefix_entries()
