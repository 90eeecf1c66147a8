"""Deprecated alias: `PrefixRepository` → `KVRepository` (DESIGN.md §17).

The serving prefix cache is no longer a standalone class — prefix
snapshots are `RepositoryEntry(kind="prefix")` rows in the SAME ReStore
repository that manages analytics artifacts, priced by the same
`CostModel` under the same byte budget, stored in the §15 tier
hierarchy.  This shim keeps the old ``match`` / ``store`` surface for
one release; ``match`` is now literally ``probe → splice → record_use``.

It also fixes two standing accounting bugs of the old class, carried by
the new machinery:

  * ``match`` stamped ``time.time()``, making eviction order depend on
    the wall clock — recency now flows through the repository's logical
    clock (deterministic under test);
  * ``every_k`` alias entries reported ``nbytes=0`` but LRU eviction
    could drop the parent while aliases kept advertising the deleted
    arrays — eviction now expands to every entry sharing the artifact.
"""
from __future__ import annotations

import warnings

from ..core.prefix_plan import prefix_fingerprints  # noqa: F401 (re-export)
from .kv_repo import KVRepository, PrefixHit

__all__ = ["PrefixRepository", "PrefixHit", "prefix_fingerprints"]


class PrefixRepository:
    def __init__(self, model_version: str = "v0",
                 capacity_bytes: int = 1 << 34):
        warnings.warn(
            "PrefixRepository is deprecated; use repro_torch.serve.kv_repo.KVRepository "
            "(prefix snapshots live in the unified ReStore repository)",
            DeprecationWarning, stacklevel=2)
        self.kv = KVRepository(model_version=model_version,
                               budget_bytes=capacity_bytes)

    @property
    def model_version(self) -> str:
        return self.kv.model_version

    @property
    def capacity_bytes(self) -> int:
        return self.kv.repository.budget_bytes

    @property
    def total_bytes(self) -> int:
        return self.kv.total_bytes

    @property
    def entries(self):
        """Live prefix entries keyed by fingerprint (signature)."""
        return self.kv.entries

    # old verbs, expressed as the new ones
    def match(self, tokens):
        hit = self.kv.probe(tokens)
        if hit is None:
            return None
        hit = self.kv.splice(hit)
        if hit is None:
            return None
        self.kv.record_use(hit)
        return hit

    def store(self, tokens, cache, *, every_k: int = 0, logits=None):
        return self.kv.store_prefix(tokens, cache, logits=logits,
                                    every_k=every_k)

    def evict_unused(self, window_s: float) -> int:
        return self.kv.evict_unused(window_s)

    def invalidate_version(self, new_version: str) -> int:
        return self.kv.invalidate_version(new_version)

    def __len__(self) -> int:
        return len(self.kv)
