"""Prompt prefixes as physical plans (DESIGN.md §17).

ReStore's repository stores *plans* and the artifacts they produced.
The serving path stores *token prefixes* and the KV/recurrent state
prefilling them produced.  This module makes the correspondence literal:
a `PrefixPlan` is the PhysicalPlan-analog of a prompt prefix — a chain
of per-token "operators" whose Merkle fingerprints play exactly the role
`plan.fingerprints()` plays for relational plans:

  fingerprint(prefix) = H(fingerprint(prefix[:-1]), token[-1])

seeded with the model version (the "input dataset" of the decode path:
a weight change invalidates every stored state, rule R4).  A
`RepositoryEntry` built over a `PrefixPlan` (``kind="prefix"``) lives in
the SAME byte-budgeted `Repository` as analytics artifacts and is
priced by the same `CostModel` — producer cost is the calibrated
prefill cost of the prefix, load cost is the tier read of the KV bytes.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np

from .. import trace


def prefix_fingerprints(tokens, model_version: str) -> List[str]:
    """Fingerprint of every prefix of a token sequence (Merkle chain).
    Counts ``kv.hashed_tokens``: one a token, the chain's steps."""
    out = []
    h = hashlib.sha256(model_version.encode()).hexdigest()
    for t in tokens:
        h = hashlib.sha256(f"{h}:{int(t)}".encode()).hexdigest()
        out.append(h)
    trace.count("kv.hashed_tokens", len(out))
    return out


class PrefixOp:
    """Pseudo-operator standing for the whole prefill of a prefix.

    Exists so kind-agnostic cost-model code (`should_splice` scans
    ``entry.plan.topo()`` for streaming kinds) works unchanged:
    ``"PREFIX"`` is not a streaming kind — prefill amortizes quadratic
    attention work, so a stored prefix always splices.
    """

    kind = "PREFIX"

    def __init__(self, plan: "PrefixPlan"):
        self.params = {"length": len(plan.tokens),
                       "model_version": plan.model_version}
        self.inputs: list = []


class PrefixPlan:
    """PhysicalPlan-analog for a token prefix (DESIGN.md §17).

    Duck-types the slice of the `PhysicalPlan` API the repository,
    cost model, and serializer touch: ``n_ops`` (token count — the
    ordering rule "longest prefix first" falls out of the repository's
    existing ``-n_ops`` sort), ``topo``, ``fingerprints``, and a
    content signature (the Merkle fingerprint of the full prefix).
    """

    def __init__(self, tokens, model_version: str,
                 fingerprints: Optional[List[str]] = None):
        self.tokens = np.asarray(tokens, np.int32)
        self.model_version = str(model_version)
        self._fps = (list(fingerprints) if fingerprints is not None
                     else prefix_fingerprints(self.tokens, model_version))
        if len(self._fps) != len(self.tokens) or not self._fps:
            raise ValueError("prefix plan needs one fingerprint per token")
        self._op = PrefixOp(self)

    @property
    def signature(self) -> str:
        return self._fps[-1]

    def n_ops(self) -> int:
        return int(len(self.tokens))

    def topo(self):
        return [self._op]

    def fingerprints(self) -> Dict[int, str]:
        """Per-prefix-length fingerprints, keyed by length (the analog
        of per-operator fingerprints keyed by operator)."""
        return {i + 1: fp for i, fp in enumerate(self._fps)}

    def prefix(self, length: int) -> "PrefixPlan":
        """The sub-plan covering the first ``length`` tokens (the
        sub-job analog; shares the already-computed fingerprint chain)."""
        if not 0 < length <= len(self.tokens):
            raise ValueError(f"bad prefix length {length}")
        return PrefixPlan(self.tokens[:length], self.model_version,
                          fingerprints=self._fps[:length])

    def is_prefix_of(self, other: "PrefixPlan") -> bool:
        return (len(self.tokens) <= len(other.tokens)
                and other._fps[len(self.tokens) - 1] == self.signature)


def prefix_plan_signature(plan: PrefixPlan) -> str:
    return plan.signature


def make_prefix_entry(plan: PrefixPlan, artifact: str, *, nbytes: int,
                      producer_cost_s: float = 0.0, created_at: float = 0.0,
                      history_uses: float = 0.0,
                      source_versions: Optional[Dict[str, int]] = None):
    """A repository entry for a stored prefix state.  ``nbytes=0`` marks
    an alias entry: an intermediate prefix length sharing the parent
    snapshot's arrays (the sub-job-enumeration analog) — it charges the
    budget nothing and is dropped with its parent artifact."""
    from .repository import RepositoryEntry
    return RepositoryEntry(
        plan=plan, artifact=artifact, signature=plan.signature,
        bytes_in=0, bytes_out=int(nbytes), rows_out=plan.n_ops(),
        exec_time_s=producer_cost_s, producer_cost_s=producer_cost_s,
        created_at=created_at, history_uses=history_uses,
        source_versions=dict(source_versions or {}), kind="prefix")
