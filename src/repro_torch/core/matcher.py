"""Plan containment matching (paper §3; semantic extension DESIGN.md §10).

Two exact implementations, tested to agree:

* ``match_bottom_up`` — the production path.  Operator equivalence (same
  function over equivalent inputs) is exactly Merkle-fingerprint equality,
  so containment of a repository plan in an input plan reduces to: "does
  the input plan contain an operator whose fingerprint equals the
  fingerprint of the repository plan's output operator?".  O(|plan|) with
  an index, instead of the paper's repeated pairwise traversals.

* ``pairwise_plan_traversal`` — a faithful port of the paper's
  Algorithm 1 (simultaneous depth-first traversal from the Load
  operators).  Kept as the reference implementation and exercised by the
  benchmarks that reproduce the paper's matcher behaviour.

Beyond the paper's exact matching, ``SemanticIndex`` finds *subsumption*
matches: a repository plan identical to an input sub-plan except for a
weaker FILTER predicate and/or a wider PROJECT column set still answers
the sub-plan, provided the rewriter re-applies a compensation (residual
predicate / narrowing projection) on top of the loaded artifact.  Exact
hits always take priority: the semantic probe refuses to fire whenever
the exact index would hit."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..dataflow.expr import (Expr, conjoin, implies, pred_columns,
                             residual_pred)
from .plan import Operator, PhysicalPlan


def _output_op(plan: PhysicalPlan) -> Operator:
    sink = plan.sinks[0]
    return sink.inputs[0] if sink.kind == "STORE" else sink


# ---------------------------------------------------------------------------
# Production matcher: bottom-up / fingerprint


def match_bottom_up(input_plan: PhysicalPlan,
                    repo_plan: PhysicalPlan) -> Optional[Operator]:
    """Return the operator in ``input_plan`` equivalent to ``repo_plan``'s
    output, or None if the repository plan is not contained.  When
    duplicate-fingerprint operators exist (a diamond plan with repeated
    subtrees) the topologically-latest one is returned, matching
    ``FingerprintIndex.probe`` — anchoring late keeps sub-job credit
    attribution on the copy whose downstream consumers run last."""
    target_fp = repo_plan.fingerprints()[id(_output_op(repo_plan))]
    in_fps = input_plan.fingerprints()
    for op in reversed(input_plan.topo()):
        if op.kind in ("LOAD", "STORE"):
            continue  # rewriting a Load with a Load is useless
        if in_fps[id(op)] == target_fp:
            return op
    return None


class FingerprintIndex:
    """Beyond-paper fast path: index input-plan ops by fingerprint once,
    then each repository probe is O(1) instead of a plan scan.  All ops
    sharing a fingerprint are kept (duplicated subtrees in diamond plans
    are distinct rewrite sites); ``probe`` prefers the topologically-
    latest anchor."""

    def __init__(self, input_plan: PhysicalPlan):
        self.by_fp: Dict[str, List[Operator]] = {}
        self.fps = input_plan.fingerprints()   # shared with SemanticIndex
        for op in input_plan.topo():
            if op.kind in ("LOAD", "STORE"):
                continue
            self.by_fp.setdefault(self.fps[id(op)], []).append(op)

    def probe(self, repo_plan: PhysicalPlan) -> Optional[Operator]:
        return self.probe_fp(
            repo_plan.fingerprints()[id(_output_op(repo_plan))])

    def probe_fp(self, fp: str) -> Optional[Operator]:
        """Probe by a precomputed output fingerprint (a repository
        entry's ``signature``), skipping the repo-plan Merkle pass."""
        ops = self.by_fp.get(fp)
        return ops[-1] if ops else None


# ---------------------------------------------------------------------------
# Paper Algorithm 1 (faithful port)


def _find_equivalent(op: Operator, candidates: List[Operator]) -> Optional[Operator]:
    for c in candidates:
        if c.local_sig() == op.local_sig():
            return c
    return None


def pairwise_plan_traversal(input_plan: PhysicalPlan,
                            repo_plan: PhysicalPlan) -> Optional[Operator]:
    """Algorithm 1: simultaneous DFS from the Load operators.  Returns the
    last matched operator of the *input* plan (the rewrite anchor), or
    None.  As in the paper, matching starts by pairing Load operators that
    read the same dataset."""
    succ1 = input_plan.successors()
    succ2 = repo_plan.successors()

    loads1 = input_plan.loads()
    loads2 = repo_plan.loads()
    # each repo Load must have an equivalent input Load
    pairs = []
    used = set()
    for l2 in loads2:
        found = None
        for l1 in loads1:
            if id(l1) in used:
                continue
            if l1.local_sig() == l2.local_sig():
                found = l1
                break
        if found is None:
            return None
        used.add(id(found))
        pairs.append((found, l2))

    remaining2 = [o for o in repo_plan.topo()
                  if o.kind not in ("LOAD", "STORE")]
    matched: Dict[int, Operator] = {}   # repo op id -> input op
    seen = set()

    def traverse(succs1: List[Operator], succs2: List[Operator],
                 last_match: Optional[Operator]) -> Optional[Operator]:
        succs2 = [s for s in succs2 if s.kind != "STORE"]
        if not succs2:
            return last_match
        if not succs1:
            return None
        ret: Optional[Operator] = None
        s2_left = list(succs2)
        for s in succs1:
            if id(s) in seen:
                continue
            seen.add(id(s))
            eq = _find_equivalent(s, s2_left)
            if eq is None:
                continue
            ret = traverse(succ1[id(s)], succ2[id(eq)], s)
            if ret is None:
                return None
            matched[id(eq)] = s
            s2_left.remove(eq)
            if not s2_left:
                break
        if s2_left:
            return None
        return ret

    last: Optional[Operator] = None
    for l1, l2 in pairs:
        r = traverse(succ1[id(l1)], succ2[id(l2)], last)
        if r is None:
            return None
        last = r

    # all repo ops must be matched
    for o in remaining2:
        if id(o) not in matched:
            return None
    out2 = _output_op(repo_plan)
    return matched.get(id(out2), last)


# ---------------------------------------------------------------------------
# Semantic subsumption matching (DESIGN.md §10)


@dataclasses.dataclass
class SemanticMatch:
    """A subsumption hit: the repository artifact *covers* the anchor's
    sub-plan; splicing it in requires re-applying ``residual`` (a FILTER)
    and/or ``narrow_cols`` (a PROJECT) on top of the Load."""
    anchor: Operator
    residual: Optional[Expr]
    narrow_cols: Optional[Tuple[str, ...]]

    @property
    def n_comp_ops(self) -> int:
        return (self.residual is not None) + (self.narrow_cols is not None)


def _peel_chain(op: Operator):
    """Strip the maximal FILTER/PROJECT chain under ``op``.

    Returns (base, preds, net_cols): the first non-FILTER/PROJECT
    operator, every filter predicate on the way down, and the chain's
    net output columns (the *topmost* PROJECT's column set — inner
    projections are supersets in any well-formed plan; None = all of the
    base's columns survive).  The chain is semantically
    σ(∧preds) ∘ π(net_cols) over the base: FILTER and PROJECT commute
    here because predicates only need their own columns at eval time and
    neither operator reorders rows."""
    preds: List[Expr] = []
    net_cols: Optional[Tuple[str, ...]] = None
    cur = op
    while cur.kind in ("FILTER", "PROJECT"):
        if cur.kind == "FILTER":
            preds.append(cur.params["pred"])
        elif net_cols is None:
            net_cols = tuple(sorted(cur.params["cols"]))
        cur = cur.inputs[0]
    return cur, preds, net_cols


def _base_id(op: Operator, fps: Dict[int, str]) -> str:
    """Identity of a chain base, robust to prior exact rewriting.

    Artifact names are content-addressed — ``art/<fp[:16]>`` of the
    original-form operator that produced them — so a ``LOAD(art/h)``
    spliced in by an earlier rewrite round denotes the same value as any
    operator whose fingerprint starts with ``h``.  Truncating every base
    to the 16-hex prefix lets a repository chain over the original
    subtree line up with an input chain over its already-rewritten
    Load."""
    if op.kind == "LOAD":
        ds = op.params["dataset"]
        if ds.startswith("art/"):
            return ds[4:]
    return fps[id(op)][:16]


def peel_repo_output(repo_plan: PhysicalPlan) -> Optional[tuple]:
    """Precompute a repository plan's probe-side peel:
    ``(output_fp, base_id, preds, net_cols)``, or None when the output
    is not a FILTER/PROJECT chain (nothing to weaken/widen).  Entry
    plans are immutable, so the rewriter caches this across rounds."""
    out = _output_op(repo_plan)
    if out.kind not in ("FILTER", "PROJECT"):
        return None
    repo_fps = repo_plan.fingerprints()
    r_base, r_preds, r_cols = _peel_chain(out)
    return (repo_fps[id(out)], _base_id(r_base, repo_fps),
            r_preds, r_cols)


class SemanticIndex:
    """After the exact ``FingerprintIndex`` probe misses, find repository
    plans identical to an input sub-plan except for a *weaker* FILTER
    predicate and/or *wider* PROJECT column set.

    Input-plan FILTER/PROJECT chain tops are indexed by the identity of
    the first operator *below* the chain (see ``_base_id``), so a probe
    only compares chains hanging off an identical base.  Exact hits take
    priority by construction: the probe returns None whenever the
    repository plan's output fingerprint occurs anywhere in the input
    plan (the exact index would have answered).

    ``fps`` lets the caller share the input plan's fingerprint map with
    an already-built ``FingerprintIndex`` instead of recomputing it."""

    def __init__(self, input_plan: PhysicalPlan,
                 fps: Optional[Dict[int, str]] = None):
        fps = fps if fps is not None else input_plan.fingerprints()
        self._all_fps = frozenset(fps.values())
        # chain-base identity -> chain tops in topo order
        self._by_base: Dict[str, List[tuple]] = {}
        for op in input_plan.topo():
            if op.kind not in ("FILTER", "PROJECT"):
                continue
            base, preds, cols = _peel_chain(op)
            self._by_base.setdefault(_base_id(base, fps), []).append(
                (op, preds, cols))

    def probe(self, repo_plan: PhysicalPlan) -> Optional[SemanticMatch]:
        return self.probe_peeled(peel_repo_output(repo_plan))

    def probe_peeled(self, peeled: Optional[tuple]
                     ) -> Optional[SemanticMatch]:
        if peeled is None:
            return None               # nothing to weaken/widen
        out_fp, base_id, r_preds, r_cols = peeled
        if out_fp in self._all_fps:
            return None               # exact hit: not semantic's business
        cands = self._by_base.get(base_id)
        if not cands:
            return None
        for anchor, preds, cols in reversed(cands):   # topo-latest first
            m = self._compensate(preds, cols, r_preds, r_cols)
            if m is not None:
                residual, narrow = m
                return SemanticMatch(anchor, residual, narrow)
        return None

    @staticmethod
    def _compensate(preds, cols, r_preds, r_cols):
        """Compensation for answering σ(∧preds)∘π(cols) from a stored
        σ(∧r_preds)∘π(r_cols) artifact, or None when unsound."""
        # projection containment: the artifact must retain every column
        # the input chain outputs (r_cols None = all base columns kept)
        if r_cols is not None and (cols is None
                                   or not set(cols) <= set(r_cols)):
            return None
        # predicate containment: input rows must be a subset of stored
        if r_preds and not preds:
            return None
        residual: Optional[Expr] = None
        if preds:
            p = conjoin(preds)
            if r_preds:
                q = conjoin(r_preds)
                if not implies(p, q):
                    return None
                residual = residual_pred(p, q)
            else:
                residual = p
        # the residual re-runs over the artifact: its columns must exist
        if residual is not None and r_cols is not None \
                and not pred_columns(residual) <= set(r_cols):
            return None
        narrow = None
        if cols is not None and (r_cols is None or set(cols) < set(r_cols)):
            narrow = cols
        # residual None and narrow None = the chains are equivalent up to
        # FILTER/PROJECT reordering (different fingerprints, same value):
        # the artifact answers the anchor with no compensation at all
        return residual, narrow
