"""Multi-query batch optimization (DESIGN.md §16).

ReStore reuses job outputs *across time*; this module shares work
*within a batch*, where the cross-industry workload studies
(arXiv:1208.4174) put the bigger win: N queued workflows that overlap
right now.  ``optimize_batch`` finds the common sub-plans —

  * **exact** — operators whose Merkle fingerprints appear in ≥2 of the
    batch's plans (the same currency ``FingerprintIndex`` probes with),
    keeping only per-plan *maximal* ones so a shared join subsumes its
    shared inputs;
  * **subsumed** — FILTER/PROJECT chains over the same base that differ
    only in predicate strength / column width: the batch's *covering*
    chain (weakest predicate, widest columns — checked with the same
    implication machinery ``SemanticIndex`` uses) is materialized once
    and every variant compensates with a residual filter at query time

— then builds one shared prefix plan whose operator DAG is physically
deduplicated (operators keyed by fingerprint, so the engine computes
each shared value once even inside the prefix), schedules it first, and
hands the repository *known-uses* hints: a sub-job about to be consumed
by 5 queries is admitted with known (not estimated) expected uses in
the CostModel knapsack, overriding the seen-once admission gate.

Planning never perturbs the economics it relies on: repository probes
run through ``rewrite_plan(..., record=False)`` so an optimizer looking
at the repository is not mistaken for a reuse hit (the satellite-6
audit), and already-materialized shared sub-plans are simply dropped
from the prefix.

``run_batch`` drives a :class:`~core.restore.ReStore` through the
whole protocol — hint, pin, shared prefix, per-query runs, release —
and audits ``dup_executions`` (a shared sub-plan executing more than
once anywhere in the batch) for the bench/CI gate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..dataflow.builder import as_plan
from ..dataflow.compiler import art_name, compile_workflow
from .matcher import SemanticIndex, _base_id, _peel_chain
from .plan import Operator, PhysicalPlan, store
from .rewriter import is_trivial, rewrite_plan

# Operator kinds worth sharing across queries.  LOAD is free (both
# queries read the catalog anyway), STORE/SPLIT are plumbing.
SHARE_KINDS = frozenset({"PROJECT", "FILTER", "FOREACH", "JOIN",
                         "GROUPBY", "COGROUP", "DISTINCT", "UNION"})


@dataclasses.dataclass
class SharedSubplan:
    """One sub-plan selected for single execution on behalf of the batch."""
    fp: str                   # fingerprint of the shared operator
    kind: str                 # operator kind (JOIN, FOREACH, ...)
    n_consumers: int          # distinct queries known to consume it
    artifact: str             # content-addressed boundary artifact name
    plan: PhysicalPlan        # standalone Load...→op→Store form
    semantic: bool = False    # covering chain serving subsumed variants
    already_stored: bool = False  # repository probe found it → no exec


@dataclasses.dataclass
class BatchPlan:
    plans: List[PhysicalPlan]            # the batch, coerced to plans
    shared_plan: Optional[PhysicalPlan]  # dedup'd shared prefix (or None)
    shared: List[SharedSubplan]
    known_uses: Dict[str, float]         # hint key -> known consumers
    boundary_artifacts: Set[str]         # everything the prefix stores
    planning_s: float = 0.0


@dataclasses.dataclass
class BatchResult:
    results: List[Dict]                  # per-query outputs, batch order
    reports: List                        # per-query RunReport
    batch: BatchPlan
    shared_report: Optional[object]      # RunReport of the shared prefix
    shared_wall_s: float
    dup_executions: int


# ---------------------------------------------------------------------------
# Batch analysis


def _chain_tops(plan: PhysicalPlan) -> List[Operator]:
    """FILTER/PROJECT operators that top a maximal chain (no
    FILTER/PROJECT consumer above them) — the units SemanticIndex
    reasons about."""
    succ = plan.successors()
    return [op for op in plan.topo()
            if op.kind in ("FILTER", "PROJECT")
            and not any(s.kind in ("FILTER", "PROJECT")
                        for s in succ[id(op)])]


def _maximal_shared_fps(plans: Sequence[PhysicalPlan],
                        all_fps: List[Dict[int, str]],
                        shared_fps: Set[str]) -> Set[str]:
    """Shared fingerprints that are maximal in at least one plan: no
    ancestor (toward the sinks) of an occurrence is itself shared.  The
    union over plans keeps a sub-plan that is maximal for one query even
    when another query shares a larger cone containing it."""
    keep: Set[str] = set()
    for plan, fps in zip(plans, all_fps):
        succ = plan.successors()
        covered: Dict[int, bool] = {}
        for op in reversed(plan.topo()):
            cov = False
            for s in succ[id(op)]:
                if covered[id(s)] or fps[id(s)] in shared_fps:
                    cov = True
                    break
            covered[id(op)] = cov
        for op in plan.topo():
            if fps[id(op)] in shared_fps and not covered[id(op)]:
                keep.add(fps[id(op)])
    return keep


def _semantic_groups(plans: Sequence[PhysicalPlan],
                     all_fps: List[Dict[int, str]]):
    """Group FILTER/PROJECT chain tops by the identity of the operator
    under the chain, across every plan in the batch.  Returns
    base_id -> list of (plan_idx, top_op, preds, net_cols, top_fp)."""
    groups: Dict[str, List[Tuple]] = {}
    for pi, (plan, fps) in enumerate(zip(plans, all_fps)):
        for top in _chain_tops(plan):
            base, preds, cols = _peel_chain(top)
            groups.setdefault(_base_id(base, fps), []).append(
                (pi, top, preds, cols, fps[id(top)]))
    return groups


def _pick_covering(group, exact_fps: Set[str]):
    """From one base's chain variants pick the covering chain — the one
    whose stored output can answer the most *other* variants through
    residual compensation (``SemanticIndex._compensate`` soundness).
    Variants already shared exactly have their own materialization and
    do not count as semantic consumers.  Returns
    (top_op, plan_idx, top_fp, n_consumer_plans) or None."""
    best = None
    for (pi, top, preds, cols, fp) in group:
        consumers = {pi}
        for (qi, _, q_preds, q_cols, q_fp) in group:
            if q_fp == fp or q_fp in exact_fps:
                continue
            if SemanticIndex._compensate(q_preds, q_cols,
                                         preds, cols) is not None:
                consumers.add(qi)
        if len(consumers) >= 2 and (best is None
                                    or len(consumers) > best[3]):
            best = (top, pi, fp, len(consumers))
    return best


def optimize_batch(queries: Sequence, repo=None,
                   semantic: bool = True) -> BatchPlan:
    """Analyze a batch of queries (plans or dataflow builders) and plan
    the shared execution: which sub-plans are common (exactly or by
    subsumption), one deduplicated prefix plan that materializes each of
    them once, and the known-uses hints for the repository.

    ``repo`` (optional) is probed — with ``record=False``, planning
    probes must not look like reuse hits — to drop shared sub-plans the
    repository already holds."""
    t0 = time.time()
    plans = [as_plan(q) for q in queries]
    all_fps = [p.fingerprints() for p in plans]

    # -- exact sharing: fingerprint present in >= 2 distinct plans
    where: Dict[str, Set[int]] = {}
    reps: Dict[str, Tuple[int, Operator]] = {}
    for pi, (plan, fps) in enumerate(zip(plans, all_fps)):
        for op in plan.topo():
            if op.kind not in SHARE_KINDS:
                continue
            fp = fps[id(op)]
            where.setdefault(fp, set()).add(pi)
            reps.setdefault(fp, (pi, op))
    exact_fps = {fp for fp, pis in where.items() if len(pis) >= 2}
    selected: List[Tuple[str, Operator, int, bool]] = [
        (fp, reps[fp][1], len(where[fp]), False)
        for fp in sorted(_maximal_shared_fps(plans, all_fps, exact_fps))]

    # -- subsumed sharing: covering FILTER/PROJECT chains across plans
    if semantic:
        seen = {fp for fp, _, _, _ in selected}
        groups = _semantic_groups(plans, all_fps)
        for base_id in sorted(groups):
            group = groups[base_id]
            if len({pi for pi, *_ in group}) < 2:
                continue
            pick = _pick_covering(group, exact_fps)
            if pick is None:
                continue
            top, pi, fp, n = pick
            if fp in exact_fps:
                # covering chain is itself exact-shared: already
                # selected; raise its known uses to the semantic reach
                selected = [(f, o, max(c, n) if f == fp else c, s)
                            for f, o, c, s in selected]
                continue
            if fp not in seen:
                seen.add(fp)
                selected.append((fp, top, n, True))

    # -- one physically-deduplicated prefix DAG (operators keyed by
    # fingerprint, so shared subtrees are computed once inside it too)
    canon: Dict[str, Operator] = {}

    def build(op: Operator, fps: Dict[int, str]) -> Operator:
        fp = fps[id(op)]
        got = canon.get(fp)
        if got is None:
            got = Operator(op.kind, dict(op.params),
                           [build(i, fps) for i in op.inputs])
            canon[fp] = got
        return got

    shared: List[SharedSubplan] = []
    live_sinks: List[Operator] = []
    for fp, op, n, is_sem in selected:
        # identical fingerprints denote identical subtrees, so any
        # representative occurrence serves; reps covers every SHARE_KINDS
        # op in the batch, semantic picks included
        rep_pi, rep_op = reps[fp]
        c_op = build(rep_op, all_fps[rep_pi])
        sink = store(c_op, art_name(fp))
        sub = PhysicalPlan([sink])
        wf = compile_workflow(sub)
        artifact = wf.final_outputs[art_name(fp)]
        stored_already = False
        if repo is not None:
            probe = rewrite_plan(sub, repo, semantic=semantic,
                                 record=False)
            stored_already = is_trivial(probe.plan)
        shared.append(SharedSubplan(fp=fp, kind=op.kind, n_consumers=n,
                                    artifact=artifact, plan=sub,
                                    semantic=is_sem,
                                    already_stored=stored_already))
        if not stored_already:
            live_sinks.append(sink)

    shared_plan = PhysicalPlan(live_sinks) if live_sinks else None

    # -- known-uses hints + the prefix's full boundary footprint
    known: Dict[str, float] = {}
    boundary: Set[str] = set()
    for s in shared:
        known[s.artifact] = max(known.get(s.artifact, 0.0),
                                float(s.n_consumers))
        boundary.add(s.artifact)
    if shared_plan is not None:
        peak = max((s.n_consumers for s in shared), default=0)
        for job in compile_workflow(shared_plan).jobs:
            for out in job.outputs:
                boundary.add(out)
                # intermediate boundaries under a shared op serve at
                # least that op's consumers transitively
                known.setdefault(out, float(peak))

    return BatchPlan(plans=plans, shared_plan=shared_plan, shared=shared,
                     known_uses=known, boundary_artifacts=boundary,
                     planning_s=time.time() - t0)


# ---------------------------------------------------------------------------
# Batch execution


def count_dup_executions(bp: BatchPlan, reports) -> int:
    """Shared sub-plans executed more than once across the batch: a
    per-query job that re-produced a shared boundary artifact, or that
    recomputed a shared operator no splice shielded.  A splice at or
    above an operator (its subtree was replaced by an artifact load —
    exactly, or semantically at a chain top over the same base) means
    the operator never executed, so a job that reuses the FILTER chain
    artifact is clean even though the shared FOREACH below it also
    appears in its plan.  The shared prefix itself is the sanctioned
    single execution, so any hit here is a duplicate."""
    shared_arts = {s.artifact for s in bp.shared}
    sem_base = {}                 # covering artifact -> its chain's base id
    for s in bp.shared:
        if s.semantic:
            top = s.plan.sinks[0].inputs[0]
            base, _, _ = _peel_chain(top)
            sem_base[s.artifact] = _base_id(base, s.plan.fingerprints())
    dup = 0
    for plan, rep in zip(bp.plans, reports):
        wf = compile_workflow(plan)
        for job, jr in zip(wf.jobs, rep.jobs):
            if not jr.executed:
                continue
            if set(job.outputs) & bp.boundary_artifacts:
                dup += 1
                continue
            fps = job.plan.fingerprints()
            reused = set(jr.reused_artifacts)
            spliced = {id(op) for op in job.plan.topo()
                       if art_name(fps[id(op)]) in reused}
            hot_bases = {sem_base[a] for a in reused if a in sem_base}
            if hot_bases:
                for top in _chain_tops(job.plan):
                    base, _, _ = _peel_chain(top)
                    if _base_id(base, fps) in hot_bases:
                        spliced.add(id(top))
            succ = job.plan.successors()
            covered: Dict[int, bool] = {}
            for op in reversed(job.plan.topo()):
                covered[id(op)] = (id(op) in spliced
                                   or any(covered[id(s2)]
                                          for s2 in succ[id(op)]))
            if any(art_name(fps[id(op)]) in shared_arts
                   and not covered[id(op)] for op in job.plan.topo()):
                dup += 1
    return dup


def run_batch(driver, queries: Sequence, semantic: bool = True
              ) -> BatchResult:
    """Execute a batch through one :class:`ReStore` driver: optimize,
    install known-uses hints, pin the shared boundary (names pin fine
    before the artifacts exist), run the shared prefix once, run each
    query (their rewrites splice the shared artifacts), then release
    hints and pins and settle the repository budget."""
    bp = optimize_batch(queries, repo=driver.repo, semantic=semantic)
    repo = driver.repo
    shared_report = None
    repo.set_known_uses(bp.known_uses)
    repo.pin(bp.boundary_artifacts)
    try:
        if bp.shared_plan is not None:
            _, shared_report = driver.run(bp.shared_plan)
        results: List[Dict] = []
        reports: List = []
        for plan in bp.plans:
            out, rep = driver.run(plan)
            results.append(out)
            reports.append(rep)
    finally:
        repo.unpin(bp.boundary_artifacts)
        repo.clear_known_uses(bp.known_uses)
        repo.rebalance()
    return BatchResult(
        results=results, reports=reports, batch=bp,
        shared_report=shared_report,
        shared_wall_s=(shared_report.total_wall_s
                       if shared_report is not None else 0.0),
        dup_executions=count_dup_executions(bp, reports))
