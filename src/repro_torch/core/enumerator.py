"""Sub-job enumeration (paper §4; cost-driven mode in DESIGN.md §9).

For every physical operator selected by the active policy, inject a
Split + Store so its output is materialized during job execution and
becomes a repository candidate:

  * Conservative H_C — input-reducing operators: PROJECT, FILTER (and
    FOREACH, Pig's projection carrier);
  * Aggressive   H_A — H_C plus the expensive operators: JOIN, GROUPBY,
    COGROUP;
  * NoHeuristic  NH  — every operator;
  * Cost         —   any operator, but only when the cost model predicts
    the benefit of keeping it (recompute savings × expected reuses)
    exceeds the cost of storing it.  Operators are identified by the
    *structural* (version-blind) fingerprint so the prediction survives
    dataset churn; never-seen operators are not materialized — their
    first execution only collects statistics.

Candidate artifacts are named by the fingerprint of the *original-form*
operator (pre-rewrite), so the same logical value always maps to the same
artifact regardless of how much of the plan was answered from the
repository this time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..dataflow.compiler import art_name
from .cost_model import CostModel
from .plan import Operator, PhysicalPlan, split, store

CONSERVATIVE = frozenset({"PROJECT", "FILTER", "FOREACH"})
AGGRESSIVE = CONSERVATIVE | {"JOIN", "GROUPBY", "COGROUP"}
ALL_OPS = AGGRESSIVE | {"UNION", "DISTINCT"}

HEURISTICS = {
    "conservative": CONSERVATIVE,
    "aggressive": AGGRESSIVE,
    "none": ALL_OPS,          # the paper's "No Heuristic" policy
    "cost": ALL_OPS,          # candidate universe; cost model selects
    "off": frozenset(),       # no sub-job materialization at all
}


@dataclasses.dataclass
class Candidate:
    artifact: str
    plan: PhysicalPlan        # original-form Load...→op→Store
    exec_op_uid: int          # uid of the op in the executed plan
    struct_fp: str = ""       # version-blind fingerprint (cost-model key)


def enumerate_subjobs(exec_plan: PhysicalPlan, origin: Dict[int, Operator],
                      orig_plan: PhysicalPlan, heuristic: str,
                      cost_model: Optional[CostModel] = None
                      ) -> tuple[PhysicalPlan, List[Candidate]]:
    """Inject Split+Store sinks for every sub-job the active policy
    wants materialized and return (augmented plan, candidates).

    ``exec_plan`` is the (possibly rewritten) plan about to execute;
    ``origin`` maps its operators back to ``orig_plan`` (the original,
    pre-rewrite form), which names the candidate artifacts.  In
    ``"cost"`` mode a ``cost_model`` is required: an operator is
    materialized only if ``cost_model.should_materialize`` approves its
    structural fingerprint (predicted benefit > store cost).

    Batch-optimizer known-uses hints (DESIGN.md §16) extend the reach of
    any non-"off" heuristic: an operator whose fingerprint or artifact
    name is hinted is materialized even when its kind falls outside the
    heuristic's set, because queued queries are known to consume it."""
    kinds = HEURISTICS[heuristic]
    use_cost = heuristic == "cost"
    if use_cost and cost_model is None:
        raise ValueError('heuristic "cost" requires a cost_model')
    orig_fps = orig_plan.fingerprints()
    struct_fps = orig_plan.structural_fingerprints()

    existing = {s.params["name"] for s in exec_plan.sinks
                if s.kind == "STORE"}
    sinks = list(exec_plan.sinks)
    candidates: List[Candidate] = []
    for op in exec_plan.topo():
        orig = origin.get(id(op))
        if orig is None:
            continue
        hinted = (cost_model is not None and kinds
                  and op.kind in ALL_OPS
                  and cost_model.known_uses_for(
                      struct_fps[id(orig)],
                      art_name(orig_fps[id(orig)])) > 0.0)
        if op.kind not in kinds and not hinted:
            continue
        if use_cost and not cost_model.should_materialize(
                struct_fps[id(orig)],
                artifact=art_name(orig_fps[id(orig)])):
            continue
        name = art_name(orig_fps[id(orig)])
        if name in existing:
            continue
        existing.add(name)
        sinks.append(store(split(op), name))
        candidates.append(Candidate(
            artifact=name,
            plan=orig_plan.subplan_upto(orig, name),
            exec_op_uid=op.uid,
            struct_fp=struct_fps[id(orig)]))
    return PhysicalPlan(sinks), candidates


def whole_job_candidates(exec_plan: PhysicalPlan, origin: Dict[int, Operator],
                         orig_plan: PhysicalPlan) -> List[Candidate]:
    """Every job output is a repository candidate (paper §4 ¶2) — at zero
    extra cost, since workflow outputs are stored anyway."""
    orig_fps = orig_plan.fingerprints()
    struct_fps = orig_plan.structural_fingerprints()
    out: List[Candidate] = []
    for s in exec_plan.sinks:
        if s.kind != "STORE":
            continue
        inp = s.inputs[0]
        target = inp.inputs[0] if inp.kind == "SPLIT" else inp
        if target.kind == "LOAD":
            continue
        orig = origin.get(id(target))
        if orig is None:
            continue
        out.append(Candidate(
            artifact=s.params["name"],
            plan=orig_plan.subplan_upto(orig, s.params["name"]),
            exec_op_uid=target.uid,
            struct_fp=struct_fps[id(orig)]))
    return out
