"""Plan rewriting (paper §3; semantic compensation DESIGN.md §10).

Given a job's physical plan and the repository, repeatedly:
  scan the repository in its partial order; the first entry whose plan is
  contained in the job plan rewrites it — the matched region is replaced
  by a Load of the entry's artifact — then a fresh scan starts (so several
  repository plans can rewrite one job, exactly as in the paper).

Beyond the paper, when a full exact scan comes up empty the rewriter
probes the ``SemanticIndex``: a stored artifact that merely *covers* the
matched region (weaker FILTER / wider PROJECT) is spliced in together
with a compensation chain — FILTER(residual) and/or PROJECT(narrowing) on
top of the Load — that re-derives the exact value.  The compensation root
inherits the anchor's origin, so the enumerator can re-materialize the
exact value under its canonical name (upgrading the semantic hit to an
exact one for future runs).

The rewriter tracks, for every operator of the rewritten plan, which
operator of the *original* plan it computes.  The sub-job enumerator uses
this to name candidate artifacts by original-form fingerprints, keeping
the repository language canonical across runs (see DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .matcher import (FingerprintIndex, SemanticIndex,
                      pairwise_plan_traversal, peel_repo_output)
from .plan import (Operator, Partitioning, PhysicalPlan, filter_, load,
                   project)
from .repository import Repository, RepositoryEntry


@dataclasses.dataclass
class RewriteResult:
    plan: PhysicalPlan
    used: List[RepositoryEntry]              # entries applied, in order
    origin: Dict[int, Operator]              # rewritten op id -> original op
    n_semantic: int = 0                      # of which, subsumption hits
    # ids (in `plan`) of compensation-chain roots: these ops re-derive a
    # reused value, so the driver must not record their execution as the
    # original operator's cost / missed-reuse statistics
    comp_op_ids: Set[int] = dataclasses.field(default_factory=set)


def _replace_tracking(plan: PhysicalPlan, old: Operator, new: Operator,
                      origin: Dict[int, Operator],
                      tracked: Set[int]) -> Tuple[PhysicalPlan,
                                                  Dict[int, Operator],
                                                  Set[int]]:
    mapping: Dict[int, Operator] = {id(old): new}
    new_origin: Dict[int, Operator] = {}

    def rebuild(op: Operator) -> Operator:
        if id(op) in mapping:
            return mapping[id(op)]
        new_inputs = [rebuild(i) for i in op.inputs]
        if all(a is b for a, b in zip(new_inputs, op.inputs)):
            out = op
        else:
            out = Operator(op.kind, dict(op.params), new_inputs)
        mapping[id(op)] = out
        return out

    sinks = [rebuild(s) for s in plan.sinks]
    rewritten = PhysicalPlan(sinks)
    for op in plan.topo():
        new_op = mapping.get(id(op))
        if new_op is None:
            continue
        orig = origin.get(id(op))
        if orig is not None:
            new_origin[id(new_op)] = orig
    # the injected Load computes what `old` computed
    if id(old) in origin:
        new_origin[id(new)] = origin[id(old)]
    # carry tracked op ids through the rebuild (ops replaced away drop out)
    new_tracked = {id(mapping[t]) for t in tracked if t in mapping}
    return rewritten, new_origin, new_tracked


def _avoided_exchanges(plan: PhysicalPlan, anchor: Operator,
                       part: Optional[Partitioning],
                       n_shards: Optional[int]) -> int:
    """How many downstream exchanges a co-partitioned artifact spliced
    at ``anchor`` makes shuffle-free (DESIGN.md §11): walk the anchor's
    consumers through partition-preserving operators and count blocking
    consumers whose keys the artifact's property covers/aligns."""
    if part is None or n_shards is None or part.n_parts != n_shards:
        return 0
    succ = plan.successors()
    n = 0
    frontier = [anchor]
    seen = set()
    while frontier:
        op = frontier.pop()
        for s in succ.get(id(op), []):
            if id(s) in seen:
                continue
            seen.add(id(s))
            k = s.kind
            if k in ("FILTER", "SPLIT", "STORE"):
                frontier.append(s)
            elif k == "PROJECT" \
                    and set(part.keys) <= set(s.params["cols"]):
                frontier.append(s)
            elif k == "GROUPBY" \
                    and part.covers(s.params["keys"], n_shards):
                n += 1
            elif k == "JOIN":
                keys = s.params["left_keys"] if s.inputs[0] is op \
                    else s.params["right_keys"]
                n += part.aligns(keys, n_shards)
            elif k == "COGROUP":
                keys = s.params["keys_left"] if s.inputs[0] is op \
                    else s.params["keys_right"]
                n += part.aligns(keys, n_shards)
            elif k == "DISTINCT":
                n += 1     # any subset partitioning co-locates equal rows
    return n


def rewrite_plan(plan: PhysicalPlan, repo: Repository,
                 use_algorithm1: bool = False,
                 semantic: bool = True,
                 max_rewrites: int = 64,
                 n_shards: Optional[int] = None,
                 record: bool = True) -> RewriteResult:
    """Rewrite ``plan`` against the repository until no entry matches.

    Each round scans ``repo.ordered()`` (the paper's partial order, so
    the first hit is the best hit); the matched region is replaced by a
    Load of the entry's artifact and a fresh scan starts, letting
    several repository plans rewrite one job.  When an exact scan misses
    and ``semantic`` is on, the round falls back to subsumption probes
    (DESIGN.md §10): the anchor is replaced by the Load *plus* its
    compensation chain, and the realized saving is net of the predicted
    compensation compute.  Every hit is recorded via ``repo.record_use``
    with the predicted time saved and its kind, which feeds recency
    eviction, the cost model's expected-reuse statistics (DESIGN.md §9),
    and the repository's exact/semantic hit counters.  Returns the
    rewritten plan, the entries applied (in order), and the
    rewritten-op -> original-op map the sub-job enumerator needs.

    ``record=False`` makes the scan a pure *planning probe*: no
    ``record_use`` credit is issued.  The batch optimizer (DESIGN.md
    §16) probes candidate shared sub-plans to see what is already
    materialized; those probes are not reuse hits, and crediting them
    would inflate recency/hit-count and the expected-uses estimate the
    repository evicts by."""
    origin: Dict[int, Operator] = {id(op): op for op in plan.topo()}
    used: List[RepositoryEntry] = []
    n_semantic = 0
    comp_ids: Set[int] = set()
    # entry plans are immutable: peel each once, not once per round
    peels: Dict[int, Optional[tuple]] = {}

    cm = repo.cost_model
    for _ in range(max_rewrites):
        hit: Optional[Tuple[RepositoryEntry, Operator]] = None
        index: Optional[FingerprintIndex] = None
        if use_algorithm1:
            # faithful sequential scan with Algorithm 1 per entry
            for entry in repo.ordered():
                anchor = pairwise_plan_traversal(plan, entry.plan)
                if anchor is not None and anchor.kind not in ("LOAD", "STORE"):
                    if not cm.should_splice(entry):
                        continue       # L7 guard: benefit below overhead
                    hit = (entry, anchor)
                    break
        else:
            index = FingerprintIndex(plan)
            for entry in repo.ordered():
                # entry.signature IS the output fingerprint: no per-probe
                # Merkle pass over the entry plan
                anchor = index.probe_fp(entry.signature)
                if anchor is not None:
                    if not cm.should_splice(entry):
                        continue       # L7 guard: benefit below overhead
                    hit = (entry, anchor)
                    break
        if hit is not None:
            entry, anchor = hit
            new_load = load(entry.artifact)
            saved = cm.savings_per_reuse_s(
                entry.producer_cost_s or entry.exec_time_s, entry.bytes_out)
            if entry.partitioning is not None:
                # the partition property rides along on the spliced Load
                # (physical property: not part of the fingerprint), and
                # every downstream exchange it makes shuffle-free is
                # extra realized savings (DESIGN.md §11)
                new_load.params["partitioning"] = dict(entry.partitioning)
                saved += _avoided_exchanges(
                    plan, anchor, Partitioning.from_dict(entry.partitioning),
                    n_shards) * cm.shuffle_cost_s(entry.bytes_out)
            plan, origin, comp_ids = _replace_tracking(
                plan, anchor, new_load, origin, comp_ids)
            used.append(entry)
            if record:
                repo.record_use(entry, saved_s=max(saved, 0.0))
            continue
        if semantic and not use_algorithm1:
            sem = None
            sem_index = SemanticIndex(plan, fps=index.fps)
            for entry in repo.ordered():
                if id(entry) not in peels:
                    peels[id(entry)] = peel_repo_output(entry.plan)
                m = sem_index.probe_peeled(peels[id(entry)])
                if m is not None:
                    sem = (entry, m)
                    break
            if sem is not None:
                entry, m = sem
                comp: Operator = load(entry.artifact)
                saved = cm.savings_per_reuse_s(
                    entry.producer_cost_s or entry.exec_time_s,
                    entry.bytes_out) - cm.compensation_cost_s(
                        entry.bytes_out, m.n_comp_ops)
                if entry.partitioning is not None:
                    # compensation FILTERs preserve the property (the
                    # executor's propagation re-checks PROJECT
                    # narrowing), so a co-partitioned covering artifact
                    # earns the same avoided-exchange credit as an
                    # exact hit
                    comp.params["partitioning"] = dict(entry.partitioning)
                    saved += _avoided_exchanges(
                        plan, m.anchor,
                        Partitioning.from_dict(entry.partitioning),
                        n_shards) * cm.shuffle_cost_s(entry.bytes_out)
                if m.residual is not None:
                    comp = filter_(comp, m.residual)
                if m.narrow_cols is not None:
                    comp = project(comp, m.narrow_cols)
                plan, origin, comp_ids = _replace_tracking(
                    plan, m.anchor, comp, origin, comp_ids)
                comp_ids.add(id(comp))
                used.append(entry)
                n_semantic += 1
                if record:
                    repo.record_use(entry, saved_s=max(saved, 0.0),
                                    kind="semantic")
                continue
        break
    return RewriteResult(plan, used, origin, n_semantic, comp_ids)


def is_trivial(plan: PhysicalPlan) -> bool:
    """True when every sink is STORE(LOAD(...)) — a fully-reused job."""
    for s in plan.sinks:
        if s.kind != "STORE" or s.inputs[0].kind != "LOAD":
            return False
    return True
