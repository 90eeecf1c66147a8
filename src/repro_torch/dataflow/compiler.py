"""Plan -> workflow-of-jobs compiler (the Pig MapReduce-compiler analogue).

A *job* is one jitted map->shuffle->reduce stage.  The compiler walks the
physical plan and cuts it at blocking operators (JOIN / GROUPBY / COGROUP /
DISTINCT), exactly like Pig embeds each such operator in its own reducer
stage (paper §2): pipelined (non-blocking) operators ride along in the map
phase before the blocking op or in the reduce phase after it; a second
blocking operator downstream starts a new job, with the boundary value
materialized to the artifact store.

Materialized boundaries are *content-addressed*: the dataset name is the
producing operator's plan fingerprint.  Two workflows that compute the
same intermediate therefore refer to the same artifact name — this is what
lets ReStore's Load-equivalence work across workflows (paper §3 relies on
rewritten jobs loading canonical repository filenames; content addressing
gives the same property structurally).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..core.plan import (BLOCKING_KINDS, Operator, PhysicalPlan, load, store)

MAP, REDUCE = 0, 1


class _UF:
    def __init__(self):
        self.parent: Dict[int, int] = {}
        self.n = 0

    def make(self) -> int:
        x = self.n
        self.n += 1
        self.parent[x] = x
        return x

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra
        return ra


@dataclasses.dataclass
class Job:
    job_id: int
    plan: PhysicalPlan
    inputs: List[str]          # dataset names read (sources + artifacts)
    outputs: List[str]         # dataset names written
    blocking: Optional[str]    # kind of the reduce-stage op (None = map-only)

    def depends_on(self, other: "Job") -> bool:
        return any(o in self.inputs for o in other.outputs)


@dataclasses.dataclass
class Workflow:
    jobs: List[Job]                 # topologically ordered
    final_outputs: Dict[str, str]   # user store-name -> dataset name

    def n_jobs(self) -> int:
        return len(self.jobs)


def art_name(fp: str) -> str:
    return "art/" + fp[:16]


def compile_workflow(plan: PhysicalPlan) -> Workflow:
    topo = plan.topo()

    uf = _UF()
    jobof: Dict[int, int] = {}
    phase: Dict[int, int] = {}
    has_reduce: Dict[int, bool] = {}   # keyed by uf-root
    cuts: List[Operator] = []          # ops materialized at a job boundary
    cut_set = set()

    def _has_reduce(j: int) -> bool:
        return has_reduce.get(uf.find(j), False)

    def _set_reduce(j: int):
        has_reduce[uf.find(j)] = True

    def _union(a: int, b: int) -> int:
        flag = _has_reduce(a) or _has_reduce(b)
        r = uf.union(a, b)
        if flag:
            has_reduce[uf.find(r)] = True
        return r

    def _cut(op: Operator):
        if id(op) not in cut_set:
            cut_set.add(id(op))
            cuts.append(op)

    for op in topo:
        if op.kind == "LOAD":
            continue
        infos = []
        for i in op.inputs:
            if i.kind == "LOAD":
                infos.append((i, None))
            else:
                infos.append((i, (jobof[id(i)], phase[id(i)])))

        if op.kind in BLOCKING_KINDS:
            myjob = uf.make()
            for i, info in infos:
                if info is None:
                    continue
                j, p = info
                if p == REDUCE or _has_reduce(j):
                    _cut(i)           # boundary: materialize, reload
                else:
                    myjob = _union(myjob, j)
            _set_reduce(myjob)
            jobof[id(op)], phase[id(op)] = myjob, REDUCE
            continue

        # non-blocking (FILTER/PROJECT/FOREACH/UNION/SPLIT/STORE)
        placed = [info for _, info in infos if info is not None]
        if not placed:
            jobof[id(op)], phase[id(op)] = uf.make(), MAP
        elif len(placed) == 1:
            (j, p) = placed[0]
            jobof[id(op)], phase[id(op)] = j, p
        else:
            roots = {uf.find(j) for j, _ in placed}
            phases = {p for _, p in placed}
            if len(roots) == 1 and len(phases) == 1:
                jobof[id(op)], phase[id(op)] = placed[0]
            elif phases == {MAP} and not any(_has_reduce(j) for j, _ in placed):
                j0 = placed[0][0]
                for j, _ in placed[1:]:
                    j0 = _union(j0, j)
                jobof[id(op)], phase[id(op)] = j0, MAP
            else:
                # mixed: keep the first map-phase pipeline, cut the rest
                keep = None
                for (i, info) in infos:
                    if info is None:
                        continue
                    j, p = info
                    if keep is None and p == MAP and not _has_reduce(j):
                        keep = (j, p)
                    else:
                        _cut(i)
                if keep is None:
                    keep = (uf.make(), MAP)
                jobof[id(op)], phase[id(op)] = keep

    # ---- group operators by job root --------------------------------------
    members: Dict[int, List[Operator]] = {}
    for op in topo:
        if op.kind == "LOAD":
            continue
        r = uf.find(jobof[id(op)])
        members.setdefault(r, []).append(op)

    # cut ops that are consumed by a different job than their own, plus
    # every op in `cuts`; order jobs topologically by producer->consumer
    producer_job = {id(op): uf.find(jobof[id(op)]) for op in topo
                    if op.kind != "LOAD"}

    # job dependency edges
    deps: Dict[int, set] = {r: set() for r in members}
    for op in topo:
        if op.kind == "LOAD":
            continue
        r = producer_job[id(op)]
        for i in op.inputs:
            if i.kind == "LOAD":
                continue
            ri = producer_job[id(i)]
            if ri != r:
                deps[r].add(ri)
                _cut(i)

    order: List[int] = []
    seen = set()

    def visit(r):
        if r in seen:
            return
        seen.add(r)
        for d in sorted(deps[r]):
            visit(d)
        order.append(r)

    for r in sorted(members):
        visit(r)

    # ---- build fragments in job-topo order --------------------------------
    artname: Dict[int, str] = {}      # original op id -> artifact dataset
    jobs: List[Job] = []
    final_outputs: Dict[str, str] = {}

    for jid, r in enumerate(order):
        ops = members[r]
        opset = {id(o) for o in ops}
        frag_map: Dict[int, Operator] = {}

        def rebuild(op: Operator) -> Operator:
            if id(op) in frag_map:
                return frag_map[id(op)]
            if op.kind == "LOAD":
                new = load(op.params["dataset"], op.params.get("version", 0),
                           op.params.get("capacity"), op.params.get("schema"))
            elif id(op) not in opset:
                new = load(artname[id(op)])     # boundary input
            else:
                new = Operator(op.kind, dict(op.params),
                               [rebuild(i) for i in op.inputs])
            frag_map[id(op)] = new
            return new

        sinks: List[Operator] = []
        sink_origin: Dict[int, Operator] = {}
        for op in ops:
            if op.kind == "STORE":
                s = rebuild(op)
                sinks.append(s)
                sink_origin[id(s)] = op
        # injected stores for cut ops produced here
        for op in ops:
            if id(op) in cut_set:
                s = store(rebuild(op), "pending")
                sinks.append(s)
                sink_origin[id(s)] = op

        frag = PhysicalPlan(sinks)
        fps = frag.fingerprints()
        outputs: List[str] = []
        dedup: List[Operator] = []
        for s in sinks:
            origin = sink_origin[id(s)]
            name = art_name(fps[id(s.inputs[0])])
            if origin.kind == "STORE":
                final_outputs[origin.params["name"]] = name
            else:
                artname[id(origin)] = name
            s.params["name"] = name
            if name not in outputs:
                outputs.append(name)
                dedup.append(s)
        sinks = dedup
        frag = PhysicalPlan(sinks)

        inputs = sorted({o.params["dataset"] for o in frag.loads()})
        blocking = None
        for op in ops:
            if op.kind in BLOCKING_KINDS:
                blocking = op.kind
        jobs.append(Job(jid, frag, inputs, outputs, blocking))

    return Workflow(jobs, final_outputs)
