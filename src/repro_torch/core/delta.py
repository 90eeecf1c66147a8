"""Incremental artifact maintenance: delta plans + merge operators
(DESIGN.md §12).

ReStore's rule R4 treats any input change as total loss: a version bump
deletes every dependent repository entry and the next workflow recomputes
from zero.  Real analytic inputs overwhelmingly grow by *append* (the
cross-industry workload study in PAPERS.md), so this module turns
"stale ⇒ delete" into "stale ⇒ refresh from the delta" whenever the
`Catalog` can prove the change was append-only (its append lineage,
``Catalog.append``).

For a stored entry whose plan P ran over inputs R (now R ∪ ΔR), a
*delta plan* and a *merge operator* are derived per root operator class:

  root class                  delta plan                  merge operator
  --------------------------  --------------------------  ----------------
  record-wise chain           P(Δ): changed Loads bound    append rows
  (FILTER/PROJECT/FOREACH/    to their delta rows,         (shard-local for
  UNION/SPLIT over Loads)     unchanged Loads to empty     partitioned
                                                           artifacts)
  GROUPBY, decomposable aggs  partial aggregate            re-aggregate the
  (sum/count/min/max)         G(sub(Δ))                    union of stored +
                                                           partial (count
                                                           partials SUM)
  DISTINCT                    DISTINCT(sub(Δ))             DISTINCT of union
  JOIN                        three-way delta join         append rows
                              ΔL ⋈ R' ∪ L ⋈ ΔR (L = pre-
                              append snapshot, R' = post)
  anything else (incl. non-   —                            fall back to R4
  decomposable aggregates,                                 delete+recompute
  e.g. mean)

The merged value is bit-identical to a cold recompute over the appended
inputs for append/join merges (they partition the recomputed multiset
exactly) and for min/max/count re-aggregation.  Float SUM re-aggregation
combines the stored total with the delta partial — a different
association than one pass over all rows — so it is bit-identical
exactly when the aggregation is rounding-free (integer-valued float
data within the mantissa, as in the differential tests and the delta
bench) and approximately equal otherwise, the same contract any
partial-aggregation system (combiners, M3R) offers.  The other caveat
is a both-sides-changed JOIN whose bounded probe window saturates
(``expansion`` overflow) — overflows are counted, not silent, exactly
as in normal execution.

`execute_refresh` runs the delta plan through the normal `Engine` (as a
transient job: its output never lands in the store; on the card its
GROUPBY and JOIN reach the segment-sum and probe kernels, and so does a
re-aggregation merge), applies the merge
via `ArtifactStore.append`/`merge_shards`, then rebinds the entry's plan
and ``source_versions`` to the catalog's current versions — after which
the entry matches *exactly* again (same signature a fresh plan over the
new versions fingerprints to), with no semantic compensation needed.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

from ..dataflow.compiler import Job
from ..dataflow.physical import op_distinct, op_groupby, op_union
from ..dataflow.table import Table, pad_capacity, slice_valid
from .plan import (APPEND_DISTRIBUTIVE_KINDS, Operator, PhysicalPlan, load,
                   plan_signature, rebind_load_versions, store)

# decomposable aggregate -> the aggregate that merges its partials
MERGEABLE_AGGS = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


@dataclasses.dataclass
class RefreshSpec:
    """A derived refresh: the delta plan to execute plus the merge
    operator class, bindings for its temporary Load datasets, and the
    signature the entry will carry once rebound."""
    entry: object                      # RepositoryEntry
    kind: str                          # append | reagg | distinct | join
    delta_plan: PhysicalPlan           # Load(tmp)…→root→Store(delta_name)
    delta_name: str
    bindings: Dict[str, Table]         # tmp dataset name -> bound rows
    new_versions: Dict[str, int]       # dataset -> catalog version after
    refreshed_signature: str           # entry signature after rebinding
    delta_fraction: float              # Δ rows / base rows over changed ds
    merge_keys: Tuple[str, ...] = ()   # reagg: group keys
    merge_aggs: Optional[Dict] = None  # reagg: out -> (merge fn, out col)


def _subplan_ops(op: Operator):
    return PhysicalPlan([op]).topo()


def _is_recordwise(op: Operator) -> bool:
    return all(o.kind in APPEND_DISTRIBUTIVE_KINDS for o in _subplan_ops(op))


def _empty_like(table: Table, cols=None) -> Table:
    return slice_valid(table, 0, 0, cols=cols)


def derive_refresh(entry, catalog) -> Optional["RefreshSpec"]:
    """Derive a delta plan + merge operator for a stale entry, or None
    when the entry is not incrementally maintainable (plan loads a
    boundary artifact, a changed input is off the append lineage, the
    root class has no merge operator, or an aggregate is
    non-decomposable) — the caller then falls back to R4."""
    plan = entry.plan
    if len(plan.sinks) != 1 or plan.sinks[0].kind != "STORE":
        return None
    root = plan.sinks[0].inputs[0]

    changed: Dict[str, Tuple[int, int]] = {}
    for ld in plan.loads():
        ds = ld.params["dataset"]
        v = ld.params.get("version", 0)
        if ds not in catalog.sources:
            return None            # boundary artifact / unknown dataset
        cur = catalog.version(ds)
        if cur == v:
            continue
        if not catalog.is_append_since(ds, v):
            return None            # arbitrary rewrite: R4 territory
        changed[ds] = (v, cur)
    if not changed:
        return None                # nothing stale to refresh

    bindings: Dict[str, Table] = {}
    counter = itertools.count()

    def bind(table: Table) -> str:
        nm = f"tmp$delta${next(counter)}"
        bindings[nm] = table
        return nm

    # column pruning: a Load whose consumers (in this plan) are all
    # PROJECTs only ever contributes those columns, so its delta/base
    # bindings materialize just that subset — host slicing is the bulk
    # of a small refresh's cost, and wide source rows (strings) would
    # otherwise be copied only to be projected away
    succ = plan.successors()

    def _needed_cols(ld: Operator):
        ss = succ.get(id(ld), [])
        if ss and all(s.kind == "PROJECT" for s in ss):
            cols = set()
            for s in ss:
                cols.update(s.params["cols"])
            return tuple(sorted(cols))
        return None

    def rebound(op: Operator, mode: str) -> Operator:
        """Copy of a record-wise subplan with every Load bound to the
        dataset's delta / current / pre-append rows (each occurrence
        gets its own binding, so self-joins bind independently)."""
        if op.kind == "LOAD":
            ds = op.params["dataset"]
            v = op.params.get("version", 0)
            nc = _needed_cols(op)
            if mode == "delta":
                t = catalog.delta_table(ds, v, cols=nc) if ds in changed \
                    else _empty_like(catalog.get(ds), cols=nc)
            elif mode == "base":
                t = catalog.snapshot_table(ds, v, cols=nc) \
                    if ds in changed else _full(ds, nc)
            else:                  # "full": post-append state
                t = _full(ds, nc)
            return load(bind(t))
        return Operator(op.kind, dict(op.params),
                        [rebound(i, mode) for i in op.inputs])

    def _full(ds: str, nc) -> Table:
        t = catalog.get(ds)
        return t.select(nc) if nc is not None else t

    merge_keys: Tuple[str, ...] = ()
    merge_aggs: Optional[Dict] = None
    if root.kind in APPEND_DISTRIBUTIVE_KINDS and _is_recordwise(root):
        kind = "append"
        droot = rebound(root, "delta")
    elif root.kind == "GROUPBY" and _is_recordwise(root.inputs[0]):
        if any(fn not in MERGEABLE_AGGS
               for fn, _ in root.params["aggs"].values()):
            return None            # non-decomposable (e.g. mean)
        kind = "reagg"
        droot = Operator("GROUPBY", dict(root.params),
                         [rebound(root.inputs[0], "delta")])
        merge_keys = tuple(root.params["keys"])
        merge_aggs = {out: (MERGEABLE_AGGS[fn], out)
                      for out, (fn, _c) in root.params["aggs"].items()}
    elif root.kind == "DISTINCT" and _is_recordwise(root.inputs[0]):
        kind = "distinct"
        droot = Operator("DISTINCT", {}, [rebound(root.inputs[0], "delta")])
    elif root.kind == "JOIN" and all(_is_recordwise(i) for i in root.inputs):
        kind = "join"
        left, right = root.inputs

        def side_changed(side: Operator) -> bool:
            return any(o.kind == "LOAD" and o.params["dataset"] in changed
                       for o in _subplan_ops(side))

        terms = []
        if side_changed(left):     # ΔL ⋈ R'
            terms.append(Operator("JOIN", dict(root.params),
                                  [rebound(left, "delta"),
                                   rebound(right, "full")]))
        if side_changed(right):    # L ⋈ ΔR (L = pre-append snapshot)
            terms.append(Operator("JOIN", dict(root.params),
                                  [rebound(left, "base"),
                                   rebound(right, "delta")]))
        droot = terms[0] if len(terms) == 1 \
            else Operator("UNION", {}, terms)
    else:
        return None

    # content-addressed like every job output: STORE names are excluded
    # from fingerprints, so the process-wide jit cache may serve a
    # structurally-identical delta plan's closure — outputs then arrive
    # under THAT plan's sink name, which must therefore be the same name
    delta_name = "delta/" + \
        PhysicalPlan([droot]).fingerprints()[id(droot)][:16]
    new_versions = {ld.params["dataset"]:
                    catalog.version(ld.params["dataset"])
                    for ld in plan.loads()}
    refreshed_sig = plan_signature(rebind_load_versions(plan, new_versions))

    d_rows = base_rows = 0
    for ds, (v, cur) in changed.items():
        n_old = catalog.rows_at(ds, v) or 0
        n_new = catalog.rows_at(ds, cur) or n_old
        d_rows += n_new - n_old
        base_rows += n_old
    return RefreshSpec(entry=entry, kind=kind,
                       delta_plan=PhysicalPlan([store(droot, delta_name)]),
                       delta_name=delta_name, bindings=bindings,
                       new_versions=new_versions,
                       refreshed_signature=refreshed_sig,
                       delta_fraction=d_rows / max(base_rows, 1),
                       merge_keys=merge_keys, merge_aggs=merge_aggs)


# ---------------------------------------------------------------------------
# Merge operators


# The merges run eagerly over the engine's operators (the reference
# jits them; the port has no trace to cache), on the tables' device.


def _reagg_merge_fn(old: Table, delta: Table, keys, aggs_t) -> Table:
    return op_groupby(op_union(old, delta), keys,
                      {out: (fn, col) for out, fn, col in aggs_t})


def _distinct_merge(old: Table, delta: Table) -> Table:
    return op_distinct(op_union(old, delta))


def _reagg_merge(keys, aggs):
    """Merge operator of a refreshed GROUPBY artifact: group the union
    of the stored aggregate rows and the delta partial (at most two
    partial rows per key).  min/max/count merges are exact; SUM merges
    re-associate the reduction and are bit-identical to a cold
    recompute only when the aggregation itself is rounding-free (see
    module docstring)."""
    aggs_t = tuple(sorted((out, fn, col)
                          for out, (fn, col) in aggs.items()))

    def merge(old: Table, delta: Table) -> Table:
        return _reagg_merge_fn(old, delta, tuple(keys), aggs_t)
    return merge


def execute_refresh(spec: RefreshSpec, engine, store_, catalog) -> object:
    """Execute a derived refresh through the normal `Engine`: run the
    delta plan as a transient job (its output is returned, never put in
    the store), merge into the stored artifact — shard-locally when the
    artifact is partitioned and its partition keys co-locate each merge
    group — then rebind the entry's plan/signature/source_versions to
    the catalog's current versions so it matches exactly again.  The
    caller (`Repository`) re-indexes the entry under its new signature.
    Returns the delta job's `JobStats`."""
    entry = spec.entry
    n_shards = getattr(engine, "n_shards", None)
    bindings = spec.bindings
    if n_shards:
        bindings = {nm: pad_capacity(t, n_shards)
                    for nm, t in bindings.items()}
    job = Job(job_id=-1, plan=spec.delta_plan,
              inputs=sorted(bindings), outputs=[spec.delta_name],
              blocking=None)
    for nm, t in bindings.items():
        catalog.sources[nm] = t
    try:
        outputs, stats = engine.run_job(job, transient=True)
    finally:
        for nm in bindings:
            catalog.sources.pop(nm, None)
    delta = outputs[spec.delta_name]

    part = store_.partitioning(entry.artifact)
    if spec.kind in ("append", "join"):
        store_.append(entry.artifact, delta)
    else:
        merge = _reagg_merge(spec.merge_keys, spec.merge_aggs) \
            if spec.kind == "reagg" else _distinct_merge
        local_ok = part is not None and (
            spec.kind == "distinct"        # equal rows share a shard
            or set(part["keys"]) <= set(spec.merge_keys))
        if local_ok:
            store_.merge_shards(entry.artifact, delta, merge_fn=merge)
        else:
            # monolithic artifact — or partition keys that don't
            # co-locate the merge groups (re-put monolithic: a safe
            # downgrade, never a wrong skip).  Compact the loaded value
            # first: a memory-backend artifact keeps its producer's full
            # capacity (disk compaction lives on the flusher), and
            # merging at that width would cost as much as recomputing.
            # Power-of-two capacities, as in the reference, so the merged
            # value has the reference's capacity.
            old = slice_valid(store_.get(entry.artifact), 0,
                              round_pow2=True)
            merged = merge(old, slice_valid(delta, 0, round_pow2=True))
            store_.put(entry.artifact, merged)

    entry.plan = rebind_load_versions(entry.plan, spec.new_versions)
    entry.signature = spec.refreshed_signature
    assert plan_signature(entry.plan) == entry.signature
    entry.source_versions = dict(spec.new_versions)
    entry.bytes_out = store_.nbytes(entry.artifact)
    entry.partitioning = store_.partitioning(entry.artifact)
    return stats
