"""Physical plan IR: DAGs of physical operators, exactly the abstraction
ReStore matches and rewrites (paper §2, §3).

Operator kinds (the Pig physical-operator set used by the paper):
  LOAD, STORE, PROJECT, FOREACH, FILTER, JOIN, GROUPBY, COGROUP,
  DISTINCT, UNION, SPLIT.

Every operator has a canonical ``local_sig`` (kind + parameters) and a
Merkle ``fingerprint`` (sha256 over local_sig + input fingerprints).  Two
operators are *equivalent* in the paper's sense — same function over
equivalent inputs — iff their fingerprints are equal.  LOAD fingerprints
include the dataset version, which implements eviction rule R4 (modified
inputs never match) structurally.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ..dataflow.expr import Col, Expr, agg_key, pred_normal_key

# operator kinds whose inputs are order-insensitive
_COMMUTATIVE_KINDS = {"UNION"}
# operators that force a shuffle boundary (map -> reduce)
BLOCKING_KINDS = {"JOIN", "GROUPBY", "COGROUP", "DISTINCT"}
# operators that distribute over input append — F(R ∪ ΔR) = F(R) ∪ F(ΔR)
# record-wise — so a plan built only from these refreshes a stale
# artifact by appending the delta plan's rows (DESIGN.md §12)
APPEND_DISTRIBUTIVE_KINDS = frozenset(
    {"LOAD", "FILTER", "PROJECT", "FOREACH", "UNION", "SPLIT"})


_op_counter = itertools.count()


@dataclasses.dataclass(eq=False)
class Operator:
    kind: str
    params: Dict
    inputs: List["Operator"]
    uid: int = dataclasses.field(default_factory=lambda: next(_op_counter))

    # ------------------------------------------------------------------
    def param_key(self) -> Tuple:
        p = self.params
        k = self.kind
        if k == "LOAD":
            return (p["dataset"], p.get("version", 0))
        if k == "STORE":
            return ()  # store target name is irrelevant for equivalence
        if k == "PROJECT":
            return tuple(sorted(p["cols"]))
        if k == "FOREACH":
            return tuple(sorted((n, e.key()) for n, e in p["gens"].items()))
        if k == "FILTER":
            # normalized digest: commuted / reassociated conjuncts
            # fingerprint equal (DESIGN.md §10)
            return pred_normal_key(p["pred"])
        if k == "JOIN":
            return (tuple(p["left_keys"]), tuple(p["right_keys"]),
                    p.get("expansion", 1))
        if k == "GROUPBY":
            return (tuple(sorted(p["keys"])), agg_key(p["aggs"]))
        if k == "COGROUP":
            return (tuple(p["keys_left"]), tuple(p["keys_right"]),
                    agg_key(p["aggs_left"]), agg_key(p["aggs_right"]))
        if k in ("DISTINCT", "UNION", "SPLIT"):
            return ()
        raise ValueError(f"unknown operator kind {k}")

    def local_sig(self) -> Tuple:
        return (self.kind, self.param_key())

    def __repr__(self):
        return f"{self.kind}#{self.uid}"


# ---------------------------------------------------------------------------
# Builder helpers


def load(dataset: str, version: int = 0, capacity: int | None = None,
         schema=None) -> Operator:
    return Operator("LOAD", dict(dataset=dataset, version=version,
                                 capacity=capacity, schema=schema), [])


def store(inp: Operator, name: str) -> Operator:
    return Operator("STORE", dict(name=name), [inp])


def project(inp: Operator, cols: Sequence[str]) -> Operator:
    return Operator("PROJECT", dict(cols=tuple(cols)), [inp])


def foreach(inp: Operator, gens: Dict[str, Expr]) -> Operator:
    return Operator("FOREACH", dict(gens=dict(gens)), [inp])


def filter_(inp: Operator, pred: Expr) -> Operator:
    return Operator("FILTER", dict(pred=pred), [inp])


def join(left: Operator, right: Operator, left_keys, right_keys,
         expansion: int = 1) -> Operator:
    return Operator("JOIN", dict(left_keys=tuple(left_keys),
                                 right_keys=tuple(right_keys),
                                 expansion=expansion), [left, right])


def groupby(inp: Operator, keys, aggs: Dict[str, Tuple[str, str]]) -> Operator:
    return Operator("GROUPBY", dict(keys=tuple(keys), aggs=dict(aggs)), [inp])


def cogroup(left: Operator, right: Operator, keys_left, keys_right,
            aggs_left, aggs_right) -> Operator:
    return Operator("COGROUP", dict(keys_left=tuple(keys_left),
                                    keys_right=tuple(keys_right),
                                    aggs_left=dict(aggs_left),
                                    aggs_right=dict(aggs_right)),
                    [left, right])


def distinct(inp: Operator) -> Operator:
    return Operator("DISTINCT", {}, [inp])


def union(a: Operator, b: Operator) -> Operator:
    return Operator("UNION", {}, [a, b])


def split(inp: Operator) -> Operator:
    return Operator("SPLIT", {}, [inp])


# ---------------------------------------------------------------------------
# Plan


@dataclasses.dataclass
class PhysicalPlan:
    """A DAG identified by its sink operators (STOREs)."""

    sinks: List[Operator]

    # -- traversal -----------------------------------------------------------
    def topo(self) -> List[Operator]:
        seen: Dict[int, Operator] = {}
        order: List[Operator] = []

        def visit(op: Operator):
            if id(op) in seen:
                return
            seen[id(op)] = op
            for i in op.inputs:
                visit(i)
            order.append(op)

        for s in self.sinks:
            visit(s)
        return order

    def loads(self) -> List[Operator]:
        return [o for o in self.topo() if o.kind == "LOAD"]

    def successors(self) -> Dict[int, List[Operator]]:
        succ: Dict[int, List[Operator]] = {id(o): [] for o in self.topo()}
        for o in self.topo():
            for i in o.inputs:
                succ[id(i)].append(o)
        return succ

    # -- fingerprints ----------------------------------------------------------
    def _fingerprints(self, version_sensitive: bool) -> Dict[int, str]:
        fp: Dict[int, str] = {}
        for op in self.topo():
            in_fps = [fp[id(i)] for i in op.inputs]
            if op.kind in _COMMUTATIVE_KINDS:
                in_fps = sorted(in_fps)
            sig = op.local_sig()
            if not version_sensitive and op.kind == "LOAD":
                sig = (op.kind, (op.params["dataset"],))
            h = hashlib.sha256(
                repr((sig, tuple(in_fps))).encode()).hexdigest()
            fp[id(op)] = h
        return fp

    def fingerprints(self) -> Dict[int, str]:
        return self._fingerprints(version_sensitive=True)

    def structural_fingerprints(self) -> Dict[int, str]:
        """Fingerprints with LOAD dataset *versions* masked out.

        Artifact identity must be version-sensitive (eviction rule R4:
        a churned input invalidates the artifact), but the cost model's
        plan *statistics* should not be — "this operator recurs and is
        expensive" survives a dataset version bump.  Statistics are
        therefore keyed by this version-blind variant (DESIGN.md §9)."""
        return self._fingerprints(version_sensitive=False)

    def fingerprint_of(self, op: Operator) -> str:
        return self.fingerprints()[id(op)]

    # -- rewriting -------------------------------------------------------------
    def replace(self, old: Operator, new: Operator) -> "PhysicalPlan":
        """Return a new plan with ``old``'s subtree replaced by ``new``.

        Downstream operators are rebuilt; untouched subgraphs are shared.
        """
        mapping: Dict[int, Operator] = {id(old): new}

        def rebuild(op: Operator) -> Operator:
            if id(op) in mapping:
                return mapping[id(op)]
            new_inputs = [rebuild(i) for i in op.inputs]
            if all(a is b for a, b in zip(new_inputs, op.inputs)):
                mapping[id(op)] = op
            else:
                mapping[id(op)] = Operator(op.kind, dict(op.params), new_inputs)
            return mapping[id(op)]

        return PhysicalPlan([rebuild(s) for s in self.sinks])

    def subplan_upto(self, op: Operator, store_name: str) -> "PhysicalPlan":
        """The paper's sub-job J_P: everything from the Loads up to and
        including ``op``, terminated by a Store (paper §4)."""
        if op.kind == "STORE":
            return PhysicalPlan([op])
        return PhysicalPlan([store(op, store_name)])

    def describe(self) -> str:
        lines = []
        for op in self.topo():
            ins = ",".join(repr(i) for i in op.inputs)
            lines.append(f"{op!r}({ins}) {op.param_key()}")
        return "\n".join(lines)

    def n_ops(self) -> int:
        return len(self.topo())


def rebind_load_versions(plan: PhysicalPlan,
                         versions: Dict[str, int]) -> PhysicalPlan:
    """Return a copy of ``plan`` whose LOAD operators carry the given
    dataset versions (untouched subgraphs are shared, like `replace`).

    Workload drivers build queries from version-agnostic templates; this
    stamps the catalog's *current* versions into the plan so that LOAD
    fingerprints — and therefore matching — respect rule R4 after
    dataset churn."""
    mapping: Dict[int, Operator] = {}

    def rebuild(op: Operator) -> Operator:
        if id(op) in mapping:
            return mapping[id(op)]
        if op.kind == "LOAD":
            ds = op.params["dataset"]
            if ds in versions and op.params.get("version", 0) != versions[ds]:
                new = Operator("LOAD", dict(op.params), [])
                new.params["version"] = versions[ds]
            else:
                new = op
        else:
            new_inputs = [rebuild(i) for i in op.inputs]
            if all(a is b for a, b in zip(new_inputs, op.inputs)):
                new = op
            else:
                new = Operator(op.kind, dict(op.params), new_inputs)
        mapping[id(op)] = new
        return new

    return PhysicalPlan([rebuild(s) for s in plan.sinks])


# ---------------------------------------------------------------------------
# Partitioning: the physical property behind shuffle-free reuse
# (DESIGN.md §11).  A value is *hash-partitioned* when row r lives on
# shard ``partition_hash(keys)(r) % n_parts`` — the property the mesh
# exchange establishes and FILTER/PROJECT/FOREACH preserve (M3R's
# partition stability).  It is a PHYSICAL property: it never enters
# operator fingerprints, so a partitioned and a monolithic artifact of
# the same value are interchangeable for matching, but a consumer that
# finds the property compatible skips its exchange entirely.


@dataclasses.dataclass(frozen=True)
class Partitioning:
    keys: Tuple[str, ...]          # ordered: the hash is positional
    n_parts: int
    scheme: str = "hash_mod"

    def covers(self, keys, n_parts: int) -> bool:
        """True when data partitioned this way is already co-located for
        a grouping exchange on ``keys`` across ``n_parts`` shards: rows
        equal on ``keys`` are equal on any subset, so they share a
        shard.  (JOIN sides need `aligns`, not `covers`: subset hashing
        would break positional agreement between the two sides.)"""
        return (self.scheme == "hash_mod" and self.n_parts == n_parts
                and set(self.keys) <= set(keys))

    def aligns(self, keys, n_parts: int) -> bool:
        """Exact positional match — required for JOIN/COGROUP sides."""
        return (self.scheme == "hash_mod" and self.n_parts == n_parts
                and tuple(self.keys) == tuple(keys))

    def to_dict(self) -> Dict:
        return {"keys": list(self.keys), "n_parts": self.n_parts,
                "scheme": self.scheme}

    @staticmethod
    def from_dict(d) -> "Optional[Partitioning]":
        if d is None:
            return None
        if isinstance(d, Partitioning):
            return d
        return Partitioning(tuple(d["keys"]), int(d["n_parts"]),
                            d.get("scheme", "hash_mod"))


@dataclasses.dataclass
class PlanProps:
    """Static physical properties of a plan under mesh execution:
    per-op output partitioning, per-blocking-op exchange-skip flags
    (one bool per table input), and per-op output column names."""
    part: Dict[int, Optional[Partitioning]]
    skip: Dict[int, Tuple[bool, ...]]
    schema: Dict[int, Tuple[str, ...]]

    def n_exchanges(self) -> int:
        return sum(len(v) for v in self.skip.values())

    def n_skipped(self) -> int:
        return sum(1 for v in self.skip.values() for s in v if s)


def _join_out_names(left_names, right_names):
    out = list(left_names)
    for n in right_names:
        out.append(n if n not in out else n + "_r")
    return tuple(sorted(out))


def plan_physical_props(plan: PhysicalPlan,
                        dataset_parts: Dict[str, Optional[Partitioning]],
                        dataset_schemas: Dict[str, Tuple[str, ...]],
                        n_parts: Optional[int]) -> PlanProps:
    """Propagate the partition property through a plan (DESIGN.md §11).

    ``dataset_parts``/``dataset_schemas`` describe the LOAD-able inputs
    (artifact manifests + catalog tables); ``n_parts`` is the mesh's
    shuffle-axis size (None = single device, everything unpartitioned).
    Rules: FILTER/SPLIT/STORE preserve; PROJECT preserves iff the keys
    survive; FOREACH preserves iff every key column is an identity
    generator; blocking operators inherit a covering input property
    (their exchange is skipped) or establish a fresh one on their keys;
    UNION destroys the property (concatenation breaks block layout)."""
    part: Dict[int, Optional[Partitioning]] = {}
    skip: Dict[int, Tuple[bool, ...]] = {}
    schema: Dict[int, Tuple[str, ...]] = {}

    for op in plan.topo():
        p = op.params
        in_parts = [part[id(i)] for i in op.inputs]
        in_schemas = [schema[id(i)] for i in op.inputs]
        out_part: Optional[Partitioning] = None
        out_schema: Tuple[str, ...] = in_schemas[0] if in_schemas else ()

        if op.kind == "LOAD":
            # ONLY the store-backed property (dataset_parts) is trusted:
            # a rewriter-spliced LOAD also carries the repository entry's
            # claim in params["partitioning"], but that claim can go
            # stale (e.g. the artifact re-written monolithic by a
            # partition-blind run) and a wrongly-granted skip silently
            # corrupts aggregates
            out_part = Partitioning.from_dict(
                dataset_parts.get(p["dataset"]))
            if n_parts is None or (out_part is not None
                                   and out_part.n_parts != n_parts):
                out_part = None     # mismatched P: no locality to exploit
            out_schema = tuple(sorted(dataset_schemas.get(p["dataset"], ())))
        elif op.kind in ("FILTER", "SPLIT", "STORE"):
            out_part = in_parts[0]
        elif op.kind == "PROJECT":
            out_schema = tuple(sorted(p["cols"]))
            ip = in_parts[0]
            out_part = ip if ip and set(ip.keys) <= set(p["cols"]) else None
        elif op.kind == "FOREACH":
            out_schema = tuple(sorted(p["gens"]))
            ip = in_parts[0]
            if ip and all(isinstance(p["gens"].get(k), Col)
                          and p["gens"][k].name == k for k in ip.keys):
                out_part = ip
        elif op.kind == "UNION":
            out_part = None
        elif op.kind == "GROUPBY":
            keys = tuple(p["keys"])
            out_schema = tuple(sorted(set(keys) | set(p["aggs"])))
            if n_parts is not None:
                ip = in_parts[0]
                if ip is not None and ip.covers(keys, n_parts):
                    skip[id(op)] = (True,)
                    out_part = ip          # partition stability
                else:
                    skip[id(op)] = (False,)
                    out_part = Partitioning(keys, n_parts)
        elif op.kind == "DISTINCT":
            # the exchange keys are ALL columns; any partitioning on a
            # subset of them co-locates equal rows
            if n_parts is not None:
                ip = in_parts[0]
                if ip is not None and ip.covers(out_schema, n_parts):
                    skip[id(op)] = (True,)
                    out_part = ip
                else:
                    skip[id(op)] = (False,)
                    out_part = Partitioning(out_schema, n_parts)
        elif op.kind == "JOIN":
            lkeys, rkeys = tuple(p["left_keys"]), tuple(p["right_keys"])
            out_schema = _join_out_names(in_schemas[0], in_schemas[1])
            if n_parts is not None:
                sl = in_parts[0] is not None \
                    and in_parts[0].aligns(lkeys, n_parts)
                sr = in_parts[1] is not None \
                    and in_parts[1].aligns(rkeys, n_parts)
                skip[id(op)] = (sl, sr)
                out_part = Partitioning(lkeys, n_parts)
        elif op.kind == "COGROUP":
            kl, kr = tuple(p["keys_left"]), tuple(p["keys_right"])
            out_schema = tuple(sorted(
                set(kl) | {f"l_{n}" for n in p["aggs_left"]}
                | {f"r_{n}" for n in p["aggs_right"]}))
            if n_parts is not None:
                sl = in_parts[0] is not None \
                    and in_parts[0].aligns(kl, n_parts)
                sr = in_parts[1] is not None \
                    and in_parts[1].aligns(kr, n_parts)
                both = sl and sr      # the unioned exchange is one unit
                skip[id(op)] = (both, both)
                out_part = Partitioning(kl, n_parts)

        part[id(op)] = out_part
        schema[id(op)] = out_schema
    return PlanProps(part, skip, schema)


# operators an input's partition property survives on the way to its
# first blocking consumer.  PROJECT needs no column check HERE: the
# demand keys come from the blocking consumer itself, and keys a
# consumer exchanges on necessarily survived every projection between
# the Load and that consumer (they exist in its input).
_PART_PRESERVING = {"FILTER", "SPLIT", "STORE", "PROJECT"}


def load_partition_demands(plan: PhysicalPlan) -> Dict[str, Tuple[str, ...]]:
    """dataset name -> the key tuple its first blocking consumer
    exchanges on, walking through partition-preserving operators.  The
    engine uses this to re-partition a mismatched-P artifact on read
    (DESIGN.md §11) so the consumer's exchange can still be skipped."""
    succ = plan.successors()
    out: Dict[str, Tuple[str, ...]] = {}
    for ld in plan.loads():
        frontier = [ld]
        seen = set()
        demand = None
        while frontier and demand is None:
            op = frontier.pop()
            for s in succ.get(id(op), []):
                if id(s) in seen:
                    continue
                seen.add(id(s))
                if s.kind == "GROUPBY":
                    demand = tuple(s.params["keys"])
                elif s.kind == "JOIN":
                    demand = tuple(s.params["left_keys"]) \
                        if s.inputs[0] is op else \
                        tuple(s.params["right_keys"])
                elif s.kind == "COGROUP":
                    demand = tuple(s.params["keys_left"]) \
                        if s.inputs[0] is op else \
                        tuple(s.params["keys_right"])
                elif s.kind in _PART_PRESERVING:
                    frontier.append(s)
                if demand:
                    break
        if demand:
            out[ld.params["dataset"]] = demand
    return out


def plan_signature(plan: PhysicalPlan) -> str:
    """Fingerprint of a single-sink plan's *output* (pre-Store), used as the
    repository key: two plans with the same signature compute the same
    result from the same inputs."""
    assert len(plan.sinks) == 1
    sink = plan.sinks[0]
    target = sink.inputs[0] if sink.kind == "STORE" else sink
    return plan.fingerprints()[id(target)]
