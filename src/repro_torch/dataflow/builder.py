"""Pig-style fluent dataflow builder (DESIGN.md §16).

ReStore's user interface in the paper is Pig Latin: scripts are chains
of LOAD / FILTER / FOREACH / GROUP / JOIN / STORE statements that the
Pig compiler lowers to MapReduce plans.  This module is that front-end
for our engine — a small immutable builder whose methods mirror Pig
statements and whose ``build()`` lowers to the existing
:class:`~core.plan.PhysicalPlan`:

    plan = (Dataflow.load("page_views")
            .filter(col("timespent") > 10)
            .group_by("user", views=("count", "user"))
            .store("out")
            .build())

Every method delegates to the ``core.plan`` free-function constructors,
so the compiled operators carry *identical* params — and therefore
identical Merkle fingerprints — to hand-built plans.  That identity is
load-bearing: fingerprints are the reuse currency (repository keys,
singleflight keys, MQO sharing keys), so the front-end must be a pure
notation change.  ``tests/test_builder.py`` pins this with a
fingerprint-equality sweep over all PigMix templates plus random
programs.

Builders are immutable: each method returns a *new* ``Dataflow``
wrapping a new operator DAG node, so intermediate flows can be reused
to express DAG fan-out naturally::

    scan = Dataflow.load("synth").filter(col("f0") > 3)
    a = scan.group_by("f1", n=("count", "f1")).store("a")
    b = scan.distinct().store("b")

``as_plan`` is the coercion point the unified submission surface
(``ReStore.run`` / ``ReStoreService.submit`` / ``submit_batch``) funnels
through: it accepts a ``Dataflow`` or a ``PhysicalPlan`` and always
hands back a plan.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

from ..core import plan as P
from ..core.plan import Operator, PhysicalPlan
from .expr import AGG_FNS, Col, Expr

__all__ = ["Dataflow", "col", "as_plan"]


def col(name: str) -> Col:
    """Column reference for builder predicates / generators:
    ``col("timespent") > 10`` builds the same ``Expr`` tree as
    ``Col("timespent") > Const(10)``."""
    return Col(name)


def _keys(keys) -> List[str]:
    """Normalize a key spec: a bare column name or a sequence of them."""
    if isinstance(keys, str):
        return [keys]
    return list(keys)


def _check_aggs(aggs: Dict[str, Tuple[str, str]], where: str) -> None:
    for out, spec in aggs.items():
        if (not isinstance(spec, tuple)) or len(spec) != 2:
            raise TypeError(
                f"{where}: agg {out!r} must be a (fn, column) tuple, "
                f"got {spec!r}")
        fn, c = spec
        if fn not in AGG_FNS:
            raise ValueError(
                f"{where}: unknown agg fn {fn!r} for {out!r} "
                f"(expected one of {AGG_FNS})")
        if not isinstance(c, str):
            raise TypeError(
                f"{where}: agg {out!r} column must be a str, got {c!r}")


class Dataflow:
    """One relation in a Pig-style script, wrapping the operator that
    produces it.  Immutable — every method returns a new ``Dataflow``."""

    __slots__ = ("_op",)

    def __init__(self, op: Operator):
        self._op = op

    # -- source -----------------------------------------------------------

    @classmethod
    def load(cls, dataset: str, version: int = 0, capacity: int = None,
             schema=None) -> "Dataflow":
        return cls(P.load(dataset, version=version, capacity=capacity,
                          schema=schema))

    # -- per-row (map-side) statements ------------------------------------

    def filter(self, pred: Expr) -> "Dataflow":
        if not isinstance(pred, Expr):
            raise TypeError(f"filter() wants an Expr predicate, built "
                            f"e.g. from col(...); got {pred!r}")
        return Dataflow(P.filter_(self._op, pred))

    def project(self, *cols: str) -> "Dataflow":
        if len(cols) == 1 and not isinstance(cols[0], str):
            cols = tuple(cols[0])        # .project(["a", "b"]) also works
        return Dataflow(P.project(self._op, cols))

    def foreach(self, **gens: Expr) -> "Dataflow":
        """Pig's FOREACH ... GENERATE: keyword args name the generated
        columns, values are expressions over input columns."""
        out = {}
        for name, g in gens.items():
            out[name] = Col(g) if isinstance(g, str) else g
        return Dataflow(P.foreach(self._op, out))

    # -- blocking statements ----------------------------------------------

    def group_by(self, *keys, **aggs: Tuple[str, str]) -> "Dataflow":
        """Pig's GROUP ... + FOREACH GENERATE agg(...): positional args
        are the grouping keys, keyword args map output column ->
        ``(fn, column)`` with fn in ``AGG_FNS``."""
        if len(keys) == 1 and not isinstance(keys[0], str):
            keys = tuple(keys[0])
        _check_aggs(aggs, "group_by")
        return Dataflow(P.groupby(self._op, keys, aggs))

    def join(self, other: "Dataflow", on=None, *, left_on=None,
             right_on=None, expansion: int = 1) -> "Dataflow":
        """Pig's JOIN a BY k, b BY k2: either ``on=`` (same key names on
        both sides) or ``left_on=`` / ``right_on=``."""
        if on is not None:
            if left_on is not None or right_on is not None:
                raise TypeError("join(): pass either on= or "
                                "left_on=/right_on=, not both")
            left_on = right_on = on
        if left_on is None or right_on is None:
            raise TypeError("join(): key columns required "
                            "(on= or left_on=/right_on=)")
        return Dataflow(P.join(self._op, _as_op(other), _keys(left_on),
                               _keys(right_on), expansion=expansion))

    def cogroup(self, other: "Dataflow", *, on=None, left_on=None,
                right_on=None, left_aggs: Dict[str, Tuple[str, str]],
                right_aggs: Dict[str, Tuple[str, str]]) -> "Dataflow":
        if on is not None:
            left_on = right_on = on
        if left_on is None or right_on is None:
            raise TypeError("cogroup(): key columns required "
                            "(on= or left_on=/right_on=)")
        _check_aggs(left_aggs, "cogroup")
        _check_aggs(right_aggs, "cogroup")
        return Dataflow(P.cogroup(self._op, _as_op(other), _keys(left_on),
                                  _keys(right_on), left_aggs, right_aggs))

    def distinct(self) -> "Dataflow":
        return Dataflow(P.distinct(self._op))

    def union(self, other: "Dataflow") -> "Dataflow":
        return Dataflow(P.union(self._op, _as_op(other)))

    # -- sink / lowering --------------------------------------------------

    def store(self, name: str) -> "Dataflow":
        return Dataflow(P.store(self._op, name))

    def build(self, *sibling_sinks: "Dataflow") -> PhysicalPlan:
        """Lower to a ``PhysicalPlan``.  The flow must end in ``store``;
        extra stored flows may be passed to build a multi-sink plan."""
        sinks = []
        for flow in (self,) + sibling_sinks:
            op = _as_op(flow)
            if op.kind != "STORE":
                raise ValueError(
                    "build(): call .store(name) before .build() "
                    f"(flow ends in {op.kind})")
            sinks.append(op)
        return PhysicalPlan(sinks)

    # -- introspection ----------------------------------------------------

    @property
    def op(self) -> Operator:
        """The underlying operator (escape hatch to core.plan wiring)."""
        return self._op

    def __repr__(self) -> str:
        return f"Dataflow<{self._op.kind}>"


def _as_op(flow: Union[Dataflow, Operator]) -> Operator:
    if isinstance(flow, Dataflow):
        return flow._op
    if isinstance(flow, Operator):
        return flow
    raise TypeError(f"expected a Dataflow (or Operator), got {flow!r}")


def as_plan(query: Union[Dataflow, PhysicalPlan]) -> PhysicalPlan:
    """Coerce the unified submission surface's input to a plan: accepts
    a ``PhysicalPlan`` (passed through) or a stored ``Dataflow``
    (lowered via ``build()``)."""
    if isinstance(query, PhysicalPlan):
        return query
    if isinstance(query, Dataflow):
        return query.build()
    raise TypeError(
        f"expected a PhysicalPlan or dataflow builder, got {type(query)!r}")
