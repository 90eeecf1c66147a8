"""The traffic files' PigMix plans, lowered to the program's plan
objects (``repro_torch.core.plan``'s constructors, whose plans take the
same fingerprints as the port's builder DSL).

A plan is a nested list: ``["store", name, child]``, ``["load",
dataset]``, ``["project", child, cols]``, ``["filter", child, expr]``,
``["foreach", child, {name: expr}]``, ``["join", left, right, left_on,
right_on]``, ``["group_by", child, keys, {name: [fn, col]}]``,
``["distinct", child]``, ``["union", a, b]``.  An expression is
``["col", name]``, ``["const", v]``, ``["param", name]``, ``["cast", e,
dtype]`` or ``[op, a, b]`` with op one of lt le gt ge eq ne add sub mul
div.  ``reference/pigmix_ref.py`` evaluates the same lists."""
from __future__ import annotations

from typing import Dict

import numpy as np


def draw_params(spec: Dict, rng: np.random.Generator) -> Dict:
    """One value of each parameter: ``["uniform", lo, hi]`` (a float32
    value as a Python float) or ``["integers", lo, hi]`` (hi excluded)."""
    out = {}
    for name, (kind, lo, hi) in sorted(spec.items()):
        if kind == "uniform":
            out[name] = float(np.float32(rng.uniform(lo, hi)))
        elif kind == "integers":
            out[name] = int(rng.integers(lo, hi))
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
    return out


def setup_params(spec: Dict, rng: np.random.Generator) -> Dict:
    """Constants no window draw can take: a float from a stream of its
    own, an integer one below its range."""
    out = {}
    for name, (kind, lo, hi) in sorted(spec.items()):
        out[name] = float(np.float32(rng.uniform(lo, hi))) \
            if kind == "uniform" else int(lo) - 1
    return out


def lower(node, params: Dict, versions: Dict[str, int]):
    """A ``PhysicalPlan`` of the program for one plan of a traffic file,
    its loads bound to the catalog's current versions."""
    from repro_torch.core import plan as P
    from repro_torch.core.plan import rebind_load_versions
    from repro_torch.dataflow.expr import BinOp, Cast, Col, Const

    def ex(e):
        op = e[0]
        if op == "col":
            return Col(e[1])
        if op == "const":
            return Const(e[1])
        if op == "param":
            return Const(params[e[1]])
        if op == "cast":
            return Cast(ex(e[1]), e[2])
        return BinOp(op, ex(e[1]), ex(e[2]))

    def lo(n):
        op = n[0]
        if op == "load":
            return P.load(n[1])
        if op == "project":
            return P.project(lo(n[1]), list(n[2]))
        if op == "filter":
            return P.filter_(lo(n[1]), ex(n[2]))
        if op == "foreach":
            return P.foreach(lo(n[1]), {k: ex(e) for k, e in n[2].items()})
        if op == "join":
            return P.join(lo(n[1]), lo(n[2]), list(n[3]), list(n[4]))
        if op == "group_by":
            return P.groupby(lo(n[1]), list(n[2]),
                             {k: (f, c) for k, (f, c) in n[3].items()})
        if op == "distinct":
            return P.distinct(lo(n[1]))
        if op == "union":
            return P.union(lo(n[1]), lo(n[2]))
        raise ValueError(f"unknown operator {op!r}")

    stores = node if node[0] != "store" else [node]
    plan = P.PhysicalPlan([P.store(lo(s[2]), s[1]) for s in stores])
    return rebind_load_versions(plan, versions)
