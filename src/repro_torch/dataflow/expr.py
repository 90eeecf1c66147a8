"""Row expressions for Filter predicates and ForEach generators.

Expressions are tiny trees with (a) a PyTorch evaluator over a Table and (b) a
canonical ``key()`` used for operator-equivalence tests and plan
fingerprints (paper §3: two operators are equivalent iff they perform the
same function over equivalent inputs).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .table import Table, encode_strings, torch_dtype


class Expr:
    def key(self) -> Tuple:
        raise NotImplementedError

    def eval(self, t: Table) -> torch.Tensor:
        raise NotImplementedError

    # sugar
    def _bin(self, op, other):
        other = other if isinstance(other, Expr) else Const(other)
        return BinOp(op, self, other)

    def __add__(self, o):
        return self._bin("add", o)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __mod__(self, o):
        return self._bin("mod", o)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("eq", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("ne", o)

    def __lt__(self, o):
        return self._bin("lt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __and__(self, o):
        return self._bin("and", o)

    def __or__(self, o):
        return self._bin("or", o)

    def __hash__(self):
        return hash(self.key())


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def key(self):
        return ("col", self.name)

    def eval(self, t):
        return t.col(self.name)


@dataclasses.dataclass(frozen=True, eq=False)
class Const(Expr):
    value: object  # int | float | str

    def key(self):
        return ("const", repr(self.value))

    def eval(self, t):
        # 0-d tensors of the reference's 32-bit dtypes: torch.tensor(1)
        # would be int64 and widen every column it touches
        dev = t.device
        if isinstance(self.value, str):
            return torch.from_numpy(encode_strings([self.value])[0]).to(dev)
        if isinstance(self.value, (bool, np.bool_)):
            return torch.tensor(self.value, dtype=torch.bool, device=dev)
        if isinstance(self.value, (int, np.integer)):
            return torch.tensor(self.value, dtype=torch.int32, device=dev)
        return torch.tensor(self.value, dtype=torch.float32, device=dev)


_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / torch.where(b == 0, torch.ones_like(b), b),
    "mod": lambda a, b: a % torch.where(b == 0, torch.ones_like(b), b),
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
}

_COMMUTATIVE = {"add", "mul", "eq", "ne", "and", "or"}


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def key(self):
        lk, rk = self.lhs.key(), self.rhs.key()
        if self.op in _COMMUTATIVE and rk < lk:  # canonical arg order
            lk, rk = rk, lk
        return ("bin", self.op, lk, rk)

    def eval(self, t):
        a, b = self.lhs.eval(t), self.rhs.eval(t)
        if a.ndim == 2 or (hasattr(b, "ndim") and b.ndim >= 1
                           and b.shape[-1:] == a.shape[-1:] and a.ndim == 2):
            # fixed-width string comparison: reduce across width
            r = _OPS[self.op](a, b)
            if self.op in ("eq",):
                return r.all(dim=-1)
            if self.op in ("ne",):
                return r.any(dim=-1)
            return r
        return _OPS[self.op](a, b)


@dataclasses.dataclass(frozen=True, eq=False)
class Cast(Expr):
    inner: Expr
    dtype: str

    def key(self):
        return ("cast", self.dtype, self.inner.key())

    def eval(self, t):
        return self.inner.eval(t).to(torch_dtype(self.dtype))


# Aggregation spec used by GROUPBY / COGROUP: (fn, column) pairs.
AGG_FNS = ("sum", "count", "min", "max", "mean")


def agg_key(aggs) -> Tuple:
    """aggs: dict outname -> (fn, colname)."""
    return tuple(sorted((o, fn, c) for o, (fn, c) in aggs.items()))


# ---------------------------------------------------------------------------
# Predicate normalization & implication (DESIGN.md §10)
#
# Filter predicates are normalized to conjunctive normal form over *atoms*:
# a comparison of one column against a constant (structured atom, open to
# interval reasoning) or any other boolean leaf (opaque atom, compared by
# canonical key only).  The normal form powers
#   * normalized FILTER fingerprints  — commuted / reassociated conjuncts
#     hash equal (``pred_normal_key``);
#   * subsumption checks              — ``implies(p, q)`` decides whether
#     every row satisfying p also satisfies q;
#   * compensation                    — ``residual_pred(p, q)`` is the part
#     of p a stored σ_q artifact still needs re-applied on top.

_CMP_OPS = frozenset({"lt", "le", "gt", "ge", "eq", "ne"})
_CMP_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
             "eq": "eq", "ne": "ne"}


@dataclasses.dataclass(frozen=True, eq=False)
class Atom:
    """One boolean leaf of a normalized predicate.  Compare atoms via
    ``key()`` — generated equality would recurse into ``expr``, whose
    ``==`` is overloaded to build expression nodes.

    ``col``/``op``/``value`` are set only for the structured
    column-vs-numeric-constant form; ``expr`` always holds an evaluable
    expression for re-emission in residual predicates."""
    expr: Expr
    col: object = None    # str | None
    op: object = None     # one of _CMP_OPS | None
    value: object = None  # int | float | None

    @property
    def structured(self) -> bool:
        return self.col is not None

    def key(self) -> Tuple:
        if self.structured:
            return ("atom", self.col, self.op, repr(self.value))
        return ("opaque",) + (self.expr.key(),)


def _as_atom(e: Expr) -> Atom:
    """Recognize ``col <cmp> const`` (either argument order) as a
    structured atom; anything else is opaque."""
    if isinstance(e, BinOp) and e.op in _CMP_OPS:
        lhs, rhs, op = e.lhs, e.rhs, e.op
        if isinstance(lhs, Const) and isinstance(rhs, Col):
            lhs, rhs, op = rhs, lhs, _CMP_FLIP[op]
        if isinstance(lhs, Col) and isinstance(rhs, Const) \
                and isinstance(rhs.value, (int, float)) \
                and not isinstance(rhs.value, bool):
            return Atom(e, col=lhs.name, op=op, value=rhs.value)
    return Atom(e)


# Upper bound on CNF size: OR-over-AND distribution is exponential in
# the worst case, and ``pred_normal_key`` runs inside every FILTER
# fingerprint.  Predicates whose normal form would exceed the cap fall
# back to the raw canonical key (exact-only matching, no semantics).
MAX_CNF_CLAUSES = 64


class PredicateTooComplex(Exception):
    """The predicate's CNF would exceed ``MAX_CNF_CLAUSES``."""


def _cnf_clauses(e: Expr) -> Tuple[Tuple[Atom, ...], ...]:
    """CNF as a tuple of clauses; a clause is a tuple of disjoined atoms.
    AND flattens (union of clauses); OR distributes over AND.  Every
    intermediate result is held under ``MAX_CNF_CLAUSES``, bounding the
    whole normalization polynomially."""
    if isinstance(e, BinOp) and e.op == "and":
        out = _cnf_clauses(e.lhs) + _cnf_clauses(e.rhs)
        if len(out) > MAX_CNF_CLAUSES:
            raise PredicateTooComplex(len(out))
        return out
    if isinstance(e, BinOp) and e.op == "or":
        ls, rs = _cnf_clauses(e.lhs), _cnf_clauses(e.rhs)
        if len(ls) * len(rs) > MAX_CNF_CLAUSES:
            raise PredicateTooComplex(len(ls) * len(rs))
        return tuple(cl + cr for cl in ls for cr in rs)
    return ((_as_atom(e),),)


def _dedup_sort(clauses) -> Tuple[Tuple[Atom, ...], ...]:
    out = []
    seen = set()
    for c in clauses:
        atoms = {a.key(): a for a in c}
        canon = tuple(atoms[k] for k in sorted(atoms))
        ck = tuple(a.key() for a in canon)
        if ck not in seen:
            seen.add(ck)
            out.append((ck, canon))
    out.sort(key=lambda p: p[0])
    return tuple(c for _, c in out)


def to_cnf(pred: Expr) -> Tuple[Tuple[Atom, ...], ...]:
    """Canonical CNF: clauses and atoms deduped and sorted by key.
    Raises ``PredicateTooComplex`` past ``MAX_CNF_CLAUSES`` clauses."""
    return _dedup_sort(_cnf_clauses(pred))


def pred_normal_key(pred: Expr) -> Tuple:
    """Canonical digest of a predicate: equal for commuted and
    reassociated conjuncts/disjuncts.  Used by FILTER fingerprints.
    Oversized predicates keep their raw (linear-time) canonical key."""
    try:
        clauses = to_cnf(pred)
    except PredicateTooComplex:
        return ("rawpred", pred.key())
    return ("cnf",) + tuple(tuple(a.key() for a in c) for c in clauses)


def pred_columns(pred: Expr) -> frozenset:
    """Names of every column the predicate reads."""
    cols = set()

    def walk(e: Expr):
        if isinstance(e, Col):
            cols.add(e.name)
        elif isinstance(e, BinOp):
            walk(e.lhs)
            walk(e.rhs)
        elif isinstance(e, Cast):
            walk(e.inner)
    walk(pred)
    return frozenset(cols)


def _interval_implies(ao: str, va, bo: str, vb) -> bool:
    """``x ⋈ao va  ⇒  x ⋈bo vb`` by containment of satisfying ranges."""
    if bo == "gt":
        return (ao == "gt" and va >= vb) or \
               (ao in ("ge", "eq") and va > vb)
    if bo == "ge":
        return ao in ("gt", "ge", "eq") and va >= vb
    if bo == "lt":
        return (ao == "lt" and va <= vb) or \
               (ao in ("le", "eq") and va < vb)
    if bo == "le":
        return ao in ("lt", "le", "eq") and va <= vb
    if bo == "eq":
        return ao == "eq" and va == vb
    if bo == "ne":
        return (ao == "eq" and va != vb) or \
               (ao == "gt" and va >= vb) or (ao == "ge" and va > vb) or \
               (ao == "lt" and va <= vb) or (ao == "le" and va < vb)
    return False


def atom_implies(a: Atom, b: Atom) -> bool:
    """a ⇒ b for single atoms.  Equal atoms trivially imply; structured
    atoms on the same column use interval reasoning (set containment of
    the satisfying ranges).  Conservative: False when unsure.

    The interval check runs on the exact Python values AND on the
    constants rounded to float32: predicates evaluate against columns as
    narrow as float32, where two distinct reals can collapse to one
    runtime constant and "strictly stronger" silently stops being
    strict.  Requiring the containment under both semantics covers both
    integer columns (exact) and float32 columns (rounded)."""
    if a.key() == b.key():
        return True
    if not (a.structured and b.structured) or a.col != b.col:
        return False
    if not _interval_implies(a.op, a.value, b.op, b.value):
        return False
    return _interval_implies(a.op, float(np.float32(a.value)),
                             b.op, float(np.float32(b.value)))


def _clause_implies(ca, cb) -> bool:
    """Disjunction ca ⇒ disjunction cb: every atom of ca implies some
    atom of cb (then any witness satisfying ca satisfies cb)."""
    return all(any(atom_implies(a, b) for b in cb) for a in ca)


def implies(p: Expr, q: Expr) -> bool:
    """Does p ⇒ q?  p = ∧ Cp; q = ∧ Cq.  Sufficient (and sound) check:
    every clause of q is implied by some clause of p.  Oversized
    predicates conservatively do not imply anything."""
    try:
        cp, cq = to_cnf(p), to_cnf(q)
    except PredicateTooComplex:
        return False
    return all(any(_clause_implies(c1, c2) for c1 in cp) for c2 in cq)


def _clause_expr(clause) -> Expr:
    e = clause[0].expr
    for a in clause[1:]:
        e = BinOp("or", e, a.expr)
    return e


def conjoin(preds) -> Expr:
    """AND together a non-empty sequence of predicates."""
    preds = list(preds)
    e = preds[0]
    for p in preds[1:]:
        e = BinOp("and", e, p)
    return e


def residual_pred(p: Expr, q: Expr):
    """Given p ⇒ q, the compensation predicate R with  q ∧ R ≡ p:
    the clauses of CNF(p) not already implied by q (q implies its own
    clauses, so dropping them is exact, not an approximation).  Returns
    None when p and q are equivalent (no residual filter needed).
    Re-applying all of p is always sound given p ⇒ q, so oversized
    predicates fall back to it."""
    try:
        cq = to_cnf(q)
        keep = [c for c in to_cnf(p)
                if not any(_clause_implies(c2, c) for c2 in cq)]
    except PredicateTooComplex:
        return p
    if not keep:
        return None
    return conjoin(_clause_expr(c) for c in keep)
