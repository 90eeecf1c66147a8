"""A plain evaluator of the benchmark's PigMix plans, and the comparison
that judges a result against it.

A plan is the nested list the traffic files hold (``plan_spec.py``);
tables are dicts of tensors: fixed-width strings as (n, 20) uint8,
integers as int32, floats as float32.  Filters and row-level arithmetic
follow the program's 32-bit semantics (a float constant is float32, a
division by zero divides by one); aggregates are computed in float64.
Every grouping, distinct and join is exact: keys are compared whole,
never by hash alone.

``float_round`` (the control) rounds float inputs and every float
output to a lower precision, as a program computing in it would."""
from __future__ import annotations

from typing import Dict, Optional

import torch

Table = Dict[str, torch.Tensor]


def _words(col: torch.Tensor) -> torch.Tensor:
    """A column as int64 words that compare equal iff the values do:
    a string's bytes packed 8 to a word, a number's bits."""
    if col.ndim == 2:
        n, w = col.shape
        pad = (-w) % 8
        b = torch.nn.functional.pad(col, (0, pad)) if pad else col
        return b.contiguous().view(torch.int64).view(n, -1)
    if col.dtype == torch.float32:
        return col.contiguous().view(torch.int32).to(torch.int64)[:, None]
    if col.dtype == torch.bool:
        return col.to(torch.int64)[:, None]
    return col.to(torch.int64)[:, None]


def key_matrix(t: Table, names) -> torch.Tensor:
    return torch.cat([_words(t[n]) for n in names], 1)


def _n(t: Table) -> int:
    return next(iter(t.values())).shape[0]


def _take(t: Table, idx) -> Table:
    return {k: v[idx] for k, v in t.items()}


# ----------------------------------------------------------------- exprs


def _const(v, n, dev):
    if isinstance(v, bool):
        return torch.full((n,), v, dtype=torch.bool, device=dev)
    if isinstance(v, int):
        return torch.full((n,), v, dtype=torch.int32, device=dev)
    return torch.full((n,), v, dtype=torch.float32, device=dev)


_CMP = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
        "eq": torch.eq, "ne": torch.ne}


def _promote(a, b):
    if a.dtype == b.dtype:
        return a, b
    if torch.float32 in (a.dtype, b.dtype):
        return a.to(torch.float32), b.to(torch.float32)
    return a.to(torch.int32), b.to(torch.int32)


def eval_expr(e, t: Table, params: Dict):
    op = e[0]
    n = _n(t)
    dev = next(iter(t.values())).device
    if op == "col":
        return t[e[1]]
    if op == "const":
        return _const(e[1], n, dev)
    if op == "param":
        return _const(params[e[1]], n, dev)
    if op == "cast":
        return eval_expr(e[1], t, params).to(getattr(torch, e[2]))
    a, b = _promote(eval_expr(e[1], t, params), eval_expr(e[2], t, params))
    if op in _CMP:
        return _CMP[op](a, b)
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return a / torch.where(b == 0, torch.ones_like(b), b)
    raise ValueError(f"unknown expression {op!r}")


# ------------------------------------------------------------- operators


def _group_ids(km: torch.Tensor):
    """Exact group ids of the rows of a key matrix, and each group's
    first row."""
    uniq, inv = torch.unique(km, dim=0, return_inverse=True)
    g = uniq.shape[0]
    rows = torch.arange(km.shape[0], device=km.device)
    first = torch.full((g,), km.shape[0], dtype=torch.int64, device=km.device)
    first = first.scatter_reduce(0, inv, rows, "amin")
    return inv, first, g


def _group_by(t: Table, keys, aggs, rnd) -> Table:
    inv, first, g = _group_ids(key_matrix(t, keys))
    out = {k: t[k][first] for k in keys}
    cnt = torch.zeros(g, dtype=torch.float64, device=inv.device)
    cnt.index_add_(0, inv, torch.ones_like(inv, dtype=torch.float64))
    for name, (fn, col) in aggs.items():
        if fn == "count":
            out[name] = rnd(cnt)
            continue
        v = t[col].to(torch.float64)
        s = torch.zeros(g, dtype=torch.float64, device=inv.device)
        s.index_add_(0, inv, v)
        if fn == "sum":
            out[name] = rnd(s)
        elif fn == "mean":
            out[name] = rnd(s / cnt)
        else:
            raise ValueError(f"unknown aggregate {fn!r}")
    return out


def _join(left: Table, right: Table, lkeys, rkeys) -> Table:
    """Inner equi-join; right names that clash take a ``_r`` suffix."""
    kl, kr = key_matrix(left, lkeys), key_matrix(right, rkeys)
    both = torch.cat([kl, kr], 0)
    _, inv = torch.unique(both, dim=0, return_inverse=True)
    il, ir = inv[:kl.shape[0]], inv[kl.shape[0]:]
    order = torch.argsort(ir, stable=True)
    ir_sorted = ir[order]
    lo = torch.searchsorted(ir_sorted, il, right=False)
    hi = torch.searchsorted(ir_sorted, il, right=True)
    cnt = hi - lo
    lrow = torch.repeat_interleave(
        torch.arange(kl.shape[0], device=kl.device), cnt)
    start = torch.repeat_interleave(lo, cnt)
    within = torch.arange(lrow.shape[0], device=kl.device) - \
        torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    rrow = order[start + within]
    out = {k: v[lrow] for k, v in left.items()}
    for k, v in right.items():
        out[k if k not in out else k + "_r"] = v[rrow]
    return out


def _distinct(t: Table) -> Table:
    names = sorted(t)
    _, first, _ = _group_ids(key_matrix(t, names))
    return _take(t, torch.sort(first).values)


def evaluate(node, tables: Dict[str, Table], params: Optional[Dict] = None,
             float_round=None) -> Dict[str, Table]:
    """{store name: table} of a plan (a ``["store", name, child]`` node
    or a list of them)."""
    params = params or {}
    rnd = float_round or (lambda x: x)

    def ev(n):
        op = n[0]
        if op == "load":
            t = tables[n[1]]
            return {k: (rnd(v.to(torch.float64)).to(torch.float32)
                        if v.dtype == torch.float32 and float_round else v)
                    for k, v in t.items()}
        if op == "project":
            t = ev(n[1])
            return {k: t[k] for k in n[2]}
        if op == "filter":
            t = ev(n[1])
            return _take(t, eval_expr(n[2], t, params))
        if op == "foreach":
            t = ev(n[1])
            cols = {}
            for k, e in n[2].items():
                v = eval_expr(e, t, params)
                cols[k] = v if v.shape[0] == _n(t) else v.expand(_n(t))
            return cols
        if op == "join":
            return _join(ev(n[1]), ev(n[2]), n[3], n[4])
        if op == "group_by":
            return _group_by(ev(n[1]), n[2], n[3], rnd)
        if op == "distinct":
            return _distinct(ev(n[1]))
        if op == "union":
            a, b = ev(n[1]), ev(n[2])
            return {k: torch.cat([a[k], b[k]], 0) for k in a}
        raise ValueError(f"unknown operator {op!r}")

    stores = node if node[0] != "store" else [node]
    return {s[1]: ev(s[2]) for s in stores}


# ------------------------------------------------------------ comparison


def _lexsort(cols) -> torch.Tensor:
    """Row order sorting by ``cols`` (most significant first), stably."""
    n = cols[0].shape[0]
    order = torch.arange(n, device=cols[0].device)
    for c in reversed(cols):
        order = order[torch.sort(c[order], stable=True).indices]
    return order


def compare(got: Table, want: Table) -> Dict[str, float]:
    """``rows_wrong``: rows whose exact columns (strings, integers)
    differ once both sides are sorted, plus the difference in row
    counts (0 iff the multisets of exact columns agree).
    ``agg_rel_err``: the largest |got - want| / max(|want|, 1) over the
    float columns of the rows that agree."""
    if sorted(got) != sorted(want):
        return {"rows_wrong": float(max(_n(got), _n(want), 1)),
                "agg_rel_err": 0.0}
    exact = [k for k in sorted(want) if want[k].dtype not in
             (torch.float32, torch.float64)]
    floats = [k for k in sorted(want) if k not in exact]
    ng, nw = _n(got), _n(want)
    dev = want[next(iter(want))].device

    def sort(t):
        km = key_matrix(t, exact) if exact else torch.zeros(
            (_n(t), 1), dtype=torch.int64, device=dev)
        cols = [km[:, i] for i in range(km.shape[1])] + \
            [t[k].to(torch.float64) for k in floats]
        o = _lexsort(cols)
        return km[o], {k: t[k][o].to(torch.float64) for k in floats}

    got = {k: v.to(dev) for k, v in got.items()}
    kg, fg = sort(got)
    kw, fw = sort(want)
    m = min(ng, nw)
    same = (kg[:m] == kw[:m]).all(1)
    wrong = int((~same).sum()) + abs(ng - nw)
    err = 0.0
    for k in floats:
        a, b = fg[k][:m][same], fw[k][:m][same]
        if a.numel():
            rel = (a - b).abs() / b.abs().clamp_min(1.0)
            err = max(err, float(rel.max()))
    return {"rows_wrong": float(wrong), "agg_rel_err": err}


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """The control's precision: bfloat16, the step below float32."""
    return x.to(torch.bfloat16).to(torch.float64)
