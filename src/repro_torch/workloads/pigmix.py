"""PigMix-faithful synthetic workload (paper §7).

Data generator mirrors the PigMix tables (page_views + users/power_users)
and the §7.5 synthetic table (Table 2 field cardinalities); queries
L2-L8 and L11 are expressed over the engine's operator set the same way
Pig compiles them.  The generators take ``device=None`` (the card) and
build the string columns from an encoded vocabulary, so a 2**24-row
``page_views`` takes seconds; the bytes equal the reference generator's.

The queries are written in the Pig-style builder DSL
(``dataflow.builder``, DESIGN.md §16) — the paper's actual interface.
The original hand-built ``core.plan`` constructors are retained below
as ``LEGACY`` so ``tests/test_builder.py`` can pin that both notations
compile to fingerprint-identical plans.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core import plan as P
from ..dataflow.builder import Dataflow, col
from ..dataflow.expr import Cast, Col, Const
from ..dataflow.table import Table, encode_strings

N_USERS = 200


def _vocab_column(rng: np.random.Generator, vocab, n_rows: int,
                  width: int = 20) -> np.ndarray:
    """``encode_strings([vocab[i] for i in rng.integers(0, len(vocab),
    n_rows)])``, vectorised: the vocabulary is encoded once and indexed
    with the same draws, so the bytes (and the generator's state after
    the call) equal the per-row version's."""
    enc = encode_strings(vocab, width)
    return enc[rng.integers(0, len(vocab), n_rows)]


def gen_page_views(n_rows: int, seed: int = 0,
                   capacity: int | None = None,
                   n_users: int = N_USERS, device=None) -> Table:
    rng = np.random.default_rng(seed)
    users = [f"user{i:04d}" for i in range(n_users)]
    terms = [f"term{i:03d}" for i in range(50)]
    # the draws run in the reference's order: user, action, timespent,
    # query_term, timestamp, estimated_revenue
    return Table.from_numpy({
        "user": _vocab_column(rng, users, n_rows),
        "action": rng.integers(1, 3, n_rows).astype(np.int32),
        "timespent": rng.integers(0, 100, n_rows).astype(np.int32),
        "query_term": _vocab_column(rng, terms, n_rows),
        "timestamp": rng.integers(0, 24, n_rows).astype(np.int32),
        "estimated_revenue": rng.uniform(0, 100, n_rows)
        .astype(np.float32),
    }, capacity=capacity or n_rows, device=device)


def gen_users(seed: int = 1, n_users: int = N_USERS, device=None) -> Table:
    rng = np.random.default_rng(seed)
    names = [f"user{i:04d}" for i in range(n_users)]
    return Table.from_numpy({
        "name": encode_strings(names),
        "phone": rng.integers(10**6, 10**7, n_users).astype(np.int32),
        "zip": rng.integers(10**4, 10**5, n_users).astype(np.int32),
    }, device=device)


def gen_power_users(seed: int = 2, device=None) -> Table:
    rng = np.random.default_rng(seed)
    names = [f"user{i:04d}" for i in range(0, N_USERS, 4)]
    return Table.from_numpy({
        "name": encode_strings(names),
        "phone": rng.integers(10**6, 10**7, len(names)).astype(np.int32),
    }, device=device)


def register_all(catalog, n_rows: int = 1 << 15, seed: int = 0):
    """Generate the three PigMix tables on the catalog's device."""
    dev = catalog.device
    catalog.register("page_views", gen_page_views(n_rows, seed, device=dev))
    catalog.register("users", gen_users(device=dev))
    catalog.register("power_users", gen_power_users(device=dev))


# ---------------------------------------------------------------------------
# Queries, in the Pig-style builder DSL.  Each returns a PhysicalPlan;
# Pig's FOREACH..GENERATE maps to project/foreach, (CO)GROUP..FOREACH agg
# to group_by/cogroup.


def L2() -> P.PhysicalPlan:
    """Join page_views projection with power_users names."""
    pv = Dataflow.load("page_views").project("user", "estimated_revenue")
    pu = Dataflow.load("power_users").project("name")
    return (pv.join(pu, left_on="user", right_on="name")
            .store("L2_out").build())


def L3(agg: str = "sum") -> P.PhysicalPlan:
    """Join then group-by user with revenue aggregate (paper Q2)."""
    pv = Dataflow.load("page_views").project("user", "estimated_revenue")
    u = Dataflow.load("users").project("name")
    return (pv.join(u, left_on="user", right_on="name")
            .group_by("user", total=(agg, "estimated_revenue"))
            .store(f"L3_{agg}_out").build())


def L4() -> P.PhysicalPlan:
    """Distinct aggregate: count distinct actions per user."""
    return (Dataflow.load("page_views").project("user", "action")
            .distinct()
            .group_by("user", n_actions=("count", "action"))
            .store("L4_out").build())


def L5() -> P.PhysicalPlan:
    """Join pv with full users table (wide build side)."""
    pv = Dataflow.load("page_views").project("user", "timespent")
    u = Dataflow.load("users").project("name", "phone", "zip")
    return (pv.join(u, left_on="user", right_on="name")
            .store("L5_out").build())


def L6() -> P.PhysicalPlan:
    """Group on a wide key with a large-cardinality aggregate."""
    return (Dataflow.load("page_views")
            .project("user", "query_term", "timespent")
            .group_by("user", "query_term",
                      total_time=("sum", "timespent"))
            .store("L6_out").build())


def L7() -> P.PhysicalPlan:
    """Morning/afternoon conditional sums (Pig's nested FOREACH)."""
    return (Dataflow.load("page_views")
            .foreach(user=col("user"),
                     morning=Cast((col("timestamp") < 12), "int32")
                     * col("timespent"),
                     afternoon=Cast((col("timestamp") >= 12), "int32")
                     * col("timespent"))
            .group_by("user", m=("sum", "morning"),
                      a=("sum", "afternoon"))
            .store("L7_out").build())


def L8() -> P.PhysicalPlan:
    """Group-ALL: whole-table aggregate."""
    return (Dataflow.load("page_views")
            .foreach(all=Const(1), timespent=col("timespent"),
                     estimated_revenue=col("estimated_revenue"))
            .group_by("all", t=("sum", "timespent"),
                      r=("mean", "estimated_revenue"))
            .store("L8_out").build())


def L11(second: str = "power_users") -> P.PhysicalPlan:
    """Union of user columns, deduplicated (3-job workflow: two map
    pipelines + distinct)."""
    a = Dataflow.load("page_views").project("user").distinct()
    b = Dataflow.load(second).project("name").foreach(user=col("name"))
    return a.union(b).distinct().store(f"L11_{second}_out").build()


def L3F() -> P.PhysicalPlan:
    """L3 with a post-aggregation FOREACH (Pig keeps GROUP and the
    aggregating FOREACH separate, so the GROUP output is mid-reducer —
    exactly the case where the Aggressive Heuristic stores more than the
    Conservative one)."""
    pv = Dataflow.load("page_views").project("user", "estimated_revenue")
    u = Dataflow.load("users").project("name")
    return (pv.join(u, left_on="user", right_on="name")
            .group_by("user", total=("sum", "estimated_revenue"),
                      cnt=("count", "estimated_revenue"))
            .foreach(user=col("user"),
                     avg_rev=col("total") / col("cnt"))
            .store("L3F_out").build())


QUERIES = {"L2": L2, "L3": L3, "L3F": L3F, "L4": L4, "L5": L5, "L6": L6,
           "L7": L7, "L8": L8, "L11": L11}


# ---------------------------------------------------------------------------
# Legacy hand-built constructors (the pre-DSL notation).  Kept verbatim:
# tests/test_builder.py asserts each DSL template above compiles to a
# plan fingerprint-identical to its legacy twin, which is what makes the
# DSL a pure notation change (fingerprints are the reuse currency).


def _legacy_L2() -> P.PhysicalPlan:
    pv = P.project(P.load("page_views"), ["user", "estimated_revenue"])
    pu = P.project(P.load("power_users"), ["name"])
    j = P.join(pv, pu, ["user"], ["name"])
    return P.PhysicalPlan([P.store(j, "L2_out")])


def _legacy_L3(agg: str = "sum") -> P.PhysicalPlan:
    pv = P.project(P.load("page_views"), ["user", "estimated_revenue"])
    u = P.project(P.load("users"), ["name"])
    j = P.join(pv, u, ["user"], ["name"])
    g = P.groupby(j, ["user"],
                  {"total": (agg, "estimated_revenue")})
    return P.PhysicalPlan([P.store(g, f"L3_{agg}_out")])


def _legacy_L4() -> P.PhysicalPlan:
    pv = P.project(P.load("page_views"), ["user", "action"])
    d = P.distinct(pv)
    g = P.groupby(d, ["user"], {"n_actions": ("count", "action")})
    return P.PhysicalPlan([P.store(g, "L4_out")])


def _legacy_L5() -> P.PhysicalPlan:
    pv = P.project(P.load("page_views"), ["user", "timespent"])
    u = P.project(P.load("users"), ["name", "phone", "zip"])
    j = P.join(pv, u, ["user"], ["name"])
    return P.PhysicalPlan([P.store(j, "L5_out")])


def _legacy_L6() -> P.PhysicalPlan:
    pv = P.project(P.load("page_views"),
                   ["user", "query_term", "timespent"])
    g = P.groupby(pv, ["user", "query_term"],
                  {"total_time": ("sum", "timespent")})
    return P.PhysicalPlan([P.store(g, "L6_out")])


def _legacy_L7() -> P.PhysicalPlan:
    pv = P.load("page_views")
    f = P.foreach(pv, {
        "user": Col("user"),
        "morning": Cast((Col("timestamp") < 12), "int32")
        * Col("timespent"),
        "afternoon": Cast((Col("timestamp") >= 12), "int32")
        * Col("timespent"),
    })
    g = P.groupby(f, ["user"], {"m": ("sum", "morning"),
                                "a": ("sum", "afternoon")})
    return P.PhysicalPlan([P.store(g, "L7_out")])


def _legacy_L8() -> P.PhysicalPlan:
    pv = P.foreach(P.load("page_views"),
                   {"all": Const(1), "timespent": Col("timespent"),
                    "estimated_revenue": Col("estimated_revenue")})
    g = P.groupby(pv, ["all"], {"t": ("sum", "timespent"),
                                "r": ("mean", "estimated_revenue")})
    return P.PhysicalPlan([P.store(g, "L8_out")])


def _legacy_L11(second: str = "power_users") -> P.PhysicalPlan:
    a = P.distinct(P.project(P.load("page_views"), ["user"]))
    b = P.foreach(P.project(P.load(second), ["name"]),
                  {"user": Col("name")})
    u = P.union(a, b)
    d = P.distinct(u)
    return P.PhysicalPlan([P.store(d, f"L11_{second}_out")])


def _legacy_L3F() -> P.PhysicalPlan:
    pv = P.project(P.load("page_views"), ["user", "estimated_revenue"])
    u = P.project(P.load("users"), ["name"])
    j = P.join(pv, u, ["user"], ["name"])
    g = P.groupby(j, ["user"], {"total": ("sum", "estimated_revenue"),
                                "cnt": ("count", "estimated_revenue")})
    f = P.foreach(g, {"user": Col("user"),
                      "avg_rev": Col("total") / Col("cnt")})
    return P.PhysicalPlan([P.store(f, "L3F_out")])


LEGACY = {"L2": _legacy_L2, "L3": _legacy_L3, "L3F": _legacy_L3F,
          "L4": _legacy_L4, "L5": _legacy_L5, "L6": _legacy_L6,
          "L7": _legacy_L7, "L8": _legacy_L8, "L11": _legacy_L11}


# ---------------------------------------------------------------------------
# §7.5 synthetic table (Table 2) + QP/QF templates

FILTER_FIELDS = {   # field -> (cardinality proxy, selected fraction)
    "field6": 0.005, "field7": 0.01, "field8": 0.05, "field9": 0.10,
    "field10": 0.20, "field11": 0.50, "field12": 0.60,
}


def gen_synth(n_rows: int, seed: int = 3,
              capacity: int | None = None, device=None) -> Table:
    rng = np.random.default_rng(seed)
    cols: Dict[str, np.ndarray] = {}
    for i in range(1, 6):
        vals = [f"s{rng.integers(0, 1 << 30):019d}" for _ in range(n_rows)]
        cols[f"field{i}"] = encode_strings(vals)
    for f, frac in FILTER_FIELDS.items():
        cols[f] = (rng.random(n_rows) >= frac).astype(np.int32)
        # value 0 selected with probability `frac`
    return Table.from_numpy(cols, capacity=capacity or n_rows,
                            device=device)


def QP(n_fields: int) -> P.PhysicalPlan:
    """Project field1..fieldN -> group -> count (paper QP template)."""
    fields = [f"field{i}" for i in range(1, n_fields + 1)]
    return (Dataflow.load("synth").project(fields)
            .group_by(fields, cnt=("count", fields[0]))
            .store(f"QP{n_fields}_out").build())


def QF(field: str) -> P.PhysicalPlan:
    """Filter by equality on fieldi -> group by field1 -> count."""
    return (Dataflow.load("synth").filter(col(field) == 0)
            .project("field1", field)
            .group_by("field1", cnt=("count", field))
            .store(f"QF_{field}_out").build())


def _legacy_QP(n_fields: int) -> P.PhysicalPlan:
    fields = [f"field{i}" for i in range(1, n_fields + 1)]
    pr = P.project(P.load("synth"), fields)
    g = P.groupby(pr, fields, {"cnt": ("count", fields[0])})
    return P.PhysicalPlan([P.store(g, f"QP{n_fields}_out")])


def _legacy_QF(field: str) -> P.PhysicalPlan:
    f = P.filter_(P.load("synth"), Col(field) == 0)
    pr = P.project(f, ["field1", field])
    g = P.groupby(pr, ["field1"], {"cnt": ("count", field)})
    return P.PhysicalPlan([P.store(g, f"QF_{field}_out")])
