"""Plan / expression serialization — makes the ReStore repository
durable.  The paper's premise is reuse ACROSS workflows submitted over
days (Facebook's 7-day retention); a production driver restarts many
times in that window, so repository entries (physical plans + stats)
must round-trip through storage, not just the artifacts.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from ..dataflow import expr as E
from . import plan as P


# ---------------------------------------------------------------------------
# Expressions


def expr_to_json(e: E.Expr) -> Dict[str, Any]:
    if isinstance(e, E.Col):
        return {"t": "col", "name": e.name}
    if isinstance(e, E.Const):
        return {"t": "const", "value": e.value}
    if isinstance(e, E.BinOp):
        return {"t": "bin", "op": e.op, "lhs": expr_to_json(e.lhs),
                "rhs": expr_to_json(e.rhs)}
    if isinstance(e, E.Cast):
        return {"t": "cast", "dtype": e.dtype,
                "inner": expr_to_json(e.inner)}
    raise TypeError(f"unserializable expr {type(e)}")


def expr_from_json(d: Dict[str, Any]) -> E.Expr:
    t = d["t"]
    if t == "col":
        return E.Col(d["name"])
    if t == "const":
        return E.Const(d["value"])
    if t == "bin":
        return E.BinOp(d["op"], expr_from_json(d["lhs"]),
                       expr_from_json(d["rhs"]))
    if t == "cast":
        return E.Cast(expr_from_json(d["inner"]), d["dtype"])
    raise TypeError(t)


# ---------------------------------------------------------------------------
# Plans


def _params_to_json(op: P.Operator) -> Dict[str, Any]:
    p = dict(op.params)
    if op.kind == "FILTER":
        p["pred"] = expr_to_json(p["pred"])
    elif op.kind == "FOREACH":
        p["gens"] = {k: expr_to_json(v) for k, v in p["gens"].items()}
    elif op.kind == "LOAD":
        p = {"dataset": p["dataset"], "version": p.get("version", 0)}
    return p


def _params_from_json(kind: str, p: Dict[str, Any]) -> Dict[str, Any]:
    p = dict(p)
    if kind == "FILTER":
        p["pred"] = expr_from_json(p["pred"])
    elif kind == "FOREACH":
        p["gens"] = {k: expr_from_json(v) for k, v in p["gens"].items()}
    elif kind in ("PROJECT",):
        p["cols"] = tuple(p["cols"])
    elif kind == "JOIN":
        p["left_keys"] = tuple(p["left_keys"])
        p["right_keys"] = tuple(p["right_keys"])
    elif kind == "GROUPBY":
        p["keys"] = tuple(p["keys"])
        p["aggs"] = {k: tuple(v) for k, v in p["aggs"].items()}
    elif kind == "COGROUP":
        p["keys_left"] = tuple(p["keys_left"])
        p["keys_right"] = tuple(p["keys_right"])
        p["aggs_left"] = {k: tuple(v) for k, v in p["aggs_left"].items()}
        p["aggs_right"] = {k: tuple(v) for k, v in p["aggs_right"].items()}
    return p


def plan_to_json(plan: P.PhysicalPlan) -> Dict[str, Any]:
    topo = plan.topo()
    ids = {id(op): i for i, op in enumerate(topo)}
    ops = [{"kind": op.kind, "params": _params_to_json(op),
            "inputs": [ids[id(i)] for i in op.inputs]} for op in topo]
    return {"ops": ops, "sinks": [ids[id(s)] for s in plan.sinks]}


def plan_from_json(d: Dict[str, Any]) -> P.PhysicalPlan:
    built: List[P.Operator] = []
    for o in d["ops"]:
        inputs = [built[i] for i in o["inputs"]]
        built.append(P.Operator(o["kind"],
                                _params_from_json(o["kind"], o["params"]),
                                inputs))
    return P.PhysicalPlan([built[i] for i in d["sinks"]])


# ---------------------------------------------------------------------------
# Repository


def _payload_to_json(e) -> Dict[str, Any]:
    if getattr(e, "kind", "plan") == "prefix":
        return {"prefix": {"tokens": [int(t) for t in e.plan.tokens],
                           "model_version": e.plan.model_version}}
    return plan_to_json(e.plan)


def entry_to_json(e) -> Dict[str, Any]:
    """One repository entry as a JSON-safe dict (shared by the state
    snapshot and the WAL journal — one codec, one format).  Entries are
    tagged with their artifact kind (DESIGN.md §17): a "prefix" entry
    serializes its token chain instead of an operator DAG."""
    return {
        "kind": getattr(e, "kind", "plan"),
        "plan": _payload_to_json(e), "artifact": e.artifact,
        "signature": e.signature, "bytes_in": e.bytes_in,
        "bytes_out": e.bytes_out, "rows_out": e.rows_out,
        "exec_time_s": e.exec_time_s, "created_at": e.created_at,
        "producer_cost_s": e.producer_cost_s,
        "history_uses": e.history_uses,
        "last_used": e.last_used, "use_count": e.use_count,
        "semantic_uses": e.semantic_uses,
        "saved_s_total": e.saved_s_total,
        "source_versions": e.source_versions,
        "partitioning": e.partitioning,
    }


def entry_from_json(d: Dict[str, Any]):
    """Decode one entry, or None when the payload fails the integrity
    check (a corrupted plan no longer matches its signature)."""
    from .repository import RepositoryEntry
    kind = d.get("kind", "plan")
    if kind == "prefix":
        from .prefix_plan import PrefixPlan
        p = d["plan"]["prefix"]
        try:
            plan = PrefixPlan(p["tokens"], p["model_version"])
        except (ValueError, KeyError, TypeError):
            return None
        if plan.signature != d["signature"]:
            return None
    else:
        plan = plan_from_json(d["plan"])
    e = RepositoryEntry(
        kind=kind,
        plan=plan, artifact=d["artifact"], signature=d["signature"],
        bytes_in=d["bytes_in"], bytes_out=d["bytes_out"],
        rows_out=d["rows_out"], exec_time_s=d["exec_time_s"],
        producer_cost_s=d.get("producer_cost_s", 0.0),
        history_uses=d.get("history_uses", 0.0),
        created_at=d["created_at"], last_used=d["last_used"],
        use_count=d["use_count"],
        semantic_uses=d.get("semantic_uses", 0),
        saved_s_total=d.get("saved_s_total", 0.0),
        source_versions=d["source_versions"],
        partitioning=d.get("partitioning"))
    if kind != "prefix" and P.plan_signature(plan) != e.signature:
        return None
    return e


def repository_to_json(repo) -> str:
    return json.dumps(
        {"entries": [entry_to_json(e) for e in repo.entries]}, indent=1)


def repository_from_json(text: str, repo=None):
    from .repository import Repository
    repo = repo if repo is not None else Repository()
    data = json.loads(text)
    for d in data["entries"]:
        e = entry_from_json(d)
        if e is not None:
            repo.add(e)
    return repo


def save_repository(repo, path: str) -> None:
    import os
    import tempfile
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    with os.fdopen(fd, "w") as f:
        f.write(repository_to_json(repo))
    os.replace(tmp, path)        # atomic, like the artifact store


def load_repository(path: str, repo=None, journal_path=None):
    """Load a repository state file.  A truncated/corrupt file raises by
    default (pre-§13 behavior); with ``journal_path`` it instead falls
    back to replaying the WAL journal — the crash-consistent source of
    truth the snapshot is merely a compaction of (DESIGN.md §13)."""
    try:
        with open(path) as f:
            return repository_from_json(f.read(), repo)
    except (OSError, ValueError, KeyError, TypeError):
        if journal_path is None:
            raise
        from ..service.journal import replay_journal
        return replay_journal(journal_path, repo)
