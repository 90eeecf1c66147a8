"""Incremental maintenance of the port against the reference
(``tests/test_delta_refresh.py``'s cases, DESIGN.md §12).

Every case runs the same seeded inputs through ``repro`` and
``repro_torch`` (``device="cpu"``): the maintain reports and refresh
decisions must be equal, and every refreshed artifact must equal both
the reference's refreshed artifact and a cold recompute in the port,
bit for bit (the data is integer-valued, so float32 sums are exact).
Beyond the reference's cases: the shard files ``merge_shards`` writes
are byte-equal across the packages (the npz members; zip timestamps
differ between any two writes), and ``append`` never writes into the
tensors of a Table an earlier ``get`` returned.
"""
import json
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as RCM  # noqa: E402
from repro.core import delta as RD  # noqa: E402
from repro.core import plan as RP  # noqa: E402
from repro.core import repository as RRepo  # noqa: E402
from repro.core import restore as RR  # noqa: E402
from repro.dataflow import expr as RE  # noqa: E402
from repro.dataflow import physical as RPh  # noqa: E402
from repro.dataflow import table as RT  # noqa: E402
from repro.store import artifacts as RA  # noqa: E402
from repro.workloads import stream as RS  # noqa: E402
from repro_torch.core import cost_model as TCM  # noqa: E402
from repro_torch.core import delta as TD  # noqa: E402
from repro_torch.core import plan as TP  # noqa: E402
from repro_torch.core import repository as TRepo  # noqa: E402
from repro_torch.core import restore as TR  # noqa: E402
from repro_torch.dataflow import expr as TE  # noqa: E402
from repro_torch.dataflow import physical as TPh  # noqa: E402
from repro_torch.dataflow import table as TT  # noqa: E402
from repro_torch.store import artifacts as TA  # noqa: E402
from repro_torch.workloads import stream as TS  # noqa: E402

N_DIM = 8


class Pkg:
    """One package's modules, with ``device="cpu"`` passed where the
    port's entry points take a device."""

    def __init__(self, port: bool):
        self.port = port
        (self.P, self.E, self.T, self.A, self.R, self.D, self.CM,
         self.Repo, self.Ph, self.S) = (
            (TP, TE, TT, TA, TR, TD, TCM, TRepo, TPh, TS) if port else
            (RP, RE, RT, RA, RR, RD, RCM, RRepo, RPh, RS))
        self.dev = {"device": "cpu"} if port else {}

    def table(self, cols):
        return self.T.Table.from_numpy(cols, **self.dev)

    def fact(self, seed: int, n: int = 96):
        rng = np.random.default_rng(seed)
        return self.table({
            "k": rng.integers(0, N_DIM, n).astype(np.int32),
            "v": rng.integers(0, 100, n).astype(np.int32),
            "w": rng.integers(0, 50, n).astype(np.float32)})

    def dim(self, lo: int = 0, hi: int = N_DIM):
        ks = np.arange(lo, hi, dtype=np.int32)
        return self.table({"dk": ks, "x": (ks * 3).astype(np.int32)})

    def store(self, **kw):
        return self.A.ArtifactStore(**kw, **self.dev)

    def restore(self, delta_fact=None, delta_dim=None, **kw):
        store = self.store()
        cat = self.A.Catalog(store, **self.dev)
        cat.register("fact", self.fact(0))
        cat.register("dim", self.dim())
        kw.setdefault("min_splice_benefit_s", 0.0)
        rs = self.R.ReStore(cat, store, **kw, **self.dev)
        if delta_fact is not None:
            cat.append("fact", delta_fact)
        if delta_dim is not None:
            cat.append("dim", delta_dim)
        return rs


REF, PORT = Pkg(False), Pkg(True)
BOTH = (REF, PORT)


def _sortable(a):
    """1-D lexsort key; a byte-string column (2-D uint8) becomes bytes."""
    if a.ndim == 2:
        return np.ascontiguousarray(a).view(f"S{a.shape[1]}").ravel()
    return a


def canon(t):
    d = t.to_numpy()
    order = np.lexsort(tuple(_sortable(d[c])
                             for c in sorted(d, reverse=True)))
    return {c: d[c][order] for c in sorted(d)}


def assert_same(a, b, label=""):
    ca, cb = canon(a), canon(b)
    assert sorted(ca) == sorted(cb), f"{label}: column sets differ"
    for c in ca:
        assert ca[c].dtype == cb[c].dtype, f"{label}:{c}"
        assert np.array_equal(ca[c], cb[c]), f"{label}:{c}"


# ------------------------------------------------------------- builders


def _chain(k):
    f = k.P.filter_(k.P.load("fact"), k.E.Col("v") > 20)
    pr = k.P.project(f, ["k", "v"])
    fe = k.P.foreach(pr, {"k": k.E.Col("k"),
                          "v2": k.E.Col("v") * k.E.Const(2)})
    return k.P.PhysicalPlan([k.P.store(fe, "out")])


def _union(k):
    a = k.P.project(k.P.load("fact"), ["k"])
    b = k.P.foreach(k.P.project(k.P.load("dim"), ["dk"]),
                    {"k": k.E.Col("dk")})
    return k.P.PhysicalPlan([k.P.store(k.P.union(a, b), "out")])


def _groupby_all(k):
    f = k.P.filter_(k.P.load("fact"), k.E.Col("v") > 10)
    g = k.P.groupby(f, ["k"], {"s": ("sum", "w"), "n": ("count", "v"),
                               "mn": ("min", "v"), "mx": ("max", "v")})
    return k.P.PhysicalPlan([k.P.store(g, "out")])


def _distinct(k):
    d = k.P.distinct(k.P.project(k.P.load("fact"), ["k", "v"]))
    return k.P.PhysicalPlan([k.P.store(d, "out")])


def _join(k):
    j = k.P.join(k.P.project(k.P.load("fact"), ["k", "v"]),
                 k.P.load("dim"), ["k"], ["dk"])
    return k.P.PhysicalPlan([k.P.store(j, "out")])


def _group_sum(k, fn="sum"):
    g = k.P.groupby(k.P.load("fact"), ["k"], {"s": (fn, "v")})
    return k.P.PhysicalPlan([k.P.store(g, "out")])


def _join_extra(k):
    rng = np.random.default_rng(14)
    return k.table({
        "k": rng.integers(0, N_DIM + 4, 24).astype(np.int32),
        "v": rng.integers(0, 100, 24).astype(np.int32),
        "w": rng.integers(0, 50, 24).astype(np.float32)})


# (builder, delta_fact(k), delta_dim(k)) per refreshable root class
REFRESH_CASES = {
    "recordwise_chain": (_chain, lambda k: k.fact(7, 32), None),
    "union": (_union, lambda k: k.fact(8, 24), None),
    "union_both_inputs_changed": (_union, lambda k: k.fact(9, 16),
                                  lambda k: k.dim(N_DIM, N_DIM + 4)),
    "groupby_all_decomposable_aggs": (_groupby_all,
                                      lambda k: k.fact(11, 48), None),
    "distinct": (_distinct, lambda k: k.fact(12, 40), None),
    "join_left_side_changed": (_join, lambda k: k.fact(13, 32), None),
    "join_both_sides_changed": (_join, _join_extra,
                                lambda k: k.dim(N_DIM, N_DIM + 4)),
}


def _check_refresh(k, build, dfact, ddim):
    """Cold run -> append -> maintain(refresh) -> the new-version query,
    answered without executing.  Returns (report, refreshed result,
    cold result over the appended data, run report)."""
    rs = k.restore(heuristic="aggressive")
    rs.run_plan(build(k))
    if dfact is not None:
        rs.catalog.append("fact", dfact(k))
    if ddim is not None:
        rs.catalog.append("dim", ddim(k))
    rep = rs.maintain(mode="refresh")
    versions = {ds: rs.catalog.version(ds) for ds in ("fact", "dim")}
    plan2 = k.P.rebind_load_versions(build(k), versions)
    got, run_rep = rs.run_plan(plan2)
    cold_rs = k.restore(dfact(k) if dfact else None,
                        ddim(k) if ddim else None, heuristic="off",
                        rewrite_enabled=False, semantic=False)
    cold, _ = cold_rs.run_plan(plan2)
    return rep, got["out"], cold["out"], run_rep


@pytest.mark.parametrize("case", sorted(REFRESH_CASES))
def test_refresh_matches_reference(case):
    build, dfact, ddim = REFRESH_CASES[case]
    r_rep, r_got, r_cold, r_run = _check_refresh(REF, build, dfact, ddim)
    p_rep, p_got, p_cold, p_run = _check_refresh(PORT, build, dfact, ddim)
    assert p_rep == r_rep and p_rep["refreshed"] >= 1
    assert p_run.n_executed == r_run.n_executed == 0
    assert_same(p_got, p_cold, "port refreshed vs port cold")
    assert_same(p_got, r_got, "port vs reference refreshed")
    assert_same(p_cold, r_cold, "port vs reference cold")


# ----------------------------------------------- fallback to R4 (delete)


def _rewrite_churn(k):
    rs = k.restore(heuristic="off")
    rs.run_plan(_group_sum(k))
    rs.catalog.register("fact", k.fact(55))
    return rs, rs.maintain(mode="refresh")


def _nondecomposable(k):
    rs = k.restore(heuristic="off")
    rs.run_plan(_group_sum(k, "mean"))
    rs.catalog.append("fact", k.fact(3, 8))
    return rs, rs.maintain(mode="refresh")


def _above_blocking_root(k):
    g = k.P.groupby(k.P.load("fact"), ["k"], {"s": ("sum", "v")})
    f = k.P.foreach(g, {"k": k.E.Col("k"),
                        "s2": k.E.Col("s") * k.E.Const(2)})
    rs = k.restore(heuristic="off")
    rs.run_plan(k.P.PhysicalPlan([k.P.store(f, "out")]))
    rs.catalog.append("fact", k.fact(3, 8))
    return rs, rs.maintain(mode="refresh")


def _boundary_inputs(k):
    g = k.P.groupby(k.P.load("fact"), ["k"], {"s": ("sum", "v")})
    j = k.P.join(g, k.P.load("dim"), ["k"], ["dk"])
    rs = k.restore(heuristic="off")
    rs.run_plan(k.P.PhysicalPlan([k.P.store(j, "out")]))
    n_art = sum(any(ld.params["dataset"].startswith("art/")
                    for ld in e.plan.loads()) for e in rs.repo.entries)
    assert n_art, "expected a downstream entry loading a boundary"
    rs.catalog.append("fact", k.fact(3, 8))
    return rs, rs.maintain(mode="refresh")


@pytest.mark.parametrize("scenario", [_rewrite_churn, _nondecomposable,
                                      _above_blocking_root,
                                      _boundary_inputs],
                         ids=lambda f: f.__name__.strip("_"))
def test_fallback_to_delete_matches_reference(scenario):
    r_rs, r_rep = scenario(REF)
    p_rs, p_rep = scenario(PORT)
    assert p_rep == r_rep and p_rep["deleted"] >= 1
    assert sorted(e.signature for e in p_rs.repo.entries) == \
        sorted(e.signature for e in r_rs.repo.entries)
    assert "FOREACH" not in [e.plan.sinks[0].inputs[0].kind
                             for e in p_rs.repo.entries]


# ------------------------------------------------ catalog append lineage


def test_catalog_lineage_matches_reference():
    out = {}
    for k in BOTH:
        cat = k.A.Catalog(k.store(), **k.dev)
        cat.register("fact", k.fact(0, 10))
        cat.append("fact", k.fact(1, 4))
        d, snap = cat.delta_table("fact", 0), cat.snapshot_table("fact", 0)
        rec = (cat.version("fact"), cat.rows_at("fact", 1),
               cat.is_append_since("fact", 0), cat.delta_fraction("fact", 0))
        cat.register("fact", k.fact(2, 6))
        rec += (cat.version("fact"), cat.is_append_since("fact", 1),
                cat.delta_table("fact", 1))
        out[k.port] = (rec, d, snap, cat)
    rec, d, snap, _ = out[True]
    assert rec == out[False][0] == (1, 14, True, 0.4, 2, False, None)
    assert_same(d, out[False][1], "delta rows")
    assert_same(snap, PORT.fact(0, 10), "snapshot")
    assert_same(snap, out[False][2], "snapshot vs reference")


# ----------------------------------- partitioned artifacts, shard-local


def _partitioned(k, store, name, t, keys, n_parts):
    store.put(name + "#tmp", t)
    tp, _ = store.get_partitioned(name + "#tmp", keys, n_parts)
    store.put(name, tp, partitioning={"keys": list(keys),
                                      "n_parts": n_parts})
    store.delete(name + "#tmp")


def _block_layout_ok(k, t, keys, n_parts):
    blk = t.capacity // n_parts
    h = k.T.partition_hash(t, keys)
    pid = np.asarray(h.cpu() if k.port else h).astype(np.int64) % n_parts
    mask = np.asarray(t.valid.cpu() if k.port else t.valid)
    return np.array_equal(pid[mask], (np.arange(t.capacity) // blk)[mask])


def _aggs(k, t):
    return k.Ph.op_groupby(t, ["k"], {"s": ("sum", "w"),
                                      "n": ("count", "v")})


def _merge(k):
    return k.D._reagg_merge(("k",), {"s": ("sum", "s"), "n": ("sum", "n")})


@pytest.mark.parametrize("kind", ["append", "reagg"])
def test_partitioned_merge_matches_reference(kind):
    got = {}
    for k in BOTH:
        store = k.store()
        if kind == "append":
            base, delta = k.fact(0, 64), k.fact(5, 16)
            _partitioned(k, store, "art", base, ["k"], 4)
            store.append("art", delta)
            mono = k.store()
            mono.put("ref", base)
            mono.append("ref", delta)
            want = mono.get("ref")
        else:
            base, delta = _aggs(k, k.fact(0, 64)), _aggs(k, k.fact(5, 32))
            _partitioned(k, store, "art", base, ["k"], 4)
            store.merge_shards("art", delta, merge_fn=_merge(k))
            want = _merge(k)(base, delta)
        t = store.get("art")
        assert store.partitioning("art")["n_parts"] == 4
        assert _block_layout_ok(k, t, ["k"], 4)
        assert_same(t, want, f"{kind}: shard-local vs global merge")
        got[k.port] = (t, store.partitioning("art"))
    assert_same(got[True][0], got[False][0], "port vs reference")
    assert got[True][1] == got[False][1]


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


@pytest.mark.parametrize("kind", ["append", "reagg"])
def test_merge_shards_files_byte_equal_to_reference(tmp_path, kind):
    roots = {}
    for k in BOTH:
        root = str(tmp_path / ("port" if k.port else "ref"))
        store = k.store(root=root, write_behind=False)
        if kind == "append":
            _partitioned(k, store, "agg", k.fact(0, 64), ["k"], 4)
            store.merge_shards("agg", k.fact(5, 16))
        else:
            _partitioned(k, store, "agg", _aggs(k, k.fact(0, 64)), ["k"], 4)
            store.merge_shards("agg", _aggs(k, k.fact(5, 32)),
                               merge_fn=_merge(k))
        store.close()
        roots[k.port] = os.path.join(root, RA._encode_name("agg"))
    files = sorted(os.listdir(roots[False]))
    assert sorted(os.listdir(roots[True])) == files
    assert "shard_00003.npz" in files
    for fn in files:
        a, b = (os.path.join(roots[p], fn) for p in (True, False))
        if fn.endswith(".npz"):
            assert _npz_members(a) == _npz_members(b), fn
        else:
            ma, mb = (json.load(open(p)) for p in (a, b))
            for m in (ma, mb):     # time and the zip-level crc differ
                m.pop("created"), m.pop("checksums")
            assert ma == mb


def test_partitioned_refresh_e2e_matches_reference():
    got = {}
    for k in BOTH:
        rs = k.restore(heuristic="off")
        rs.run_plan(_aggs_plan(k))
        (entry,) = rs.repo.entries
        tp, _ = rs.store.get_partitioned(entry.artifact, ["k"], 4)
        rs.store.put(entry.artifact, tp,
                     partitioning={"keys": ["k"], "n_parts": 4})
        entry.partitioning = rs.store.partitioning(entry.artifact)
        rs.catalog.append("fact", k.fact(21, 48))
        rep = rs.maintain(mode="refresh")
        part = rs.store.partitioning(entry.artifact)
        assert rep["refreshed"] == 1 and part["n_parts"] == 4
        assert entry.partitioning == part
        out, run_rep = rs.run_plan(k.P.rebind_load_versions(
            _aggs_plan(k), {"fact": 1}))
        assert run_rep.n_executed == 0
        cold, _ = k.restore(k.fact(21, 48), heuristic="off",
                            rewrite_enabled=False, semantic=False
                            ).run_plan(k.P.rebind_load_versions(
                                _aggs_plan(k), {"fact": 1}))
        assert_same(out["out"], cold["out"], "refreshed vs cold")
        got[k.port] = out["out"]
    assert_same(got[True], got[False], "port vs reference")


def _aggs_plan(k):
    g = k.P.groupby(k.P.load("fact"), ["k"], {"s": ("sum", "w"),
                                              "n": ("count", "v")})
    return k.P.PhysicalPlan([k.P.store(g, "out")])


# ---------------- stale views, device cache, disk; append never mutates


def test_refresh_invalidates_derived_views_and_device_cache(tmp_path):
    store = PORT.store(root=str(tmp_path))
    _partitioned(PORT, store, "art", PORT.fact(0, 64), ["k"], 4)
    v8, _ = store.get_partitioned("art", ["k"], 8)
    assert int(v8.valid.sum()) == 64
    assert store.get("art") is not None
    store.append("art", PORT.fact(5, 16))
    assert int(store.get("art").valid.sum()) == 80, \
        "device cache served a stale pre-refresh table"
    v8b, _ = store.get_partitioned("art", ["k"], 8)
    assert int(v8b.valid.sum()) == 80, \
        "derived re-partitioned view survived the refresh"
    assert _block_layout_ok(PORT, v8b, ["k"], 8)
    store.flush()
    store.close()


def test_monolithic_refresh_replaces_device_cache_and_disk(tmp_path):
    store = PORT.store(root=str(tmp_path))
    store.put("a", PORT.fact(0, 32))
    assert store.cache.get("a") is not None
    store.append("a", PORT.fact(1, 8))
    assert int(store.get("a").valid.sum()) == 40
    store.flush()
    s2 = PORT.store(root=store.root)
    assert int(s2.get("a").valid.sum()) == 40
    # and the reference reads the refreshed bytes too
    r2 = RA.ArtifactStore(root=store.root)
    assert_same(r2.get("a"), s2.get("a"), "reopened in the reference")
    store.close()
    s2.close()


@pytest.mark.parametrize("partitioned", [False, True])
def test_append_leaves_earlier_get_tensors_unchanged(partitioned):
    store = PORT.store()
    if partitioned:
        _partitioned(PORT, store, "a", PORT.fact(0, 64), ["k"], 4)
    else:
        store.put("a", PORT.fact(0, 64))
    held = store.get("a")
    before = {n: c.clone() for n, c in held.columns.items()}
    valid_before = held.valid.clone()
    store.append("a", PORT.fact(5, 16))
    for n, c in held.columns.items():
        assert torch.equal(c, before[n]), n
    assert torch.equal(held.valid, valid_before)
    new = store.get("a")
    assert new is not held and int(new.valid.sum()) == 80
    assert all(c.data_ptr() != held.col(n).data_ptr()
               for n, c in new.columns.items())


# --------------------------------------- cost-model refresh arbitration


def _entry_for_decision(k, use_count=0, producer_cost_s=10.0):
    plan = k.P.PhysicalPlan([k.P.store(
        k.P.groupby(k.P.load("fact"), ["k"], {"s": ("sum", "v")}),
        "art/d")])
    e = k.Repo.make_entry(plan, "art/d", bytes_out=1 << 10,
                          exec_time_s=producer_cost_s,
                          producer_cost_s=producer_cost_s)
    e.use_count = use_count
    return e


@pytest.mark.parametrize("cm_kw,entry_kw,frac,want", [
    ({}, {"use_count": 3}, 0.05, "refresh"),
    ({}, {"use_count": 3}, 1.5, "delete"),
    ({"fixed_io_s": 0.5}, {"producer_cost_s": 0.1}, 0.05, "delete"),
    ({}, {}, 0.05, "lazy"),
], ids=["hot_refreshes", "large_delta_deletes", "worthless_deletes",
        "cold_defers"])
def test_refresh_decision_matches_reference(cm_kw, entry_kw, frac, want):
    import time
    now = time.time()
    got = []
    for k in BOTH:
        e = _entry_for_decision(k, **entry_kw)
        e.created_at = now
        if e.use_count:
            e.last_used = now
        got.append(k.CM.CostModel(**cm_kw).refresh_decision(
            e, delta_fraction=frac, now=now))
    assert got == [want, want]


# ------------------------------------------------------- lazy refresh


def _lazy(k, second_append):
    rs = k.restore(heuristic="off")
    rs.run_plan(_group_sum(k))
    rs.catalog.append("fact", k.fact(3, 16))
    rep = rs.maintain(mode="lazy")
    n_pending = len(rs.repo.pending_refresh)
    if second_append:
        rs.catalog.append("fact", k.fact(4, 8))
    v = rs.catalog.version("fact")
    got, run_rep = rs.run_plan(k.P.rebind_load_versions(_group_sum(k),
                                                        {"fact": v}))
    cold_rs = k.restore(heuristic="off", rewrite_enabled=False,
                        semantic=False)
    cold_rs.catalog.append("fact", k.fact(3, 16))
    if second_append:
        cold_rs.catalog.append("fact", k.fact(4, 8))
    cold, _ = cold_rs.run_plan(k.P.rebind_load_versions(_group_sum(k),
                                                        {"fact": v}))
    assert_same(got["out"], cold["out"], "lazy refresh vs cold")
    return (rep, n_pending, rs.repo.refreshes, len(rs.repo.pending_refresh),
            run_rep.n_executed), got["out"]


@pytest.mark.parametrize("second_append", [False, True],
                         ids=["fires_on_probe", "rederives_after_append"])
def test_lazy_refresh_matches_reference(second_append):
    r_rec, r_out = _lazy(REF, second_append)
    p_rec, p_out = _lazy(PORT, second_append)
    assert p_rec == r_rec
    assert p_rec[0]["lazy"] == 1 and p_rec[1] == 1
    assert p_rec[2:] == (1, 0, 0)
    assert_same(p_out, r_out, "port vs reference")


def test_maintain_auto_uses_cost_model():
    reps = []
    for k in BOTH:
        rs = k.restore(heuristic="off")
        rs.run_plan(_group_sum(k))
        rs.run_plan(_group_sum(k))       # whole-job fast path: a reuse
        (entry,) = rs.repo.entries
        assert entry.use_count >= 1
        entry.producer_cost_s = 10.0     # make reuse clearly valuable
        rs.catalog.append("fact", k.fact(3, 8))
        reps.append(rs.maintain(mode="auto"))
    assert reps[0] == reps[1] and reps[1]["refreshed"] == 1


def test_stream_append_churn_matches_reference():
    out = []
    for k in BOTH:
        cfg = k.S.StreamConfig(n_events=8, n_tenants=2, n_rows=1 << 8,
                               append_every=3, append_frac=0.25,
                               maintain="refresh", seed=0)
        res = k.S.run_stream("keep", cfg, **k.dev)
        out.append((res.refreshes, res.repo_entries,
                     [(e.tenant, e.template, e.n_executed, e.n_reused)
                      for e in res.events]))
    assert out[1] == out[0]
    assert len(out[1][2]) == 8 and out[1][0] >= 1


def _recomputed_first(k):
    """The new-version plan runs BEFORE maintenance: the stale entry must
    R4-drop (eager), and a parked lazy refresh must not fire over a
    fresh entry registered at its refreshed signature."""
    rs = k.restore(heuristic="off")
    rs.run_plan(_group_sum(k))
    rs.catalog.append("fact", k.fact(3, 16))
    plan2 = k.P.rebind_load_versions(_group_sum(k), {"fact": 1})
    rs.run_plan(plan2)
    n_before = len(rs.repo)
    rep = rs.maintain(mode="refresh")
    (entry,) = rs.repo.entries
    assert entry.source_versions["fact"] == 1
    assert rs.repo.by_sig[entry.signature] is entry

    rs2 = k.restore(heuristic="off")
    rs2.run_plan(_group_sum(k))
    rs2.catalog.append("fact", k.fact(3, 16))
    lazy = rs2.maintain(mode="lazy")["lazy"]
    (spec,) = rs2.repo.pending_refresh.values()
    dup = k.Repo.make_entry(plan2, "art/dup", bytes_out=64)
    assert dup.signature == spec.refreshed_signature
    assert rs2.repo.add(dup)
    n = rs2.repo.refresh_pending(plan2, rs2.engine, rs2.catalog,
                                 rs2.store)
    assert not rs2.repo.pending_refresh
    assert [e.signature for e in rs2.repo.entries] == [dup.signature]
    return n_before, rep, lazy, n


def test_refresh_skipped_when_new_version_already_recomputed():
    got = _recomputed_first(PORT)
    assert got == _recomputed_first(REF)
    assert got == (2, {"refreshed": 0, "lazy": 0, "deleted": 1}, 1, 0)


def test_derive_refresh_none_when_not_stale_and_merge_guard():
    rs = PORT.restore(heuristic="off")
    rs.run_plan(_group_sum(PORT))
    (entry,) = rs.repo.entries
    assert TD.derive_refresh(entry, rs.catalog) is None
    store = PORT.store()
    store.put("mono", PORT.fact(0, 16))
    with pytest.raises(ValueError):
        store.merge_shards("mono", PORT.fact(1, 4))
    assert TP.Partitioning.from_dict(None) is None


def test_refresh_spec_matches_reference():
    """The derived delta plan, its merge class and its refreshed
    signature are the reference's, case by case."""
    for case, (build, dfact, ddim) in sorted(REFRESH_CASES.items()):
        specs = []
        for k in BOTH:
            rs = k.restore(heuristic="aggressive")
            rs.run_plan(build(k))
            if dfact is not None:
                rs.catalog.append("fact", dfact(k))
            if ddim is not None:
                rs.catalog.append("dim", ddim(k))
            got = []
            for e in sorted(rs.repo.entries, key=lambda e: e.signature):
                s = k.D.derive_refresh(e, rs.catalog)
                got.append(None if s is None else (
                    s.kind, s.delta_name, s.refreshed_signature,
                    s.delta_fraction, s.merge_keys,
                    k.P.plan_signature(s.delta_plan)))
            specs.append(got)
        assert specs[1] == specs[0], case


def test_refresh_on_a_mesh_engine_matches_cold_single_device():
    """A mesh engine pads the delta bindings to a multiple of its shard
    count (``pad_capacity``: 3 shards never divide the power-of-two
    binding capacities) before the delta job runs; the refreshed value
    still equals a cold single-device recompute."""
    from repro_torch.launch.mesh import LocalMesh
    for build, dfact in ((_groupby_all, lambda k: k.fact(11, 45)),
                         (_union, lambda k: k.fact(8, 24))):
        rs = PORT.restore(heuristic="aggressive",
                          mesh=LocalMesh(3, device="cpu"))
        rs.run_plan(build(PORT))
        rs.catalog.append("fact", dfact(PORT))
        assert rs.maintain(mode="refresh")["refreshed"] >= 1
        plan2 = TP.rebind_load_versions(build(PORT), {"fact": 1})
        got, run_rep = rs.run_plan(plan2)
        assert run_rep.n_executed == 0
        cold, _ = PORT.restore(dfact(PORT), heuristic="off",
                               rewrite_enabled=False,
                               semantic=False).run_plan(plan2)
        assert_same(got["out"], cold["out"], build.__name__)
