"""The whole slice: the ReStore loop of the port against the reference.

Every PigMix query runs in the three arms of
``benchmarks/common.py::measure_query`` — plain (no stores, no
rewrite), store (aggressive heuristic) and reuse (final outputs evicted,
a new driver over the same store and repository rewrites against it) —
in both packages on the same generated data, and each arm's results
must equal the reference's: keys and integer-valued aggregates exactly,
float sums and means over ``estimated_revenue`` within RTOL/ATOL.  The
scenarios of ``tests/test_restore_system.py`` then run on the port, and
stores and repositories written by either package reopen in the other.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import restore as RR  # noqa: E402
from repro.core import serialize as RS  # noqa: E402
from repro.dataflow import compiler as RC  # noqa: E402
from repro.store import artifacts as RA  # noqa: E402
from repro.workloads import pigmix as RW  # noqa: E402
from repro_torch.core import plan as TP  # noqa: E402
from repro_torch.core import restore as TR  # noqa: E402
from repro_torch.core import serialize as TS  # noqa: E402
from repro_torch.core.enumerator import AGGRESSIVE, CONSERVATIVE  # noqa: E402
from repro_torch.dataflow import compiler as TC  # noqa: E402
from repro_torch.dataflow.expr import Col  # noqa: E402
from repro_torch.store import artifacts as TA  # noqa: E402
from repro_torch.workloads import pigmix as TW  # noqa: E402

N_ROWS = 1024
RTOL, ATOL = 1e-5, 1e-3
# float aggregates of estimated_revenue: added in another order
APPROX = {"L3": {"total"}, "L3F": {"avg_rev"}, "L8": {"r"}}

# ---------------------------------------------------------------- helpers


def _ref_driver(heuristic, rewrite):
    store = RA.ArtifactStore()
    cat = RA.Catalog(store)
    RW.register_all(cat, n_rows=N_ROWS)
    return RR.ReStore(cat, store, heuristic=heuristic,
                      rewrite_enabled=rewrite)


def _port_driver(heuristic, rewrite, **kw):
    store = TA.ArtifactStore(device="cpu")
    cat = TA.Catalog(store, device="cpu")
    TW.register_all(cat, n_rows=N_ROWS)
    return TR.ReStore(cat, store, heuristic=heuristic,
                      rewrite_enabled=rewrite, device="cpu", **kw)


def _evict_finals(rs, plan, compile_workflow):
    finals = set(compile_workflow(plan).final_outputs.values())
    for name in finals:
        rs.store.delete(name)
    rs.repo._replace([e for e in rs.repo.entries
                      if e.artifact not in finals], [], None)


def _three_arms(make, W, compile_workflow, qname):
    plan_fn = W.QUERIES[qname]
    plain, _ = make("off", False).run(plan_fn())
    rs = make("aggressive", False)
    store_res, _ = rs.run(plan_fn())
    _evict_finals(rs, plan_fn(), compile_workflow)
    kw = {"device": "cpu"} if W is TW else {}
    reuse, rep = type(rs)(rs.catalog, rs.store, rs.repo, heuristic="off",
                          rewrite_enabled=True, **kw).run(plan_fn())
    return plain, store_res, reuse, rep


def _assert_results_equal(port_res, ref_res, approx=()):
    assert sorted(port_res) == sorted(ref_res)
    for k in ref_res:
        got, want = port_res[k].to_numpy(), ref_res[k].to_numpy()
        assert sorted(got) == sorted(want)
        for c in want:
            assert got[c].dtype == want[c].dtype, (k, c)
            if c in approx:
                np.testing.assert_allclose(got[c], want[c], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{k}.{c}")
            else:
                np.testing.assert_array_equal(got[c], want[c],
                                              err_msg=f"{k}.{c}")


def _rows(table):
    return {k: np.sort(v.astype(np.float64), axis=0)
            for k, v in table.to_numpy().items() if v.dtype.kind in "if"}


def _assert_rows_close(a_res, b_res):
    for k in a_res:
        a, b = _rows(a_res[k]), _rows(b_res[k])
        for c in a:
            assert np.allclose(a[c], b[c], atol=1e-3), (k, c)


# ------------------------------------------- every query, three arms


@pytest.mark.parametrize("qname", sorted(TW.QUERIES))
def test_three_arms_match_reference(qname):
    ref = _three_arms(_ref_driver, RW, RC.compile_workflow, qname)
    port = _three_arms(_port_driver, TW, TC.compile_workflow, qname)
    approx = APPROX.get(qname, ())
    for arm in range(3):
        _assert_results_equal(port[arm], ref[arm], approx)
    # the reuse arm reuses wherever the reference's does
    assert (port[3].n_reused > 0) == (ref[3].n_reused > 0), \
        (port[3].n_reused, ref[3].n_reused)


# ------------------------------- tests/test_restore_system.py scenarios


def fresh(heuristic="aggressive", **kw):
    return _port_driver(heuristic, True, **kw)


def test_whole_job_reuse_gives_same_results():
    rs = fresh()
    _, rep_a = rs.run(TW.L3("sum"))
    assert rep_a.n_executed == 2
    res_b, rep_b = rs.run(TW.L3("mean"))
    assert not rep_b.jobs[0].executed, "join job reused"
    assert rep_b.jobs[1].executed
    res_ref, _ = fresh().run(TW.L3("mean"))
    _assert_rows_close(res_ref, res_b)


def test_subjob_reuse_gives_same_results():
    rs = fresh(min_splice_benefit_s=0.0)
    rs.run(TW.L3("sum"))              # stores Load+Project sub-jobs
    pv = TP.project(TP.load("page_views"), ["user", "estimated_revenue"])
    q = TP.PhysicalPlan([TP.store(
        TP.filter_(pv, Col("estimated_revenue") > 50.0), "q_out")])
    res, rep = rs.run(q)
    assert rep.jobs[0].reused_artifacts, "sub-job reuse must fire"
    res_ref, _ = fresh().run(q)
    _assert_rows_close(res_ref, res)


def test_heuristics_store_sets_are_nested():
    stored = {}
    for h in ("conservative", "aggressive", "none"):
        _, rep = fresh(heuristic=h).run(TW.L3("sum"))
        stored[h] = {a for j in rep.jobs for a in j.stored_candidates}
    assert stored["conservative"] <= stored["aggressive"] <= stored["none"]
    assert CONSERVATIVE < AGGRESSIVE


def test_every_query_fully_reused_by_a_fresh_driver():
    rs = fresh()
    for qfn in TW.QUERIES.values():
        rs.run(qfn())
    rs2 = TR.ReStore(rs.catalog, rs.store, rs.repo, heuristic="off",
                     device="cpu")
    for name, qfn in TW.QUERIES.items():
        _, rep = rs2.run(qfn())
        assert rep.n_executed == 0, f"{name}: full reuse expected"


def test_catalog_version_bump_prevents_stale_reuse():
    rs = fresh()
    rs.run(TW.L3("sum"))
    assert len(rs.repo) > 0
    rs.catalog.register("page_views",
                        TW.gen_page_views(512, seed=99, device="cpu"))
    rs.repo.evict_stale(rs.catalog)
    pv = TP.project(TP.load("page_views",
                            version=rs.catalog.version("page_views")),
                    ["user", "estimated_revenue"])
    _, rep = rs.run(TP.PhysicalPlan([TP.store(pv, "v_out")]))
    assert not rep.jobs[0].reused_artifacts


def test_l7_streaming_splice_declined():
    store = TA.ArtifactStore(device="cpu")
    cat = TA.Catalog(store, device="cpu")
    TW.register_all(cat, n_rows=4096)
    rs = TR.ReStore(cat, store, heuristic="aggressive", device="cpu")
    res_cold, _ = rs.run(TW.L7())

    _evict_finals(rs, TW.L7(), TC.compile_workflow)
    armed = TR.ReStore(cat, store, rs.repo, heuristic="off", device="cpu")
    assert armed.repo.cost_model.min_splice_benefit_s > 0
    res_a, rep_a = armed.run(TW.L7())
    assert all(not j.reused_artifacts for j in rep_a.jobs)
    assert any(j.executed for j in rep_a.jobs)

    _evict_finals(rs, TW.L7(), TC.compile_workflow)
    rs.repo.cost_model.min_splice_benefit_s = 0.0
    disarmed = TR.ReStore(cat, store, rs.repo, heuristic="off",
                          device="cpu")
    res_d, rep_d = disarmed.run(TW.L7())
    assert any(j.reused_artifacts for j in rep_d.jobs)
    for res in (res_a, res_d):
        _assert_rows_close(res_cold, res)


# ------------------------------------------ stores and repositories


def _disk_run(tmp_path, W, make_store, make_cat, make_rs, S):
    store = make_store(str(tmp_path))
    cat = make_cat(store)
    W.register_all(cat, n_rows=N_ROWS)
    rs = make_rs(cat, store)
    rs.run(W.L3("sum"))
    rs.run(W.L11())
    store.flush()
    S.save_repository(rs.repo, str(tmp_path / "repo.json"))
    names = store.names()
    tables = {n: store.get(n) for n in names}
    store.close()
    return names, tables


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_and_repository_reopen_in_the_other_package(tmp_path, writer):
    root = tmp_path / "store"
    if writer == "reference":
        names, written = _disk_run(
            root, RW, lambda r: RA.ArtifactStore(root=r),
            lambda s: RA.Catalog(s),
            lambda c, s: RR.ReStore(c, s, heuristic="aggressive"), RS)
        reader = TA.ArtifactStore(root=str(root), device="cpu")
        repo = TS.load_repository(str(root / "repo.json"))
    else:
        names, written = _disk_run(
            root, TW, lambda r: TA.ArtifactStore(root=r, device="cpu"),
            lambda s: TA.Catalog(s, device="cpu"),
            lambda c, s: TR.ReStore(c, s, heuristic="aggressive",
                                    device="cpu"), TS)
        reader = RA.ArtifactStore(root=str(root))
        repo = RS.load_repository(str(root / "repo.json"))
    assert names and reader.names() == names
    for n in names:
        assert reader.verify(n)
        got = reader.get(n)
        want = written[n]
        np.testing.assert_array_equal(np.asarray(got.valid),
                                      np.asarray(want.valid))
        g, w = got.to_numpy(only_valid=False), want.to_numpy(False)
        assert sorted(g) == sorted(w)
        for c in w:
            assert np.asarray(g[c]).tobytes() == np.asarray(w[c]).tobytes()
    assert len(repo.entries) > 0
    assert sorted(e.signature for e in repo.entries) == \
        sorted(e.signature for e in (RS if writer == "port" else TS)
               .load_repository(str(root / "repo.json")).entries)
    reader.close()


def test_disk_store_write_behind_uses_the_compaction_path(tmp_path):
    store = TA.ArtifactStore(root=str(tmp_path), device="cpu")
    cat = TA.Catalog(store, device="cpu")
    TW.register_all(cat, n_rows=N_ROWS)
    rs = TR.ReStore(cat, store, heuristic="aggressive", device="cpu")
    rs.run(TW.L2())
    store.flush()
    assert store.names()
    for n in store.names():
        m = store.meta[n]
        assert m["capacity"] >= m["rows"] and store.verify(n)
    reopened = TA.ArtifactStore(root=str(tmp_path), device="cpu")
    for n in store.names():
        t = reopened.get(n)
        assert int(t.num_valid()) == store.meta[n]["rows"]
    store.close()
    reopened.close()
