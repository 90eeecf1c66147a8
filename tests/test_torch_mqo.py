"""The port's multi-query batch optimizer against the reference
(``tests/test_mqo.py``'s cases, DESIGN.md §16).

The same batches go through ``repro`` and ``repro_torch``
(``device="cpu"``): the shared sub-plans (fingerprint, kind, consumers,
artifact, semantic flag, already stored), the known-uses hints and the
boundary are the reference's; batched results are bit-identical to
sequential runs and to the reference's batched results; no shared
sub-plan executes twice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as RCM  # noqa: E402
from repro.core import mqo as RM  # noqa: E402
from repro.core import restore as RR  # noqa: E402
from repro.core import rewriter as RW  # noqa: E402
from repro.dataflow import builder as RB  # noqa: E402
from repro.dataflow import compiler as RC  # noqa: E402
from repro.service import service as RSvc  # noqa: E402
from repro.store import artifacts as RA  # noqa: E402
from repro.workloads import pigmix as RPM  # noqa: E402
from repro.workloads import stream as RS  # noqa: E402
from repro_torch.core import cost_model as TCM  # noqa: E402
from repro_torch.core import mqo as TM  # noqa: E402
from repro_torch.core import restore as TR  # noqa: E402
from repro_torch.core import rewriter as TW  # noqa: E402
from repro_torch.dataflow import builder as TB  # noqa: E402
from repro_torch.dataflow import compiler as TC  # noqa: E402
from repro_torch.service import service as TSvc  # noqa: E402
from repro_torch.store import artifacts as TA  # noqa: E402
from repro_torch.workloads import pigmix as TPM  # noqa: E402
from repro_torch.workloads import stream as TS  # noqa: E402

N_ROWS = 1024


class Pkg:
    def __init__(self, port: bool):
        self.port = port
        (self.M, self.R, self.W, self.B, self.C, self.Svc, self.A,
         self.PM, self.S, self.CM) = (
            (TM, TR, TW, TB, TC, TSvc, TA, TPM, TS, TCM) if port else
            (RM, RR, RW, RB, RC, RSvc, RA, RPM, RS, RCM))
        self.dev = {"device": "cpu"} if port else {}

    def catalog(self, n_rows=N_ROWS):
        store = self.A.ArtifactStore(**self.dev)
        cat = self.A.Catalog(store, **self.dev)
        self.PM.register_all(cat, n_rows=n_rows)
        return cat, store

    def driver(self, heuristic="cost", n_rows=N_ROWS, **kw):
        cat, store = self.catalog(n_rows)
        return self.R.ReStore(cat, store, heuristic=heuristic, **kw,
                              **self.dev)

    def scan_variant(self, thresh, name):
        return (self.B.Dataflow.load("page_views")
                .filter(self.B.col("timespent") > thresh)
                .group_by("user", n=("count", "timespent"))
                .store(name).build())

    def batch(self):
        return [self.PM.L3("sum"), self.PM.L3F(), self.PM.L2(),
                self.scan_variant(10, "v10"), self.scan_variant(60, "v60")]

    def variants(self):
        return [self.scan_variant(10, "a"), self.scan_variant(50, "b"),
                self.scan_variant(80, "c")]


REF, PORT = Pkg(False), Pkg(True)
BOTH = (REF, PORT)


def _canon(table):
    d = table.to_numpy()

    def key(a):
        return (np.ascontiguousarray(a).view(f"S{a.shape[1]}").ravel()
                if a.ndim == 2 else a)

    order = np.lexsort(tuple(key(d[c]) for c in sorted(d, reverse=True)))
    return {c: d[c][order] for c in sorted(d)}


def _assert_identical(a, b):
    assert set(a) == set(b)
    for k in a:
        ca, cb = _canon(a[k]), _canon(b[k])
        assert set(ca) == set(cb)
        for c in ca:
            assert ca[c].dtype == cb[c].dtype, (k, c)
            assert np.array_equal(ca[c], cb[c]), (k, c)


def _shape(bp):
    """Everything a BatchPlan decides, as plain data."""
    return ([(s.fp, s.kind, s.n_consumers, s.artifact, s.semantic,
              s.already_stored) for s in bp.shared],
            None if bp.shared_plan is None else
            sorted(s.params["name"] for s in bp.shared_plan.sinks),
            dict(bp.known_uses), sorted(bp.boundary_artifacts))


# ------------------------------------------------------------- planning


BATCHES = {
    "exact_maximal_shared": lambda k: [k.PM.L3("sum"), k.PM.L3F(),
                                       k.PM.L2()],
    "semantic_covering": lambda k: k.variants(),
    "no_overlap": lambda k: [k.PM.L6(), k.PM.L8()],
    "builders": lambda k: _flow_and_plan(
        k.B.Dataflow.load("page_views").project("user", "timespent")
        .store("x")),
}


def _flow_and_plan(flow):
    return [flow, flow.build()]


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_optimize_batch_matches_reference(name):
    r, p = (k.M.optimize_batch(BATCHES[name](k)) for k in BOTH)
    assert _shape(p) == _shape(r)
    by_kind = {s.kind: s for s in p.shared}
    if name == "exact_maximal_shared":
        assert by_kind["JOIN"].n_consumers == 2
        assert by_kind["PROJECT"].n_consumers == 3 and len(p.shared) == 2
        assert set(p.known_uses) >= p.boundary_artifacts
    elif name == "semantic_covering":
        (sem,) = [s for s in p.shared if s.semantic]
        assert sem.kind == "FILTER" and sem.n_consumers == 3
    elif name == "no_overlap":
        assert p.shared == [] and p.shared_plan is None
        assert p.known_uses == {}
    else:
        assert len(p.shared) == 1 and p.shared[0].n_consumers == 2


def test_optimize_batch_drops_already_stored_from_prefix():
    shapes = []
    for k in BOTH:
        rs = k.driver()
        rs.run(k.PM.L3("sum"))
        bp = k.M.optimize_batch([k.PM.L3("sum"), k.PM.L3F()], repo=rs.repo)
        (join,) = [s for s in bp.shared if s.kind == "JOIN"]
        assert join.already_stored
        live = ([] if bp.shared_plan is None else
                [s.params["name"] for s in bp.shared_plan.sinks])
        assert join.plan.sinks[0].params["name"] not in live
        shapes.append(_shape(bp))
    assert shapes[1] == shapes[0]


def test_planning_probe_does_not_credit_record_use():
    rs = PORT.driver(heuristic="aggressive")
    rs.run(TPM.L3("sum"))
    before = {e.artifact: e.use_count for e in rs.repo.ordered()}
    assert before
    wf = TC.compile_workflow(TPM.L3("sum"))
    for job in wf.jobs:
        TW.rewrite_plan(job.plan, rs.repo, record=False)
    after = {e.artifact: e.use_count for e in rs.repo.ordered()}
    assert after == before, "planning probes must not credit record_use"
    for job in wf.jobs:
        TW.rewrite_plan(job.plan, rs.repo)
    assert any(after[e.artifact] < e.use_count for e in rs.repo.ordered())


def test_known_uses_hint_admits_never_seen_subjob():
    got = []
    for k in BOTH:
        cm = k.CM.CostModel()
        fp = "deadbeef" * 8
        rec = [cm.should_materialize(fp)]
        cm.set_known_uses({fp: 3.0})
        rec += [cm.should_materialize(fp),
                cm.should_materialize("other" * 8, artifact=fp)]
        cm.clear_known_uses([fp])
        rec.append(cm.should_materialize(fp))
        cm.set_known_uses({"k": 5.0})
        cm.set_known_uses({"k": 2.0})
        rec.append(cm.known_uses_for("k"))
        cm.clear_known_uses()
        rec.append(cm.known_uses)
        got.append(rec)
    assert got[1] == got[0] == [False, True, True, False, 5.0, {}]


# ------------------------------------------------------------ execution


@pytest.mark.parametrize("which", ["batch", "variants"])
def test_batch_bit_identical_to_sequential_and_reference(which):
    out = {}
    for k in BOTH:
        queries = getattr(k, which)()
        rs = k.driver()
        br = k.M.run_batch(rs, queries)
        assert br.dup_executions == 0
        assert k.M.count_dup_executions(br.batch, br.reports) == 0
        assert len(br.batch.shared) >= 1
        assert br.shared_report is not None
        assert br.shared_report.n_executed >= 1
        for s in br.batch.shared:
            assert rs.store.exists(s.artifact)
            assert any(e.artifact == s.artifact for e in rs.repo.ordered())
        assert rs.repo.cost_model.known_uses == {} and not rs.repo.pinned
        seq = k.driver()
        for q, bres in zip(getattr(k, which)(), br.results):
            _assert_identical(bres, seq.run(q)[0])
        n_sem = sum(j.n_semantic for rep in br.reports for j in rep.jobs)
        if which == "variants":
            assert n_sem >= 2, "stricter variants splice the covering chain"
        out[k.port] = (br, n_sem)
    (pb, p_sem), (rb, r_sem) = out[True], out[False]
    assert _shape(pb.batch) == _shape(rb.batch)
    assert p_sem == r_sem
    assert [r.n_executed for r in pb.reports] == \
        [r.n_executed for r in rb.reports]
    for a, b in zip(pb.results, rb.results):
        _assert_identical(a, b)


def test_count_dup_executions_flags_unshielded_recompute():
    got = []
    for k in BOTH:
        bp = k.M.optimize_batch([k.PM.L3("sum"), k.PM.L3F()])
        rs = k.driver(heuristic="off", n_rows=256, rewrite_enabled=False)
        got.append(k.M.count_dup_executions(
            bp, [rs.run(p)[1] for p in bp.plans]))
    assert got[1] == got[0] and got[1] >= 1


def test_run_batch_via_driver_convenience():
    br = PORT.driver().run_batch([TPM.L3("sum"), TPM.L3F()])
    assert br.dup_executions == 0
    assert {"L3_sum_out"} <= set(br.results[0])


# -------------------------------------------------------------- service


def test_submit_batch_fans_out_tickets():
    out = {}
    for k in BOTH:
        cat, store = k.catalog()
        svc = k.Svc.ReStoreService(cat, store, n_workers=2,
                                   heuristic="cost", **k.dev)
        try:
            tickets = svc.submit_batch(k.batch(),
                                       tenants=["a", "b", "c", "a", "b"])
            results = [t.result(120) for t in tickets]
            st = svc.stats()
            assert st["batches"] == 1 and st["batch_shared_subplans"] >= 1
            assert st["dup_executions"] == 0
        finally:
            svc.stop()
        seq = k.driver()
        for q, (bres, _rep) in zip(k.batch(), results):
            _assert_identical(bres, seq.run(q)[0])
        out[k.port] = ([r for r, _ in results], st["batch_shared_subplans"])
    assert out[True][1] == out[False][1]
    for a, b in zip(out[True][0], out[False][0]):
        _assert_identical(a, b)


def test_submit_batch_accepts_builders_and_tenant_mismatch_raises():
    cat, store = PORT.catalog(256)
    svc = TSvc.ReStoreService(cat, store, n_workers=1, heuristic="cost",
                              device="cpu")
    try:
        with pytest.raises(ValueError, match="1:1"):
            svc.submit_batch([TPM.L2()], tenants=["a", "b"])
        flow = (TB.Dataflow.load("page_views").project("user")
                .distinct().store("u"))
        (res, _), = [t.result(60) for t in svc.submit_batch([flow])]
        assert "u" in res
    finally:
        svc.stop()


# --------------------------------------------------------------- stream


def test_stream_mqo_mode_batches_without_dups():
    out = []
    for k in BOTH:
        r = k.S.run_stream("mqo", k.S.StreamConfig(n_events=8, n_rows=512,
                                                   batch_size=4), **k.dev)
        assert r.batches == 2 and r.mqo_dup_executions == 0
        assert len(r.events) == 8
        r_cost = k.S.run_stream("cost", k.S.StreamConfig(
            n_events=8, n_rows=512), **k.dev)
        assert r.n_reused_total >= r_cost.n_reused_total
        out.append([(e.tenant, e.template) for e in r.events])
    assert out[1] == out[0]
