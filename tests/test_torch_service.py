"""The port's ReStore service, journal, fault injection and stream driver
against the reference (``tests/test_service.py``, ``test_faults.py``,
``test_crash_recovery.py`` without the remote-tier demotion case, and
``test_repository_policy.py::test_stream_driver_smoke_all_modes``;
DESIGN.md §9, §13, §15).

Answers are held against the reference's: every result the port's
service, fault sweep or recovered repository returns must equal the
reference's serial baseline on the same seeded PigMix tables (valid rows
after a canonical sort).  Scheduling counters are the reference test's
expectations.  Cross-package properties: a journal either package writes
replays in the other, and one ``FaultSchedule`` seed fires the same
faults at the same IO events in both packages (``write_behind=False``,
so the draw order does not depend on thread timing).  The prefetch test
calls ``prefetch_now()`` itself instead of waiting on the interval loop.
"""
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import _service_util as RU  # noqa: E402
from repro.core import repository as RRepo  # noqa: E402
from repro.core import restore as RR  # noqa: E402
from repro.service import faults as RF  # noqa: E402
from repro.service import journal as RJ  # noqa: E402
from repro.service import service as RSvc  # noqa: E402
from repro.store import artifacts as RA  # noqa: E402
from repro.workloads import pigmix as RPM  # noqa: E402
from repro.workloads import stream as RS  # noqa: E402
from repro_torch.core.repository import Repository  # noqa: E402
from repro_torch.core.restore import ReStore  # noqa: E402
from repro_torch.core.serialize import (load_repository,  # noqa: E402
                                        save_repository)
from repro_torch.service import faults as TF  # noqa: E402
from repro_torch.service.journal import (RepositoryJournal,  # noqa: E402
                                         replay_journal)
from repro_torch.service.service import (ReStoreService,  # noqa: E402
                                         ServiceClosed, ServiceOverloaded,
                                         ServiceTimeout)
from repro_torch.store.artifacts import (ArtifactFlushError,  # noqa: E402
                                         ArtifactStore, Catalog,
                                         TransientStoreError, _encode_name)
from repro_torch.workloads import pigmix  # noqa: E402
from repro_torch.workloads import stream as TS  # noqa: E402

N_ROWS = 512
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_RATES = {"transient": 0.15, "latency": 0.05,
               "truncate": 0.10, "flip": 0.10, "manifest": 0.05}

_BASELINE = {}


def ref_baseline():
    """The reference's answers to the standard mix, computed once."""
    if "mix" not in _BASELINE:
        _BASELINE["mix"] = RU.run_mix(RU.fresh_driver(n_rows=N_ROWS))
    return _BASELINE["mix"]


# ------------------------------------------------------ port helpers


def fresh_driver(root=None, injector=None, repository=None, **kw):
    store_kw = {k: kw.pop(k) for k in ("cache_bytes", "write_behind",
                                       "tmp_gc_age_s") if k in kw}
    store = ArtifactStore(root=None if root is None else str(root),
                          fault_injector=injector, device="cpu", **store_kw)
    cat = Catalog(store, device="cpu")
    pigmix.register_all(cat, n_rows=N_ROWS)
    return ReStore(cat, store, repository if repository is not None
                   else Repository(), device="cpu", **kw)


def run_mix(driver):
    out = {}
    for label, qfn in (("L3_sum", lambda: pigmix.L3("sum")),
                       ("L2", pigmix.L2),
                       ("L3_mean", lambda: pigmix.L3("mean"))):
        results, _ = driver.run_plan(qfn())
        for sink, table in results.items():
            out[f"{label}:{sink}"] = table
    return out


def _service(tmp_path=None, **kw):
    store = ArtifactStore(root=None if tmp_path is None
                          else str(tmp_path / "store"), device="cpu")
    cat = Catalog(store, device="cpu")
    pigmix.register_all(cat, n_rows=N_ROWS)
    kw.setdefault("n_workers", 2)
    return ReStoreService(cat, store, Repository(), device="cpu", **kw)


def _gate(svc):
    """Make every worker block inside run_plan until released."""
    ev = threading.Event()
    for drv in svc._drivers:
        orig = drv.run_plan

        def wrapped(plan, _orig=orig):
            ev.wait(30)
            return _orig(plan)

        drv.run_plan = wrapped
    return ev


def _distinct_plans():
    return [pigmix.L2(), pigmix.L3("sum"), pigmix.L3("mean"),
            pigmix.L4(), pigmix.L5()]


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "condition never became true"
        time.sleep(0.002)


# -------------------------------------------------------- correctness


def test_concurrent_results_match_reference_baseline():
    svc = _service(n_workers=4)
    try:
        tickets = [(label, svc.submit(qfn(), tenant=f"t{i % 2}"))
                   for i, (label, qfn) in enumerate(
                       [("L3_sum", lambda: pigmix.L3("sum")),
                        ("L2", pigmix.L2),
                        ("L3_mean", lambda: pigmix.L3("mean"))])]
        got = {}
        for label, t in tickets:
            results, _ = t.result(timeout=120)
            for sink, table in results.items():
                got[f"{label}:{sink}"] = table
        assert RU.results_identical(ref_baseline(), got)
        assert RU.results_identical(run_mix(fresh_driver()), got)
        st = svc.stats()
        assert st["dup_executions"] == 0
        assert st["completed"] == 3 and st["failed"] == 0
    finally:
        svc.stop()


def test_shared_repository_gives_cross_tenant_reuse():
    svc = _service(n_workers=2)
    ref = RSvc.ReStoreService(*_ref_catalog(), RRepo.Repository(),
                              n_workers=2)
    try:
        flags = []
        for s, W in ((ref, RPM), (svc, pigmix)):
            s.run(W.L3("sum"), tenant="alice", timeout=120)
            _, rep = s.run(W.L3("mean"), tenant="bob", timeout=120)
            flags.append([j.executed for j in rep.jobs])
        assert flags[1] == flags[0] and not flags[1][0], \
            "bob must reuse alice's join sub-job"
    finally:
        svc.stop()
        ref.stop()


def _ref_catalog():
    store = RA.ArtifactStore()
    cat = RA.Catalog(store)
    RPM.register_all(cat, n_rows=N_ROWS)
    return cat, store


# -------------------------------------------------------- singleflight


@pytest.mark.parametrize("singleflight", [True, False])
def test_singleflight(singleflight):
    svc = _service(n_workers=1, singleflight=singleflight)
    gate = _gate(svc)
    n = 5 if singleflight else 3
    try:
        tickets = [svc.submit(pigmix.L3("sum"), tenant=f"t{i}")
                   for i in range(n)]
        gate.set()
        outs = [t.result(timeout=120) for t in tickets]
        st = svc.stats()
        assert st["singleflight_hits"] == (n - 1 if singleflight else 0)
        assert st["dup_executions"] == 0 and st["completed"] == n
        want = ref_baseline()["L3_sum:L3_sum_out"]
        for results, _ in outs:
            assert RU.identical(results["L3_sum_out"], want)
    finally:
        svc.stop()


# -------------------------------------------------------- backpressure


def test_backpressure_rejects_nonblocking_when_full():
    svc = _service(n_workers=1, max_queue=2)
    gate = _gate(svc)
    try:
        plans = _distinct_plans()
        svc.submit(plans[0], tenant="t")
        _wait(lambda: svc.stats()["executing"] == 1)
        svc.submit(plans[1], tenant="t")
        svc.submit(plans[2], tenant="t")
        with pytest.raises(ServiceOverloaded):
            svc.submit(plans[3], tenant="t", block=False)
        with pytest.raises(ServiceOverloaded):
            svc.submit(plans[4], tenant="t", timeout=0.05)
        assert svc.stats()["rejected"] == 2
        gate.set()
    finally:
        svc.stop()


def test_blocking_submit_proceeds_when_space_frees():
    svc = _service(n_workers=1, max_queue=1)
    gate = _gate(svc)
    try:
        plans = _distinct_plans()
        svc.submit(plans[0], tenant="t")
        _wait(lambda: svc.stats()["executing"] == 1)
        svc.submit(plans[1], tenant="t")      # queue now full
        release = threading.Timer(0.05, gate.set)
        release.start()
        t = svc.submit(plans[2], tenant="t", timeout=30)  # blocks, then ok
        t.result(timeout=120)
        release.join()
    finally:
        svc.stop()


def test_round_robin_prevents_tenant_starvation():
    svc = _service(n_workers=1)
    gate = _gate(svc)
    order = []
    for drv in svc._drivers:
        orig = drv.run_plan

        def wrapped(plan, _orig=orig):
            order.append(plan.sinks[0].params["name"])
            return _orig(plan)

        drv.run_plan = wrapped
    try:
        plans = _distinct_plans()
        first = svc.submit(plans[0], tenant="chatty")
        _wait(lambda: svc.stats()["executing"] == 1)
        for p in plans[1:]:
            svc.submit(p, tenant="chatty")
        quiet = svc.submit(pigmix.L6(), tenant="quiet")
        gate.set()
        quiet.result(timeout=120)
        first.result(timeout=120)
        svc.stop()                       # drain the rest
        chatty_last = max(i for i, s in enumerate(order) if s != "L6_out")
        assert order.index("L6_out") < chatty_last, \
            f"quiet tenant starved: {order}"
    finally:
        svc.stop()


# -------------------------------------------------- retry / deadline


@pytest.mark.parametrize("failures,max_attempts", [(2, 3), (None, 2)],
                         ids=["requeue_with_backoff", "exhaust_to_failure"])
def test_transient_errors(failures, max_attempts):
    svc = _service(n_workers=1, max_attempts=max_attempts,
                   retry_base_s=0.001)
    calls = {"n": 0}
    drv = svc._drivers[0]
    orig = drv.run_plan

    def flaky(plan):
        calls["n"] += 1
        if failures is None or calls["n"] <= failures:
            raise TransientStoreError("art/x", "injected transient")
        return orig(plan)

    drv.run_plan = flaky
    try:
        if failures is None:
            with pytest.raises(TransientStoreError):
                svc.run(pigmix.L2(), timeout=120)
            st = svc.stats()
            assert st["failed"] == 1 and st["retries"] == max_attempts - 1
        else:
            results, _ = svc.run(pigmix.L2(), timeout=120)
            assert RU.identical(results["L2_out"],
                                ref_baseline()["L2:L2_out"])
            st = svc.stats()
            assert st["retries"] == failures and calls["n"] == failures + 1
            assert st["completed"] == 1 and st["failed"] == 0
    finally:
        svc.stop()


def test_deadline_exceeded_fails_at_pickup():
    svc = _service(n_workers=1)
    gate = _gate(svc)
    try:
        blocker = svc.submit(pigmix.L2(), tenant="t")
        _wait(lambda: svc.stats()["executing"] == 1)
        doomed = svc.submit(pigmix.L4(), tenant="t", deadline_s=0.01)
        time.sleep(0.05)
        gate.set()
        with pytest.raises(ServiceTimeout):
            doomed.result(timeout=120)
        blocker.result(timeout=120)
        assert svc.stats()["timeouts"] == 1
    finally:
        svc.stop()


# ----------------------------------------------------------- shutdown


def test_stop_drain_finishes_queued_work():
    svc = _service(n_workers=2)
    tickets = [svc.submit(p, tenant="t") for p in _distinct_plans()]
    svc.stop(drain=True)
    for t in tickets:
        t.result(timeout=1)
    assert svc.stats()["completed"] == len(tickets)
    with pytest.raises(ServiceClosed):
        svc.submit(pigmix.L2())


def test_stop_nondrain_fails_queued_tickets():
    svc = _service(n_workers=1)
    gate = _gate(svc)
    running = svc.submit(pigmix.L2(), tenant="t")
    _wait(lambda: svc.stats()["executing"] == 1)
    queued = svc.submit(pigmix.L4(), tenant="t")
    stopper = threading.Thread(target=svc.stop, kwargs={"drain": False})
    stopper.start()
    time.sleep(0.05)
    gate.set()
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    running.result(timeout=1)
    with pytest.raises(ServiceClosed):
        queued.result(timeout=1)


# ------------------------------------------- journal + maintenance


def test_service_with_journal_recovers_for_reuse(tmp_path):
    root = str(tmp_path / "store")
    store = ArtifactStore(root=root, device="cpu")
    cat = Catalog(store, device="cpu")
    pigmix.register_all(cat, n_rows=N_ROWS)
    svc = ReStoreService(cat, store, Repository(), n_workers=2,
                         journal=RepositoryJournal(root), device="cpu")
    svc.run(pigmix.L3("sum"), tenant="a", timeout=120)
    svc.run(pigmix.L2(), tenant="b", timeout=120)
    n_entries = len(svc.repo)
    svc.stop()
    assert n_entries > 0

    store2 = ArtifactStore(root=root, device="cpu")
    cat2 = Catalog(store2, device="cpu")
    pigmix.register_all(cat2, n_rows=N_ROWS)
    repo2, journal2 = RepositoryJournal.recover(store2)
    assert journal2.recovered_entries == n_entries
    assert journal2.reconciled_drops == 0
    svc2 = ReStoreService(cat2, store2, repo2, n_workers=2,
                          journal=journal2, device="cpu")
    try:
        res, rep = svc2.run(pigmix.L3("sum"), tenant="a", timeout=120)
        assert rep.n_executed == 0, "full reuse after recovery"
        assert RU.identical(res["L3_sum_out"],
                            ref_baseline()["L3_sum:L3_sum_out"])
    finally:
        svc2.stop()


def test_maintain_now_and_stats_shape(tmp_path):
    svc = _service(tmp_path, n_workers=1)
    ref = RSvc.ReStoreService(*_ref_catalog(), RRepo.Repository(),
                              n_workers=1)
    try:
        svc.run(pigmix.L2(), tenant="t0", timeout=120)
        ref.run(RPM.L2(), tenant="t0", timeout=120)
        assert isinstance(svc.maintain_now(), dict)
        st, rst = svc.stats(), ref.stats()
        assert set(st) == set(rst)
        assert st["per_tenant"]["t0"]["completed"] == 1
        assert st["per_tenant"] == rst["per_tenant"]
    finally:
        svc.stop()
        ref.stop()


# ------------------------------------------ speculative prefetch (§15)


def test_prefetch_warms_repeated_reads(tmp_path):
    # the interval loop never fires inside this test: prefetch_now()
    # runs each cycle, so nothing waits on thread timing
    svc = _service(tmp_path, n_workers=1, prefetch_interval_s=3600.0,
                   prefetch_k=4)
    plain = _service(n_workers=1)
    try:
        assert plain.prefetcher is None and plain.prefetch_now() == []
        assert "prefetch" not in plain.stats()
        for _ in range(3):
            svc.run(pigmix.L3("sum"), timeout=120)
            svc.prefetch_now()
        st = svc.stats()["prefetch"]
        for k in ("hits", "observed", "prefetched", "hit_rate",
                  "predictions", "refreshed_ahead"):
            assert k in st
        assert st["observed"] > 0
        assert st["predictions"], "repeated reads must rank something"
        # drop the device copies: the next cycle must warm from disk
        svc.store.drop_caches()
        warmed = svc.prefetch_now()
        assert warmed and set(warmed) <= set(st["predictions"])
        assert all(svc.store.residency(n) == "device" for n in warmed)
        assert all(svc.store.authoritative_tier(n) == "disk"
                   for n in warmed)
    finally:
        svc.stop()
        plain.stop()


def test_stream_reports_prefetch_counters_and_matches_reference():
    # maintain="refresh" makes every refresh decision independent of
    # measured times, so both packages must agree event by event
    out = []
    for S, kw in ((RS, {}), (TS, {"device": "cpu"})):
        runs = []
        for pf in (True, False):
            cfg = S.StreamConfig(n_events=10, n_tenants=2, n_rows=512,
                                 append_every=4, seed=5, prefetch=pf,
                                 prefetch_k=4, maintain="refresh")
            runs.append(S.run_stream("keep", cfg, **kw))
        res, base = runs
        assert res.prefetch_hits > 0, "zipfian replay predictions must land"
        assert res.refreshed_ahead > 0, \
            "append churn must refresh hot artifacts ahead of arrival"
        assert len(base.events) == len(res.events)
        assert base.n_reused_total == res.n_reused_total
        out.append((res.prefetch_hits, res.refreshed_ahead, res.refreshes,
                    [(e.template, e.n_executed, e.n_reused)
                     for e in res.events]))
    assert out[1] == out[0]


def test_stream_driver_smoke_all_modes():
    out = []
    for S, kw in ((RS, {}), (TS, {"device": "cpu"})):
        cfg = S.StreamConfig(n_events=6, n_tenants=2, n_rows=512,
                             churn_every=3, seed=1)
        keep = S.run_stream("keep", cfg, **kw)
        assert len(keep.events) == 6 and keep.total_wall_s > 0
        assert keep.peak_store_bytes > 0
        off = S.run_stream("off", cfg, **kw)
        assert off.n_reused_total == 0
        budget = max(int(keep.peak_store_bytes * 0.25), 1)
        for mode in ("lru", "cost"):
            r = S.run_stream(mode, cfg, budget_bytes=budget, **kw)
            assert len(r.events) == 6
            assert r.repo_bytes <= budget
        assert [e.template for e in keep.events] == \
               [e.template for e in off.events]
        out.append(([(e.tenant, e.template, e.n_executed, e.n_reused)
                     for e in keep.events + off.events],
                    keep.peak_store_bytes, keep.repo_entries))
    assert out[1] == out[0]


# ---------------------------------------------------- fault injection


def test_fault_sweep_bit_identical_and_no_permanent_failure():
    baseline = ref_baseline()
    n = int(os.environ.get("RESTORE_FAULT_SCHEDULES", 40))
    base = int(os.environ.get("RESTORE_FAULT_SEED_BASE", 0))
    total_injected, bad = 0, []
    for seed in range(base, base + n):
        inj = TF.FaultInjector(TF.FaultSchedule(seed, rates=SWEEP_RATES,
                                                max_faults=6),
                               latency_s=0.001)
        with tempfile.TemporaryDirectory() as root:
            drv = fresh_driver(root=root, injector=inj)
            try:
                got = run_mix(drv)          # must never raise
                drv.store.flush()
            except BaseException as e:      # noqa: BLE001 - report seed
                bad.append((seed, repr(e)))
                continue
            finally:
                drv.store.close()
            if not RU.results_identical(baseline, got):
                bad.append((seed, "result mismatch"))
        total_injected += inj.total_injected()
    assert not bad, f"failing seeds: {bad[:5]} ({len(bad)}/{n})"
    assert total_injected > 0, "no faults injected across the sweep"


def test_schedule_and_budget_match_reference():
    draws = []
    for F in (RF, TF):
        sched = F.FaultSchedule(7, rates=SWEEP_RATES, max_faults=100)
        draws.append([sched.draw("read") for _ in range(200)])
    assert draws[0] == draws[1]
    assert any(k is not None for k in draws[1])
    for F in (RF, TF):
        inj = F.FaultInjector(F.FaultSchedule(3, rates={"transient": 1.0},
                                              max_faults=2))
        fired = 0
        for _ in range(10):
            try:
                inj.on("read", "x")
            except OSError:
                fired += 1
        assert fired == 2 and inj.total_injected() == 2


# with write_behind=False a raise at "write" would fail the put itself
# (there is no flusher to retry it), so this schedule damages published
# bytes and adds latency only; the damage shows on the reopened store
SEQ_RATES = {"latency": 0.10, "truncate": 0.15, "flip": 0.15,
             "manifest": 0.10}


def _recording(F):
    class Recording(F.FaultInjector):
        """Logs every IO event with the fault kinds it fired."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.log = []

        def on(self, point, name, path=None):
            before = dict(self.injected)
            try:
                super().on(point, name, path=path)
            finally:
                self.log.append((point, name, tuple(sorted(
                    k for k, v in self.injected.items()
                    if v != before.get(k, 0)))))
    return Recording


@pytest.mark.parametrize("seed", [1, 4])
def test_fault_schedule_fires_same_sequence_in_both_packages(tmp_path,
                                                             seed):
    logs, answers = [], []
    for F, drv_fn, label in ((RF, RU.fresh_driver, "ref"),
                             (TF, fresh_driver, "port")):
        inj = _recording(F)(F.FaultSchedule(seed, rates=SEQ_RATES,
                                            max_faults=12),
                            latency_s=0.0)
        root = str(tmp_path / label)
        # the splice guard prices measured times: off, so that reuse
        # decisions (and with them the reads) do not depend on timing
        kw = {"write_behind": False, "min_splice_benefit_s": 0.0}
        if F is RF:
            kw["n_rows"] = N_ROWS
        mix = RU.run_mix if F is RF else run_mix
        drv = drv_fn(root=root, injector=inj, **kw)
        got = mix(drv)
        # reopen over the same root (cold caches): the reads hit disk
        drv2 = drv_fn(root=root, injector=inj, repository=drv.repo, **kw)
        got2 = mix(drv2)
        logs.append(inj.log)
        answers.append((got, got2))
    assert logs[1] == logs[0]
    assert any(kinds for _, _, kinds in logs[1]), "no fault fired"
    assert {p for p, _, _ in logs[1]} >= {"write", "publish", "published"}
    for got in answers[1]:
        assert RU.results_identical(ref_baseline(), got)


def _corrupt_every_artifact(root):
    n = 0
    for d in os.listdir(root):
        path = os.path.join(root, d)
        if not os.path.isdir(path) or d.startswith((".", "_")):
            continue
        for fn in os.listdir(path):
            if fn.endswith(".npz"):
                fp = os.path.join(path, fn)
                with open(fp, "r+b") as f:
                    b = f.read(1)
                    f.seek(0)
                    f.write(bytes([b[0] ^ 0xFF]))
                n += 1
                break
    return n


def _reopen(root, repo):
    store2 = ArtifactStore(root=root, device="cpu")
    cat2 = Catalog(store2, device="cpu")
    pigmix.register_all(cat2, n_rows=N_ROWS, seed=0)
    return ReStore(cat2, store2, repo, device="cpu")


def test_corrupted_artifacts_quarantined_with_cold_fallback(tmp_path):
    root = str(tmp_path / "store")
    drv = fresh_driver(root=root)
    run_mix(drv)
    drv.store.flush()
    assert _corrupt_every_artifact(root) > 0
    drv2 = _reopen(root, drv.repo)
    _, rep = drv2.run_plan(pigmix.L3("sum"))
    assert rep.degraded >= 1
    got = run_mix(drv2)
    assert RU.results_identical(ref_baseline(), got), \
        "cold fallback must reproduce the fault-free answer"
    assert drv2.store.stats["quarantined"] >= 1
    for e in drv2.repo.entries:
        assert drv2.store.exists(e.artifact)


def test_manifest_corruption_reaped_on_open(tmp_path):
    root = str(tmp_path / "store")
    drv = fresh_driver(root=root)
    drv.run_plan(pigmix.L2())
    drv.store.flush()
    dirs = [d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
            and not d.startswith((".", "_"))]
    victim = os.path.join(root, sorted(dirs)[0], "manifest.json")
    with open(victim, "w") as f:
        f.write("{ not json")
    store2 = ArtifactStore(root=root, device="cpu")
    assert store2.stats["corrupt_on_open"] == 1
    assert not os.path.exists(os.path.dirname(victim))


@pytest.mark.parametrize("budget", [3, 10 ** 6],
                         ids=["retried", "exhausted"])
def test_transient_read_errors(tmp_path, budget):
    root = str(tmp_path / "store")
    drv = fresh_driver(root=root)
    drv.run_plan(pigmix.L2())
    drv.store.flush()
    name = drv.repo.entries[0].artifact
    inj = TF.FaultInjector(TF.FaultSchedule(0, rates={"transient": 1.0},
                                            max_faults=budget))
    store2 = ArtifactStore(root=root, fault_injector=inj, device="cpu")
    if budget == 3:
        assert store2.get(name) is not None
        assert store2.stats["read_retries"] == 3
    else:
        with pytest.raises(TransientStoreError):
            store2.get(name)


def test_simulated_crash_in_flusher_reports_at_flush(tmp_path):
    root = str(tmp_path / "store")
    inj = TF.FaultInjector(TF.FaultSchedule(0, rates={}, max_faults=1))
    drv = fresh_driver(root=root, injector=inj)
    inj.arm("publish")
    _, rep = drv.run_plan(pigmix.L2())
    if not rep.flush_failures:          # crash hit a later artifact
        with pytest.raises(ArtifactFlushError):
            drv.store.flush()
    assert any(d.startswith(".tmp-") for d in os.listdir(root)), \
        "a crash mid-publish leaves its tmp dir, like a real kill"
    store2 = ArtifactStore(root=root, tmp_gc_age_s=0, device="cpu")
    assert not any(d.startswith(".tmp-") for d in os.listdir(root))
    assert store2.stats["tmp_gc"] >= 1


# -------------------------------------------------- crash recovery


_CHILD = r"""
import sys, time
from repro_torch.core.repository import Repository
from repro_torch.core.restore import ReStore
from repro_torch.service.journal import RepositoryJournal
from repro_torch.store.artifacts import ArtifactStore, Catalog
from repro_torch.workloads import pigmix

root, marker = sys.argv[1], sys.argv[2]


class StallAtPublish:
    def __init__(self):
        self.armed = False

    def on(self, point, name, path=None):
        if self.armed and point == "publish":
            with open(marker + ".tmp", "w") as f:
                f.write(name)
            import os
            os.replace(marker + ".tmp", marker)
            time.sleep(600)


inj = StallAtPublish()
store = ArtifactStore(root=root, fault_injector=inj, device="cpu")
cat = Catalog(store, device="cpu")
pigmix.register_all(cat, n_rows=%(n_rows)d)
journal = RepositoryJournal(root)
repo = Repository()
repo.bind_journal(journal)
journal.repo = repo
drv = ReStore(cat, store, repo, device="cpu")
drv.run_plan(pigmix.L3("sum"))
store.flush()
print("FLUSHED", flush=True)
inj.armed = True
drv.run_plan(pigmix.L2())
store.flush()
""" % {"n_rows": N_ROWS}


def test_sigkill_mid_publish_recovers_clean(tmp_path):
    root = str(tmp_path / "store")
    marker = str(tmp_path / "mid_publish")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    # the child imports repro_torch only, as on a machine without JAX
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, root, marker],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 300
        while not os.path.exists(marker):
            if proc.poll() is not None:
                _, err = proc.communicate()
                raise AssertionError(
                    f"child died before the kill point:\n{err.decode()}")
            assert time.time() < deadline, "child never reached mid-publish"
            time.sleep(0.01)
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=60)
    assert any(d.startswith(".tmp-") for d in os.listdir(root))

    store = ArtifactStore(root=root, device="cpu")
    repo, journal = RepositoryJournal.recover(store)
    assert not any(d.startswith(".tmp-") for d in os.listdir(root))
    for e in repo.entries:
        assert store.exists(e.artifact) and store.verify(e.artifact)
    assert journal.recovered_entries == len(repo.entries) >= 1
    cat = Catalog(store, device="cpu")
    pigmix.register_all(cat, n_rows=N_ROWS)
    drv = ReStore(cat, store, repo, device="cpu")
    _, rep = drv.run_plan(pigmix.L3("sum"))
    assert rep.n_executed == 0, "whole-workflow reuse after recovery"
    assert RU.results_identical(ref_baseline(), run_mix(drv))


def _disk_driver(tmp_path, journal=True):
    root = str(tmp_path / "store")
    drv = fresh_driver(root=root)
    j = None
    if journal:
        j = RepositoryJournal(root)
        drv.repo.bind_journal(j)
        j.repo = drv.repo
    return drv, j, root


def _recovered(root):
    return RepositoryJournal.recover(ArtifactStore(root=root,
                                                   device="cpu"))


def test_recover_drops_entries_for_missing_artifacts(tmp_path):
    drv, _, root = _disk_driver(tmp_path)
    drv.run_plan(pigmix.L3("sum"))
    drv.store.flush()
    n = len(drv.repo)
    victim = drv.repo.entries[0].artifact
    shutil.rmtree(os.path.join(root, _encode_name(victim)))
    repo2, journal2 = _recovered(root)
    assert journal2.reconciled_drops == 1 and len(repo2) == n - 1
    assert all(e.artifact != victim for e in repo2.entries)


@pytest.mark.parametrize("damage", ["snapshot", "torn_tail"])
def test_damaged_journal_files_tolerated(tmp_path, damage):
    drv, j, root = _disk_driver(tmp_path)
    drv.run_plan(pigmix.L3("sum"))
    drv.store.flush()
    n = len(drv.repo)
    j.close()
    if damage == "snapshot":
        with open(j.snapshot_path, "w") as f:
            f.write("{ definitely not json")
    else:
        with open(j.journal_path, "a") as f:
            f.write('{"t": "add", "e": {"trunc')    # crash mid-append
    repo2, _ = _recovered(root)
    assert len(repo2) == n


def test_rotate_compacts_journal_and_roundtrips(tmp_path):
    drv, j, root = _disk_driver(tmp_path)
    drv.run_plan(pigmix.L3("sum"))
    drv.store.flush()
    n = len(drv.repo)
    assert j.appended > 0
    j.rotate(drv.repo)
    assert j.rotations == 1
    assert os.path.getsize(j.journal_path) == 0, "rotate truncates"
    with open(j.snapshot_path) as f:
        assert len(json.load(f)["entries"]) == n
    j.close()
    repo2, _ = _recovered(root)
    assert len(repo2) == n


def test_auto_rotation_at_threshold(tmp_path):
    drv, j, root = _disk_driver(tmp_path)
    j.rotate_every = 5
    drv.run_plan(pigmix.L3("sum"))
    drv.run_plan(pigmix.L3("mean"))
    assert j.rotations >= 1
    repo2, _ = _recovered(root)
    assert len(repo2) == len(drv.repo)


def test_use_records_replay_post_update_totals(tmp_path):
    drv, j, root = _disk_driver(tmp_path)
    drv.run_plan(pigmix.L3("sum"))
    drv.run_plan(pigmix.L3("sum"))      # second run: reuse -> use records
    drv.store.flush()
    by_sig = {e.signature: e for e in drv.repo.entries}
    repo2, _ = _recovered(root)
    for e in repo2.entries:
        live = by_sig[e.signature]
        assert e.use_count == live.use_count
        assert e.saved_s_total == pytest.approx(live.saved_s_total)


def test_pins_are_not_restored(tmp_path):
    drv, j, root = _disk_driver(tmp_path)
    drv.run_plan(pigmix.L3("sum"))
    drv.store.flush()
    drv.repo.pin([drv.repo.entries[0].artifact])
    repo2, _ = _recovered(root)
    assert not repo2.pinned, "pins are run-scoped, never recovered"


def test_load_repository_and_replay_journal_fallbacks(tmp_path):
    drv, j, root = _disk_driver(tmp_path)
    drv.run_plan(pigmix.L3("sum"))
    drv.store.flush()
    n = len(drv.repo)
    state = str(tmp_path / "state.json")
    save_repository(drv.repo, state)
    with open(state, "w") as f:
        f.write('{"entries": [truncated')
    with pytest.raises((ValueError, OSError)):
        load_repository(state)
    assert len(load_repository(state, journal_path=root)) == n
    assert len(replay_journal(root)) == n
    assert len(replay_journal(os.path.join(root, "_journal"))) == n
    store2 = ArtifactStore(root=root, device="cpu")
    assert all("_journal" not in nm for nm in store2.names())


# ------------------------------------- journals across the packages


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    """A store + journal written by one package recovers in the other:
    same entries, same use totals, and the recovered repository answers
    the repeated query by reuse with the reference's rows."""
    root = str(tmp_path / "store")
    if writer == "port":
        drv = fresh_driver(root=root)
        J = RepositoryJournal
    else:
        drv = RU.fresh_driver(root=root, n_rows=N_ROWS)
        J = RJ.RepositoryJournal
    j = J(root)
    drv.repo.bind_journal(j)
    j.repo = drv.repo
    drv.run_plan(pigmix.L3("sum") if writer == "port" else RPM.L3("sum"))
    drv.run_plan(pigmix.L3("sum") if writer == "port" else RPM.L3("sum"))
    drv.store.flush()
    j.close()
    want = sorted((e.signature, e.artifact, e.use_count)
                  for e in drv.repo.entries)
    if writer == "port":
        store2 = RA.ArtifactStore(root=root)
        repo2, _ = RJ.RepositoryJournal.recover(store2)
        cat2 = RA.Catalog(store2)
        RPM.register_all(cat2, n_rows=N_ROWS)
        drv2, plan = RR.ReStore(cat2, store2, repo2), RPM.L3("sum")
    else:
        store2 = ArtifactStore(root=root, device="cpu")
        repo2, _ = RepositoryJournal.recover(store2)
        cat2 = Catalog(store2, device="cpu")
        pigmix.register_all(cat2, n_rows=N_ROWS)
        drv2 = ReStore(cat2, store2, repo2, device="cpu")
        plan = pigmix.L3("sum")
    assert sorted((e.signature, e.artifact, e.use_count)
                  for e in repo2.entries) == want
    res, rep = drv2.run_plan(plan)
    assert rep.n_executed == 0
    assert RU.identical(res["L3_sum_out"],
                        ref_baseline()["L3_sum:L3_sum_out"])
