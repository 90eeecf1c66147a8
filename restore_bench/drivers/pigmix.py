"""PigMix workflows through ``ReStoreService``, from a closed loop: the
traffic's tenants take turns, with a fixed number of workflows in
flight, and a workflow is done once it has stored its outputs and their
row counts are on the host.

Set-up makes the tables from the run seed (``yardstick/pigmix_tables``),
registers them, starts a service of ``workers`` threads over one
repository (policy and byte budget from the config) with its journal in
a fresh directory under ``TMPDIR``, and runs the traffic's set-up
workflows.  The window's workflows come from the traffic file: each
tenant's (template, params) sequence is fixed by the file's
``schedule_seed`` (``yardstick/stream_schedule``), so every run seed
gets the same work on other data.  A sample of the finished workflows,
drawn from the run seed, is held against ``reference/pigmix_ref.py``
once the window has closed."""
from __future__ import annotations

import itertools
import queue
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import pigmix_ref
from ..yardstick import pigmix_tables, stream_schedule
from . import plan_spec


def _row_counts(results) -> List[int]:
    """The rows each output of a workflow holds, read to the host: what
    a Pig client reports once a workflow has stored its outputs."""
    return torch.stack([t.valid.sum() for t in results.values()]).tolist()


class Driver:
    kind = "workflows"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, rec):
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.device, self.rec = torch.device(device), rec
        self.events: List[Dict] = []
        self.kept: List[Dict] = []
        self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self):
        from repro_torch.core.repository import Repository
        from repro_torch.dataflow.table import Table
        from repro_torch.service import ReStoreService, RepositoryJournal
        from repro_torch.store.artifacts import ArtifactStore, Catalog

        c = self.cfg
        self.tables = pigmix_tables.tables(self.seed, c["page_views_rows"],
                                           c["users"])
        self.tmp = tempfile.mkdtemp(prefix="restore_bench_journal_")
        self.store = ArtifactStore(device=self.device,
                                   cache_bytes=c["device_cache_bytes"])
        self.catalog = Catalog(self.store, device=self.device)
        for name, cols in self.tables.items():
            self.catalog.register(name, Table.from_numpy(cols,
                                                         device=self.device))
        self.versions = {ds: self.catalog.version(ds) for ds in self.tables}
        self.repo = Repository(budget_bytes=c["repository_budget_bytes"],
                               policy=c["policy"])
        self.svc = ReStoreService(
            self.catalog, self.store, self.repo, n_workers=c["workers"],
            journal=RepositoryJournal(self.tmp), device=self.device,
            heuristic=c["heuristic"])
        self.templates = self.tr["templates"]
        self._plans = {}
        self.names = sorted(self.templates)
        srng = np.random.default_rng(self.tr["schedule_seed"] + 1)
        for _ in range(self.tr.get("setup_passes", 1)):
            for name in self.names:
                t = self.templates[name]
                params = plan_spec.setup_params(t.get("params", {}), srng)
                self.svc.run(plan_spec.lower(t["plan"], params,
                                             self.versions), timeout=600)
        self._install_spans()
        torch.cuda.synchronize(self.device) \
            if self.device.type == "cuda" else None

    def _install_spans(self):
        rec = self.rec
        if not rec.traced:
            return
        for d in self.svc._drivers:
            rec.wrap(d, "run_plan", "restore.run_plan")
            rec.wrap(d.engine, "run_job", "engine.run_job")
        rec.wrap(self.store, "put", "store.put")
        rec.wrap(self.store, "get", "store.get")

    # ------------------------------------------------------------ window
    def _plan(self, name, params):
        """The program's plan of a template: lowered once per template
        and parameters (the program derives nothing from the object
        across runs: fingerprints are worked out anew on each)."""
        key = (name, tuple(sorted(params.items())))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = plan_spec.lower(
                self.templates[name]["plan"], params, self.versions)
        return plan

    def _streams(self):
        """Each tenant's (template, params) sequence, from the schedule
        seed; a tenant that reaches the end of its sequence starts it
        again."""
        tr = self.tr
        n = tr["per_tenant"]
        seqs = stream_schedule.tenant_streams(
            tr["schedule_seed"], len(self.names), tr["tenants"],
            tr["zipf_s"], n)
        prng = np.random.default_rng(tr["schedule_seed"] + 5)
        out = []
        for seq in seqs:
            out.append([(self.names[ti], plan_spec.draw_params(
                self.templates[self.names[ti]].get("params", {}), prng))
                for ti in seq])
        return out

    def window(self, seconds: float):
        """A closed loop over the traffic's tenants: ``outstanding``
        workflows in flight, the tenants taking turns (each submission
        is the next tenant's next workflow), until the window closes.
        One client thread submits, waits for whichever ticket resolves
        next and reads the row count of each of that workflow's outputs
        to the host; a workflow's latency runs from its submit to its
        counts on the host.  The workflows in flight when the window
        closes finish here and count in the latencies, not in the
        rate."""
        from repro_torch.service.service import Ticket
        streams = self._streams()
        for seq in streams:
            for name, params in seq:
                self._plan(name, params)
        resolved = queue.SimpleQueue()
        for attr in ("_resolve", "_reject"):
            inner = getattr(Ticket, attr)

            def hook(ticket, *a, _inner=inner):
                r = _inner(ticket, *a)
                resolved.put(ticket)
                return r
            self.rec.patch(Ticket, attr, hook)
        self._streams_ = streams
        self._next = [0] * len(streams)
        self._draws = np.random.default_rng([self.seed % (1 << 63), 17])
        self._seen = set()
        self.pending = {}
        self.sf0 = self.svc.stats()["singleflight_hits"]
        self.t_close = None
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + seconds
        self.t0_ns = time.time_ns()
        turns = itertools.cycle(range(len(streams)))
        for _ in range(self.tr["outstanding"]):
            self._submit(next(turns))
        while self.pending:
            self._finish(resolved.get(timeout=300))
            if time.perf_counter() < self.t_end:
                self._submit(next(turns))
            elif self.t_close is None:
                self.t_close = time.perf_counter()
                self.t_close_ns = time.time_ns()
        if self.t_close is None:
            self.t_close = time.perf_counter()
            self.t_close_ns = time.time_ns()

    def _submit(self, tenant: int):
        seq = self._streams_[tenant]
        name, params = seq[self._next[tenant] % len(seq)]
        self._next[tenant] += 1
        plan = self._plan(name, params)
        t_sub = time.perf_counter()
        try:
            t = self.svc.submit(plan, tenant=f"t{tenant}")
        except Exception as e:              # counted
            self.failed += 1
            self.events.append(dict(template=name, submit=t_sub,
                                    error=repr(e)))
            return
        self.pending[id(t)] = (tenant, t_sub, name, params)

    def _finish(self, t):
        """A resolved ticket: its outputs' row counts read to the host,
        its latency and report's counts recorded, and its results kept
        for the verdict if the sample (the first of each template run by
        reuse and by execution, the rest drawn from the run seed) takes
        them."""
        tenant, t_sub, name, params = self.pending.pop(id(t))
        try:
            results, report = t.result(timeout=0)
            with self.rec.span("client.count"):
                _row_counts(results)
        except Exception as e:
            self.failed += 1
            self.events.append(dict(template=name, submit=t_sub,
                                    error=repr(e)))
            return
        done = time.perf_counter()
        executed = report.n_executed > 0
        self.events.append(dict(
            template=name, submit=t_sub, done=done,
            n_executed=report.n_executed, n_reused=report.n_reused,
            job_walls=[j.stats.wall_s for j in report.jobs
                       if j.executed and j.stats is not None]))
        first = (name, executed) not in self._seen
        self._seen.add((name, executed))
        if len(self.kept) < self.tr["check_max"] and (
                first or self._draws.random() < self.tr["check_share"]):
            self.kept.append(dict(template=name, params=params,
                                  results=results, executed=executed))

    def drain(self):
        """Every submitted workflow has finished in ``window``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.singleflight = self.svc.stats()["singleflight_hits"] - self.sf0
        self.repo_stats = dict(entries=len(self.repo),
                               bytes=self.repo.total_stored_bytes(),
                               evictions=self.repo.evictions,
                               rejections=self.repo.rejections)

    def release(self):
        """Stop the service and drop the program's state; the sampled
        results stay, as device columns of their live rows."""
        self.svc.stop()
        self.rec.unwrap()
        for k in self.kept:
            k["results"] = {name: {c: v[t.valid] for c, v in
                                   t.columns.items()}
                            for name, t in k["results"].items()}
        del self.svc, self.catalog, self.store, self.repo
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ verdict
    def reference_tables(self):
        return {n: {c: torch.from_numpy(a).to(self.device)
                    for c, a in cols.items()}
                for n, cols in self.tables.items()}

    def verify(self, float_round=None) -> Dict[str, float]:
        """The worst ``rows_wrong`` and ``agg_rel_err`` over the sampled
        workflows (and how many were compared)."""
        tabs = self.reference_tables()
        cache = {}
        worst = {"rows_wrong": 0.0, "agg_rel_err": 0.0}
        for k in self.kept:
            key = (k["template"], tuple(sorted(k["params"].items())))
            if key not in cache:
                cache[key] = pigmix_ref.evaluate(
                    self.templates[k["template"]]["plan"], tabs, k["params"],
                    float_round=float_round)
            want = cache[key]
            for name, got in k["results"].items():
                if name not in want:
                    worst["rows_wrong"] = max(worst["rows_wrong"], 1.0)
                    continue
                r = pigmix_ref.compare(got, want[name])
                for m in worst:
                    worst[m] = max(worst[m], r[m])
            if set(want) - set(k["results"]):
                worst["rows_wrong"] = max(worst["rows_wrong"], 1.0)
        worst["checked"] = float(len(self.kept))
        return worst

    def control(self) -> Dict[str, float]:
        """The reference in bfloat16, judged in the program's place."""
        tabs = self.reference_tables()
        worst = {"rows_wrong": 0.0, "agg_rel_err": 0.0}
        done = set()
        for k in self.kept:
            key = (k["template"], tuple(sorted(k["params"].items())))
            if key in done:
                continue
            done.add(key)
            plan = self.templates[k["template"]]["plan"]
            want = pigmix_ref.evaluate(plan, tabs, k["params"])
            low = pigmix_ref.evaluate(plan, tabs, k["params"],
                                      float_round=pigmix_ref.bf16_round)
            for name in want:
                r = pigmix_ref.compare(low[name], want[name])
                for m in worst:
                    worst[m] = max(worst[m], r[m])
        return worst

    # ---------------------------------------------------------- records
    def notes(self) -> Dict[str, float]:
        ok = [e for e in self.events if "done" in e]
        return dict(repo_entries=self.repo_stats["entries"],
                    repo_bytes=self.repo_stats["bytes"],
                    repo_evictions=self.repo_stats["evictions"],
                    repo_rejections=self.repo_stats["rejections"],
                    executed=sum(e["n_executed"] for e in ok),
                    workflows_executing=sum(1 for e in ok
                                            if e["n_executed"]),
                    singleflight_hits=self.singleflight)

    def record(self) -> Dict:
        """What the metric readers read."""
        ok = [e for e in self.events if "done" in e]
        return dict(kind=self.kind, t0=self.t0, t_end=self.t_end,
                    t0_ns=self.t0_ns, t_close_ns=self.t_close_ns,
                    window_s=self.t_end - self.t0, events=ok,
                    attempted=len(self.events), failed=self.failed,
                    repo=self.repo_stats)
