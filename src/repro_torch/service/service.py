"""Concurrent multi-tenant ReStore service (DESIGN.md §13).

``ReStoreService`` turns the single-query driver into a long-running
server: N worker threads execute whole workflows concurrently over ONE
shared catalog / artifact store / repository / jit cache, which is the
whole point — tenants reuse each other's sub-job results the moment
they are registered.

Scheduling and robustness:

  * **admission queue** — bounded; ``submit`` blocks (backpressure) or
    raises ``ServiceOverloaded`` when full;
  * **per-tenant fairness** — one FIFO per tenant, drained round-robin,
    with an optional per-tenant in-flight cap, so one chatty tenant
    cannot starve the rest of the worker pool (and thereby of the
    repository byte budget its artifacts compete for);
  * **singleflight** — tickets are keyed by the workflow plan's
    structural fingerprint; a submit matching a queued or executing key
    attaches to the leader and receives its results.  Two tenants
    submitting the same job at the same instant compute it once — the
    stampede that bursty recurrent arrivals (Chen et al.) make common;
  * **retries / timeouts** — transient store errors requeue the ticket
    with capped exponential backoff up to ``max_attempts``; a ticket
    older than its ``deadline_s`` when a worker picks it up fails with
    ``ServiceTimeout`` (requeue-or-fail);
  * **degradation** — corrupt/missing artifacts are quarantined inside
    the driver (ArtifactError -> cold recompute); the per-run counts
    surface in ``stats()["degraded"]``.

On the card every worker thread, like the store's flusher, works on the
default stream of the service's device, so their kernels and copies
serialize there and no cross-stream ordering is needed.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import torch

from ..core.mqo import optimize_batch
from ..core.plan import PhysicalPlan, plan_signature
from ..core.repository import Repository
from ..core.restore import ReStore
from ..dataflow.builder import as_plan
from ..device import resolve
from ..store.artifacts import ArtifactError, Catalog, TransientStoreError


class ServiceOverloaded(RuntimeError):
    """Admission queue full and the caller declined to wait."""


class ServiceTimeout(RuntimeError):
    """The ticket exceeded its deadline before a worker could run it."""


class ServiceClosed(RuntimeError):
    """submit() after stop()."""


class Ticket:
    """Handle for one submitted workflow."""

    def __init__(self, plan: PhysicalPlan, tenant: str, key: str,
                 deadline_s: Optional[float]):
        self.plan = plan
        self.tenant = tenant
        self.key = key
        self.deadline_s = deadline_s
        self.submitted_at = time.time()
        self.attempts = 0
        self.followers: List["Ticket"] = []
        self._ev = threading.Event()
        self._results = None
        self._report = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the outcome: returns ``(results, report)`` or
        raises the failure (ServiceTimeout, TransientStoreError after
        all retries, ...).  ``timeout`` bounds the wait itself."""
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"ticket for tenant {self.tenant!r} still pending")
        if self._error is not None:
            raise self._error
        return self._results, self._report

    def _resolve(self, results, report) -> None:
        self._results, self._report = results, report
        self._ev.set()

    def _reject(self, err: BaseException) -> None:
        self._error = err
        self._ev.set()


class ReStoreService:
    def __init__(self, catalog: Catalog, store,
                 repository: Optional[Repository] = None,
                 n_workers: int = 4,
                 max_queue: int = 64,
                 per_tenant_inflight: Optional[int] = None,
                 singleflight: bool = True,
                 max_attempts: int = 3,
                 retry_base_s: float = 0.01,
                 retry_cap_s: float = 0.25,
                 journal=None,
                 maintain_interval_s: Optional[float] = None,
                 prefetch_interval_s: Optional[float] = None,
                 prefetch_k: int = 4,
                 job_overhead_s: float = 0.0,
                 device=None,
                 **driver_kwargs):
        self.catalog = catalog
        # the device every worker's engine runs on (None: the card)
        self.device = resolve(device)
        self.store = store
        self.repo = repository if repository is not None else Repository()
        self.repo.bind_store(store)
        if journal is not None:
            self.repo.bind_journal(journal)
            journal.repo = self.repo
        self.journal = journal
        self.n_workers = int(n_workers)
        self.max_queue = int(max_queue)
        self.per_tenant_inflight = per_tenant_inflight
        self.singleflight = singleflight
        self.max_attempts = int(max_attempts)
        self.retry_base_s = float(retry_base_s)
        self.retry_cap_s = float(retry_cap_s)
        # constant per-job stall modelling the launch + DFS round-trip
        # overhead of the paper's MapReduce setting (our in-process
        # engine has none).  It is WAIT, not compute, so a correctly
        # concurrent pool overlaps it across workers — the service
        # bench's goodput-scaling gate rides on exactly that
        self.job_overhead_s = float(job_overhead_s)
        # one driver per worker: drivers carry per-run state (_run_pins,
        # _art_versions) but share catalog/store/repo/jit-cache, so a
        # sub-job one tenant materializes is immediately matchable by
        # every other worker
        self._drivers = [ReStore(catalog, store, self.repo,
                                 device=self.device, **driver_kwargs)
                         for _ in range(self.n_workers)]
        self._cv = threading.Condition()
        self._queues: "Dict[str, collections.deque]" = {}
        self._rr: "collections.deque[str]" = collections.deque()
        self._qsize = 0
        self._inflight: Dict[str, Ticket] = {}     # singleflight leaders
        self._executing_keys: set = set()
        self._executing_by_tenant: Dict[str, int] = {}
        self._closed = False
        self._stats = {
            "submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "retries": 0, "timeouts": 0, "singleflight_hits": 0,
            "dup_executions": 0, "degraded": 0, "flush_failures": 0,
            "batches": 0, "batch_shared_subplans": 0,
        }
        self._tenant_stats: Dict[str, Dict[str, int]] = {}
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             name=f"restore-worker-{i}", daemon=True)
            for i in range(self.n_workers)]
        for t in self._workers:
            t.start()
        self._maintain_stop = threading.Event()
        self._maintain_thread = None
        if maintain_interval_s is not None:
            self._maintain_thread = threading.Thread(
                target=self._maintain_loop, args=(float(maintain_interval_s),),
                name="restore-maintainer", daemon=True)
            self._maintain_thread.start()
        # speculative prefetcher (DESIGN.md §15): mines the store's read
        # log on a background cadence beside the maintenance loop and
        # warms predicted-hot artifacts; its ahead-of-arrival refresh
        # reuses maintain_now restricted to the predicted names
        self.prefetcher = None
        self._prefetch_stop = threading.Event()
        self._prefetch_thread = None
        if prefetch_interval_s is not None:
            from ..store.prefetch import SpeculativePrefetcher
            self.prefetcher = SpeculativePrefetcher(
                store, k=prefetch_k,
                maintainer=lambda names: self.repo.maintain(
                    self.catalog, self._drivers[0].engine, self.store,
                    only=names))
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_loop,
                args=(float(prefetch_interval_s),),
                name="restore-prefetcher", daemon=True)
            self._prefetch_thread.start()

    # ------------------------------------------------------------ submit
    def submit(self, plan, tenant: str = "default",
               block: bool = True, timeout: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue a workflow — a ``PhysicalPlan`` or a Pig-style
        builder (``dataflow.builder.Dataflow``, lowered on entry);
        returns a Ticket immediately.  With the queue full:
        ``block=True`` waits (``timeout`` bounds it) for space, else
        raises ServiceOverloaded."""
        plan = as_plan(plan)
        key = plan_signature(plan)
        deadline = time.time() + timeout if timeout is not None else None
        with self._cv:
            if self._closed:
                raise ServiceClosed("service is stopped")
            self._stats["submitted"] += 1
            self._tenant(tenant)["submitted"] += 1
            if self.singleflight:
                leader = self._inflight.get(key)
                if leader is not None:
                    t = Ticket(plan, tenant, key, deadline_s)
                    leader.followers.append(t)
                    self._stats["singleflight_hits"] += 1
                    self._tenant(tenant)["singleflight_hits"] += 1
                    return t
            while self._qsize >= self.max_queue and not self._closed:
                if not block:
                    self._stats["rejected"] += 1
                    self._tenant(tenant)["rejected"] += 1
                    raise ServiceOverloaded(
                        f"queue full ({self.max_queue} pending)")
                remaining = None if deadline is None \
                    else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    self._stats["rejected"] += 1
                    self._tenant(tenant)["rejected"] += 1
                    raise ServiceOverloaded(
                        f"queue full ({self.max_queue} pending)")
                self._cv.wait(remaining)
            if self._closed:
                raise ServiceClosed("service is stopped")
            t = Ticket(plan, tenant, key, deadline_s)
            self._enqueue_locked(t)
            if self.singleflight:
                self._inflight[key] = t
            self._cv.notify_all()
            return t

    def run(self, plan, tenant: str = "default",
            timeout: Optional[float] = None):
        """Convenience: submit (plan or builder) and wait."""
        return self.submit(plan, tenant).result(timeout)

    def submit_batch(self, queries, tenants=None, tenant: str = "default",
                     semantic: bool = True,
                     timeout: Optional[float] = None) -> List[Ticket]:
        """Drain a batch through the multi-query optimizer (DESIGN.md
        §16) and fan results out to per-query tickets.

        The batch window extends singleflight from identical-plan to
        shared-subplan granularity: ``optimize_batch`` finds sub-plans
        common to several queued queries (exactly or by subsumption),
        the shared prefix is submitted once and awaited, and only then
        are the per-query tickets enqueued — their rewrites splice the
        freshly materialized shared artifacts, so a sub-job consumed by
        five queries executes once no matter which workers pick them up.

        Known-uses hints and pins are installed for the batch's
        lifetime (a background waiter releases them when the last
        ticket settles).  A shared-prefix failure degrades gracefully:
        the queries still run, each recomputing cold.  ``queries`` may
        mix plans and builders; ``tenants`` (optional, same length)
        attributes each ticket, else all go to ``tenant``."""
        plans = [as_plan(q) for q in queries]
        if tenants is None:
            tenants = [tenant] * len(plans)
        if len(tenants) != len(plans):
            raise ValueError("tenants must match queries 1:1")
        bp = optimize_batch(plans, repo=self.repo, semantic=semantic)
        with self._cv:
            self._stats["batches"] += 1
            self._stats["batch_shared_subplans"] += len(bp.shared)
        released = threading.Event()
        self.repo.set_known_uses(bp.known_uses)
        self.repo.pin(bp.boundary_artifacts)

        def _release():
            if released.is_set():
                return
            released.set()
            self.repo.unpin(bp.boundary_artifacts)
            self.repo.clear_known_uses(bp.known_uses)
            self.repo.rebalance()

        try:
            if bp.shared_plan is not None:
                try:
                    self.submit(bp.shared_plan,
                                tenant="_batch").result(timeout)
                except Exception:
                    pass        # degraded: queries recompute cold
            tickets = [self.submit(p, tenant=t)
                       for p, t in zip(plans, tenants)]
        except BaseException:
            _release()
            raise

        def _waiter():
            for t in tickets:
                t._ev.wait()
            _release()

        threading.Thread(target=_waiter, name="restore-batch-waiter",
                         daemon=True).start()
        return tickets

    def _tenant(self, tenant: str) -> Dict[str, int]:
        st = self._tenant_stats.get(tenant)
        if st is None:
            st = self._tenant_stats[tenant] = {
                "submitted": 0, "completed": 0, "failed": 0,
                "rejected": 0, "singleflight_hits": 0}
        return st

    def _enqueue_locked(self, t: Ticket) -> None:
        q = self._queues.get(t.tenant)
        if q is None:
            q = self._queues[t.tenant] = collections.deque()
            self._rr.append(t.tenant)
        q.append(t)
        self._qsize += 1

    # ----------------------------------------------------------- workers
    def _next_ticket_locked(self) -> Optional[Ticket]:
        """Round-robin over tenants with queued work, honouring the
        per-tenant in-flight cap.  Advances the rotation so service
        order interleaves tenants regardless of queue depths."""
        for _ in range(len(self._rr)):
            tenant = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(tenant)
            if not q:
                continue
            if (self.per_tenant_inflight is not None
                    and self._executing_by_tenant.get(tenant, 0)
                    >= self.per_tenant_inflight):
                continue
            t = q.popleft()
            self._qsize -= 1
            return t
        return None

    def _worker_loop(self, idx: int) -> None:
        driver = self._drivers[idx]
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                t = self._next_ticket_locked()
                while t is None and not self._closed:
                    self._cv.wait()
                    t = self._next_ticket_locked()
                if t is None:           # closed and drained
                    return
                now = time.time()
                if (t.deadline_s is not None
                        and now - t.submitted_at > t.deadline_s):
                    self._stats["timeouts"] += 1
                    self._finish_locked(
                        t, error=ServiceTimeout(
                            f"queued {now - t.submitted_at:.3f}s > "
                            f"deadline {t.deadline_s:.3f}s"))
                    self._cv.notify_all()
                    continue
                if t.key in self._executing_keys:
                    # the invariant the singleflight gate exists for;
                    # asserted == 0 by the bench gate
                    self._stats["dup_executions"] += 1
                self._executing_keys.add(t.key)
                self._executing_by_tenant[t.tenant] = \
                    self._executing_by_tenant.get(t.tenant, 0) + 1
                self._cv.notify_all()
            t.attempts += 1
            try:
                if self.job_overhead_s > 0:
                    time.sleep(self.job_overhead_s)
                results, report = driver.run_plan(t.plan)
            except TransientStoreError as e:
                if t.attempts < self.max_attempts:
                    with self._cv:
                        self._stats["retries"] += 1
                    # the ticket stays "executing" through the backoff so
                    # stop(drain=True) cannot slip past it mid-retry
                    time.sleep(min(self.retry_cap_s,
                                   self.retry_base_s
                                   * (2 ** (t.attempts - 1))))
                    with self._cv:
                        self._after_exec_locked(t)
                        self._enqueue_locked(t)
                        self._cv.notify_all()
                else:
                    with self._cv:
                        self._after_exec_locked(t)
                        self._finish_locked(t, error=e)
                        self._cv.notify_all()
            except BaseException as e:
                with self._cv:
                    self._after_exec_locked(t)
                    self._finish_locked(t, error=e)
                    self._cv.notify_all()
            else:
                with self._cv:
                    self._after_exec_locked(t)
                    self._stats["degraded"] += report.degraded
                    self._stats["flush_failures"] += \
                        len(report.flush_failures)
                    self._finish_locked(t, results=results, report=report)
                    self._cv.notify_all()

    def _after_exec_locked(self, t: Ticket) -> None:
        self._executing_keys.discard(t.key)
        n = self._executing_by_tenant.get(t.tenant, 1) - 1
        if n > 0:
            self._executing_by_tenant[t.tenant] = n
        else:
            self._executing_by_tenant.pop(t.tenant, None)

    def _finish_locked(self, t: Ticket, results=None, report=None,
                       error: Optional[BaseException] = None) -> None:
        """Resolve a ticket (and its singleflight followers) and retire
        its key.  Callers hold the service lock."""
        if self._inflight.get(t.key) is t:
            del self._inflight[t.key]
        tickets = [t] + t.followers
        for tk in tickets:
            if error is not None:
                self._stats["failed"] += 1
                self._tenant(tk.tenant)["failed"] += 1
                tk._reject(error)
            else:
                self._stats["completed"] += 1
                self._tenant(tk.tenant)["completed"] += 1
                tk._resolve(results, report)
        t.followers = []

    # ------------------------------------------------------- maintenance
    def _maintain_loop(self, interval_s: float) -> None:
        while not self._maintain_stop.wait(interval_s):
            try:
                self.maintain_now()
            except Exception:
                pass                    # background sweep must not die

    def maintain_now(self, mode: str = "auto") -> Dict[str, int]:
        """One incremental-maintenance sweep through worker 0's engine
        (thread-safe against in-flight queries: the repository and store
        serialize their own mutations)."""
        return self.repo.maintain(self.catalog, self._drivers[0].engine,
                                  self.store, mode=mode)

    def _prefetch_loop(self, interval_s: float) -> None:
        while not self._prefetch_stop.wait(interval_s):
            try:
                self.prefetch_now()
            except Exception:
                pass                    # speculation must not die either

    def prefetch_now(self) -> list:
        """One prefetch cycle: drain the read log, warm the predicted
        top-k.  Safe to call with no prefetcher configured (no-op)."""
        if self.prefetcher is None:
            return []
        return self.prefetcher.prefetch()

    # ------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._cv:
            out = dict(self._stats)
            out["queued"] = self._qsize
            out["executing"] = len(self._executing_keys)
            out["per_tenant"] = {k: dict(v)
                                 for k, v in self._tenant_stats.items()}
        out["store"] = dict(self.store.stats)
        out["quarantined"] = self.store.stats["quarantined"]
        if self.prefetcher is not None:
            out["prefetch"] = self.prefetcher.stats()
        return out

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Shut down.  ``drain=True`` finishes queued work first; else
        queued tickets fail with ServiceClosed.  Always flushes the
        store (a durability point) and rotates the journal."""
        deadline = time.time() + timeout if timeout is not None else None
        with self._cv:
            if not drain:
                for q in self._queues.values():
                    while q:
                        t = q.popleft()
                        self._qsize -= 1
                        self._finish_locked(
                            t, error=ServiceClosed("service stopping"))
            while self._qsize or self._executing_keys:
                remaining = None if deadline is None \
                    else max(deadline - time.time(), 0.001)
                if not self._cv.wait(remaining):
                    break
            self._closed = True
            self._cv.notify_all()
        if self._maintain_thread is not None:
            self._maintain_stop.set()
            self._maintain_thread.join(timeout=5)
        if self._prefetch_thread is not None:
            self._prefetch_stop.set()
            self._prefetch_thread.join(timeout=5)
        for w in self._workers:
            w.join(timeout=10)
        flush_err = None
        try:
            self.store.flush()
        except ArtifactError as e:
            flush_err = e
        if self.journal is not None:
            self.journal.rotate(self.repo)
            self.journal.close()
        if flush_err is not None:
            raise flush_err
