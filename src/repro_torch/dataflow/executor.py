"""Job / workflow execution engine.

Each job's plan fragment runs eagerly as one pass over its operators
(the analogue of one MapReduce job launch).  The plan closure and the
op-uid map of the first fingerprint-equal plan live in a **process-wide
cache keyed by plan fingerprint**, as in the reference, so ``hits`` and
``misses`` mean the same there and here.  There is no trace to compile:
capturing the job in a CUDA graph is work for a later change.

A job synchronises with the device once, after its last operator, and
then fetches every per-op statistic in one device-to-host copy.

Statistics collected per job mirror what Hadoop gives ReStore (paper §5):
input/output rows and bytes, wall time — they feed the repository's
ordering and eviction rules.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Tuple

import torch

from ..device import resolve
from ..store.artifacts import ArtifactStore, Catalog
from .compiler import Job, Workflow
from .physical import execute_plan
from .table import Table


@dataclasses.dataclass
class JobStats:
    job_id: int
    wall_s: float
    rows_in: int
    bytes_in: int
    rows_out: int
    bytes_out: int
    op_rows: Dict[int, int]
    join_overflow: int = 0
    # op uid -> estimated cumulative seconds to produce that op's output
    # (its whole input cone) — the producer cost of the sub-job rooted
    # there, feeding the repository cost model (DESIGN.md §9)
    op_cost_s: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def reduction(self) -> float:
        """input:output byte ratio — ordering rule 2 metric (paper §3)."""
        return self.bytes_in / max(self.bytes_out, 1)


# Relative work weights for attributing a job's measured wall time over
# its operators: the wall clock is split proportional to a rows-processed
# work model, blocking (sort-backed) operators weighing several times a
# streaming map op.  The attributed times always sum to the wall time.
_OP_WEIGHT = {
    "LOAD": 0.5, "STORE": 0.05, "SPLIT": 0.02,
    "PROJECT": 0.3, "FILTER": 0.4, "FOREACH": 0.6, "UNION": 0.3,
    "DISTINCT": 2.5, "GROUPBY": 3.0, "JOIN": 4.0, "COGROUP": 4.0,
}


def attribute_op_costs(plan, op_rows: Dict[int, int],
                       wall_s: float) -> Dict[int, float]:
    """Split a job's wall time across its operators (weighted by rows
    touched), then accumulate over each operator's input cone.  Returns
    op uid -> cumulative producer cost in seconds; for a single-sink
    plan the sink's value equals ``wall_s``."""
    topo = plan.topo()
    work: Dict[int, float] = {}
    for op in topo:
        rin = sum(op_rows.get(i.uid, 0) for i in op.inputs)
        rout = op_rows.get(op.uid, 0)
        work[op.uid] = _OP_WEIGHT.get(op.kind, 1.0) * (rin + rout + 64)
    total = sum(work.values()) or 1.0
    own = {uid: wall_s * w / total for uid, w in work.items()}
    # cumulative over the input cone; a shared subtree is counted once
    cones: Dict[int, frozenset] = {}
    out: Dict[int, float] = {}
    for op in topo:
        cone = frozenset({op.uid}).union(*(cones[id(i)] for i in op.inputs)) \
            if op.inputs else frozenset({op.uid})
        cones[id(op)] = cone
        out[op.uid] = sum(own[u] for u in cone)
    return out


class JitCache:
    """Process-wide plan-fingerprint -> plan-closure cache.

    LRU-bounded by entry count: each entry pins a plan closure, so an
    unbounded dict would grow for the whole process lifetime across
    benchmark sweeps."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._fns: "collections.OrderedDict[Tuple, Callable]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        # key -> Event for a build in progress: two workers racing on
        # the SAME key build it once
        self._building: Dict[Tuple, threading.Event] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple, build: Callable[[], Callable]) -> Callable:
        while True:
            with self._lock:
                fn = self._fns.get(key)
                if fn is not None:
                    self._fns.move_to_end(key)
                    self.hits += 1
                    return fn
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    self.misses += 1
                    break               # this thread builds
            ev.wait()                   # a peer is building this key
        try:
            fn = build()
        except BaseException:
            with self._lock:            # waiters retry (and rebuild)
                self._building.pop(key).set()
            raise
        with self._lock:
            self._fns[key] = fn
            while len(self._fns) > self.max_entries:
                self._fns.popitem(last=False)
            self._building.pop(key).set()
            return fn

    def clear(self):
        with self._lock:
            self._fns.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self):
        return len(self._fns)


GLOBAL_JIT_CACHE = JitCache(
    max_entries=int(os.environ.get("RESTORE_JIT_CACHE_ENTRIES", 256)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Executes workflows of jobs over a catalog + artifact store, on
    one device (``device=None``: the card)."""

    def __init__(self, catalog: Catalog, store: ArtifactStore,
                 measure_exec: bool = False, repeats: int = 5,
                 device=None):
        self.catalog = catalog
        self.store = store
        self.device = resolve(device)
        # measure_exec: warm once off the clock, then repeat the full
        # load->execute->store cycle `repeats` times and report the
        # median (benchmarks compare execution, not first-call set-up)
        self.measure_exec = measure_exec
        self.repeats = repeats
        self._jit_cache = GLOBAL_JIT_CACHE

    # ------------------------------------------------------------------
    def _dataset(self, name: str) -> Table:
        t = self.store.get(name) if self.store.exists(name) \
            else self.catalog.get(name)
        if t.device != self.device:
            raise ValueError(
                f"dataset {name!r} lives on {t.device}, the engine runs "
                f"on {self.device}")
        return t

    def _jitted(self, plan):
        """Returns (fn, uid_by_fp, fps): the cached plan closure, the
        CACHED plan's op-uid per fingerprint, and the current plan's
        fingerprints.  A cache hit serves a closure over the *first*
        fingerprint-equal plan, whose op uids differ from the current
        plan's — stats are translated through fingerprints."""
        fps = plan.fingerprints()
        sig = "|".join(sorted(fps[id(s)] for s in plan.sinks))
        # the device type picks kernels or plain versions, so it is
        # part of the key, where the reference keys on use_pallas()
        key = (sig, self.device.type)

        def build():
            def fn(datasets):
                return execute_plan(plan, datasets)
            uid_by_fp = {fps[id(op)]: op.uid for op in plan.topo()}
            return fn, uid_by_fp

        fn, uid_by_fp = self._jit_cache.get(key, build)
        return fn, uid_by_fp, fps

    def run_job(self, job: Job,
                transient: bool = False) -> tuple[Dict[str, Table],
                                                  JobStats]:
        """Timed window mirrors Eq. 2: T_load (dataset reads from the
        store) + operator execution + T_store (artifact writes — with the
        write-behind store only the handoff is on the clock).

        ``transient=True`` skips T_store entirely: outputs are returned
        to the caller but never put in the artifact store."""
        input_names = sorted({o.params["dataset"] for o in job.plan.loads()})
        fn, uid_by_fp, fps = self._jitted(job.plan)

        def load_inputs():
            return {n: self._dataset(n) for n in input_names}

        if self.measure_exec:   # warm kernels + OS page cache off the clock
            warm, _ = fn(load_inputs())
            _sync(self.device)
            del warm

        walls = []
        reps = self.repeats if self.measure_exec else 1
        for _ in range(reps):
            t0 = time.perf_counter()
            inputs = load_inputs()                               # T_load
            outputs, stats = fn(inputs)
            # one synchronization point per job (not per output or op)
            _sync(self.device)
            if not transient:
                for name, t in outputs.items():                  # T_store
                    self.store.put(name, t)
            walls.append(time.perf_counter() - t0)
            if self.measure_exec:
                # drain the write-behind queue between reps so background
                # serialization does not contend with the next timed rep
                self.store.flush()
        wall = sorted(walls)[len(walls) // 2]

        # every per-op scalar plus the input/output row counts cross to
        # the host in ONE copy, not one round trip per int()
        uids = sorted(stats)
        scalars = [stats[u]["rows_out"] for u in uids]
        scalars += [stats[u]["join_overflow"] for u in uids
                    if "join_overflow" in stats[u]]
        scalars += [t.num_valid() for t in inputs.values()]
        scalars += [t.num_valid() for t in outputs.values()]
        vals = torch.stack([s.to(torch.int64) for s in scalars]).tolist() \
            if scalars else []
        rows_by_uid = dict(zip(uids, vals[:len(uids)]))
        k = len(uids)
        n_ovf = len(scalars) - k - len(inputs) - len(outputs)
        ovf = sum(vals[k:k + n_ovf])
        rows_in = sum(vals[k + n_ovf:k + n_ovf + len(inputs)])
        rows_out = sum(vals[k + n_ovf + len(inputs):])
        bytes_in = sum(t.nbytes() for t in inputs.values())
        bytes_out = sum(t.nbytes() for t in outputs.values())
        # stats arrive keyed by the cached plan's op uids; translate to
        # the current plan's uids through the shared fingerprints
        op_rows = {}
        for op in job.plan.topo():
            r = rows_by_uid.get(uid_by_fp.get(fps[id(op)]))
            if r is not None:
                op_rows[op.uid] = int(r)
        op_cost = attribute_op_costs(job.plan, op_rows, wall)
        js = JobStats(job.job_id, wall, rows_in, bytes_in,
                      rows_out, bytes_out, op_rows, ovf, op_cost)
        return outputs, js

    def run_workflow(self, wf: Workflow) -> tuple[Dict[str, Table],
                                                  List[JobStats]]:
        all_stats: List[JobStats] = []
        for job in wf.jobs:
            # whole-job reuse fast path: if every output already exists in
            # the artifact store the job is a no-op (paper §3)
            if all(self.store.exists(o) for o in job.outputs):
                all_stats.append(JobStats(job.job_id, 0.0, 0, 0, 0, 0, {}))
                continue
            _, stats = self.run_job(job)
            all_stats.append(stats)
        results = {user: self.store.get(ds)
                   for user, ds in wf.final_outputs.items()}
        # workflow end is a durability point: all artifacts on disk
        self.store.flush()
        return results, all_stats
