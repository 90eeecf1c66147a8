"""Job / workflow execution engine.

Each job's plan fragment runs eagerly as one pass over its operators
(the analogue of one MapReduce job launch).  The plan closure and the
op-uid map of the first fingerprint-equal plan live in a **process-wide
cache keyed by plan fingerprint**, as in the reference, so ``hits`` and
``misses`` mean the same there and here.  There is no trace to compile:
capturing the job in a CUDA graph is work for a later change.

A job synchronises with the device once, after its last operator, and
then fetches every per-op statistic in one device-to-host copy.

With a ``mesh`` (``launch.mesh.LocalMesh``) the blocking operators run
map->exchange->reduce across its shards (``dataflow/shuffle.py``), and
partition-aware runs store artifacts sharded so a later co-partitioned
consumer skips its exchange (DESIGN.md §11).

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

from ..core.plan import (Partitioning, load_partition_demands,
                         plan_physical_props)
from ..device import resolve
from ..kernels import autotune
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
    # mesh execution (DESIGN.md §11): rows the exchange's bounded
    # buckets dropped, exchange counts, and the static partition
    # property of each op's output (op uid -> Partitioning.to_dict())
    shuffle_overflow: int = 0
    shuffles: int = 0
    shuffles_skipped: int = 0
    # 1 if the bounded-bucket / hash-reduce run lost rows and the job
    # was rerun on the lossless configuration (DESIGN.md §14)
    shuffle_retries: int = 0
    op_partitioning: Dict[int, dict] = dataclasses.field(default_factory=dict)

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
    one device (``device=None``: the mesh's device, else the card)."""

    def __init__(self, catalog: Catalog, store: ArtifactStore,
                 measure_exec: bool = False, repeats: int = 5,
                 mesh=None, shuffle_axis: str = "data",
                 skew_factor: float = 4.0, partition_aware: bool = True,
                 device=None):
        self.catalog = catalog
        self.store = store
        self.device = resolve(mesh.device if device is None
                              and mesh is not None else device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh on {mesh.device}, engine on "
                             f"{self.device}")
        # measure_exec: warm once off the clock, then repeat the full
        # load->execute->store cycle `repeats` times and report the
        # median (benchmarks compare execution, not first-call set-up)
        self.measure_exec = measure_exec
        self.repeats = repeats
        # mesh execution (DESIGN.md §11): blocking operators run through
        # the exchange across the mesh's ``shuffle_axis``.
        # partition_aware=False is the ablation arm: artifacts are stored
        # monolithic and stored partition properties are ignored (every
        # exchange always runs)
        self.mesh = mesh
        self.shuffle_axis = shuffle_axis
        # the exchange's bucket skew is an autotunable knob (inert
        # unless RESTORE_AUTOTUNE=1, kernels/autotune.py)
        self.skew_factor = autotune.choose("exchange", 0, "row", "skew",
                                           skew_factor)
        self.partition_aware = partition_aware
        self._jit_cache = GLOBAL_JIT_CACHE

    @property
    def n_shards(self):
        if self.mesh is None:
            return None
        return int(self.mesh.shape[self.shuffle_axis])

    # ------------------------------------------------------------------
    def _dataset(self, name: str) -> Table:
        t = self.store.get(name) if self.store.exists(name) \
            else self.catalog.get(name)
        if t.device != self.device:
            raise ValueError(
                f"dataset {name!r} lives on {t.device}, the engine runs "
                f"on {self.device}")
        return t

    def _mesh_context(self, plan, input_names):
        """Physical context of a mesh run: per-dataset partition
        properties and schemas, plus re-partitioned overrides for
        mismatched artifacts a blocking consumer demands (DESIGN.md
        §11).  Returns (props, overrides, parts_key) — parts_key goes
        into the cache key, because the co-partition skip decisions
        change what the plan computes."""
        n_shards = self.n_shards
        demands = load_partition_demands(plan) if self.partition_aware \
            else {}
        dataset_parts, schemas, overrides = {}, {}, {}
        for n in input_names:
            sp = self.store.partitioning(n) if self.partition_aware \
                else None
            want = demands.get(n)
            covered = (sp is not None and sp["n_parts"] == n_shards
                       and set(sp["keys"]) <= set(want or ()))
            if want and not covered and self.partition_aware \
                    and self.store.exists(n):
                # co-partition on read (M3R-style partition stability):
                # one host pass now, cached as a derived view, instead
                # of an exchange on every consumption.  Catalog-only
                # datasets stay on the device exchange.
                overrides[n], sp = self.store.get_partitioned(
                    n, want, n_shards)
            dataset_parts[n] = sp
            schemas[n] = self._schema(n, overrides)
        props = None
        if self.partition_aware:
            props = plan_physical_props(
                plan,
                {k: Partitioning.from_dict(v)
                 for k, v in dataset_parts.items() if v is not None},
                schemas, n_shards)
        # key only what changes the computation: the partition FUNCTION
        # (keys/n_parts/scheme), not per-shard row counts
        parts_key = (
            self.shuffle_axis, n_shards, self.skew_factor,
            self.partition_aware, str(self.mesh.device),
            tuple(sorted(
                (n, (tuple(dataset_parts[n]["keys"]),
                     dataset_parts[n]["n_parts"],
                     dataset_parts[n].get("scheme", "hash_mod"))
                 if dataset_parts[n] is not None else None)
                for n in input_names)))
        return props, overrides, parts_key

    def _schema(self, name: str, overrides) -> tuple:
        """Column names of a dataset without forcing a cold load (the
        store reads just the npz directory for on-disk artifacts)."""
        t = overrides.get(name)
        if t is not None:
            return tuple(t.names)
        try:
            return self.store.column_names(name)
        except KeyError:
            return tuple(self.catalog.get(name).names)

    def _jitted(self, plan, props=None, parts_key=None, skew=None,
                lossless=False):
        """Returns (fn, uid_by_fp, fps): the cached plan closure, the
        CACHED plan's op-uid per fingerprint, and the current plan's
        fingerprints.  A cache hit serves a closure over the *first*
        fingerprint-equal plan, whose op uids differ from the current
        plan's — stats are translated through fingerprints."""
        fps = plan.fingerprints()
        sig = "|".join(sorted(fps[id(s)] for s in plan.sinks))
        if skew is None:
            skew = self.skew_factor
        # the device type picks kernels or plain versions, so it is
        # part of the key, where the reference keys on use_pallas(); so
        # is the mesh + dataset-partitioning context (a co-partition
        # skip changes the computation)
        key = (sig, self.device.type, parts_key, skew, lossless)
        # the closure outlives this Engine in the PROCESS-WIDE cache:
        # capture plain locals, never `self`
        mesh, axis = self.mesh, self.shuffle_axis

        def build():
            def fn(datasets):
                return execute_plan(plan, datasets, mesh=mesh,
                                    shuffle_axis=axis, skew_factor=skew,
                                    props=props, lossless=lossless)
            uid_by_fp = {fps[id(op)]: op.uid for op in plan.topo()}
            return fn, uid_by_fp

        fn, uid_by_fp = self._jit_cache.get(key, build)
        return fn, uid_by_fp, fps

    def _timed(self, fn, load_inputs, transient, out_parts, reps):
        """Warm off the clock (``measure_exec``), then ``reps`` timed
        load->execute->store cycles.  Returns (outputs, stats, inputs,
        median wall seconds)."""
        if self.measure_exec:   # warm kernels + OS page cache
            warm, _ = fn(load_inputs())
            _sync(self.device)
            del warm
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            inputs = load_inputs()                               # T_load
            outputs, stats = fn(inputs)
            # one synchronization point per job (not per output or op)
            _sync(self.device)
            if not transient:
                # in name order, as the reference's jitted outputs come
                # back (a pytree dict, whose keys JAX sorts): both
                # packages then reach the store's IO points alike
                for name in sorted(outputs):                     # T_store
                    self.store.put(name, outputs[name],
                                   partitioning=out_parts.get(name))
            walls.append(time.perf_counter() - t0)
            if self.measure_exec:
                # drain the write-behind queue between reps so background
                # serialization does not contend with the next timed rep
                self.store.flush()
        return outputs, stats, inputs, sorted(walls)[len(walls) // 2]

    @staticmethod
    def _fetch(stats, inputs, outputs):
        """Every per-op scalar plus the input/output row counts cross to
        the host in ONE copy, not one round trip per int().  Returns
        (op uid -> {stat: int}, rows in, rows out)."""
        where, scalars = [], []
        for u in sorted(stats):
            for k, v in stats[u].items():
                where.append((u, k))
                scalars.append(v)
        scalars += [t.num_valid() for t in inputs.values()]
        scalars += [t.num_valid() for t in outputs.values()]
        vals = torch.stack([s.to(torch.int64) for s in scalars]).tolist() \
            if scalars else []
        per: Dict[int, Dict[str, int]] = {}
        for (u, k), v in zip(where, vals):
            per.setdefault(u, {})[k] = v
        rest = vals[len(where):]
        return per, sum(rest[:len(inputs)]), sum(rest[len(inputs):])

    def run_job(self, job: Job,
                transient: bool = False) -> tuple[Dict[str, Table],
                                                  JobStats]:
        """Timed window mirrors Eq. 2: T_load (dataset reads from the
        store) + operator execution + T_store (artifact writes — with the
        write-behind store only the handoff is on the clock).

        ``transient=True`` skips T_store entirely: outputs are returned
        to the caller but never put in the artifact store."""
        input_names = sorted({o.params["dataset"] for o in job.plan.loads()})
        props, overrides, parts_key = (None, {}, None)
        if self.mesh is not None:
            props, overrides, parts_key = self._mesh_context(
                job.plan, input_names)
        fn, uid_by_fp, fps = self._jitted(job.plan, props, parts_key)
        # partition property of each output artifact (STORE sinks
        # inherit their input's property), recorded at put() so the
        # artifact is written sharded and later consumers can skip
        # their exchange (DESIGN.md §11)
        out_parts = {}
        if props is not None:
            for s in job.plan.sinks:
                if s.kind == "STORE" and props.part.get(id(s)) is not None:
                    out_parts[s.params["name"]] = \
                        props.part[id(s)].to_dict()

        def load_inputs():
            return {n: overrides[n] if n in overrides else self._dataset(n)
                    for n in input_names}

        reps = self.repeats if self.measure_exec else 1
        outputs, stats, inputs, wall = self._timed(
            fn, load_inputs, transient, out_parts, reps)
        per, rows_in, rows_out = self._fetch(stats, inputs, outputs)
        bytes_in = sum(t.nbytes() for t in inputs.values())
        sh_ovf = sum(s.get("shuffle_overflow", 0) for s in per.values())
        retries = 0
        if sh_ovf > 0 and self.mesh is not None:
            # lossless retry (DESIGN.md §14): the bounded buckets dropped
            # rows or the hash reduce hit an h1 collision, so results are
            # not trustworthy — rerun once with skew=n_shards (every
            # bucket can hold a full source shard) and the
            # collision-proof sort-based reduce.  The retry's wall adds
            # to the job's; the first attempt's overflow count stays in
            # the stats as the audit trail.
            fn, uid_by_fp, fps = self._jitted(
                job.plan, props, parts_key, skew=float(self.n_shards),
                lossless=True)
            outputs, stats, _, wall2 = self._timed(
                fn, load_inputs, transient, out_parts, 1)
            wall += wall2
            retries = 1
            per, _, rows_out = self._fetch(stats, {}, outputs)
        bytes_out = sum(t.nbytes() for t in outputs.values())
        ovf = sum(s.get("join_overflow", 0) for s in per.values())
        # stats arrive keyed by the cached plan's op uids; translate to
        # the current plan's uids through the shared fingerprints
        op_rows = {}
        for op in job.plan.topo():
            s = per.get(uid_by_fp.get(fps[id(op)]))
            if s is not None:
                op_rows[op.uid] = int(s["rows_out"])
        op_cost = attribute_op_costs(job.plan, op_rows, wall)
        js = JobStats(job.job_id, wall, rows_in, bytes_in,
                      rows_out, bytes_out, op_rows, ovf, op_cost,
                      shuffle_overflow=sh_ovf, shuffle_retries=retries)
        if props is not None:
            js.shuffles = props.n_exchanges()
            js.shuffles_skipped = props.n_skipped()
            js.op_partitioning = {
                op.uid: props.part[id(op)].to_dict()
                for op in job.plan.topo()
                if props.part.get(id(op)) is not None}
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
