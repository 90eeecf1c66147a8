"""The ReStore driver (paper Fig. 7, §6.2; economics in DESIGN.md §9).

Mirrors the extended JobControlCompiler: jobs are processed in dependency
order; each job's plan goes through (1) matching + rewriting against the
repository, (2) sub-job enumeration, then is executed; statistics are
retrieved and the outputs registered in the repository.

Beyond the paper's driver, every execution feeds the repository's cost
model: per-op producer costs (attributed from the job's wall time),
output sizes, and the store's measured IO bandwidth.  Under the
``"cost"`` heuristic those statistics decide which sub-jobs are
materialized, and under a repository byte budget they decide which
entries survive — a candidate the repository rejects has its artifact
deleted from the store again (admission replaces the old unconditional
put).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..dataflow.builder import as_plan
from ..dataflow.compiler import Job, Workflow, compile_workflow
from ..dataflow.executor import Engine, JobStats
from ..store.artifacts import (ArtifactError, ArtifactFlushError,
                               ArtifactStore, Catalog)
from .enumerator import enumerate_subjobs, whole_job_candidates
from .plan import PhysicalPlan
from .repository import Repository, make_entry
from .rewriter import is_trivial, rewrite_plan


@dataclasses.dataclass
class JobReport:
    job_id: int
    executed: bool
    reused_artifacts: List[str]
    stored_candidates: List[str]
    stats: Optional[JobStats]
    n_ops_before: int = 0
    n_ops_after: int = 0
    rejected_candidates: List[str] = dataclasses.field(default_factory=list)
    n_semantic: int = 0               # subsumption hits among the reuses


@dataclasses.dataclass
class RunReport:
    jobs: List[JobReport]
    wall_s: float = 0.0
    # artifacts quarantined (corrupt/missing -> recomputed cold) during
    # this run: reuse degraded, correctness did not (DESIGN.md §13)
    degraded: int = 0
    # artifact names whose write-behind flush failed permanently at the
    # end-of-run durability barrier (they are de-advertised; the run's
    # results are unaffected — they were computed on device)
    flush_failures: List[str] = dataclasses.field(default_factory=list)

    @property
    def n_executed(self) -> int:
        return sum(1 for j in self.jobs if j.executed)

    @property
    def n_reused(self) -> int:
        return sum(len(j.reused_artifacts) for j in self.jobs)

    @property
    def n_semantic(self) -> int:
        return sum(j.n_semantic for j in self.jobs)

    @property
    def total_wall_s(self) -> float:
        return sum(j.stats.wall_s for j in self.jobs if j.stats)


class ReStore:
    def __init__(self, catalog: Catalog, store: ArtifactStore,
                 repository: Optional[Repository] = None,
                 heuristic: str = "aggressive",
                 use_algorithm1: bool = False,
                 rewrite_enabled: bool = True,
                 semantic: bool = True,
                 measure_exec: bool = False,
                 repeats: int = 5,
                 mesh=None, shuffle_axis: str = "data",
                 skew_factor: float = 4.0, partition_aware: bool = True,
                 min_splice_benefit_s: float = 1e-3, device=None):
        self.catalog = catalog
        self.store = store
        if repository is not None:
            self.repo = repository
        else:
            # engine-owned repository: arm the exact-splice admission
            # guard (CostModel.should_splice) — a streaming-only region
            # whose predicted byte-diet saving cannot clear the splice
            # overhead recomputes instead of reusing (the L7 fix).  A
            # caller-supplied repository keeps its own cost model as-is.
            self.repo = Repository()
            self.repo.cost_model.min_splice_benefit_s = min_splice_benefit_s
        self.repo.bind_store(store)
        # the engine runs every job on one device (None: the mesh's, else
        # the card); mesh: every job's map->shuffle->reduce stages run
        # across its shards (DESIGN.md §11); partition_aware=False is the
        # partition-blind ablation (artifacts monolithic, every exchange
        # always runs)
        self.engine = Engine(catalog, store, measure_exec=measure_exec,
                             repeats=repeats, mesh=mesh,
                             shuffle_axis=shuffle_axis,
                             skew_factor=skew_factor,
                             partition_aware=partition_aware,
                             device=device)
        self.heuristic = heuristic
        self.use_algorithm1 = use_algorithm1
        self.rewrite_enabled = rewrite_enabled
        # subsumption fallback (DESIGN.md §10): when the exact probes of
        # both reuse paths miss — the whole-job fast path (store hit on
        # identical outputs) and the exact rewrite scan — covering
        # artifacts may still answer sub-plans through compensation
        self.semantic = semantic
        # boundary artifact -> source-dataset versions it was derived
        # from, so entries of downstream jobs (whose plans load art/...
        # names) still carry the *transitive* source versions rule R4's
        # garbage collector needs
        self._art_versions: Dict[str, Dict[str, int]] = {}
        # artifacts pinned mid-run beyond the boundary names: when a
        # reused job ALIASES its output to a repository artifact, that
        # backing artifact must survive budget eviction until the
        # workflow is done (downstream jobs load it through the alias)
        self._run_pins: set = set()
        # artifacts quarantined + recomputed cold in the current run
        self._degraded = 0

    # ------------------------------------------------------------------
    def run(self, query):
        """Unified submission surface (DESIGN.md §16): accept either a
        ``PhysicalPlan`` or a Pig-style ``dataflow.builder.Dataflow``
        (lowered via its ``build()``), compile to a workflow and run it.
        Returns ``(results, RunReport)``."""
        return self.run_workflow(compile_workflow(as_plan(query)))

    def run_plan(self, plan: PhysicalPlan):
        """Deprecated alias for :meth:`run` (pre-§16 signature; kept so
        existing call sites migrate incrementally)."""
        return self.run(plan)

    def run_batch(self, queries, semantic: bool = True):
        """Run a batch of queries through the multi-query optimizer
        (DESIGN.md §16): shared sub-plans execute once, then each query
        runs against the materialized shared work.  Returns a
        :class:`core.mqo.BatchResult`."""
        from .mqo import run_batch
        return run_batch(self, queries, semantic=semantic)

    def run_workflow(self, wf: Workflow):
        # job-boundary artifacts are loaded by downstream jobs of THIS
        # workflow: pin them so budget eviction cannot delete them
        # mid-run, then settle back under budget once the run is over
        boundary = {o for job in wf.jobs for o in job.outputs}
        self.repo.pin(boundary)
        self._degraded = 0
        try:
            # graceful degradation (DESIGN.md §13): an ArtifactError while
            # gathering results means a boundary artifact went bad AFTER
            # its job completed — quarantine it and replay the workflow;
            # intact jobs short-circuit through the fast path, only the
            # damaged one recomputes.  Per-job faults degrade inside
            # _process_job; this loop only absorbs the gather window.
            for cycle in range(3):
                reports: List[JobReport] = []
                try:
                    for job in wf.jobs:
                        reports.append(self._process_job(job))
                    results = {user: self.store.get(ds)
                               for user, ds in wf.final_outputs.items()}
                    break
                except ArtifactError as e:
                    if e.name is None or cycle == 2:
                        raise
                    self._degrade(e)
        finally:
            # unpin mirrors the two pin sites exactly (boundary at run
            # start, _pin_for_run increments during the run): pins are
            # refcounted so concurrent workflows sharing the repository
            # don't release each other's protection
            self.repo.unpin(boundary)
            self.repo.unpin(self._run_pins)
            self._run_pins = set()
        self.repo.rebalance()
        # workflow end is a durability point for the write-behind store.
        # A permanent flush failure does not invalidate the results (they
        # were computed on device); the failed artifacts are already
        # de-advertised — report them instead of failing the run.
        flush_failures: List[str] = []
        try:
            self.store.flush()
        except ArtifactFlushError as e:
            flush_failures = sorted(e.failures)
        return results, RunReport(reports, degraded=self._degraded,
                                  flush_failures=flush_failures)

    def maintain(self, mode: str = "auto", only=None) -> Dict[str, int]:
        """Incremental maintenance entry point (DESIGN.md §12): refresh
        append-stale repository artifacts from their dataset deltas
        through this driver's engine; entries with no derivable delta
        plan fall back to R4 deletion.  Call after `Catalog.append`/
        `Catalog.register` churn, where `evict_stale` used to be.
        ``only`` restricts the sweep to a set of artifact names (the
        prefetcher's ahead-of-arrival refresh, DESIGN.md §15)."""
        return self.repo.maintain(self.catalog, self.engine, self.store,
                                  mode=mode, only=only)

    # ------------------------------------------------------------------
    def _degrade(self, e: ArtifactError) -> None:
        """Absorb one artifact failure: quarantine the damaged bytes,
        un-advertise every repository entry backed by them, count it.
        The caller then retries — with the artifact gone, matching
        cannot pick it again, so the retry recomputes cold."""
        self._degraded += 1
        self.store.quarantine(e.name)
        self.repo.drop_artifact(e.name)

    def _process_job(self, job: Job) -> JobReport:
        """One job with graceful degradation: an ArtifactError from the
        reuse machinery (corrupt npz, missing file, flaky IO past its
        retries) quarantines the named artifact and retries; the final
        attempt runs with rewriting disabled — fully cold — so reuse is
        never a correctness dependency (DESIGN.md §13)."""
        last: Optional[ArtifactError] = None
        for attempt in range(3):
            try:
                return self._process_job_once(
                    job, rewrite_enabled=(self.rewrite_enabled
                                          and attempt < 2))
            except ArtifactError as e:
                if e.name is None:
                    raise
                last = e
                self._degrade(e)
        raise last

    def _process_job_once(self, job: Job,
                          rewrite_enabled: bool = True) -> JobReport:
        # lazily-deferred refreshes whose probe has arrived run first,
        # so the refreshed entries match exactly below (DESIGN.md §12)
        if self.repo.pending_refresh:
            self.repo.refresh_pending(job.plan, self.engine, self.catalog,
                                      self.store)
        # a job whose outputs all exist is fully answered by the store
        if all(self.store.exists(o) for o in job.outputs):
            # this is the hottest reuse path (identical recurring jobs):
            # credit the backing entries — resolving aliases, since a
            # previously reused job serves its output THROUGH an alias
            # to the backing artifact — or budget eviction would rank
            # exactly the most-reused artifacts as unused
            outs = {self.store._resolve(o) for o in job.outputs} \
                | set(job.outputs)
            cm = self.repo.cost_model
            for e in self.repo.entries:
                if e.artifact in outs:
                    saved = cm.savings_per_reuse_s(
                        e.producer_cost_s or e.exec_time_s, e.bytes_out)
                    self.repo.record_use(e, saved_s=max(saved, 0.0))
            self._pin_for_run(outs)
            return JobReport(job.job_id, False, list(job.outputs), [], None,
                             job.plan.n_ops(), 0)

        n_before = job.plan.n_ops()
        n_semantic = 0
        comp_ids = set()
        if rewrite_enabled:
            # mesh context lets the rewriter price the exchanges a
            # co-partitioned artifact avoids (DESIGN.md §11)
            n_shards = self.engine.n_shards \
                if self.engine.partition_aware else None
            rw = rewrite_plan(job.plan, self.repo,
                              use_algorithm1=self.use_algorithm1,
                              semantic=self.semantic,
                              n_shards=n_shards)
            plan, used, origin = rw.plan, rw.used, rw.origin
            n_semantic = rw.n_semantic
            comp_ids = rw.comp_op_ids
        else:
            plan = job.plan
            used = []
            origin = {id(op): op for op in plan.topo()}

        if is_trivial(plan):
            # fully reused: alias outputs to the loaded artifacts
            trivial_versions = {}
            for e in used:
                trivial_versions.update(e.source_versions)
            for s in plan.sinks:
                self.store.alias(s.params["name"],
                                 s.inputs[0].params["dataset"])
                self._art_versions[s.params["name"]] = dict(trivial_versions)
                # the alias target backs this job's output for the rest
                # of the workflow: keep it safe from budget eviction
                self._pin_for_run({self.store._resolve(s.params["name"])})
            return JobReport(job.job_id, False,
                             [e.artifact for e in used], [], None,
                             n_before, plan.n_ops(),
                             n_semantic=n_semantic)

        exec_plan, cands = enumerate_subjobs(plan, origin, job.plan,
                                             self.heuristic,
                                             cost_model=self.repo.cost_model)
        whole = whole_job_candidates(plan, origin, job.plan)

        exec_job = Job(job.job_id, exec_plan,
                       inputs=sorted({o.params["dataset"]
                                      for o in exec_plan.loads()}),
                       outputs=[s.params["name"] for s in exec_plan.sinks],
                       blocking=job.blocking)
        outputs, stats = self.engine.run_job(exec_job)

        self._observe_execution(job.plan, exec_plan, origin, stats,
                                skip_ids=comp_ids)

        stored, rejected = [], []
        versions: Dict[str, int] = {}
        for ds in exec_job.inputs:
            if ds.startswith("art/"):
                versions.update(self._versions_of_artifact(ds))
            else:
                versions[ds] = self.catalog.version(ds)
        for o in exec_job.outputs:
            self._art_versions[o] = dict(versions)
        for c, injected in [(c, True) for c in cands] + \
                           [(c, False) for c in whole]:
            if not self.store.exists(c.artifact):
                continue
            nbytes = self.store.nbytes(c.artifact)
            self.repo.cost_model.observe_stored_bytes(c.struct_fp, nbytes)
            op_hist = self.repo.cost_model.stats_for(c.struct_fp)
            entry = make_entry(
                c.plan, c.artifact,
                bytes_in=stats.bytes_in,
                bytes_out=nbytes,
                rows_out=stats.op_rows.get(c.exec_op_uid, 0),
                exec_time_s=stats.wall_s,
                producer_cost_s=stats.op_cost_s.get(c.exec_op_uid,
                                                    stats.wall_s),
                # seed admission with observed recurrence OR the batch
                # optimizer's known consumer count (§16), whichever is
                # stronger — known uses are facts about queued queries
                history_uses=max(
                    op_hist.times_seen if op_hist else 0.0,
                    self.repo.cost_model.known_uses_for(
                        c.struct_fp, c.artifact)),
                source_versions=versions,
                # partition property of the candidate's output under
                # mesh execution — what future rewrites splice in as a
                # shuffle-free Load (DESIGN.md §11)
                partitioning=stats.op_partitioning.get(c.exec_op_uid))
            if self.repo.add(entry):
                stored.append(c.artifact)
            elif injected and entry.signature not in self.repo.by_sig \
                    and c.artifact not in job.outputs:
                # an injected sub-job artifact the repository refused to
                # keep is dead weight: nothing will ever match it, so
                # reclaim its bytes (whole-job outputs stay — they are
                # the workflow's actual results)
                self.store.delete(c.artifact)
                rejected.append(c.artifact)

        return JobReport(job.job_id, True, [e.artifact for e in used],
                         stored, stats, n_before, exec_plan.n_ops(),
                         rejected_candidates=rejected,
                         n_semantic=n_semantic)

    def _pin_for_run(self, names) -> None:
        """Pin artifacts until the current workflow run finishes (used
        for alias targets that back reused job outputs).  Each name is
        pinned at most once per run so the single unpin in run_workflow
        balances the refcount exactly."""
        new = set(names) - self._run_pins
        if new:
            self._run_pins |= new
            self.repo.pin(new)

    def _versions_of_artifact(self, name: str) -> Dict[str, int]:
        """Transitive source versions of a boundary artifact: from this
        driver's run history, falling back to the repository entry that
        recorded the artifact (a fresh driver over a warm repo)."""
        v = self._art_versions.get(name)
        if v is not None:
            return v
        for e in self.repo.entries:
            if e.artifact == name:
                return e.source_versions
        return {}

    # ------------------------------------------------------------------
    def _observe_execution(self, orig_plan: PhysicalPlan,
                           exec_plan: PhysicalPlan,
                           origin: Dict[int, object],
                           stats: JobStats,
                           skip_ids=frozenset()) -> None:
        """Feed one job's measured statistics into the cost model: per-op
        rows / byte estimates / attributed producer cost, keyed by
        structural fingerprint, plus the store's IO bandwidth samples.
        Every executed operator counts as a missed reuse opportunity —
        exactly the signal `should_materialize` needs next time.
        ``skip_ids`` holds the semantic compensation roots: they carry
        the anchor's origin (so the enumerator can re-materialize the
        exact value) but their execution is a reuse HIT, not a miss, and
        their cheap residual-pass cost must not pollute the original
        operator's producer-cost estimate (DESIGN.md §10)."""
        cm = self.repo.cost_model
        struct_fps = orig_plan.structural_fingerprints()
        row_width = stats.bytes_in / max(stats.rows_in, 1)
        for op in exec_plan.topo():
            if op.kind in ("LOAD", "STORE", "SPLIT") or id(op) in skip_ids:
                continue
            orig = origin.get(id(op))
            if orig is None or id(orig) not in struct_fps:
                continue
            rows = stats.op_rows.get(op.uid, 0)
            cm.observe_op(struct_fps[id(orig)],
                          rows_out=rows,
                          bytes_out=int(rows * row_width),
                          producer_cost_s=stats.op_cost_s.get(
                              op.uid, stats.wall_s))
        cm.calibrate_io(self.store)
