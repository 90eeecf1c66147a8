"""Multi-tenant workflow stream driver (DESIGN.md §9).

Replays a configurable stream of PigMix-derived workflows through a
single shared `ReStore`, the way the cross-industry workload study of
Chen et al. (arXiv:1208.4174) describes production clusters: many
tenants, zipfian query popularity (a few hot templates dominate, with a
long tail), and periodic dataset-version churn that invalidates
previously stored results (eviction rule R4).

Every tenant draws from the same template universe but through its own
popularity permutation, so tenants overlap on hot queries (cross-tenant
reuse through the shared repository) while each also has private
favourites.  Templates are version-agnostic; before each run the
catalog's *current* dataset versions are stamped into the plan
(`rebind_load_versions`), so churn is visible to matching.

Modes (the policy arms compared by `benchmarks/policy_bench.py`):

  * ``"off"``  — no reuse at all: every event runs against a fresh store
    with rewriting disabled (the recompute-everything baseline);
  * ``"keep"`` — store everything (NH enumeration), unbounded repository
    (used to size the total candidate byte volume);
  * ``"lru"``  — store everything, byte-budgeted repository with
    recency-only (least-recently-used) eviction;
  * ``"cost"`` — cost-model-driven materialization + benefit-per-byte
    budgeted repository;
  * ``"mqo"``  — cost arm + multi-query batching (DESIGN.md §16):
    events are drained in windows of ``batch_size`` through
    ``core.mqo.run_batch``, so sub-plans shared by queries arriving in
    the same window execute once with known-uses admission hints.

``run_stream`` takes ``device=None`` (the card): the catalog's tables,
every store and every driver live there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..core import plan as P
from ..core.plan import rebind_load_versions
from ..core.repository import Repository
from ..core.restore import ReStore
from ..dataflow.expr import Col
from ..store.artifacts import ArtifactStore, Catalog
from . import pigmix

DATASETS = ("page_views", "users", "power_users")


def _hi_rev() -> P.PhysicalPlan:
    """High-revenue users: shares its projection prefix with L3."""
    pv = P.project(P.load("page_views"), ["user", "estimated_revenue"])
    f = P.filter_(pv, Col("estimated_revenue") > 50.0)
    g = P.groupby(f, ["user"], {"hi": ("count", "estimated_revenue")})
    return P.PhysicalPlan([P.store(g, "hi_rev_out")])


def _busy_users() -> P.PhysicalPlan:
    """Heavy-timespent users: shares its projection prefix with L5."""
    pv = P.project(P.load("page_views"), ["user", "timespent"])
    f = P.filter_(pv, Col("timespent") > 50)
    g = P.groupby(f, ["user"], {"t": ("sum", "timespent")})
    return P.PhysicalPlan([P.store(g, "busy_out")])


def default_templates() -> List[Tuple[str, Callable[[], P.PhysicalPlan]]]:
    return [
        ("L2", pigmix.L2),
        ("L3_sum", lambda: pigmix.L3("sum")),
        ("L3_mean", lambda: pigmix.L3("mean")),
        ("L3F", pigmix.L3F),
        ("L4", pigmix.L4),
        ("L5", pigmix.L5),
        ("L6", pigmix.L6),
        ("L7", pigmix.L7),
        ("L8", pigmix.L8),
        ("L11", lambda: pigmix.L11("power_users")),
        ("hi_rev", _hi_rev),
        ("busy_users", _busy_users),
    ]


@dataclasses.dataclass
class StreamConfig:
    n_events: int = 48
    n_tenants: int = 3
    zipf_s: float = 1.1           # template popularity skew
    n_rows: int = 1 << 12
    seed: int = 0
    churn_every: int = 0          # bump page_views version every N events
    cache_bytes: int = 64 * 1024 * 1024
    # append churn (DESIGN.md §12): every N events page_views GROWS by
    # append_frac × n_rows fresh rows — the dominant real-world change
    # class, which incremental maintenance refreshes instead of
    # R4-deleting.  maintain="refresh"|"auto"|"lazy" routes stale
    # entries through Repository.maintain; "delete" reproduces the
    # pre-§12 delete-and-recompute behavior (the ablation arm).
    append_every: int = 0
    append_frac: float = 0.10
    maintain: str = "auto"
    # speculative prefetch (DESIGN.md §15): mine the store's read log
    # for zipfian recurrence, warm the predicted top-k between events
    # (off the timed window, like a background service cadence), and on
    # append churn delta-refresh the predicted-hot artifacts ahead of
    # the next probe instead of inside it
    prefetch: bool = False
    prefetch_k: int = 4
    # multi-query batching (DESIGN.md §16): window size for mode="mqo"
    # (0 falls back to per-event execution even in mqo mode)
    batch_size: int = 0


@dataclasses.dataclass
class StreamEvent:
    idx: int
    tenant: int
    template: str
    wall_s: float
    n_executed: int
    n_reused: int


@dataclasses.dataclass
class StreamResult:
    mode: str
    budget_bytes: Optional[int]
    events: List[StreamEvent]
    cum_wall_s: List[float]       # cumulative runtime after each event
    total_wall_s: float
    peak_store_bytes: int
    repo_entries: int
    repo_bytes: int
    evictions: int
    rejections: int
    refreshes: int = 0            # delta-refreshed entries (§12)
    prefetch_hits: int = 0        # warmed artifacts actually probed (§15)
    prefetched: int = 0           # warm attempts
    refreshed_ahead: int = 0      # delta-refreshes run pre-arrival (§15)
    batches: int = 0              # MQO windows drained (§16)
    mqo_shared_wall_s: float = 0.0   # time spent in shared prefixes
    mqo_dup_executions: int = 0      # shared sub-plans run twice (audit)
    # the shared driver (None in mode "off"), so a caller can hold the
    # repository's entries against a recompute after the run
    driver: Optional[ReStore] = None

    @property
    def n_reused_total(self) -> int:
        return sum(e.n_reused for e in self.events)


def open_loop_arrivals(n_events: int, rate_per_s: float,
                       seed: int = 0) -> np.ndarray:
    """Absolute arrival offsets (seconds) for an open-loop Poisson
    stream: exponential inter-arrival times at ``rate_per_s``.  Open
    loop means arrivals do NOT wait for completions — the offered load
    is fixed, so an overloaded service shows up as growing latency and
    falling goodput rather than as a politely self-throttling client
    (the service bench's saturation measurements depend on this)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / float(rate_per_s), n_events)
    return np.cumsum(gaps)


def _event_schedule(cfg: StreamConfig, n_templates: int):
    """Deterministic (tenant, template) sequence: zipfian rank
    distribution mapped through a per-tenant popularity permutation."""
    rng = np.random.default_rng(cfg.seed)
    p = 1.0 / np.arange(1, n_templates + 1) ** cfg.zipf_s
    p /= p.sum()
    perms = [np.random.default_rng(cfg.seed + 101 + t)
             .permutation(n_templates) for t in range(cfg.n_tenants)]
    out = []
    for _ in range(cfg.n_events):
        tenant = int(rng.integers(cfg.n_tenants))
        rank = int(rng.choice(n_templates, p=p))
        out.append((tenant, int(perms[tenant][rank])))
    return out


def _make_restore(mode: str, catalog: Catalog, store: ArtifactStore,
                  budget_bytes: Optional[int]) -> ReStore:
    if mode == "keep":
        repo = Repository()
        heuristic = "none"
    elif mode == "lru":
        repo = Repository(budget_bytes=budget_bytes, policy="lru")
        heuristic = "none"
    elif mode in ("cost", "mqo"):
        repo = Repository(budget_bytes=budget_bytes, policy="cost")
        heuristic = "cost"
    else:
        raise ValueError(f"unknown stream mode {mode!r}")
    return ReStore(catalog, store, repo, heuristic=heuristic,
                   measure_exec=True, repeats=1, device=catalog.device)


def run_stream(mode: str, cfg: StreamConfig,
               budget_bytes: Optional[int] = None,
               templates=None, device=None) -> StreamResult:
    """Replay the stream under one policy arm and return its timeline.

    Runtime per event is the engine's timed window (jit warmed off the
    clock, like every benchmark in this repo), summed over the event's
    executed jobs — a fully reused job contributes zero."""
    templates = templates or default_templates()
    schedule = _event_schedule(cfg, len(templates))

    store = ArtifactStore(cache_bytes=cfg.cache_bytes, device=device)
    catalog = Catalog(store, device=device)
    pigmix.register_all(catalog, n_rows=cfg.n_rows, seed=cfg.seed)
    shared_rs = None
    if mode != "off":
        shared_rs = _make_restore(mode, catalog, store, budget_bytes)
    prefetcher = None
    if cfg.prefetch and shared_rs is not None:
        from ..store.prefetch import SpeculativePrefetcher
        prefetcher = SpeculativePrefetcher(
            store, k=cfg.prefetch_k,
            maintainer=(None if cfg.maintain == "delete" else
                        lambda names: shared_rs.maintain(
                            mode=cfg.maintain, only=names)))

    events: List[StreamEvent] = []
    cum: List[float] = []
    total = 0.0
    peak_bytes = 0
    n_batches = 0
    mqo_shared_wall = 0.0
    mqo_dups = 0

    def _churn(i: int) -> None:
        if cfg.churn_every and i > 0 and i % cfg.churn_every == 0:
            # dataset-version churn: the hot table is re-ingested; every
            # artifact derived from the old version is stale (rule R4)
            catalog.register("page_views",
                             pigmix.gen_page_views(
                                 cfg.n_rows,
                                 seed=cfg.seed + 1000 + i,
                                 device=catalog.device))
            if shared_rs is not None:
                shared_rs.repo.evict_stale(catalog)
        if cfg.append_every and i > 0 and i % cfg.append_every == 0:
            # append churn: page_views grows; stale entries refresh from
            # the delta instead of recomputing from zero (DESIGN.md §12)
            n_delta = max(int(cfg.n_rows * cfg.append_frac), 1)
            catalog.append("page_views",
                           pigmix.gen_page_views(
                               n_delta, seed=cfg.seed + 5000 + i,
                               device=catalog.device))
            if shared_rs is not None:
                if cfg.maintain == "delete":
                    shared_rs.repo.evict_stale(catalog)
                elif prefetcher is not None:
                    # ahead-of-arrival: refresh the predicted-hot
                    # entries first (and re-warm them), then sweep the
                    # rest through the regular path
                    prefetcher.observe_append("page_views")
                    shared_rs.maintain(mode=cfg.maintain)
                else:
                    shared_rs.maintain(mode=cfg.maintain)

    def _bind(tidx: int) -> P.PhysicalPlan:
        return rebind_load_versions(
            templates[tidx][1](),
            {ds: catalog.version(ds) for ds in DATASETS})

    if mode == "mqo" and cfg.batch_size > 1:
        # windowed draining (DESIGN.md §16): churn is applied at each
        # event's index as it is *drained*, then the whole window runs
        # through the batch optimizer; the shared prefix's wall is
        # spread evenly across the window's events
        from ..core.mqo import run_batch
        for w0 in range(0, len(schedule), cfg.batch_size):
            window = list(enumerate(schedule))[w0:w0 + cfg.batch_size]
            for i, _ in window:
                _churn(i)
            plans = [_bind(tidx) for _, (_, tidx) in window]
            br = run_batch(shared_rs, plans)
            n_batches += 1
            mqo_shared_wall += br.shared_wall_s
            mqo_dups += br.dup_executions
            spread = br.shared_wall_s / max(len(window), 1)
            for (i, (tenant, tidx)), report in zip(window, br.reports):
                wall = report.total_wall_s + spread
                total += wall
                cum.append(total)
                events.append(StreamEvent(i, tenant, templates[tidx][0],
                                          wall, report.n_executed,
                                          report.n_reused))
            peak_bytes = max(peak_bytes, shared_rs.store.total_bytes())
            if prefetcher is not None:
                prefetcher.prefetch()
    else:
        for i, (tenant, tidx) in enumerate(schedule):
            _churn(i)
            plan = _bind(tidx)
            if mode == "off":
                rs = ReStore(catalog,
                             ArtifactStore(cache_bytes=cfg.cache_bytes,
                                           device=catalog.device),
                             heuristic="off", rewrite_enabled=False,
                             measure_exec=True, repeats=1,
                             device=catalog.device)
            else:
                rs = shared_rs
            _, report = rs.run_plan(plan)
            wall = report.total_wall_s
            total += wall
            cum.append(total)
            events.append(StreamEvent(i, tenant, templates[tidx][0], wall,
                                      report.n_executed, report.n_reused))
            peak_bytes = max(peak_bytes, rs.store.total_bytes())
            if prefetcher is not None:
                # between events = the background cadence: consume the
                # read log and warm the predicted-next artifacts off
                # the clock
                prefetcher.prefetch()

    repo = shared_rs.repo if shared_rs is not None else Repository()
    pstats = prefetcher.stats() if prefetcher is not None else {}
    return StreamResult(
        mode=mode, budget_bytes=budget_bytes, events=events,
        cum_wall_s=cum, total_wall_s=total, peak_store_bytes=peak_bytes,
        repo_entries=len(repo), repo_bytes=repo.total_stored_bytes(),
        evictions=repo.evictions, rejections=repo.rejections,
        refreshes=repo.refreshes,
        prefetch_hits=pstats.get("hits", 0),
        prefetched=pstats.get("prefetched", 0),
        refreshed_ahead=pstats.get("refreshed_ahead", 0),
        batches=n_batches, mqo_shared_wall_s=mqo_shared_wall,
        mqo_dup_executions=mqo_dups, driver=shared_rs)
