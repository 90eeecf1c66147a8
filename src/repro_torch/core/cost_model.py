"""Repository economics: the cost model behind keep/evict decisions
(paper §5; gain/loss framing after Chakroborti et al., arXiv:2202.06473;
DESIGN.md §9).

The paper decides *which* job and sub-job outputs to materialize from
collected plan statistics.  This module is the single place those
statistics meet a price:

  * **IO price** — load/store bandwidth, calibrated online from the
    artifact store's measured transfer samples (`calibrate_io`), so the
    same policy code prices a device-cache hit (~free) and a cold disk
    read (bytes / bandwidth) correctly.
  * **Plan statistics** — per-operator rows/bytes/producer-cost keyed by
    *structural* fingerprint (dataset versions masked), fed by the
    executor's per-op cost attribution (`JobStats.op_cost_s`).  Keying
    structurally lets statistics survive dataset-version churn: the
    artifact of a churned input can never be reused (rule R4), but the
    knowledge "this operator is expensive and recurs" can.
  * **Decisions** — `should_materialize` (sub-job admission at
    enumeration time) and `benefit_per_byte` (the knapsack-style ranking
    the byte-budgeted repository evicts by).

Benefit model (Eq. analogous to paper Eq. 1/2):

  savings_per_reuse = producer_cost − load_cost(bytes)
  benefit           = savings_per_reuse × expected_future_uses
  materialize iff     benefit > store_cost(bytes) + fixed_io
  evict by ascending  benefit / bytes  (recency-decayed)

`expected_future_uses` is a history-repeats estimator: every *observed
execution* of an operator was a missed reuse opportunity, so an operator
seen k times is predicted to recur ~k more times; a repository entry's
future uses decay with time since last use (half-life) from its hit
count.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional

# Operator kinds that stream: one pass, output rows a subset/projection
# of input rows, no exchange and no state across rows.  A matched region
# made only of these re-derives its value at memory bandwidth, so an
# exact splice saves IO bytes at most (see CostModel.should_splice).
STREAMING_KINDS = frozenset(
    {"LOAD", "STORE", "SPLIT", "FILTER", "PROJECT", "FOREACH", "UNION"})


@dataclasses.dataclass
class OpStats:
    """Collected statistics for one structural operator fingerprint."""
    times_seen: int = 0           # executions observed (missed reuses)
    rows_out: int = 0
    bytes_out: int = 0            # estimate until stored once, then exact
    bytes_exact: bool = False
    producer_cost_s: float = 0.0  # EWMA cumulative cost to (re)compute
    last_seen: float = 0.0


def _same(value):
    return value


def _agreed(decide):
    """A decision every process of a mesh takes alike: ``agree`` turns
    each process's own verdict into rank 0's (``GroupMesh.agree``), so a
    clock that reads differently on two ranks cannot split their plans;
    in one process it is the verdict itself."""
    @functools.wraps(decide)
    def decision(self, *args, **kwargs):
        return self.agree(decide(self, *args, **kwargs))
    return decision


class CostModel:
    # rank 0's value of a decision (``launch.mesh.GroupMesh.agree``,
    # installed by the ReStore driver of a mesh); the identity otherwise
    agree = staticmethod(_same)

    def __init__(self,
                 load_bandwidth_bytes_s: float = 2e9,
                 store_bandwidth_bytes_s: float = 2e9,
                 shuffle_bandwidth_bytes_s: float = 5e8,
                 fixed_io_s: float = 1e-5,
                 ewma_alpha: float = 0.5,
                 reuse_halflife_s: float = 1800.0,
                 prior_uses: float = 0.5,
                 max_expected_uses: float = 64.0,
                 min_splice_benefit_s: float = 0.0):
        self.load_bw = load_bandwidth_bytes_s
        self.store_bw = store_bandwidth_bytes_s
        self.shuffle_bw = shuffle_bandwidth_bytes_s
        # per-tier load bandwidths (DESIGN.md §15): "disk" mirrors
        # load_bw (kept as the attribute every existing caller prices
        # with); "host" and "remote" start at priors spanning the
        # realistic orders of magnitude and are replaced by calibration
        # from tier-tagged samples.  Each tier calibrates ONLY from its
        # own samples — the satellite-3 contract that a device-cache
        # hit (or a remote fetch) can never skew the disk estimate.
        self.tier_bw: Dict[str, float] = {
            "host": 8e9, "remote": 1e8, "device": 5e10}
        self.fixed_io_s = fixed_io_s
        # fixed per-request latency of the remote tier (calibrated from
        # request-level samples when available; the prior models an
        # object-store round trip)
        self.remote_latency_s = 0.02
        self.alpha = ewma_alpha
        self.halflife_s = reuse_halflife_s
        self.prior_uses = prior_uses
        self.max_expected_uses = max_expected_uses
        self.min_splice_benefit_s = min_splice_benefit_s
        # serve-side producer price (DESIGN.md §17): seconds of prefill
        # per prompt token, calibrated online from measured prefill
        # walls exactly like the IO bandwidths — it is the "producer
        # cost" of a stored prefix entry
        self.prefill_s_per_token = 1e-3
        self._prefill_tokens_seen = 0
        self.op_stats: Dict[str, OpStats] = {}
        # Batch-optimizer materialization hints (DESIGN.md §16): key
        # (structural fingerprint OR artifact name) -> number of queries
        # in the current batch *known* to consume that sub-job.  Unlike
        # op_stats these are facts about queued work, not history — they
        # override the seen-once admission gate and floor the
        # expected-uses estimate while a batch is in flight.
        self.known_uses: Dict[str, float] = {}

    # ------------------------------------------------------------- IO price
    #: minimum sampled byte mass before a measurement replaces a prior
    MIN_SAMPLE_BYTES = 1 << 16

    def calibrate_io(self, store) -> None:
        """Pull measured (bytes, seconds) transfer totals from an
        `ArtifactStore` and update the per-tier bandwidth estimates.
        Samples are tagged by the tier that served them (DESIGN.md
        §15), and each tier calibrates only from its own tag — a
        blended average would price cold reads at ~zero the moment
        cache hits dominate traffic.  The one sanctioned crossover:
        a store with NO disk backend (``has_disk`` false) may stand its
        memory samples in for the load bandwidth, because there loads
        genuinely are that cheap.  Disk-backed stores must never do
        this — a probe mix of many cache hits and a few small disk
        reads would otherwise calibrate cold reads at memory speed and
        skew every refresh_decision built on it.  A minimum sample mass
        guards against one-off timing flukes."""
        io = getattr(store, "io_stats", None)
        if io is None:
            return
        # rank 0's samples on every rank of a mesh: the bandwidths price
        # the decisions below, and the ranks' clocks differ
        s = self.agree(io() if callable(io) else io)

        def bw(prefix):
            if (s.get(prefix + "_bytes", 0) > self.MIN_SAMPLE_BYTES
                    and s.get(prefix + "_s", 0.0) > 0):
                return s[prefix + "_bytes"] / s[prefix + "_s"]
            return None

        disk = bw("load")
        if disk is not None:
            self.load_bw = disk
        elif not s.get("has_disk", False):
            mem = bw("memload")
            if mem is not None:
                self.load_bw = mem
        mem = bw("memload")
        if mem is not None:
            self.tier_bw["device"] = mem
        host = bw("hostload")
        if host is not None:
            self.tier_bw["host"] = host
        remote = bw("remoteload")
        if remote is not None:
            self.tier_bw["remote"] = remote
        st = bw("store")
        if st is not None:
            self.store_bw = st

    #: minimum token mass before a prefill sample replaces the prior
    MIN_PREFILL_TOKENS = 16

    def observe_prefill(self, n_tokens: int, seconds: float) -> None:
        """Record one measured prefill (``n_tokens`` prompt tokens in
        ``seconds``).  The first qualifying sample replaces the prior;
        later samples blend by the same EWMA the op-cost stats use, so
        the per-token rate tracks compile warmup settling down."""
        if n_tokens <= 0 or seconds <= 0.0:
            return
        rate = seconds / n_tokens
        if self._prefill_tokens_seen < self.MIN_PREFILL_TOKENS:
            self.prefill_s_per_token = rate
        else:
            self.prefill_s_per_token += self.alpha * (
                rate - self.prefill_s_per_token)
        self._prefill_tokens_seen += int(n_tokens)

    def prefill_cost_s(self, n_tokens: int) -> float:
        """Predicted wall cost of prefilling ``n_tokens`` — the producer
        cost of a prefix entry, priced per calibrated token rate."""
        return max(int(n_tokens), 0) * self.prefill_s_per_token

    def tier_bandwidth(self, tier: str) -> float:
        if tier == "disk":
            return self.load_bw
        return self.tier_bw.get(tier, self.load_bw)

    def tier_load_cost_s(self, nbytes: int, tier: str) -> float:
        """Price of serving ``nbytes`` from a given tier.  Remote reads
        carry the per-request latency on top of the bandwidth term —
        that latency, not the bytes, is what batching and prefetch
        amortize."""
        fixed = self.fixed_io_s
        if tier == "remote":
            fixed += self.remote_latency_s
        return fixed + nbytes / max(self.tier_bandwidth(tier), 1.0)

    def should_promote(self, nbytes: int, from_tier: str, to_tier: str,
                       expected_uses: float = None) -> bool:
        """Admission pricing for a tier transition (DESIGN.md §15):
        copy an artifact from ``from_tier`` to the warmer ``to_tier``
        iff the predicted read savings over its expected future uses
        exceed the one-time migration cost (one read from the source
        plus one write at store bandwidth).  The same inequality
        prices demotion in reverse: a demotion is free capacity-wise
        and only costs the write, so callers demote unless the entry
        is about to be read again from the cold tier."""
        if expected_uses is None:
            expected_uses = max(self.prior_uses * 2.0, 1.0)
        save = (self.tier_load_cost_s(nbytes, from_tier)
                - self.tier_load_cost_s(nbytes, to_tier))
        if save <= 0.0:
            return False
        migrate = (self.tier_load_cost_s(nbytes, from_tier)
                   + self.store_cost_s(nbytes))
        return save * expected_uses > migrate

    def load_cost_s(self, nbytes: int) -> float:
        return self.fixed_io_s + nbytes / max(self.load_bw, 1.0)

    def store_cost_s(self, nbytes: int) -> float:
        return self.fixed_io_s + nbytes / max(self.store_bw, 1.0)

    def shuffle_cost_s(self, nbytes: int) -> float:
        """Price of one full exchange of ``nbytes`` across the mesh —
        the map-side bucketing plus the all_to_all (DESIGN.md §11).
        Modelled as a bandwidth term like load/store (the exchange
        moves every byte once over a slower path); a reused artifact
        that is co-partitioned on its consumer's keys is credited this
        on top of the recompute savings, because the consumer's
        exchange is skipped outright."""
        return self.fixed_io_s + nbytes / max(self.shuffle_bw, 1.0)

    def compensation_cost_s(self, nbytes: int, n_ops: int = 1) -> float:
        """Price of re-deriving an exact value from a *covering* artifact
        (DESIGN.md §10): each compensation operator (residual FILTER,
        narrowing PROJECT) is one streaming pass over the loaded bytes at
        compute bandwidth — modelled as the load bandwidth, since both
        are memory-bound scans — plus the fixed dispatch cost.  Semantic
        reuse is credited with savings *net* of this, so a cheap-to-
        recompute sub-job never looks better covered than recomputed."""
        if n_ops <= 0:
            return 0.0
        return n_ops * (self.fixed_io_s + nbytes / max(self.load_bw, 1.0))

    # ----------------------------------------------------- plan statistics
    def observe_op(self, struct_fp: str, *, rows_out: int, bytes_out: int,
                   producer_cost_s: float, now: Optional[float] = None) -> None:
        """Record one observed execution of an operator (its sub-job was
        computed, not reused).  `bytes_out` may be an estimate; it is
        replaced by the exact artifact size via `observe_stored_bytes`."""
        st = self.op_stats.get(struct_fp)
        if st is None:
            st = self.op_stats[struct_fp] = OpStats()
        st.times_seen += 1
        st.rows_out = rows_out
        if not st.bytes_exact:
            st.bytes_out = bytes_out
        if st.producer_cost_s == 0.0:
            st.producer_cost_s = producer_cost_s
        else:
            st.producer_cost_s += self.alpha * (producer_cost_s
                                                - st.producer_cost_s)
        st.last_seen = now if now is not None else time.time()

    def observe_stored_bytes(self, struct_fp: str, nbytes: int) -> None:
        st = self.op_stats.get(struct_fp)
        if st is not None:
            st.bytes_out = nbytes
            st.bytes_exact = True

    def stats_for(self, struct_fp: str) -> Optional[OpStats]:
        return self.op_stats.get(struct_fp)

    # -------------------------------------------------------------- decide
    def savings_per_reuse_s(self, producer_cost_s: float,
                            nbytes: int) -> float:
        return producer_cost_s - self.load_cost_s(nbytes)

    def splice_benefit_s(self, bytes_in: int, bytes_out: int) -> float:
        """Predicted benefit of answering a *streaming* matched region
        from its artifact: such a region re-derives its value in one
        pass over bytes the query loads anyway, so the only real saving
        is the byte diet — reading the (smaller) artifact instead of
        the (larger) region inputs."""
        return self.load_cost_s(bytes_in) - self.load_cost_s(bytes_out)

    @_agreed
    def should_splice(self, entry) -> bool:
        """Exact-splice admission (the L7 guard): decline splices whose
        predicted benefit cannot clear the splice overhead
        ``min_splice_benefit_s`` (re-trace of the rewritten plan plus
        an artifact read where the input may sit in the page cache —
        the measured L7 0.6x regression).  Scope is deliberately
        narrow: only regions made entirely of streaming operators — a
        blocking region (JOIN/GROUPBY/DISTINCT/COGROUP) amortizes
        super-linear recompute and always splices — and only with
        bytes evidence on the entry; absent either, the paper's
        always-reuse rule stands.  Inert at the default threshold 0.

        A known-uses hint (batch optimizer, §16) also always splices:
        the batch deliberately materialized that artifact for queries
        queued *right now*, so declining would re-execute a sub-plan
        the shared prefix just paid to store — exactly the duplicate
        execution ``dup_executions`` gates at zero."""
        if self.min_splice_benefit_s <= 0.0:
            return True
        if self.known_uses_for(getattr(entry, "artifact", None)) > 0.0:
            return True
        kinds = {op.kind for op in entry.plan.topo()}
        if not kinds <= STREAMING_KINDS:
            return True
        if entry.bytes_in <= 0 or entry.bytes_out <= 0:
            return True
        return (self.splice_benefit_s(entry.bytes_in, entry.bytes_out)
                >= self.min_splice_benefit_s)

    def expected_future_uses(self, past_uses: float, ref_time: float,
                             now: Optional[float] = None) -> float:
        now = now if now is not None else time.time()
        decay = 0.5 ** (max(now - ref_time, 0.0) / self.halflife_s)
        return min(self.max_expected_uses,
                   (past_uses + self.prior_uses) * decay)

    # ---------------------------------------------- known-uses hints (§16)

    def set_known_uses(self, hints: Dict[str, float]) -> None:
        """Install batch-optimizer hints: key (structural fingerprint or
        artifact name) -> queries known to consume it.  Max-merged so
        overlapping batches never lower an existing hint."""
        for k, v in hints.items():
            self.known_uses[k] = max(self.known_uses.get(k, 0.0), float(v))

    def clear_known_uses(self, keys=None) -> None:
        """Drop hints when their batch retires (all, or just ``keys``)."""
        if keys is None:
            self.known_uses.clear()
        else:
            for k in keys:
                self.known_uses.pop(k, None)

    def known_uses_for(self, *keys: Optional[str]) -> float:
        """Max hint across any of the given keys (0.0 when unhinted)."""
        return max((self.known_uses.get(k, 0.0) for k in keys if k),
                   default=0.0)

    @_agreed
    def should_materialize(self, struct_fp: str,
                           now: Optional[float] = None,
                           artifact: Optional[str] = None) -> bool:
        """Sub-job admission: materialize only when the predicted benefit
        (savings × expected reuses) exceeds the store cost.  Operators
        never observed before are NOT materialized — the first execution
        collects their statistics, the second pays the store only if
        history says it recurs and saves time.  Exception: a known-uses
        hint (batch optimizer, §16) is a fact, not an estimate — a
        hinted sub-job is admitted on first sight because consumers are
        already queued behind it."""
        hint = self.known_uses_for(struct_fp, artifact)
        st = self.op_stats.get(struct_fp)
        if st is None or st.times_seen < 1:
            return hint > 0.0
        savings = self.savings_per_reuse_s(st.producer_cost_s, st.bytes_out)
        if savings <= 0.0:
            return False
        uses = max(self.expected_future_uses(st.times_seen, st.last_seen,
                                             now), hint)
        return savings * uses > self.store_cost_s(st.bytes_out)

    def refresh_cost_s(self, entry, delta_fraction: float) -> float:
        """Predicted cost of delta-refreshing a stale entry (DESIGN.md
        §12): the delta job re-runs the producer over the delta fraction
        of its input, plus one load and one store of the artifact for
        the merge."""
        cost = entry.producer_cost_s or entry.exec_time_s
        return (max(delta_fraction, 0.0) * cost
                + self.load_cost_s(entry.bytes_out)
                + self.store_cost_s(entry.bytes_out))

    @_agreed
    def refresh_decision(self, entry, delta_fraction: float,
                         now: Optional[float] = None,
                         eager_uses: float = 1.0) -> str:
        """Arbitrate refresh-vs-delete-vs-lazy for an append-stale entry
        (DESIGN.md §12):

          * ``"delete"`` — refreshing is not worth it: the delta is so
            large that the refresh costs as much as recomputing on
            demand would, or the entry's predicted future reuse value
            (savings × recency-decayed expected uses) is below the
            refresh cost;
          * ``"refresh"`` — hot entry (expected uses ≥ ``eager_uses``):
            pay the delta job now so the next probe is an exact hit;
          * ``"lazy"`` — worth keeping but not hot: defer the delta job
            until a probe actually demands the refreshed value."""
        rcost = self.refresh_cost_s(entry, delta_fraction)
        recompute = entry.producer_cost_s or entry.exec_time_s
        if rcost >= recompute:
            return "delete"
        if self.entry_benefit_s(entry, now) <= rcost:
            return "delete"
        past = entry.use_count + getattr(entry, "history_uses", 0.0)
        uses = self.expected_future_uses(
            past, entry.last_used or entry.created_at, now)
        return "refresh" if uses >= eager_uses else "lazy"

    def entry_benefit_s(self, entry, now: Optional[float] = None) -> float:
        """Predicted total future time saved by keeping a repository
        entry: savings per reuse times recency-decayed expected uses.
        Past evidence is actual reuse hits plus the executions observed
        before materialization (`history_uses`) — both predict future
        demand, and without the latter a fresh entry for a known-hot
        operator would rank below every incumbent and thrash."""
        cost = entry.producer_cost_s or entry.exec_time_s
        savings = max(self.savings_per_reuse_s(cost, entry.bytes_out), 0.0)
        ref = entry.last_used or entry.created_at
        past = entry.use_count + getattr(entry, "history_uses", 0.0)
        return savings * self.expected_future_uses(past, ref, now)

    def benefit_per_byte(self, entry, now: Optional[float] = None) -> float:
        """Eviction rank: entries are kept greedily by benefit density,
        the classic approximation to the 0/1 knapsack a byte-budgeted
        repository actually solves."""
        return self.entry_benefit_s(entry, now) / max(entry.bytes_out, 1)
