"""Execution of physical plans over Tables, in PyTorch.

All operators are static-shape: capacities are fixed, deletion is
masking.  The blocking operators (JOIN / GROUPBY / COGROUP / DISTINCT)
are sort-based, as in the reference (DESIGN.md §7).  The two relational
hot spots run in hand-written CUDA kernels when the tables live on the
card: the GROUPBY/COGROUP aggregation (``kernels/segment_reduce``) and
the JOIN probe (``kernels/hash_join``).  The tensor's device chooses:
CPU tables take the kernels' plain PyTorch versions.

With a mesh, ``execute_plan`` runs the blocking operators through
``dataflow/shuffle.py``, whose per-shard reduces are the sort-free
``op_groupby_hashed``/``op_distinct_hashed`` below (or, on the lossless
retry, the sort-based ones), seeded with the hash lane the exchange
ships with each row.

Hash-collision handling: rows are ordered by a (h1, h2) pair of
independent uint32 hashes, but *all* equality decisions (segment
boundaries, join-match verification) compare the actual key columns, so
grouping/distinct are exact and joins are exact up to a bounded probe
window whose overflows are counted in job stats.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..core.plan import PhysicalPlan
from ..kernels.hash_join.ops import probe
from ..kernels.segment_reduce.ops import segment_sum
from .table import Table, cols_equal, hash_columns

_U32_MAX = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Sorting & segments shared by GROUPBY / DISTINCT / COGROUP


class HashCache:
    """Per-plan-execution memo of raw key-column hashes.

    GROUPBY / DISTINCT / COGROUP / JOIN all hash the same (table, keys)
    pairs.  Keyed by the identity of the column tensors (in sorted-name
    order, which is what ``hash_columns`` mixes over), so a FILTER that
    only rewrites ``valid`` still shares the hashes of its input.
    Validity masking happens at the use site."""

    def __init__(self):
        # value holds the column objects alongside the hash: the memo
        # key uses id()s, which are only stable while the tensors stay
        # referenced (a GC'd temporary's recycled id must never hit)
        self._memo: Dict[Tuple, Tuple[Tuple, torch.Tensor]] = {}

    def hashes(self, t: Table, keys, seed: int) -> torch.Tensor:
        cols = tuple(t.col(n) for n in sorted(keys))
        key = (tuple(id(c) for c in cols), seed)
        ent = self._memo.get(key)
        if ent is None:
            ent = (cols, hash_columns(t, keys, seed=seed))
            self._memo[key] = ent
        return ent[1]


def _key_hashes(t: Table, keys, seed: int,
                hc: "HashCache | None") -> torch.Tensor:
    if hc is None:
        return hash_columns(t, keys, seed=seed)
    return hc.hashes(t, keys, seed)


def _masked(valid: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, h, torch.full_like(h, _U32_MAX))


def _sort_by_keys(t: Table, keys,
                  hc: "HashCache | None" = None,
                  h1=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (order, new_seg): stable order by (h1, h2) with invalid
    rows last, and the exact segment-start mask in sorted order.  The
    reference's lexsort is two stable sorts: by h2, then by h1.
    ``h1`` is an optional UNMASKED seed-0 key-hash lane computed
    upstream — the lane a mesh exchange ships with each row (DESIGN.md
    §14; the reference's ``pre``) — in place of re-hashing the key
    columns.  Validity masking still happens here, so zero-filled rows
    from unhit exchange slots are parked with the invalid rows."""
    if h1 is None:
        h1 = _key_hashes(t, keys, 0, hc)
    h1 = _masked(t.valid, h1)
    h2 = _masked(t.valid, _key_hashes(t, keys, 101, hc))
    by_h2 = torch.sort(h2, stable=True).indices
    order = by_h2[torch.sort(h1[by_h2], stable=True).indices]
    sv = t.valid[order]
    prev = torch.roll(order, 1)
    same_as_prev = cols_equal(t, order, t, prev, keys)
    same_as_prev = same_as_prev & t.valid[prev]
    same_as_prev[0] = False
    new_seg = sv & ~same_as_prev
    return order, new_seg


def _segment_aggregate(t: Table, keys, aggs, order, new_seg) -> Table:
    cap = t.capacity
    dev = t.device
    sv = t.valid[order]
    seg_id = torch.cumsum(new_seg.to(torch.int32), 0,
                          dtype=torch.int32) - 1
    last = torch.full_like(seg_id, cap - 1)
    seg_id = torch.where(sv, seg_id, last)  # park invalid in last bucket
    n_seg = new_seg.sum(dtype=torch.int32)
    out_valid = torch.arange(cap, device=dev) < n_seg

    # representative row per segment (for key columns).  Non-head rows
    # all write slot cap-1, whose winner is arbitrary on the card; that
    # slot is a real segment only when every row heads one (no
    # duplicates then), and out_valid masks it otherwise.
    rep = torch.zeros(cap, dtype=torch.int32, device=dev)
    rep[torch.where(new_seg, seg_id, last).long()] = order.to(torch.int32)

    cols: Dict[str, torch.Tensor] = {}
    for k in keys:
        kc = t.col(k).index_select(0, rep.long())
        mask = out_valid.reshape((-1,) + (1,) * (kc.ndim - 1))
        cols[k] = torch.where(mask, kc, torch.zeros_like(kc))

    # the count lane and every sum/mean lane ride ONE (cap, k) segment
    # sum: each column adds in the same order as a lane of its own
    lanes: List[torch.Tensor] = [sv.to(torch.float32)]
    lane_of: Dict[str, int] = {}
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for out_name, (fn, cname) in aggs.items():
        if fn in ("sum", "mean"):
            v = t.col(cname).index_select(0, order).to(torch.float32)
            lane_of[out_name] = len(lanes)
            lanes.append(torch.where(sv, v, zero))
    summed = segment_sum(torch.stack(lanes, 1), seg_id, num_segments=cap)
    counts = summed[:, 0]

    for out_name, (fn, cname) in aggs.items():
        if fn == "count":
            cols[out_name] = counts.clone()
            continue
        if fn in ("sum", "mean"):
            s = summed[:, lane_of[out_name]]
            cols[out_name] = s if fn == "sum" else \
                s / torch.clamp(counts, min=1.0)
        elif fn in ("min", "max"):
            v = t.col(cname).index_select(0, order).to(torch.float32)
            fill = float("inf") if fn == "min" else float("-inf")
            v = torch.where(sv, v, torch.full_like(v, fill))
            init = torch.full((cap,), fill, dtype=torch.float32, device=dev)
            cols[out_name] = init.scatter_reduce(
                0, seg_id.long(), v, "amin" if fn == "min" else "amax",
                include_self=True)
        else:
            raise ValueError(f"unknown aggregate {fn}")
        cols[out_name] = torch.where(out_valid, cols[out_name], zero)
    return Table(cols, out_valid)


# ---------------------------------------------------------------------------
# Sort-free hash-segmented reduce (mesh path, DESIGN.md §14)
#
# The distributed reduce needs no row ORDER, only segment ids: sort the
# h1 VALUES, then each row's segment is the first sorted position of its
# hash.  Exactness: every row's key columns are verified against its
# segment representative; any mismatch (two distinct keys sharing an h1)
# is COUNTED, and the engine reruns the job on the lossless sort-based
# path.  Within a group all rows share (h1, h2), so the sort path keeps
# them in row-index order — the order the scatter-add below visits them
# on the CPU; group representatives are the minimum-index row on both
# paths.  On the card the scatter-add's float atomics add in a
# run-dependent order: integer-valued lanes stay exact, float sums agree
# within the parity contract's tolerance.


def _hash_segments(t: Table, keys, h1u):
    """Return (pos, out_valid, rep, collisions): per-row segment id (the
    first sorted position of the row's masked h1, invalid rows parked at
    cap-1), validity of each output slot, the minimum-index
    representative row per segment, and the count of valid rows whose
    keys mismatch their representative (h1 collisions)."""
    cap = t.capacity
    dev = t.device
    # the carrier keeps the uint32 order only over 32-bit lanes
    h1m = _masked(t.valid, h1u & _U32_MAX)
    s = torch.sort(h1m).values
    pos = torch.searchsorted(s, h1m, side="left").to(torch.int32)
    # invalid rows park at cap-1; a valid row's first-occurrence
    # position is always < n_valid <= cap-1 when any invalid row exists
    pos = torch.where(t.valid, pos, torch.full_like(pos, cap - 1))
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    n_valid = t.valid.sum(dtype=torch.int32)
    new = torch.ones(cap, dtype=torch.bool, device=dev)
    new[1:] = s[1:] != s[:-1]
    out_valid = new & (iota < n_valid)
    rows = torch.where(t.valid, iota, torch.full_like(iota, cap))
    rep = torch.full((cap,), cap, dtype=torch.int32, device=dev)
    rep = rep.scatter_reduce(0, pos.long(), rows, "amin", include_self=True)
    rep = rep.clamp(0, cap - 1)
    eq = cols_equal(t, iota, t, rep[pos.long()], keys)
    collisions = (t.valid & ~eq).sum(dtype=torch.int32)
    return pos, out_valid, rep, collisions


def op_groupby_hashed(t: Table, keys, aggs, hc: "HashCache | None" = None,
                      h1=None) -> Tuple[Table, torch.Tensor]:
    """Sort-free GROUPBY for the distributed reduce (``h1`` as in
    ``_sort_by_keys``).  Returns (table, collision count); a nonzero
    count means the result dropped/merged groups and the caller must
    fall back to the sort-based path."""
    if h1 is None:
        h1 = _key_hashes(t, keys, 0, hc)
    pos, out_valid, rep, collisions = _hash_segments(t, keys, h1)
    cap = t.capacity
    dev = t.device
    sv = t.valid
    idx = pos.long()

    cols: Dict[str, torch.Tensor] = {}
    for k in keys:
        kc = t.col(k).index_select(0, rep.long())
        mask = out_valid.reshape((-1,) + (1,) * (kc.ndim - 1))
        cols[k] = torch.where(mask, kc, torch.zeros_like(kc))

    # one (N, k) scatter-add covers the count lane and every sum/mean
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lanes: List[torch.Tensor] = []
    lane_of: Dict = {}
    if any(fn in ("count", "mean") for fn, _ in aggs.values()):
        lane_of[None] = len(lanes)
        lanes.append(sv.to(torch.float32))
    for out_name, (fn, cname) in aggs.items():
        if fn in ("sum", "mean"):
            lane_of[out_name] = len(lanes)
            lanes.append(torch.where(sv, t.col(cname).to(torch.float32),
                                     zero))
    if lanes:
        summed = torch.zeros((cap, len(lanes)), dtype=torch.float32,
                             device=dev)
        summed.index_add_(0, idx, torch.stack(lanes, 1))

    for out_name, (fn, cname) in aggs.items():
        if fn == "count":
            cols[out_name] = summed[:, lane_of[None]].clone()
            continue
        if fn in ("sum", "mean"):
            s = summed[:, lane_of[out_name]]
            cols[out_name] = s if fn == "sum" else \
                s / torch.clamp(summed[:, lane_of[None]], min=1.0)
        elif fn in ("min", "max"):
            fill = float("inf") if fn == "min" else float("-inf")
            v = torch.where(sv, t.col(cname).to(torch.float32),
                            torch.full((), fill, device=dev))
            init = torch.full((cap,), fill, dtype=torch.float32, device=dev)
            cols[out_name] = init.scatter_reduce(
                0, idx, v, "amin" if fn == "min" else "amax",
                include_self=True)
        else:
            raise ValueError(f"unknown aggregate {fn}")
        cols[out_name] = torch.where(out_valid, cols[out_name], zero)
    return Table(cols, out_valid), collisions


def op_distinct_hashed(t: Table, hc: "HashCache | None" = None,
                       h1=None) -> Tuple[Table, torch.Tensor]:
    """Sort-free DISTINCT: keep each segment's minimum-index row in
    place (no reorder).  Returns (table, collision count)."""
    keys = t.names
    if h1 is None:
        h1 = _key_hashes(t, keys, 0, hc)
    pos, _out_valid, rep, collisions = _hash_segments(t, keys, h1)
    iota = torch.arange(t.capacity, dtype=torch.int32, device=t.device)
    keep = t.valid & (rep[pos.long()] == iota)
    return t.with_valid(keep), collisions


# ---------------------------------------------------------------------------
# Operator implementations


def op_filter(t: Table, pred) -> Table:
    p = pred.eval(t)
    return t.with_valid(t.valid & p.to(torch.bool))


def op_project(t: Table, cols) -> Table:
    return t.select(cols)


def op_foreach(t: Table, gens) -> Table:
    out = {}
    for name, e in gens.items():
        v = e.eval(t)
        if v.ndim == 0:
            v = v.expand((t.capacity,)).contiguous()
        out[name] = v
    return Table(out, t.valid)


def op_groupby(t: Table, keys, aggs, hc: "HashCache | None" = None,
               h1=None) -> Table:
    order, new_seg = _sort_by_keys(t, keys, hc, h1=h1)
    return _segment_aggregate(t, keys, aggs, order, new_seg)


def op_distinct(t: Table, hc: "HashCache | None" = None,
                h1=None) -> Table:
    keys = t.names
    order, new_seg = _sort_by_keys(t, keys, hc, h1=h1)
    return t.gather(order, new_seg)


def op_union(a: Table, b: Table) -> Table:
    names = a.names
    assert set(names) == set(b.columns), "UNION schema mismatch"
    cols = {n: torch.cat([a.col(n), b.col(n)], 0) for n in names}
    return Table(cols, torch.cat([a.valid, b.valid]))


def op_join(left: Table, right: Table, lkeys, rkeys,
            expansion: int = 1,
            hc: "HashCache | None" = None,
            h1_left=None, h1_right=None) -> Tuple[Table, torch.Tensor]:
    """Inner equi-join, sort+probe based.  Output capacity =
    left.capacity * expansion.  ``h1_left``/``h1_right`` optionally
    carry each side's exchange-shipped probe-hash lane in place of
    re-hashing the key columns (DESIGN.md §14; the reference's
    ``pre_left``/``pre_right``); every match is still verified against
    the key columns, and validity masks every decision, so shipped
    hashes change nothing observable.
    Returns (table, overflow_count)."""
    from ..kernels import autotune
    # window slack absorbs h1 ties among distinct right keys; every
    # exhausted window is counted in the returned overflow
    probe_w = expansion + autotune.choose("join_probe", left.capacity,
                                          "uint32", "slack", 4)
    cap_r = right.capacity
    dev = left.device

    if h1_right is None:
        h1_right = _key_hashes(right, rkeys, 0, hc)
    h_r = _masked(right.valid, h1_right)
    h_r_sorted, r_order = torch.sort(h_r, stable=True)

    h_l = h1_left if h1_left is not None \
        else _key_hashes(left, lkeys, 0, hc)
    pos = probe(h_l, h_r_sorted).long()
    win = torch.arange(probe_w, device=dev)
    cand = (pos[:, None] + win[None, :]).clamp(0, cap_r - 1)
    cand_rows = r_order[cand]                     # (Cl, W) right row ids
    hash_ok = h_r_sorted[cand] == h_l[:, None]

    # exact key verification
    eq = torch.ones(cand_rows.shape, dtype=torch.bool, device=dev)
    for lk, rk in zip(lkeys, rkeys):
        lc = left.col(lk)
        rc = right.col(rk)[cand_rows]
        e = lc[:, None] == rc if lc.ndim == 1 else \
            (lc[:, None, :] == rc).all(dim=-1)
        eq = eq & e
    ok = hash_ok & eq & right.valid[cand_rows] & left.valid[:, None]

    # rank of each verified match within its window.  The window is a
    # handful of slots, so a running sum over its columns replaces
    # cumsum(ok, 1): torch's innermost-dimension scan over an (N, W)
    # matrix takes ~100 ms at N = 2**24 on an H100
    rank = torch.empty(ok.shape, dtype=torch.int32, device=dev)
    running = torch.full((ok.shape[0],), -1, dtype=torch.int32, device=dev)
    for j in range(probe_w):
        running = running + ok[:, j]
        rank[:, j] = running
    # overflow: window exhausted while hashes were still equal; only a
    # tail INSIDE the array can witness that
    in_range = pos + probe_w <= cap_r - 1
    tail = (pos + probe_w).clamp(0, cap_r - 1)
    overflow = ((h_r_sorted[tail] == h_l) & in_range
                & left.valid).sum(dtype=torch.int32)

    out_cols: Dict[str, torch.Tensor] = {}
    matched_list: List[torch.Tensor] = []
    ridx_list: List[torch.Tensor] = []
    for j in range(expansion):
        sel = ok & (rank == j)
        matched_list.append(sel.any(dim=1))
        # per-row gather of the selected window slot (torch.argmax
        # refuses bool; on ints it returns the first maximum)
        slot = torch.argmax(sel.to(torch.int32), dim=1)[:, None]
        ridx_list.append(torch.take_along_dim(cand_rows, slot, 1)[:, 0])
    matched = torch.stack(matched_list, 1).reshape(-1)      # (Cl*exp,)
    ridx = torch.stack(ridx_list, 1).reshape(-1)

    for n in left.names:
        out_cols[n] = torch.repeat_interleave(left.col(n), expansion, 0)
    for n in right.names:
        name = n if n not in out_cols else n + "_r"
        out_cols[name] = right.col(n).index_select(0, ridx)
    return Table(out_cols, matched), overflow


def _cogroup_prepare(a: Table, b: Table, keys_l, keys_r, aggs_l, aggs_r):
    """Map-side alignment of both COGROUP inputs onto one shared schema
    (``k0..kn`` unified keys, ``va_*``/``vb_*`` value carriers): after
    this, COGROUP is UNION + GROUPBY (DESIGN.md §11)."""
    a_cols = {f"k{i}": a.col(k) for i, k in enumerate(keys_l)}
    b_cols = {f"k{i}": b.col(k) for i, k in enumerate(keys_r)}
    aggs = {}

    def carrier(t: Table, c, fn):
        return (t.col(c).to(torch.float32) if fn != "count"
                else torch.ones(t.capacity, dtype=torch.float32,
                                device=t.device))

    def neutral(t: Table, fn2):
        return torch.full((t.capacity,),
                          0.0 if fn2 == "sum" else float("nan"),
                          dtype=torch.float32, device=t.device)

    for out, (fn, c) in aggs_l.items():
        fn2 = "sum" if fn == "count" else fn
        a_cols[f"va_{out}"] = carrier(a, c, fn)
        b_cols[f"va_{out}"] = neutral(b, fn2)
        aggs[f"l_{out}"] = (fn2, f"va_{out}")
    for out, (fn, c) in aggs_r.items():
        fn2 = "sum" if fn == "count" else fn
        b_cols[f"vb_{out}"] = carrier(b, c, fn)
        a_cols[f"vb_{out}"] = neutral(a, fn2)
        aggs[f"r_{out}"] = (fn2, f"vb_{out}")
    keys = [f"k{i}" for i in range(len(keys_l))]
    return Table(a_cols, a.valid), Table(b_cols, b.valid), keys, aggs


def _cogroup_rename(grouped: Table, keys_l) -> Table:
    """Restore the left input's key names on the grouped result."""
    renamed = {}
    for i, k in enumerate(keys_l):
        renamed[k] = grouped.col(f"k{i}")
    for n in grouped.names:
        if not n.startswith("k"):
            renamed[n] = grouped.col(n)
    return Table(renamed, grouped.valid)


def op_cogroup(a: Table, b: Table, keys_l, keys_r, aggs_l, aggs_r,
               hc: "HashCache | None" = None) -> Table:
    """Group both inputs by key; per-key aggregates from each side."""
    ta, tb, keys, aggs = _cogroup_prepare(a, b, keys_l, keys_r,
                                          aggs_l, aggs_r)
    grouped = op_groupby(op_union(ta, tb), keys, aggs, hc)
    return _cogroup_rename(grouped, keys_l)


def op_store(t: Table) -> Table:
    # no work here: compaction to the live row count happens on the
    # store's write-behind path (DESIGN.md §3)
    return t


# ---------------------------------------------------------------------------
# Plan evaluation


def execute_plan(plan: PhysicalPlan, datasets: Dict[str, Table],
                 mesh=None, shuffle_axis: str = "data",
                 skew_factor: float = 4.0, props=None,
                 lossless: bool = False):
    """Evaluate a physical plan.  Returns (outputs, stats):
    outputs: store-name -> output Table (uncompacted; the artifact
    store compacts on its write path);
    stats: op uid -> dict of 0-d device tensors (rows_out,
    join_overflow, shuffle_overflow), left on the device for the caller
    to fetch in one copy.

    With a ``mesh`` (``launch.mesh.LocalMesh``, or a ``GroupMesh``
    whose ranks each run this on their own row blocks), the blocking
    operators
    run through the map->exchange->reduce path of ``dataflow/shuffle.py``
    across the ``shuffle_axis`` shards; ``props`` (a
    ``core.plan.PlanProps`` of the same plan object) marks which
    exchanges are skipped because the input is already co-partitioned
    (DESIGN.md §11).  ``lossless=True`` is the engine's overflow-retry
    configuration: callers pair it with ``skew_factor >= n_shards``
    (lossless buckets) and it selects the collision-proof sort-based
    reduce over the hash-segmented one."""
    values: Dict[int, Table] = {}
    outputs: Dict[str, Table] = {}
    stats: Dict[int, Dict[str, torch.Tensor]] = {}
    # table id -> (key column names, row-aligned h1 lane): shipped hash
    # lanes that survive an op (a join's left exchange) and can seed a
    # downstream co-partitioned GROUPBY's reduce (DESIGN.md §14)
    pres: Dict[int, Tuple[Tuple[str, ...], torch.Tensor]] = {}
    # (h1, h2) key hashes are computed once per (columns, seed) within
    # this plan execution and shared across GROUPBY/DISTINCT/COGROUP/JOIN
    hc = HashCache()
    if mesh is not None:
        from .shuffle import (distributed_cogroup, distributed_distinct,
                              distributed_groupby, distributed_join)
        # the row blocks of a partitioned value this process holds
        n_shards = mesh.local_shards(shuffle_axis)
    skips = props.skip if props is not None else {}

    def _skip(op, i: int, table: Table) -> bool:
        flags = skips.get(id(op), ())
        if not (i < len(flags) and flags[i]):
            return False
        if table.capacity % n_shards != 0:
            # a partitioned value is always laid out in n_shards equal
            # blocks; silently falling back to an exchange here would
            # leave downstream partitioning claims wrong — fail loud
            raise ValueError(
                f"co-partitioned input of {op.kind}#{op.uid} has capacity "
                f"{table.capacity} not divisible by {n_shards} shards")
        return True

    for op in plan.topo():
        p = op.params
        ins = [values[id(i)] for i in op.inputs]
        extra: Dict[str, torch.Tensor] = {}
        if op.kind == "LOAD":
            v = datasets[p["dataset"]]
        elif op.kind == "FILTER":
            v = op_filter(ins[0], p["pred"])
        elif op.kind == "PROJECT":
            v = op_project(ins[0], p["cols"])
        elif op.kind == "FOREACH":
            v = op_foreach(ins[0], p["gens"])
        elif op.kind == "JOIN":
            if mesh is not None:
                v, jpre, sh_ovf, ovf = distributed_join(
                    ins[0], ins[1], p["left_keys"], p["right_keys"], mesh,
                    axis=shuffle_axis, expansion=p.get("expansion", 1),
                    skew_factor=skew_factor,
                    co_left=_skip(op, 0, ins[0]),
                    co_right=_skip(op, 1, ins[1]),
                    return_pre=True)
                if jpre is not None:
                    # left-side names survive the join rename rule
                    # unchanged, so the lane keys are the left keys
                    pres[id(v)] = (tuple(p["left_keys"]), jpre)
                extra["shuffle_overflow"] = sh_ovf
            else:
                v, ovf = op_join(ins[0], ins[1], p["left_keys"],
                                 p["right_keys"], p.get("expansion", 1), hc)
            extra["join_overflow"] = ovf
        elif op.kind == "GROUPBY":
            if mesh is not None:
                entry = pres.get(id(ins[0]))
                lane = (entry[1] if entry is not None
                        and entry[0] == tuple(p["keys"]) else None)
                v, ovf = distributed_groupby(
                    ins[0], p["keys"], p["aggs"], mesh, axis=shuffle_axis,
                    skew_factor=skew_factor,
                    co_partitioned=_skip(op, 0, ins[0]),
                    lossless=lossless, pre_lane=lane)
                extra["shuffle_overflow"] = ovf
            else:
                v = op_groupby(ins[0], p["keys"], p["aggs"], hc)
        elif op.kind == "COGROUP":
            if mesh is not None:
                co = _skip(op, 0, ins[0]) and _skip(op, 1, ins[1])
                v, ovf = distributed_cogroup(
                    ins[0], ins[1], p["keys_left"], p["keys_right"],
                    p["aggs_left"], p["aggs_right"], mesh,
                    axis=shuffle_axis, skew_factor=skew_factor,
                    co_partitioned=co, lossless=lossless)
                extra["shuffle_overflow"] = ovf
            else:
                v = op_cogroup(ins[0], ins[1], p["keys_left"],
                               p["keys_right"], p["aggs_left"],
                               p["aggs_right"], hc)
        elif op.kind == "DISTINCT":
            if mesh is not None:
                v, ovf = distributed_distinct(
                    ins[0], mesh, axis=shuffle_axis,
                    skew_factor=skew_factor,
                    co_partitioned=_skip(op, 0, ins[0]),
                    lossless=lossless)
                extra["shuffle_overflow"] = ovf
            else:
                v = op_distinct(ins[0], hc)
        elif op.kind == "UNION":
            v = op_union(ins[0], ins[1])
        elif op.kind == "SPLIT":
            v = ins[0]
        elif op.kind == "STORE":
            v = op_store(ins[0])
            outputs[p["name"]] = v
        else:
            raise ValueError(op.kind)
        values[id(op)] = v
        extra["rows_out"] = v.num_valid()
        stats[op.uid] = extra
    return outputs, stats
