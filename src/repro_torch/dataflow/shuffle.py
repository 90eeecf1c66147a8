"""Distributed shuffle for the relational engine: the MapReduce
map->shuffle->reduce stage over a ``launch.mesh.LocalMesh`` or a
``GroupMesh`` (DESIGN.md §11), the port of the reference's ``shard_map``
programs.

A sharded Table is laid out in ``n_shards`` contiguous row blocks: all of
them in one process on a ``LocalMesh``, this rank's one on a
``GroupMesh`` (``mesh.local_shards(axis)`` counts the blocks a process
holds).  The exchange runs in three steps:

  map side   : ONE launch of the ``partition_scatter`` kernel
               (``kernels/radix_partition``) gives every row of every
               shard its destination shard AND its slot in a bounded
               per-destination bucket — binning + arrival rank, no sort;
               skew overflows are counted.  The seed-0 key hash that
               routes the row is shipped with it;
  shuffle    : all columns + validity + the shipped hash lane are
               byte-packed into one buffer; on a ``LocalMesh`` ONE
               ``mesh.all_to_all`` permutes the (src, dst, bucket) gather
               index, and ONE gather moves the rows into (dst, src,
               bucket) order; on a ``GroupMesh`` the rows are gathered
               into (dst, bucket) order and ONE ``all_to_all`` sends each
               destination its packed bucket, so every row crosses to
               the rank that reduces it;
  reduce side: rows for the same key are now co-located — the shard
               body (hash-segmented or sort-based reduce, or the join
               probe) runs once per shard, seeded with the shipped hash
               lanes instead of re-hashing.

Every blocking operator (GROUPBY / DISTINCT / JOIN / COGROUP) has a
distributed form here, and every one has a **shuffle-free** variant:
when the input is already hash-partitioned on compatible keys across the
same shard count (a co-partitioned repository artifact, or the output of
an upstream exchange), the map+all_to_all steps are skipped and only the
per-shard reduce runs.

Losslessness: the per-destination bucket is ``min(cap_loc, max(8,
cap_loc * skew_factor / n_shards))`` rows, so ``skew_factor >= n_shards``
makes the exchange lossless; smaller factors trade memory for a counted
overflow, exactly like the join probe window.
"""
from __future__ import annotations

import torch

from ..kernels.radix_partition.ops import scatter_slots
from .physical import (_cogroup_prepare, _cogroup_rename, op_distinct,
                       op_distinct_hashed, op_groupby, op_groupby_hashed,
                       op_join)
from .table import (Table, key_hash, pack_rows, pad_capacity,
                    partition_finalize, unpack_rows)


def _bucket_size(cap_loc: int, n_shards: int, skew_factor: float) -> int:
    return min(cap_loc, max(8, int(cap_loc * skew_factor / n_shards)))


def _zero(table: Table) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=table.device)


def _exchange(table: Table, keys, mesh, bucket: int, axis: str):
    """Fused map-side exchange of every shard at once (DESIGN.md §14).

    ``table`` holds this process's ``n_loc`` row blocks of ``cap_loc``
    rows (``n_loc`` is ``n_shards`` on a ``LocalMesh``, 1 on a
    ``GroupMesh``).  One ``scatter_slots`` call ranks them (one segment
    each); every (src, dst, bucket) slot gets the local row bound for it,
    or an appended zero row, which unpacks to valid=False.  On a
    ``LocalMesh`` the gather index goes through one ``all_to_all`` and
    the packed rows are gathered by it; on a ``GroupMesh`` the packed
    rows are gathered and go through one ``all_to_all``.  Returns
    (received Table of capacity ``n_loc * n_shards * bucket``, whose
    shard ``d`` holds the ``n_shards * bucket`` rows bound for ``d`` in
    (src, bucket) order; the shipped seed-0 key-hash lane, row-aligned
    with it; the global overflow count)."""
    n_shards = int(mesh.shape[axis])
    n_loc = mesh.local_shards(axis)
    cap_loc = table.capacity // n_loc
    dev = table.device
    h1 = key_hash(table, keys, seed=0)
    slot, overflow = scatter_slots(
        partition_finalize(h1).reshape(n_loc, cap_loc),
        table.valid.reshape(n_loc, cap_loc), n_parts=n_shards,
        bucket=bucket)
    overflow = mesh.psum(overflow)

    cols = dict(table.columns)
    cols["__h1__"] = h1
    packed, layout = pack_rows(cols, table.valid)
    n, row_bytes = packed.shape
    # invert the slot map per shard: inv[s, j] = the local row bound for
    # slot j of shard s.  The drop slot n_shards * bucket gets one extra
    # entry (many writers, sliced off), so no index falls out of range
    width = n_shards * bucket
    inv = torch.full((n_loc, width + 1), cap_loc, dtype=torch.int64,
                     device=dev)
    local = torch.arange(cap_loc, device=dev).expand(n_loc, cap_loc)
    inv.scatter_(1, slot.long(), local)
    inv = inv[:, :width]
    # row of each slot in this process's packed rows; the zero row
    # appended at index n for the slots nothing hit
    base = (torch.arange(n_loc, device=dev) * cap_loc)[:, None]
    src_row = torch.where(inv == cap_loc, torch.full_like(inv, n),
                          inv + base)
    src = torch.cat([packed, packed.new_zeros((1, row_bytes))])
    if mesh.spans_processes:
        # the rows cross processes: each destination's bucket of packed
        # rows, h1 carrier included, goes to it as bytes
        send = src.index_select(0, src_row.reshape(-1))
        recv = mesh.all_to_all(send.view(1, n_shards, bucket * row_bytes))
        recv = recv.view(n_shards * bucket, row_bytes)
    else:
        # the all_to_all permutes the (src, dst, bucket) gather index,
        # not the packed rows: on one device the rows then move once,
        # straight into (dst, src, bucket) order
        src_row = mesh.all_to_all(src_row.reshape(n_shards, n_shards,
                                                  bucket))
        recv = src.index_select(0, src_row.reshape(-1))
    rcols, rvalid = unpack_rows(recv, layout)
    lane = rcols.pop("__h1__")
    return Table(rcols, rvalid), lane, overflow


def distributed_groupby(table: Table, keys, aggs, mesh,
                        axis: str = "data", skew_factor: float = 4.0,
                        co_partitioned: bool = False,
                        lossless: bool = False,
                        pre_lane=None):
    """GROUPBY over a row-sharded Table.  Returns (result table sharded
    over ``axis`` — each shard holds the groups of its hash range — and
    the global overflow count).  With ``co_partitioned`` the input is
    already hash-partitioned on (a subset of) ``keys`` across the shards
    and the exchange is skipped (DESIGN.md §11).

    The per-shard reduce is the sort-free hash-segmented groupby; its
    h1-collision count folds into the overflow so the engine's lossless
    retry covers both loss modes.  ``lossless`` selects the sort-based
    reduce (collision-proof) — the retry path.

    ``pre_lane`` optionally carries a row-aligned seed-0 ``key_hash``
    lane for ``keys`` (an upstream join's shipped hash, see
    ``distributed_join(return_pre=True)``); it seeds the reduce in the
    exchange-skipped path.  Ignored unless ``co_partitioned``."""
    n_shards = int(mesh.shape[axis])
    n_loc = mesh.local_shards(axis)
    if co_partitioned:
        recv, lane, overflow = table, pre_lane, _zero(table)
    else:
        table = pad_capacity(table, n_loc)
        bucket = _bucket_size(table.capacity // n_loc, n_shards,
                              skew_factor)
        recv, lane, overflow = _exchange(table, keys, mesh, bucket, axis)

    def body(local, h1):
        if lossless:
            return op_groupby(local, keys, aggs, h1=h1), _zero(local)
        return op_groupby_hashed(local, keys, aggs, h1=h1)

    grouped, coll = mesh.shard_map(body, recv, lane)
    return grouped, overflow + mesh.psum(coll)


def distributed_distinct(table: Table, mesh, axis: str = "data",
                         skew_factor: float = 4.0,
                         co_partitioned: bool = False,
                         lossless: bool = False):
    """DISTINCT over a row-sharded Table: exchange on all columns (equal
    rows co-locate), then the local hash-segmented (or, ``lossless``,
    sort-based) distinct per shard."""
    n_shards = int(mesh.shape[axis])
    n_loc = mesh.local_shards(axis)
    if co_partitioned:
        recv, lane, overflow = table, None, _zero(table)
    else:
        table = pad_capacity(table, n_loc)
        bucket = _bucket_size(table.capacity // n_loc, n_shards,
                              skew_factor)
        recv, lane, overflow = _exchange(table, table.names, mesh, bucket,
                                         axis)

    def body(local, h1):
        if lossless:
            return op_distinct(local, h1=h1), _zero(local)
        return op_distinct_hashed(local, h1=h1)

    uniq, coll = mesh.shard_map(body, recv, lane)
    return uniq, overflow + mesh.psum(coll)


def distributed_join(left: Table, right: Table, lkeys, rkeys, mesh,
                     axis: str = "data", expansion: int = 1,
                     skew_factor: float = 4.0,
                     co_left: bool = False, co_right: bool = False,
                     return_pre: bool = False):
    """Inner equi-join: both sides are hash-exchanged on their keys with
    POSITIONALLY aligned partition hashes (matching key values land on
    the same shard), then the local sort+probe join runs per shard.
    Either side skips its exchange when already aligned-partitioned.
    Returns (table, exchange overflow, probe-window overflow) — the two
    loss modes are audited separately (JobStats.shuffle_overflow vs
    join_overflow).

    With ``return_pre=True`` the result tuple gains a second element:
    the left exchange's shipped h1 lane repeated onto the join output's
    row layout (output row ``i*expansion+k`` is left row ``i``), or None
    when the left exchange was skipped (DESIGN.md §14)."""
    n_shards = int(mesh.shape[axis])
    n_loc = mesh.local_shards(axis)
    if co_left:
        lrecv, lpre, lovf = left, None, _zero(left)
    else:
        left = pad_capacity(left, n_loc)
        lbucket = _bucket_size(left.capacity // n_loc, n_shards,
                               skew_factor)
        lrecv, lpre, lovf = _exchange(left, lkeys, mesh, lbucket, axis)
    if co_right:
        rrecv, rpre, rovf = right, None, _zero(right)
    else:
        right = pad_capacity(right, n_loc)
        rbucket = _bucket_size(right.capacity // n_loc, n_shards,
                               skew_factor)
        rrecv, rpre, rovf = _exchange(right, rkeys, mesh, rbucket, axis)

    def body(lloc, rloc, lh1, rh1):
        return op_join(lloc, rloc, lkeys, rkeys, expansion,
                       h1_left=lh1, h1_right=rh1)

    joined, jovf = mesh.shard_map(body, lrecv, rrecv, lpre, rpre)
    shuffle_ovf, join_ovf = lovf + rovf, mesh.psum(jovf)
    if not return_pre:
        return joined, shuffle_ovf, join_ovf
    lane = None
    if lpre is not None:
        lane = torch.repeat_interleave(lpre, expansion, 0)
    return joined, lane, shuffle_ovf, join_ovf


def distributed_cogroup(a: Table, b: Table, keys_l, keys_r,
                        aggs_l, aggs_r, mesh, axis: str = "data",
                        skew_factor: float = 4.0,
                        co_partitioned: bool = False,
                        lossless: bool = False):
    """COGROUP: both inputs are aligned onto the shared (k0..kn, va_*,
    vb_*) schema on the map side, exchanged on the unified keys, then
    unioned + grouped locally per shard.  The union happens INSIDE the
    shard body: concatenating the global tables first would interleave
    the two inputs' partition blocks and break co-location."""
    n_shards = int(mesh.shape[axis])
    n_loc = mesh.local_shards(axis)
    ta, tb, keys, aggs = _cogroup_prepare(a, b, keys_l, keys_r,
                                          aggs_l, aggs_r)
    if co_partitioned:
        arecv, brecv, apre, bpre = ta, tb, None, None
        overflow = _zero(ta)
    else:
        ta = pad_capacity(ta, n_loc)
        tb = pad_capacity(tb, n_loc)
        abucket = _bucket_size(ta.capacity // n_loc, n_shards,
                               skew_factor)
        bbucket = _bucket_size(tb.capacity // n_loc, n_shards,
                               skew_factor)
        arecv, apre, aovf = _exchange(ta, keys, mesh, abucket, axis)
        brecv, bpre, bovf = _exchange(tb, keys, mesh, bbucket, axis)
        overflow = aovf + bovf

    def body(aloc, bloc, ah1, bh1):
        cols = {n: torch.cat([aloc.col(n), bloc.col(n)])
                for n in aloc.names}
        both = Table(cols, torch.cat([aloc.valid, bloc.valid]))
        h1 = None if ah1 is None else torch.cat([ah1, bh1])
        if lossless:
            return op_groupby(both, keys, aggs, h1=h1), _zero(both)
        return op_groupby_hashed(both, keys, aggs, h1=h1)

    grouped, coll = mesh.shard_map(body, arecv, brecv, apre, bpre)
    return _cogroup_rename(grouped, keys_l), overflow + mesh.psum(coll)
