"""Plain PyTorch versions of radix partitioning and the fused bucket
scatter (the reference's ``kernels/radix_partition/ref.py``).

Hash lanes are uint32 values in the int64 carrier.  Rows run along the
last dimension; ``partition_scatter_ref`` also takes (S, N) lanes, one
independent segment per mesh shard."""
import torch


def radix_partition_ref(hashes, valid, *, n_parts: int, tile_n: int = 256):
    """pid = h & (P-1) (int32, invalid rows = P) and the (n_tiles, P)
    int32 histogram of valid rows per ``tile_n``-row tile.  N must be a
    multiple of the clamped tile (``ops.partition`` pads)."""
    n = hashes.shape[0]
    tile_n = min(tile_n, n)
    n_tiles = n // tile_n if tile_n else 0
    pid = (hashes & (n_parts - 1)).to(torch.int32)
    pid = torch.where(valid, pid, torch.full_like(pid, n_parts))
    lanes = torch.arange(n_parts, dtype=torch.int32, device=pid.device)
    onehot = (pid[:, None] == lanes[None, :]).to(torch.int32)
    hist = onehot.reshape(n_tiles, tile_n, n_parts).sum(1, dtype=torch.int32)
    return pid, hist


def partition_scatter_ref(hashes, valid, *, n_parts: int, bucket: int):
    """Fused binning + bucket-slot assignment (the map side of the
    exchange, DESIGN.md §14).  For every row: destination partition
    ``h % P`` and its *arrival rank* — the count of earlier valid rows
    of its segment bound for the same destination — giving slot
    ``pid * bucket + rank``.  Invalid rows and rows whose rank reaches
    ``bucket`` get the drop slot ``P * bucket``.  Returns (slot int32
    shaped like ``hashes``, overflow int32: 0-d for (N,) lanes, (S,) for
    (S, N) lanes)."""
    if n_parts & (n_parts - 1) == 0:
        pid = hashes & (n_parts - 1)
    else:
        pid = hashes % n_parts          # the carrier is non-negative
    lanes = torch.arange(n_parts, device=pid.device)
    onehot = ((pid[..., None] == lanes) & valid[..., None]).to(torch.int64)
    incl = torch.cumsum(onehot, -2)     # inclusive running counts
    # invalid rows' onehot is zero, so their rank is garbage, but
    # ``keep`` drops them before it can matter
    rank = torch.take_along_dim(incl, pid[..., None], -1)[..., 0] - 1
    keep = valid & (rank < bucket)
    slot = torch.where(keep, pid * bucket + rank,
                       torch.full_like(rank, n_parts * bucket))
    overflow = (valid & ~keep).sum(-1, dtype=torch.int32)
    return slot.to(torch.int32), overflow


def partition_scatter_tiled_ref(hashes, valid, *, n_parts: int,
                                bucket: int, rounds: int = 16,
                                warps: int = 8):
    """``partition_scatter_ref`` computed the way
    ``csrc/radix_partition.cu::scatter_kernel`` computes it (the CPU
    tests hold the decomposition against the reference; the card's
    tile is ``rounds`` = 16 x ``warps`` = 8 x 32 rows):

    1. a segment is cut into tiles of ``warps`` chunks of ``rounds`` x 32
       consecutive rows; round j of a warp holds 32 rows, one a lane;
    2. a row's rank in its warp is its lanes below with the same
       partition in its round (the votes) plus the warp's running count
       of that partition before the round;
    3. an exclusive scan of the warps' totals per partition gives each
       warp its offset in the tile, and their sum the tile's counts;
    4. a tile's base is the exclusive prefix of the segment's earlier
       tiles' counts (the sum the look-back forms);
    5. rank = base + warp offset + rank in the warp; the overflow is
       sum over p of max(0, total_p - bucket).

    ``n_parts`` a power of two.  Returns what ``partition_scatter_ref``
    returns."""
    h2 = hashes.reshape(-1, hashes.shape[-1])
    v2 = valid.reshape(h2.shape)
    s, n = h2.shape
    tile = warps * rounds * 32
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    pid = torch.where(v2, h2 & (n_parts - 1), torch.full_like(h2, n_parts))
    pid = torch.cat([pid, pid.new_full((s, pad), n_parts)], 1)
    lanes = torch.arange(n_parts, device=pid.device)
    # (segment, tile, warp, round, lane, partition); invalid rows count
    # for no partition
    x = (pid[..., None] == lanes).to(torch.int64).reshape(
        s, n_tiles, warps, rounds, 32, n_parts)
    in_round = torch.cumsum(x, 4) - x
    per_round = x.sum(4, keepdim=True)
    in_warp = in_round + torch.cumsum(per_round, 3) - per_round
    warp_tot = x.sum((3, 4))                              # (s, T, W, P)
    warp_off = torch.cumsum(warp_tot, 2) - warp_tot
    tile_tot = warp_tot.sum(2)                            # (s, T, P)
    base = torch.cumsum(tile_tot, 1) - tile_tot
    rank = (base[:, :, None, None, None] + warp_off[:, :, :, None, None]
            + in_warp).reshape(s, n_tiles * tile, n_parts)
    ok = pid < n_parts
    rank = torch.take_along_dim(rank, pid.clamp_max(n_parts - 1)[..., None],
                                -1)[..., 0]
    keep = ok & (rank < bucket)
    slot = torch.where(keep, pid * bucket + rank,
                       torch.full_like(rank, n_parts * bucket))[:, :n]
    overflow = (tile_tot.sum(1) - bucket).clamp_min(0).sum(-1)
    return (slot.to(torch.int32).reshape(hashes.shape),
            overflow.to(torch.int32).reshape(hashes.shape[:-1]))
