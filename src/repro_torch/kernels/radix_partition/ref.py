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


def partition_scatter_ref(hashes, valid, *, n_parts: int, bucket: int,
                          tile_n: int = 256):
    """Fused binning + bucket-slot assignment (the map side of the
    exchange, DESIGN.md §14).  For every row: destination partition
    ``h % P`` and its *arrival rank* — the count of earlier valid rows
    of its segment bound for the same destination — giving slot
    ``pid * bucket + rank``.  Invalid rows and rows whose rank reaches
    ``bucket`` get the drop slot ``P * bucket``.  ``tile_n`` does not
    change the result.  Returns (slot int32 shaped like ``hashes``,
    overflow int32: 0-d for (N,) lanes, (S,) for (S, N) lanes)."""
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
