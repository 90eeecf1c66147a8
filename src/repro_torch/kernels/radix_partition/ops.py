"""Checked wrappers of the radix-partition and partition-scatter kernels.

The tensor's device chooses the implementation: a CUDA tensor launches
``csrc/radix_partition.cu``, a CPU tensor takes the plain version in
``ref.py``.  The kernels mask the ragged tail themselves; the plain
``radix_partition_ref`` is fed rows padded with invalid ones up to the
tile, as in the reference's dispatch (``kernels/radix_partition/
ops.py``).  The reference also sends a partition count that is not a
power of two to the plain version; here only a CPU tensor goes there.
There is no fallback from the kernel to the plain version: a CUDA
tensor launches the kernel or raises, and the kernels take a
power-of-two partition count only.

Hash lanes are uint32 values in the int64 carrier.
"""
import torch

from ..build import LaunchCounter, check, library, stream_ptr
from .ref import partition_scatter_ref, radix_partition_ref

partition_launches = LaunchCounter("radix_partition")
# shapes: (S, N, P, bucket) per launch
scatter_launches = LaunchCounter("partition_scatter")
MAX_PARTS = 8192          # the kernels keep P counts a warp in shared memory
SCATTER_TILE = 4096       # rows of a scatter tile: TILE in the source


def _pad_invalid(hashes, valid, tile_n):
    """Pad the row (last) dimension with invalid rows to a multiple of
    the clamped tile.  Returns (hashes, valid, original rows)."""
    n = hashes.shape[-1]
    pad = (-n) % min(tile_n, n) if n else 0
    if pad == 0:
        return hashes, valid, n
    shape = hashes.shape[:-1] + (pad,)
    return (torch.cat([hashes, hashes.new_zeros(shape)], -1),
            torch.cat([valid, valid.new_zeros(shape)], -1), n)


def _check_kernel_args(hashes, valid, n_parts, what):
    if hashes.dtype != torch.int64 or not hashes.is_contiguous():
        raise ValueError(f"{what}: hashes must be contiguous int64 lanes")
    if valid.dtype != torch.bool or valid.shape != hashes.shape \
            or not valid.is_contiguous() or valid.device != hashes.device:
        raise ValueError(f"{what}: valid must be a contiguous bool mask "
                         "shaped like hashes, on the same device")
    if n_parts < 1 or n_parts & (n_parts - 1) or n_parts > MAX_PARTS:
        raise ValueError(f"{what}: n_parts must be a power of two "
                         f"<= {MAX_PARTS}, got {n_parts}")


def partition(hashes, valid, *, n_parts: int, tile_n: int = 256):
    """hashes: (N,) int64 uint32 lanes; valid: (N,) bool; n_parts a
    power of two.  Returns (pid (N,) int32 with invalid rows =
    n_parts, hist (ceil(N / tile), n_parts) int32 of valid rows per tile
    of ``tile = min(tile_n, N)`` rows)."""
    if not hashes.is_cuda:
        h, v, n = _pad_invalid(hashes, valid, tile_n)
        pid, hist = radix_partition_ref(h, v, n_parts=n_parts,
                                        tile_n=tile_n)
        return pid[:n], hist
    _check_kernel_args(hashes, valid, n_parts, "partition")
    if hashes.ndim != 1:
        raise ValueError("partition: hashes must be (N,)")
    if tile_n < 1:
        raise ValueError(f"partition: tile_n must be >= 1, got {tile_n}")
    n = hashes.shape[0]
    if n >= 2**31:
        raise ValueError("partition: too many rows")
    tile = min(tile_n, n) if n else 1
    dev = hashes.device
    pid = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty((-(-n // tile), n_parts), dtype=torch.int32,
                       device=dev)
    if n == 0:
        return pid, hist
    lib = library()
    with torch.cuda.device(dev):
        rc = lib.restore_radix_partition(
            hashes.data_ptr(), valid.data_ptr(), pid.data_ptr(),
            hist.data_ptr(), n, tile, n_parts, stream_ptr(dev))
    check(rc, "radix_partition")
    partition_launches.add()
    return pid, hist


def scatter_slots(hashes, valid, *, n_parts: int, bucket: int):
    """Fused partition + bucket-scatter slots (DESIGN.md §14).

    hashes, valid: (N,) — or (S, N), one independent segment per mesh
    shard, all ranked in one launch.  Returns (slot int32 shaped like
    ``hashes``, ``n_parts * bucket`` being the drop slot; the count of
    valid rows that overflowed their bucket, 0-d for (N,) and (S,) for
    (S, N)).  On the card ``n_parts`` must be a power of two
    (ValueError otherwise); a CPU tensor takes the plain version at any
    count."""
    if not hashes.is_cuda:
        return partition_scatter_ref(hashes, valid, n_parts=n_parts,
                                     bucket=bucket)
    _check_kernel_args(hashes, valid, n_parts, "scatter_slots")
    if hashes.ndim not in (1, 2):
        raise ValueError("scatter_slots: hashes must be (N,) or (S, N)")
    if bucket < 1 or n_parts * bucket >= 2**31:
        raise ValueError(f"scatter_slots: n_parts * bucket must fit in "
                         f"int32 (got {n_parts} * {bucket})")
    h2 = hashes.reshape(-1, hashes.shape[-1])
    n_segs, n = h2.shape
    dev = h2.device
    slot = torch.empty(h2.shape, dtype=torch.int32, device=dev)
    if n == 0 or n_segs == 0:
        ovf = torch.zeros(n_segs, dtype=torch.int32, device=dev)
    else:
        # a status word holds a 30-bit count
        if n >= 2**30 or n_segs * n >= 2**31:
            raise ValueError("scatter_slots: too many rows")
        n_tiles = -(-n // SCATTER_TILE)
        ovf = torch.empty(n_segs, dtype=torch.int32, device=dev)
        status = torch.empty(n_segs * n_tiles * n_parts + 1,
                             dtype=torch.int32, device=dev)
        lib = library()
        with torch.cuda.device(dev):
            rc = lib.restore_partition_scatter(
                h2.data_ptr(), valid.data_ptr(), slot.data_ptr(),
                ovf.data_ptr(), status.data_ptr(), n, n_segs, n_parts,
                bucket, stream_ptr(dev))
        check(rc, "partition_scatter")
        scatter_launches.add((n_segs, n, n_parts, bucket))
    slot = slot.reshape(hashes.shape)
    return slot, (ovf[0] if hashes.ndim == 1 else ovf)
