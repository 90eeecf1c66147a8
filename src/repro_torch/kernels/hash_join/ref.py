"""Plain PyTorch version of the join probe, and of the kernel's bucket
directory and bucket search (held against the plain version by the
tests)."""
import torch


def join_probe_ref(left_hashes, right_hashes_sorted):
    """searchsorted(right, left, side='left') as int32 positions."""
    return torch.searchsorted(right_hashes_sorted, left_hashes,
                              side="left").to(torch.int32)


def probe_directory_ref(right_hashes_sorted, bits: int):
    """The kernel's directory: dir[j] = lower_bound(right, j << (32 -
    bits)) for j in [0, 2**bits], so dir[2**bits] = R; (2**bits + 1,)
    int32."""
    edges = torch.arange((1 << bits) + 1, dtype=torch.int64,
                         device=right_hashes_sorted.device) << (32 - bits)
    return torch.searchsorted(right_hashes_sorted, edges,
                              side="left").to(torch.int32)


def probe_bucketed_ref(left_hashes, right_hashes_sorted, bits: int,
                       window: int = 8):
    """The kernel's search, step for step: each probe looks only inside
    its bucket [dir[j], dir[j + 1]), halves it while it holds more than
    ``window`` keys, then counts the keys below the probe in what is
    left.  Equals ``join_probe_ref`` for any sorted build side."""
    right = right_hashes_sorted
    d = probe_directory_ref(right, bits).long()
    j = left_hashes >> (32 - bits)
    lo, length = d[j], d[j + 1] - d[j]
    pad = torch.cat([right, right.new_full((window,), 0)])
    while bool((length > window).any()):
        big = length > window
        half = length >> 1
        lt = pad[(lo + half - 1).clamp(min=0)] < left_hashes
        lo = torch.where(big & lt, lo + half, lo)
        length = torch.where(big, torch.where(lt, length - half, half),
                             length)
    offs = torch.arange(window, device=right.device)
    idx = lo[:, None] + offs[None, :]
    inside = offs[None, :] < length[:, None]
    below = (pad[idx] < left_hashes[:, None]) & inside
    return (lo + below.sum(1)).to(torch.int32)
