"""Checked wrapper of the join-probe kernel.

The tensor's device chooses the implementation: a CUDA tensor launches
``csrc/join_probe.cu``, a CPU tensor takes the plain version in
``ref.py``.  There is no fallback from the kernel to the plain version.
"""
import torch

from ..build import LaunchCounter, check, library, stream_ptr
from .ref import join_probe_ref

launches = LaunchCounter("join_probe")
# the pre-pass that writes the directory and the uint32 keys: one launch
# before every probe launch, counted beside it
directory_launches = LaunchCounter("join_probe_directory")

# Directory bits: 2**b buckets of the 32-bit hash space, b chosen by
# measurement (PERF.md).  The search's time goes to reads of the uint32
# build keys.  Up to L1_KEYS keys (a 256 KB copy) L1 holds most of them
# beside a small directory, so b stops at B_L1 (16 KB); a larger build
# side misses L1 anyway, and there a larger directory (up to B_MAX, 128
# KB) shortens the search.
B_L1, B_MAX = 12, 15
L1_KEYS = 1 << 16


def probe_bits(r: int) -> int:
    """Directory bits for a build side of r keys: buckets of 2-4 keys on
    average (2**(b+1) <= r < 2**(b+2)), at least 1 and at most B_L1 (up to
    L1_KEYS keys) or B_MAX."""
    cap = B_L1 if r <= L1_KEYS else B_MAX
    return max(1, min(cap, r.bit_length() - 2))


def probe(left_hashes, right_hashes_sorted):
    """left_hashes: (N,) int64 uint32 lanes; right_hashes_sorted: (R,)
    int64 uint32 lanes, ascending.  Returns (N,) int32 positions =
    searchsorted(right, left, side='left')."""
    if not left_hashes.is_cuda:
        return join_probe_ref(left_hashes, right_hashes_sorted)
    for name, t in (("left", left_hashes), ("right", right_hashes_sorted)):
        if t.dtype != torch.int64 or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"probe: {name} hashes must be contiguous "
                             "(N,) int64")
    if right_hashes_sorted.device != left_hashes.device:
        raise ValueError("probe: left and right hashes on two devices")
    if right_hashes_sorted.shape[0] >= 2**31 - 16:
        raise ValueError("probe: build side must fit in int32")
    return _launch(left_hashes, right_hashes_sorted,
                   probe_bits(right_hashes_sorted.shape[0]))


def _launch(left, right, bits):
    """The kernel with a given directory size (``bench.py`` sweeps it)."""
    lib = library()
    dev = left.device
    n, r = left.shape[0], right.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    # scratch: the uint32 keys (the last window read may pass r by 11)
    # and the directory
    keys = torch.empty(r + 12, dtype=torch.int32, device=dev)
    dir_ = torch.empty((1 << bits) + 1, dtype=torch.int32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        rc = lib.restore_join_probe(
            left.data_ptr(), right.data_ptr(), pos.data_ptr(), n, r, bits,
            keys.data_ptr(), dir_.data_ptr(), n_sm, stream_ptr(dev))
    check(rc, "join_probe")
    if n > 0:            # an empty probe side launches nothing
        directory_launches.add()
        launches.add()
    return pos
