"""Checked wrapper of the join-probe kernel.

The tensor's device chooses the implementation: a CUDA tensor launches
``csrc/join_probe.cu``, a CPU tensor takes the plain version in
``ref.py``.  There is no fallback from the kernel to the plain version.
"""
import torch

from ..build import LaunchCounter, check, library, stream_ptr
from .ref import join_probe_ref

launches = LaunchCounter()


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
    if right_hashes_sorted.shape[0] >= 2**31:
        raise ValueError("probe: build side must fit in int32")
    lib = library()
    dev = left_hashes.device
    n = left_hashes.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        rc = lib.restore_join_probe(
            left_hashes.data_ptr(), right_hashes_sorted.data_ptr(),
            pos.data_ptr(), n, right_hashes_sorted.shape[0], n_sm,
            stream_ptr(dev))
    check(rc, "join_probe")
    launches.add()
    return pos
