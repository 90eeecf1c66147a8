"""Checked wrapper of the sorted segment-sum kernel.

The tensor's device chooses the implementation: a CUDA tensor launches
``csrc/segment_sum.cu``, a CPU tensor takes the plain version in
``ref.py``.  There is no fallback from the kernel to the plain version.
"""
import torch

from ..build import LaunchCounter, check, library, stream_ptr
from .ref import segment_sum_ref

launches = LaunchCounter()


def scratch_entries(n: int, tile: int) -> int:
    """Partial-buffer entries of every reduction level for n rows (the
    same recurrence as ``restore_segment_sum`` in the CUDA source)."""
    total = 0
    while n > tile:
        n = 2 * (-(-n // tile))
        total += n
    return total


def segment_sum(values, seg_ids, *, num_segments: int):
    """values: (N, D) float32; seg_ids: (N,) int32 sorted ascending (not
    necessarily dense).  Rows with ids outside [0, num_segments) are
    dropped.  Returns (num_segments, D) float32."""
    if not values.is_cuda:
        return segment_sum_ref(values, seg_ids, num_segments=num_segments)
    if values.ndim != 2 or values.dtype != torch.float32:
        raise ValueError("segment_sum: values must be (N, D) float32")
    if seg_ids.dtype != torch.int32 or seg_ids.shape != values.shape[:1]:
        raise ValueError("segment_sum: seg_ids must be (N,) int32")
    if seg_ids.device != values.device:
        raise ValueError("segment_sum: values and seg_ids on two devices")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_sum: inputs must be contiguous")
    n, d = values.shape
    if n >= 2**31 or num_segments >= 2**31:
        raise ValueError("segment_sum: sizes must fit in int32")
    lib = library()
    dev = values.device
    out = torch.zeros((num_segments, d), dtype=torch.float32, device=dev)
    m = scratch_entries(n, lib.restore_segment_sum_tile())
    s_vals = torch.empty(max(m, 1) * d, dtype=torch.float32, device=dev)
    s_ids = torch.empty(max(m, 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.restore_segment_sum(
            values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), n, d,
            num_segments, s_vals.data_ptr(), s_ids.data_ptr(),
            stream_ptr(dev))
    check(rc, "segment_sum")
    launches.add()
    return out
