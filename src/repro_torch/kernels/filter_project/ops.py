"""Checked wrapper of the stable filter-compaction kernel.

The tensor's device chooses the implementation: a CUDA tensor launches
``csrc/filter_compact.cu``, a CPU tensor takes the plain version in
``ref.py``.  There is no fallback from the kernel to the plain version.
"""
import torch

from ..build import LaunchCounter, check, library, stream_ptr
from .ref import filter_compact_ref

launches = LaunchCounter("filter_compact")
_BLOCK = 1024


def compact(values, mask):
    """values: (N,) or (N, W) rows of any dtype; mask: (N,) bool.
    Returns (out, total): survivors moved to the front in order, the
    other rows zero, and the survivor count as a 0-d int32 tensor."""
    (out,), total = compact_columns([values], mask)
    return out, total


def compact_columns(columns, mask):
    """``compact`` of every tensor in ``columns`` under one mask: the
    kernel counts and scans the mask once, then scatters each column.
    Returns (list of compacted columns, total)."""
    dev = mask.device
    if any(c.device != dev for c in columns):
        raise ValueError("compact: values and mask on two devices")
    if not mask.is_cuda:
        outs = [filter_compact_ref(c, mask)[0] for c in columns]
        return outs, mask.sum(dtype=torch.int32)
    if mask.dtype != torch.bool or mask.ndim != 1:
        raise ValueError("compact: mask must be (N,) bool")
    n = mask.shape[0]
    for c in columns:
        if c.shape[:1] != mask.shape:
            raise ValueError("compact: mask must be (N,) bool")
    if not all(t.is_contiguous() for t in (mask, *columns)):
        raise ValueError("compact: inputs must be contiguous")
    if n >= 2**31:
        raise ValueError("compact: row count must fit in int32")
    lib = library()
    nb = max(1, -(-n // _BLOCK))
    counts = torch.empty(nb, dtype=torch.int32, device=dev)
    offsets = torch.empty(nb, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    outs = []
    with torch.cuda.device(dev):
        stream = stream_ptr(dev)
        rc = lib.restore_compact_offsets(
            mask.data_ptr(), n, counts.data_ptr(), offsets.data_ptr(),
            total.data_ptr(), stream)
        check(rc, "filter_compact")
        for c in columns:
            row_bytes = (c[0].numel() if n else 0) * c.element_size()
            out = torch.empty_like(c)
            rc = lib.restore_compact_scatter(
                c.data_ptr(), mask.data_ptr(), out.data_ptr(), n, row_bytes,
                offsets.data_ptr(), total.data_ptr(), stream)
            check(rc, "filter_compact")
            outs.append(out)
    launches.add()
    return outs, total
