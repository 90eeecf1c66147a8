"""Plain PyTorch version of the join probe."""
import torch


def join_probe_ref(left_hashes, right_hashes_sorted):
    """searchsorted(right, left, side='left') as int32 positions."""
    return torch.searchsorted(right_hashes_sorted, left_hashes,
                              side="left").to(torch.int32)
