"""Plain PyTorch version of the stable filter compaction."""
import torch


def filter_compact_ref(values, mask):
    """values (N, ...) of any dtype, mask (N,) bool -> (out, total): the
    rows under the mask moved to the front in order, the rest zero."""
    n = values.shape[0]
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    out = values.index_select(0, order)
    total = mask.sum(dtype=torch.int32)
    live = torch.arange(n, device=values.device) < total
    live = live.reshape((n,) + (1,) * (values.ndim - 1))
    return torch.where(live, out, torch.zeros_like(out)), total
