"""Plain PyTorch version of the sorted segment sum."""
import torch


def segment_sum_ref(values, seg_ids, *, num_segments: int):
    """values (N, D) -> (num_segments, D) float32 per-segment sums; rows
    whose id is outside [0, num_segments) are dropped."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    v = torch.where(ok[:, None], values.to(torch.float32),
                    torch.zeros((), dtype=torch.float32,
                                device=values.device))
    sid = torch.where(ok, seg_ids, num_segments).long()
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=torch.float32, device=values.device)
    out.index_add_(0, sid, v)
    return out[:num_segments]
