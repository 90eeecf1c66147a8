"""Ambient mesh context for the explicitly distributed layer paths
(``src/repro/models/dist.py``): the expert-parallel MoE, chunked
attention and the sequence-sharded decode attention.

Model code runs on one device by default.  The launch layer calls
``set_mesh`` with a ``launch.mesh.LocalMesh`` (or, one rank a shard, a
``GroupMesh``) of named axes to route the MoE through its
expert-parallel path, and ``set_optimized(True)`` to unlock chunked
attention and the sequence-sharded decode.

The batch a model call sees: on a ``LocalMesh`` the whole batch, which
the mesh paths split over the DP axes where those divide it (and
replicate otherwise); on a ``GroupMesh`` this rank's block of it, every
DP axis splitting the batch (``dp_split``).
"""
from __future__ import annotations

from typing import Optional

_MESH: Optional[object] = None
_OPTIMIZED = False


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def set_optimized(v: bool) -> None:
    """Enable the beyond-baseline implementations (chunked attention,
    the sequence-sharded decode attention)."""
    global _OPTIMIZED
    _OPTIMIZED = v


def optimized() -> bool:
    return _OPTIMIZED


def dp_axis_names(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_split(mesh, b: int):
    """(spec entry, DP shards, rows a shard) of a batch of ``b`` rows as
    a model call on ``mesh`` sees it.  A ``LocalMesh`` call holds the
    whole batch: split over the DP axes when they divide it, else every
    shard takes all ``b`` rows (entry None).  A ``GroupMesh`` call holds
    this rank's block, the batch split over every DP axis: the rows a
    shard are ``b`` itself."""
    dp = dp_axis_names(mesh)
    total = 1
    for a in dp:
        total *= mesh.shape[a]
    if not dp:
        return None, 1, b
    entry = dp if len(dp) > 1 else dp[0]
    if mesh.spans_processes:
        return entry, total, b
    if b % total or b < total:
        return None, 1, b
    return entry, total, b // total
