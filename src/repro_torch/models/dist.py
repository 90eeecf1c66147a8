"""Ambient mesh context for the explicitly distributed layer paths
(``src/repro/models/dist.py``): the expert-parallel MoE, chunked
attention and the sequence-sharded decode attention.

Model code runs on one device by default.  The launch layer calls
``set_mesh`` with a ``launch.mesh.LocalMesh`` of named axes to route
the MoE through its expert-parallel path, and ``set_optimized(True)`` to
unlock chunked attention and the sequence-sharded decode.
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
