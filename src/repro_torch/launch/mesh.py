"""A mesh of logical shards on one device: the port's counterpart of the
reference's 1-D data mesh (``jax.make_mesh((n,), ("data",))`` under
``shard_map``, DESIGN.md §11).

The reference runs its mesh path in one process over ``n`` devices.  The
port runs the same program over ``n_shards`` logical shards of one
device (the card, or the CPU when asked for):

  * a sharded tensor is laid out in ``n_shards`` contiguous row blocks,
    as ``PartitionSpec(axis)`` lays it out across devices;
  * ``shard_map`` runs a shard body once per block and concatenates the
    outputs in shard order;
  * ``all_to_all`` is one permutation of a (src, dst, bucket, ...)
    buffer on the device;
  * ``psum`` is a sum over shards.

A mesh across several cards over NCCL is the counterpart of a TPU slice
and is not built here.  The reference's model meshes
(``make_production_mesh``, ``make_host_mesh``, ``dp_axes``, ``tp_axis``)
belong to the model path and are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..dataflow.table import Table
from ..device import resolve


class LocalMesh:
    """``n_shards`` logical shards along ``axis`` on one device."""

    def __init__(self, n_shards: int, axis: str = "data", device=None):
        if n_shards < 1:
            raise ValueError(f"LocalMesh: n_shards must be >= 1, "
                             f"got {n_shards}")
        self.n_shards = int(n_shards)
        self.axis = axis
        self.device = resolve(device)
        self.shape = {axis: self.n_shards}

    def __repr__(self):
        return (f"LocalMesh({self.n_shards}, axis={self.axis!r}, "
                f"device={str(self.device)!r})")

    # ------------------------------------------------------------------
    def blocks(self, x: torch.Tensor):
        """The ``n_shards`` row blocks of ``x`` (views, in shard order)."""
        n = x.shape[0]
        if n % self.n_shards:
            raise ValueError(f"LocalMesh: {n} rows do not split into "
                             f"{self.n_shards} shards")
        return torch.chunk(x, self.n_shards, 0) if n else \
            (x,) * self.n_shards

    def shard_map(self, body: Callable, *args):
        """Run ``body`` once per shard and gather its outputs.

        Every argument is sharded by rows: a ``Table`` (see
        ``dataflow.table``), a tensor, or None (passed through).  The
        body returns a tuple; a Table or a tensor with rows is
        concatenated in shard order, and a 0-d tensor is stacked into an
        (n_shards,) tensor of per-shard values (``psum`` reduces it)."""

        def split(a):
            if a is None:
                return (None,) * self.n_shards
            if isinstance(a, Table):
                cols = {n: self.blocks(c) for n, c in a.columns.items()}
                valid = self.blocks(a.valid)
                return tuple(Table({n: cols[n][i] for n in cols}, valid[i])
                             for i in range(self.n_shards))
            return self.blocks(a)

        per_arg = [split(a) for a in args]
        outs = [body(*(pa[i] for pa in per_arg))
                for i in range(self.n_shards)]
        return tuple(_gather([o[j] for o in outs])
                     for j in range(len(outs[0])))

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """(S_src, S_dst, ...) -> (S_dst, S_src, ...): chunk ``d`` of
        source shard ``s`` lands as chunk ``s`` of shard ``d`` — the
        semantics of ``jax.lax.all_to_all(split_axis=0, concat_axis=0,
        tiled=False)`` over the mesh axis."""
        if buf.shape[0] != self.n_shards or buf.shape[1] != self.n_shards:
            raise ValueError(f"all_to_all: leading dims {tuple(buf.shape)}"
                             f" are not ({self.n_shards}, {self.n_shards})")
        return buf.transpose(0, 1).contiguous()

    def psum(self, per_shard: torch.Tensor) -> torch.Tensor:
        """Sum of per-shard values over the mesh axis."""
        return per_shard.sum(0, dtype=per_shard.dtype)


def _gather(parts):
    first = parts[0]
    if isinstance(first, Table):
        return Table({n: torch.cat([p.col(n) for p in parts])
                      for n in first.columns},
                     torch.cat([p.valid for p in parts]))
    if first.ndim == 0:
        return torch.stack(parts)
    return torch.cat(parts)


def make_data_mesh(n_shards: int, axis: str = "data",
                   device=None) -> LocalMesh:
    """1-D data mesh of ``n_shards`` shards — the MapReduce scale-out
    axis of the relational engine (DESIGN.md §11)."""
    return LocalMesh(n_shards, axis, device)
