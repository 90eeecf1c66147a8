"""A mesh of logical shards on one device: the port's counterpart of the
reference's meshes (``src/repro/launch/mesh.py``): the 1-D data mesh of
the relational engine (``jax.make_mesh((n,), ("data",))`` under
``shard_map``, DESIGN.md §11) and the model meshes over ("pod", "data",
"model").

The reference runs its mesh programs in one process over the devices of
a mesh.  The port runs the same programs over the logical shards of one
device (the card, or the CPU when asked for):

  * a mesh has named axes, ``shape`` {name: size} and ``axis_names``, as
    JAX's ``Mesh``; its shards are numbered in row-major order of their
    coordinates (the first axis slowest), the order of the reference's
    devices;
  * a sharded tensor is cut into blocks by a ``PartitionSpec``, as the
    reference lays it out across devices; a block is a view, so a shard
    that writes into its block writes into the tensor;
  * ``shard_map(body, mesh, in_specs, out_specs)`` runs ``body`` once
    per shard on its blocks and gathers the outputs by ``out_specs``;
    inside the body ``axis_index(name)`` is the shard's coordinate;
  * the collectives take per-shard values stacked on a leading dim of
    ``n_shards`` (a body returns ``x[None]`` under
    ``PartitionSpec(mesh.axis_names)`` to stack them): ``psum``,
    ``pmax`` and ``pmean`` over a named axis, ``all_to_all``, and
    ``axis_index`` as a stacked tensor.

A body runs to its end before the next shard's starts, so a collective
cannot sit in the middle of one.  Where a reference shard body calls a
collective in its middle, the port writes the body as stages around the
collective: a ``shard_map`` up to it, the collective on the stacked
values, a ``shard_map`` after it (``dataflow/shuffle.py`` around its
``all_to_all``, ``models/layers.py`` around the MoE's ``psum`` and the
sequence-sharded decode's ``pmax``/``psum``, ``train/compression.py``
around ``compressed_psum``'s).  JAX's in-body collectives are not
emulated in general.

The 1-D API of the relational engine stays as it was: ``LocalMesh(n,
axis, device)``, ``blocks``, the method ``shard_map(body, *args)``,
``all_to_all(buf)`` and ``psum(per_shard)`` without an axis.

A mesh across several cards (a process group over NCCL) is not built
here: it waits for a multi-card cell (ROADMAP item 22 with 13b).
"""
from __future__ import annotations

import contextvars
import itertools
import math
from typing import Callable, Dict, Tuple

import torch

from ..dataflow.table import Table
from ..device import resolve
from ..tree import tree_map


class PartitionSpec(tuple):
    """The layout of a tensor over a mesh, one entry per leading dim: None
    (not split), an axis name, or a tuple of names (split over their
    product, the first name slowest); dims past the last entry are not
    split.  ``PartitionSpec("data", None)`` is ``P("data", None)`` of
    the reference."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec
_CURRENT = contextvars.ContextVar("repro_torch_shard", default=None)


def _names(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


class LocalMesh:
    """Logical shards on one device: ``LocalMesh(n, axis)`` is the 1-D
    mesh of ``n`` shards along ``axis``; ``LocalMesh((2, 4), ("data",
    "model"))`` a mesh of named axes."""

    def __init__(self, n_shards, axis="data", device=None):
        sizes = (n_shards,) if isinstance(n_shards, int) else tuple(n_shards)
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"LocalMesh: shape {sizes} over axes {names}")
        if any(int(s) < 1 for s in sizes):
            raise ValueError(f"LocalMesh: n_shards must be >= 1, "
                             f"got {sizes}")
        self.sizes = tuple(int(s) for s in sizes)
        self.axis_names = names
        self.axis = axis
        self.shape: Dict[str, int] = dict(zip(names, self.sizes))
        self.n_shards = math.prod(self.sizes)
        self.device = resolve(device)

    def __repr__(self):
        if len(self.sizes) == 1:
            return (f"LocalMesh({self.n_shards}, axis={self.axis_names[0]!r},"
                    f" device={str(self.device)!r})")
        return (f"LocalMesh({self.sizes}, {self.axis_names}, "
                f"device={str(self.device)!r})")

    # ------------------------------------------------------------------
    def coords(self):
        """Every shard's coordinates {axis: index}, in shard order."""
        return [dict(zip(self.axis_names, c))
                for c in itertools.product(*(range(s) for s in self.sizes))]

    def _ravel(self, coords, names) -> int:
        i = 0
        for a in names:
            i = i * self.shape[a] + coords[a]
        return i

    def axis_size(self, axis) -> int:
        """The number of shards along ``axis``, a name or a tuple of
        names."""
        return math.prod(self.shape[a] for a in _names(axis))

    def block(self, x, spec, coords):
        """The block of ``x`` that the shard at ``coords`` holds under
        ``spec`` (a view).  Raises if a split dim does not divide."""
        if not isinstance(x, torch.Tensor):
            if any(e is not None for e in spec):
                raise ValueError(f"sharding: {spec} splits a "
                                 f"{type(x).__name__}")
            return x
        if len(spec) > x.ndim:
            raise ValueError(f"sharding: {spec} has more entries than "
                             f"the tensor's {x.ndim} dims")
        for d, e in enumerate(spec):
            if e is None:
                continue
            names = _names(e)
            n = self.axis_size(names)
            if x.shape[d] % n:
                raise ValueError(f"sharding: dim {d} of {tuple(x.shape)} "
                                 f"does not split into {n} blocks "
                                 f"({spec})")
            step = x.shape[d] // n
            x = x.narrow(d, self._ravel(coords, names) * step, step)
        return x

    def spec_blocks(self, x, spec):
        """``x``'s block on every shard, in shard order."""
        return [self.block(x, spec, c) for c in self.coords()]

    def gather(self, blocks, spec):
        """The tensor whose blocks under ``spec`` are ``blocks`` (one per
        shard, in shard order).  Blocks of shards that differ only along
        an axis the spec does not name are taken as equal: the first
        one's (coordinate 0 on such axes) is kept, as the reference's
        replicated out_specs keep one."""
        first = blocks[0]
        split = [(d, _names(e)) for d, e in enumerate(spec) if e is not None]
        if not isinstance(first, torch.Tensor) or not split:
            return first
        named = {a for _, ns in split for a in ns}
        shape = list(first.shape)
        for d, ns in split:
            shape[d] *= self.axis_size(ns)
        out = first.new_empty(shape)
        for c, blk in zip(self.coords(), blocks):
            if any(c[a] for a in self.axis_names if a not in named):
                continue
            view = out
            for d, ns in split:
                view = view.narrow(d, self._ravel(c, ns) * blk.shape[d],
                                   blk.shape[d])
            view.copy_(blk)
        return out

    # ---------------------------------------------- the 1-D engine API
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

    # ---------------------------------------------- collectives
    def _grouped(self, x: torch.Tensor, axis):
        if x.shape[0] != self.n_shards:
            raise ValueError(f"collective: leading dim {x.shape[0]} is not "
                             f"the mesh's {self.n_shards} shards")
        names = _names(axis)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"collective: no axis {a!r} in "
                                 f"{self.axis_names}")
        dims = tuple(self.axis_names.index(a) for a in names)
        return x.reshape(self.sizes + x.shape[1:]), dims

    def psum(self, per_shard: torch.Tensor, axis=None) -> torch.Tensor:
        """Without ``axis``: the sum of the 1-D mesh's per-shard values.
        With ``axis`` (a name or a tuple of names): the per-shard values
        stacked on the leading dim, each replaced by the sum over its
        group along ``axis`` (every shard of a group holds the sum)."""
        if axis is None:
            return per_shard.sum(0, dtype=per_shard.dtype)
        y, dims = self._grouped(per_shard, axis)
        return y.sum(dims, keepdim=True, dtype=y.dtype).expand_as(y) \
            .reshape(per_shard.shape)

    def pmax(self, per_shard: torch.Tensor, axis) -> torch.Tensor:
        """``psum`` with the maximum in place of the sum."""
        y, dims = self._grouped(per_shard, axis)
        return y.amax(dims, keepdim=True).expand_as(y) \
            .reshape(per_shard.shape)

    def pmean(self, per_shard: torch.Tensor, axis) -> torch.Tensor:
        """``psum`` over ``axis`` divided by the group's size."""
        return self.psum(per_shard, axis) / self.axis_size(axis)

    def axis_index(self, axis: str) -> torch.Tensor:
        """Every shard's coordinate along ``axis``, stacked: (n_shards,)
        int64 on the mesh's device."""
        i = self.axis_names.index(axis)
        idx = torch.arange(self.sizes[i], device=self.device)
        shape = [1] * len(self.sizes)
        shape[i] = self.sizes[i]
        return idx.view(shape).expand(self.sizes).reshape(-1)

    def all_to_all(self, buf: torch.Tensor, axis=None) -> torch.Tensor:
        """Without ``axis``, on the 1-D mesh: (S_src, S_dst, ...) ->
        (S_dst, S_src, ...): chunk ``d`` of source shard ``s`` lands as
        chunk ``s`` of shard ``d``, the semantics of
        ``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``
        over the mesh axis.  With ``axis``: (n_shards, A, ...) stacked per
        shard, A the axis's size, the same exchange within each group of
        shards along ``axis``."""
        if axis is None:
            if buf.shape[0] != self.n_shards or \
                    buf.shape[1] != self.n_shards:
                raise ValueError(f"all_to_all: leading dims "
                                 f"{tuple(buf.shape)} are not "
                                 f"({self.n_shards}, {self.n_shards})")
            return buf.transpose(0, 1).contiguous()
        y, (d,) = self._grouped(buf, axis)
        if buf.ndim < 2 or buf.shape[1] != self.shape[axis]:
            raise ValueError(f"all_to_all: dim 1 of {tuple(buf.shape)} is "
                             f"not the size of {axis!r}")
        return y.transpose(d, len(self.sizes)).contiguous() \
            .reshape(buf.shape)


def _gather(parts):
    first = parts[0]
    if isinstance(first, Table):
        return Table({n: torch.cat([p.col(n) for p in parts])
                      for n in first.columns},
                     torch.cat([p.valid for p in parts]))
    if first.ndim == 0:
        return torch.stack(parts)
    return torch.cat(parts)


# --------------------------------------------------- shard_map over specs
def _map_spec(fn, spec, tree, *rest):
    """``fn(spec, leaf, *rest_leaves)`` over a value tree whose spec tree
    is ``spec``; a PartitionSpec covers the whole subtree under it, as a
    prefix spec does in JAX."""
    if isinstance(spec, PartitionSpec):
        return tree_map(lambda x, *r: fn(spec, x, *r), tree, *rest)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, spec[k], tree[k], *(r[k] for r in rest))
                for k in spec}
    return type(spec)(_map_spec(fn, s, t, *(r[i] for r in rest))
                      for i, (s, t) in enumerate(zip(spec, tree)))


def shard_map(body: Callable, mesh: LocalMesh, in_specs, out_specs):
    """The reference's ``shard_map(f, mesh, in_specs, out_specs)`` over
    the logical shards of ``mesh``.  Returns a function of the arguments
    ``in_specs`` describes (one spec, or spec tree, per argument): it cuts
    each argument into its shard's blocks (views), calls ``body`` once
    per shard in shard order with ``axis_index`` bound to the shard's
    coordinates, and gathers the outputs by ``out_specs`` (a spec, or a
    tuple or tree of specs matching the body's outputs)."""
    if isinstance(in_specs, PartitionSpec):
        in_specs = (in_specs,)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} arguments for "
                             f"{len(in_specs)} in_specs")
        outs = []
        for c in mesh.coords():
            blocks = [_map_spec(lambda s, x: mesh.block(x, s, c), s, a)
                      for s, a in zip(in_specs, args)]
            token = _CURRENT.set((mesh, c))
            try:
                outs.append(body(*blocks))
            finally:
                _CURRENT.reset(token)
        return _map_spec(lambda s, *per: mesh.gather(list(per), s),
                         out_specs, *outs)

    return run


def axis_index(axis: str) -> int:
    """Inside a ``shard_map`` body: the shard's coordinate along
    ``axis`` (the reference's ``jax.lax.axis_index``)."""
    cur = _CURRENT.get()
    if cur is None:
        raise RuntimeError("axis_index: called outside a shard_map body")
    return cur[1][axis]


# --------------------------------------------------- the meshes
def make_data_mesh(n_shards: int, axis: str = "data",
                   device=None) -> LocalMesh:
    """1-D data mesh of ``n_shards`` shards — the MapReduce scale-out
    axis of the relational engine (DESIGN.md §11)."""
    return LocalMesh(n_shards, axis, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> LocalMesh:
    """16x16 = 256 shards a pod over ("data", "model"); multi-pod adds a
    leading "pod" axis of 2.  A shape of logical shards: nothing is
    allocated."""
    if multi_pod:
        return LocalMesh((2, 16, 16), ("pod", "data", "model"), device)
    return LocalMesh((16, 16), ("data", "model"), device)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> LocalMesh:
    """A (data, model) mesh of logical shards, as the distributed tests
    and the CPU examples use it."""
    return LocalMesh((data, model), ("data", "model"), device)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"
