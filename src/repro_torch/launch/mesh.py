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

``GroupMesh`` runs the same programs across processes, as the reference
runs them across devices: one process (a rank of a ``torch.distributed``
process group) is one shard.  It has ``LocalMesh``'s API, and the
difference lives in the two classes, not in their callers:

  * a value that ``LocalMesh`` stacks per shard on a leading dim of
    ``n_shards`` has, on a ``GroupMesh``, a leading dim of 1: this
    rank's row of that stack (``n_local`` is the number of shards a
    process holds: ``n_shards``, or 1);
  * a row-sharded Table or tensor of the 1-D engine API is this rank's
    block (``local_table`` cuts it from the whole, as ``blocks`` would);
  * ``shard_map`` runs only this rank's body, on this rank's block: an
    argument is a whole value, cut by its in_spec, or, wrapped in
    ``Resident``, what the process already holds of it (``localize`` of
    the whole: this rank's block, taken as it is); an output a spec
    shards stays this rank's block, and ``globalize`` gathers it over
    the spec's axes where a program reads the whole value;
  * the collectives are ``torch.distributed`` calls on one subgroup per
    set of named axes, built once with the mesh: a float ``psum`` (and
    ``pmean``) gathers the group's values and adds them in rank order,
    as ``LocalMesh`` adds its shards (``_ordered_sum``), so the two
    meshes give the same bits whatever order a backend would add in;
    integers and ``pmax`` take ``all_reduce`` (exact in any order), and
    ``all_to_all_single`` and ``all_gather_into_tensor`` move the rest;
    a 16-bit value that a backend cannot reduce raises;
  * ``sum_ranks`` (a per-process host statistic summed over the ranks)
    and ``agree`` (rank 0's value of a decision, broadcast) keep every
    rank's driver on the same plan, so the ranks issue the same
    collectives in the same order.

A model program on a ``GroupMesh`` sees one view on every rank: its
inputs are the rank's block of the batch over the data-parallel axes
(every DP axis splits the batch; ``models/dist.py::dp_split``), and the
mesh paths of ``models/layers.py`` cut only over "model", their
sharded weights and caches handed in as ``Resident`` blocks.

``CountingMesh`` is one rank of a ``GroupMesh`` of any shape with no
process group: its transport primitives move nothing and count what the
rank would send and receive, so the dry-run (``launch/dryrun.py``) counts
the programs that run on ranks, per device of a production mesh.

``init_group_mesh`` builds one inside a process group; ``spawn`` starts
the ranks as processes of this host.  The backend is named by the
caller: "nccl" puts rank r on card r, "gloo" runs every rank on the
device the caller names (the CPU, or one card that the ranks share, in
which case each collective's tensors are copied through pinned host
buffers: that backend's transport, counted in ``transport``).
"""
from __future__ import annotations

import collections
import contextvars
import datetime
import itertools
import math
import os
import time
import traceback
from typing import Callable, Dict, Tuple

import torch

from ..dataflow.table import Table, pad_capacity
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


class Resident:
    """A ``shard_map`` argument that is already what this process holds
    of a value under its in_spec (``mesh.localize`` of the whole): on a
    ``LocalMesh`` the whole value, cut into every shard's blocks as an
    unwrapped argument is; on a ``GroupMesh`` this rank's block, handed
    to the body as it is.  A program whose sharded state lives as blocks
    between calls (the expert weights, the sequence-sharded cache, the
    per-shard rows of a collective) passes it wrapped; a whole value is
    passed as it is."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __repr__(self):
        return f"Resident({self.value!r})"


def _ordered_sum(stack: torch.Tensor) -> torch.Tensor:
    """``stack[0] + stack[1] + ...`` over the leading dim, left to right,
    in the input's dtype; a 16-bit float accumulates in float32 and is
    rounded once.  The float sum of both meshes, so that a ``GroupMesh``
    gives ``LocalMesh``'s bits."""
    acc = stack[0].float() if stack.element_size() == 2 else stack[0]
    for i in range(1, stack.shape[0]):
        acc = acc + stack[i]
    return acc.to(stack.dtype)


def _names(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


class LocalMesh:
    """Logical shards on one device: ``LocalMesh(n, axis)`` is the 1-D
    mesh of ``n`` shards along ``axis``; ``LocalMesh((2, 4), ("data",
    "model"))`` a mesh of named axes."""

    spans_processes = False
    rank = 0

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

    @property
    def n_local(self) -> int:
        """The shards this process holds: every one."""
        return self.n_shards

    def local_coords(self):
        """The coordinates of the shards this process runs."""
        return self.coords()

    def local_shards(self, axis) -> int:
        """The row blocks a row-sharded value of this process holds
        along ``axis``."""
        return self.axis_size(axis)

    def local_table(self, table: Table) -> Table:
        """The rows of ``table`` this process holds: all of them."""
        return table

    def assemble(self, blocks, spec):
        """A ``shard_map`` output from this process's blocks: the whole
        value (``gather``)."""
        return self.gather(blocks, spec)

    def globalize(self, x, spec):
        """The whole value of an output sharded by ``spec``: ``x``
        already is."""
        return x

    def localize(self, x, spec):
        """What this process keeps of the whole value ``x`` laid out by
        ``spec``: all of it (every shard's block is a view of it)."""
        return x

    def gather_rows(self, x):
        """The rows of every shard of a row-sharded Table or tensor, in
        shard order: ``x`` already holds them."""
        return x

    def sum_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """A per-process statistic summed over the processes: one."""
        return x

    def agree(self, value):
        """Rank 0's value of a host decision: this process is rank 0."""
        return value

    def barrier(self) -> None:
        pass

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

    def resident_block(self, x, spec, coords):
        """The block at ``coords`` of a ``Resident`` argument ``x`` (what
        this process holds): here the whole value, cut by ``spec``."""
        return self.block(x, spec, coords)

    def spec_blocks(self, x, spec):
        """``x``'s block on every shard, in shard order."""
        return [self.block(x, spec, c) for c in self.coords()]

    def addressable_blocks(self, x, spec):
        """``x``'s blocks on the shards of this process, in shard order
        (the reference's ``addressable_shards``)."""
        return [self.block(x, spec, c) for c in self.local_coords()]

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
                return (None,) * self.n_local
            if isinstance(a, Table):
                cols = {n: self.blocks(c) for n, c in a.columns.items()}
                valid = self.blocks(a.valid)
                return tuple(Table({n: cols[n][i] for n in cols}, valid[i])
                             for i in range(self.n_local))
            return self.blocks(a)

        per_arg = [split(a) for a in args]
        outs = [body(*(pa[i] for pa in per_arg))
                for i in range(self.n_local)]
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
        group along ``axis`` (every shard of a group holds the sum).
        Floats add in shard order (``_ordered_sum``)."""
        if axis is None:
            if per_shard.is_floating_point():
                return _ordered_sum(per_shard)
            return per_shard.sum(0, dtype=per_shard.dtype)
        y, dims = self._grouped(per_shard, axis)
        if not y.is_floating_point():
            return y.sum(dims, keepdim=True, dtype=y.dtype).expand_as(y) \
                .reshape(per_shard.shape)
        # floats: the group's values added in rank order (the group's
        # axes in mesh order, row-major), as GroupMesh adds them
        dims = tuple(sorted(dims))
        perm = list(dims) + [i for i in range(y.ndim) if i not in dims]
        z = y.permute(perm)
        group = math.prod(self.sizes[d] for d in dims)
        total = _ordered_sum(z.reshape((group,) + z.shape[len(dims):]))
        total = total.reshape((1,) * len(dims) + total.shape)
        inv = [perm.index(i) for i in range(y.ndim)]
        return total.permute(inv).expand_as(y).reshape(per_shard.shape)

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
    if len(parts) == 1:
        return first[None] if isinstance(first, torch.Tensor) and \
            first.ndim == 0 else first
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
    tuple or tree of specs matching the body's outputs).  On a
    ``GroupMesh`` the body runs once, on this rank's blocks, and a
    sharded output stays this rank's block.  An argument wrapped in
    ``Resident`` is what the process holds of it: cut like any other on
    a ``LocalMesh``, this rank's block as it is on a ``GroupMesh``."""
    if isinstance(in_specs, PartitionSpec):
        in_specs = (in_specs,)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} arguments for "
                             f"{len(in_specs)} in_specs")
        outs = []
        for c in mesh.local_coords():
            blocks = [
                _map_spec(lambda s, x: mesh.resident_block(x, s, c), s,
                          a.value) if isinstance(a, Resident) else
                _map_spec(lambda s, x: mesh.block(x, s, c), s, a)
                for s, a in zip(in_specs, args)]
            token = _CURRENT.set((mesh, c))
            try:
                outs.append(body(*blocks))
            finally:
                _CURRENT.reset(token)
        return _map_spec(lambda s, *per: mesh.assemble(list(per), s),
                         out_specs, *outs)

    return run


def axis_index(axis: str) -> int:
    """Inside a ``shard_map`` body: the shard's coordinate along
    ``axis`` (the reference's ``jax.lax.axis_index``)."""
    cur = _CURRENT.get()
    if cur is None:
        raise RuntimeError("axis_index: called outside a shard_map body")
    return cur[1][axis]


# --------------------------------------------------- across processes
def _carrier(x: torch.Tensor) -> torch.Tensor:
    """``x`` (at least 1-D) as a dtype every backend moves bit for bit:
    bool and 16-bit types travel as bytes (gloo takes neither bool nor
    any 16-bit type), their last dim widened to the bytes; ``out.view(
    x.dtype)`` narrows it back."""
    x = x.contiguous()
    if x.dtype == torch.bool or x.element_size() == 2:
        return x.view(torch.uint8)
    return x


class GroupMesh(LocalMesh):
    """A mesh whose shards are the ranks of the current
    ``torch.distributed`` process group, one rank a shard in row-major
    order of the coordinates (rank r holds shard r), with ``LocalMesh``'s
    API (see the module's docstring).

    ``backend`` must be the process group's.  "nccl": this rank's device
    is card ``LOCAL_RANK`` (or the rank), and ``device``, if given, must
    be it.  "gloo": every rank runs on ``device`` (None: the card, as
    every entry point resolves it); on a card each collective copies its
    tensors through pinned host buffers."""

    spans_processes = True

    def __init__(self, sizes, axes="data", *, backend: str, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("GroupMesh: no process group (call "
                               "init_group_mesh, or init_process_group)")
        got = dist.get_backend()
        if got != backend:
            raise ValueError(f"GroupMesh: backend {backend!r}, the process "
                             f"group's is {got!r}")
        world = dist.get_world_size()
        rank = dist.get_rank()
        if backend == "nccl":
            if world > torch.cuda.device_count():
                raise ValueError(f"GroupMesh: {world} nccl ranks over "
                                 f"{torch.cuda.device_count()} cards (one "
                                 "rank a card)")
            local = int(os.environ.get("LOCAL_RANK", rank))
            card = torch.device("cuda", local)
            if device is not None and resolve(device) != card:
                raise ValueError(f"GroupMesh: nccl rank {rank} runs on "
                                 f"{card}, not {device}")
            device = card
        elif backend != "gloo":
            raise ValueError(f"GroupMesh: backend {backend!r} (nccl or "
                             "gloo)")
        super().__init__(sizes, axes, device)
        if self.n_shards != world:
            raise ValueError(f"GroupMesh: shape {self.sizes} over a world "
                             f"of {world} ranks")
        self.backend = backend
        self.rank = rank
        self.world = world
        self.my_coords = self.coords()[rank]
        self.staged = backend == "gloo" and self.device.type == "cuda"
        # per collective: calls, payload bytes this rank sent, seconds
        # (the device synchronised before and after)
        self.transport = collections.defaultdict(
            lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})
        self.staged_bytes = 0   # host <-> card copies of the gloo route
        # one subgroup per nonempty set of axes, the ranks that share the
        # other coordinates; every rank creates every group, in one order
        ranks = list(range(world))
        self._groups = {}
        for k in range(1, len(self.axis_names) + 1):
            for names in itertools.combinations(self.axis_names, k):
                if k == len(self.axis_names):
                    self._groups[names] = None
                    continue
                mine = None
                others = [a for a in self.axis_names if a not in names]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    members = [r for r in ranks if all(
                        self.coords()[r][a] == f
                        for a, f in zip(others, fixed))]
                    g = dist.new_group(members, backend=backend)
                    if rank in members:
                        mine = g
                self._groups[names] = mine

    def __repr__(self):
        return (f"GroupMesh({self.sizes}, {self.axis_names}, "
                f"backend={self.backend!r}, rank={self.rank}, "
                f"device={str(self.device)!r})")

    # -------------------------------------------------------- placement
    @property
    def n_local(self) -> int:
        return 1

    def local_coords(self):
        return [self.my_coords]

    def local_shards(self, axis) -> int:
        return 1

    def local_table(self, table: Table) -> Table:
        """This rank's block of the whole ``table``: its capacity padded
        to a multiple of the shards, then block ``rank`` (views), the
        block ``LocalMesh.blocks`` gives shard ``rank``."""
        table = pad_capacity(table, self.n_shards)
        step = table.capacity // self.n_shards
        lo = self.rank * step
        return Table({n: c[lo:lo + step] for n, c in table.columns.items()},
                     table.valid[lo:lo + step])

    def blocks(self, x: torch.Tensor):
        return (x,)

    def assemble(self, blocks, spec):
        return blocks[0]

    def resident_block(self, x, spec, coords):
        """A ``Resident`` argument is this rank's block already."""
        return x

    def globalize(self, x, spec):
        """The whole value whose block on this rank is ``x`` under
        ``spec``: the blocks of the ranks that differ from this one only
        along the axes ``spec`` names, gathered over that subgroup and
        laid out as ``LocalMesh.gather`` lays them."""
        if not isinstance(x, torch.Tensor) or all(e is None for e in spec):
            return x
        named = {a for e in spec if e is not None for a in _names(e)}
        names = tuple(a for a in self.axis_names if a in named)
        # the subgroup's ranks are row-major over ``names``
        parts = self._all_gather(x, names)
        return self.gather([parts[self._ravel(c, names)]
                            for c in self.coords()], spec)

    def localize(self, x, spec):
        """This rank's block of the whole value ``x`` under ``spec``, a
        tensor of its own (the reference's addressable shard)."""
        if not isinstance(x, torch.Tensor):
            return x
        return self.block(x, spec, self.my_coords).clone()

    def gather_rows(self, x):
        """Every rank's rows, in rank order: a Table (every column and
        the validity) or a tensor, the same capacity on every rank."""
        if isinstance(x, Table):
            return Table({n: self.gather_rows(c)
                          for n, c in x.columns.items()},
                         self.gather_rows(x.valid))
        return self._all_gather(x).flatten(0, 1)

    # -------------------------------------------------------- transport
    def _group(self, axis):
        if axis is None:
            return None             # the default group: every rank
        names = _names(axis)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"collective: no axis {a!r} in "
                                 f"{self.axis_names}")
        return self._groups[tuple(a for a in self.axis_names if a in names)]

    def _call(self, name, fn, ins, outs, nbytes):
        """Run ``fn(ins, outs)`` (host buffers on the staged route; on the
        card for nccl, which moves no host tensor), count it, and return
        ``outs`` where the inputs lay."""
        home = ins[0].device
        if self.backend == "nccl" and home.type != "cuda":
            ins = [t.to(self.device) for t in ins]
            res = self._call(name, fn, ins, [t.to(self.device)
                                             for t in outs], nbytes)
            return [t.to(home) for t in res]
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if self.staged:
            hin = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   .copy_(t) for t in ins]
            hout = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in outs]
            fn(hin, hout)
            for t, h in zip(outs, hout):
                t.copy_(h)
            self.staged_bytes += sum(t.numel() * t.element_size()
                                     for t in ins + outs)
        else:
            fn(ins, outs)
        if sync:
            torch.cuda.synchronize(self.device)
        rec = self.transport[name]
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["seconds"] += time.perf_counter() - t0
        return outs

    def _all_reduce(self, x: torch.Tensor, op: str, axis=None):
        import torch.distributed as dist
        if x.element_size() == 2 or x.dtype == torch.bool:
            # gloo reduces no 16-bit type and no bool
            raise TypeError(f"GroupMesh: no all_reduce of {x.dtype} (psum "
                            "and pmax gather floats; cast the rest)")
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        g = self._group(axis)
        src = x.contiguous()
        out = src.clone()

        def fn(ins, outs):
            outs[0].copy_(ins[0])
            dist.all_reduce(outs[0], op=red, group=g)

        return self._call("all_reduce", fn, [src], [out],
                          src.numel() * src.element_size())[0]

    def _all_gather(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """(group size, *x.shape): every rank's ``x`` of the group, in
        rank order."""
        import torch.distributed as dist
        g = self._group(axis)
        n = dist.get_world_size(g)
        src = _carrier(x.reshape((1,) + tuple(x.shape)))
        # ranks' inputs concatenated on dim 0, the layout every backend
        # takes
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)

        def fn(ins, outs):
            gather(outs[0], ins[0], group=g)

        out = self._call("all_gather", fn, [src], [out],
                         src.numel() * src.element_size())[0]
        out = out.view(x.dtype) if out.dtype != x.dtype else out
        return out.reshape((n,) + tuple(x.shape))

    def _all_to_all(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """x (A, ...) over a group of A ranks: chunk d goes to the group's
        rank d; returns (A, ...) with chunk s from the group's rank s."""
        import torch.distributed as dist
        g = self._group(axis)
        src = _carrier(x)
        out = torch.empty_like(src)

        def fn(ins, outs):
            dist.all_to_all_single(outs[0], ins[0], group=g)

        out = self._call("all_to_all", fn, [src], [out],
                         src.numel() * src.element_size())[0]
        return out.view(x.dtype) if out.dtype != x.dtype else out

    # -------------------------------------------------------- collectives
    def _one(self, x: torch.Tensor):
        if x.ndim == 0 or x.shape[0] != 1:
            raise ValueError(f"collective: leading dim of {tuple(x.shape)} "
                             f"is not this rank's 1 shard")

    def _sum(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """The group's ``x`` summed: floats gathered and added in rank
        order (``_ordered_sum``, bit-equal to ``LocalMesh.psum`` on the
        same per-shard values; 16-bit floats travel as bytes), integers
        by ``all_reduce``."""
        if x.is_floating_point():
            return _ordered_sum(self._all_gather(x, axis))
        return self._all_reduce(x, "sum", axis)

    def psum(self, per_shard: torch.Tensor, axis=None) -> torch.Tensor:
        if axis is None:
            if per_shard.ndim == 0:
                return self._sum(per_shard)
            self._one(per_shard)
            return self._sum(per_shard[0])
        self._one(per_shard)
        return self._sum(per_shard, axis)

    def pmax(self, per_shard: torch.Tensor, axis) -> torch.Tensor:
        """``all_reduce`` MAX (order-free); a 16-bit float is gathered and
        its maximum taken here, since gloo reduces no 16-bit type."""
        self._one(per_shard)
        if per_shard.element_size() == 2 and per_shard.is_floating_point():
            return self._all_gather(per_shard, axis).amax(0)
        return self._all_reduce(per_shard, "max", axis)

    def axis_index(self, axis: str) -> torch.Tensor:
        return torch.tensor([self.my_coords[axis]], device=self.device)

    def all_to_all(self, buf: torch.Tensor, axis=None) -> torch.Tensor:
        """(1, A, ...) -> (1, A, ...): chunk d of this rank goes to the
        rank at coordinate d along the axis (every axis of the 1-D mesh
        without ``axis``), and chunk s of the result came from the rank
        at coordinate s, as ``LocalMesh.all_to_all`` permutes them."""
        self._one(buf)
        a = self.n_shards if axis is None else self.shape[axis]
        if buf.ndim < 2 or buf.shape[1] != a:
            raise ValueError(f"all_to_all: dim 1 of {tuple(buf.shape)} is "
                             f"not the group's {a} ranks")
        return self._all_to_all(buf[0], axis)[None]

    def sum_ranks(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, "sum")

    def agree(self, value):
        """Rank 0's ``value``, on every rank (``broadcast_object_list``):
        a host decision that reads a clock can differ between ranks, and
        the ranks must agree on every decision that shapes the plan."""
        import torch.distributed as dist
        box = [value]
        dist.broadcast_object_list(box, src=0)
        self.transport["broadcast"]["calls"] += 1
        return box[0]

    def barrier(self) -> None:
        self._all_reduce(torch.zeros(1, device=self.device), "sum")


# a node: the cards one HGX H100 board joins over NVLink, 8 consecutive
# ranks (rank // NODE_RANKS); a group with ranks on two nodes crosses the
# network
NODE_RANKS = 8
# the reference's names of the collectives (``src/repro/launch/dryrun.py``)
# for the transport primitives
REF_COLLECTIVE = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                  "all_to_all": "all-to-all"}


class CountingMesh(GroupMesh):
    """One rank (``rank``, 0 by default) of a mesh of any shape, such as
    the production (16, 16) or (2, 16, 16), with no process group: the
    per-device cost model of the programs ``GroupMesh`` runs on ranks
    (``launch/dryrun.py``).

    Everything above the transport primitives is ``GroupMesh``'s own code
    (``globalize``, ``localize``, the rank-order float ``psum``,
    ``shard_map`` with ``Resident`` blocks), so a program run on this mesh
    issues the collectives it issues on the rank.  The primitives
    (``_all_reduce``, ``_all_gather``, ``_all_to_all``, ``agree``; the
    inherited ``barrier`` is an ``_all_reduce``) move nothing: each
    returns a result of the right shape and dtype on the input's device,
    uninitialised (on the ``meta`` device, no storage), and records

      * ``transport[name]`` calls and bytes, by ``GroupMesh._call``'s
        rule (the payload this rank sends);
      * ``collective_bytes`` and ``collective_counts`` under the
        reference's names (``REF_COLLECTIVE``), the bytes of the result's
        shape, as the reference sums them from its compiled HLO;
      * ``link_bytes``: those result bytes on "network" where the call's
        group holds ranks of two nodes (``NODE_RANKS``), else on
        "nvlink".

    A value computed from a collective's result is meaningless off
    ``meta``; only shapes, dtypes and counts are."""

    def __init__(self, sizes, axes="data", *, rank: int = 0, device=None):
        LocalMesh.__init__(self, sizes, axes, device)
        if not 0 <= rank < self.n_shards:
            raise ValueError(f"CountingMesh: rank {rank} of {self.n_shards}")
        self.backend = "count"
        self.rank = rank
        self.world = self.n_shards
        self.my_coords = self.coords()[rank]
        self.staged = False
        self.transport = collections.defaultdict(
            lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})
        self.staged_bytes = 0
        self.collective_bytes = {k: 0 for k in REF_COLLECTIVE.values()}
        self.collective_counts = {k: 0 for k in REF_COLLECTIVE.values()}
        self.link_bytes = {"nvlink": 0, "network": 0}

    def __repr__(self):
        return (f"CountingMesh({self.sizes}, {self.axis_names}, "
                f"rank={self.rank}, device={str(self.device)!r})")

    def _members(self, axis):
        """The ranks of this rank's group over ``axis`` (None: all)."""
        if axis is None:
            return range(self.world)
        names = set(_names(axis))
        for a in names:
            if a not in self.shape:
                raise ValueError(f"collective: no axis {a!r} in "
                                 f"{self.axis_names}")
        ranges = [range(n) if a in names else (self.my_coords[a],)
                  for a, n in zip(self.axis_names, self.sizes)]
        return [self._ravel(dict(zip(self.axis_names, c)), self.axis_names)
                for c in itertools.product(*ranges)]

    def _count(self, name, axis, x, gathered=False) -> int:
        """Records a call of ``name`` that sends ``x`` over the group of
        ``axis``; its result is ``x``'s size, or that a member when
        ``gathered``.  Returns the group's size."""
        members = self._members(axis)
        payload = x.numel() * x.element_size()
        result = payload * (len(members) if gathered else 1)
        rec = self.transport[name]
        rec["calls"] += 1
        rec["bytes"] += payload
        ref = REF_COLLECTIVE[name]
        self.collective_counts[ref] += 1
        self.collective_bytes[ref] += result
        node = self.rank // NODE_RANKS
        link = "network" if any(r // NODE_RANKS != node for r in members) \
            else "nvlink"
        self.link_bytes[link] += result
        return len(members)

    def _all_reduce(self, x: torch.Tensor, op: str, axis=None):
        if x.element_size() == 2 or x.dtype == torch.bool:
            raise TypeError(f"GroupMesh: no all_reduce of {x.dtype} (psum "
                            "and pmax gather floats; cast the rest)")
        self._count("all_reduce", axis, x)
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def _all_gather(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        n = self._count("all_gather", axis, x, gathered=True)
        return x.new_empty((n,) + tuple(x.shape))

    def _all_to_all(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        self._count("all_to_all", axis, x)
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def agree(self, value):
        self.transport["broadcast"]["calls"] += 1
        return value


def init_group_mesh(sizes, axes="data", *, backend: str, device=None,
                    rank=None, world=None, init_method=None,
                    timeout_s: float = 300.0) -> GroupMesh:
    """A ``GroupMesh`` of shape ``sizes`` over ``axes``, in the process
    group this call joins unless one exists: rank, world and rendezvous
    from the arguments, else from the environment ``torchrun``
    (``torch.distributed.run``) sets (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT).  "nccl" also pins this process to its card.  A
    collective that waits longer than ``timeout_s`` raises."""
    import torch.distributed as dist
    if not dist.is_initialized():
        rank = int(os.environ["RANK"] if rank is None else rank)
        world = int(os.environ["WORLD_SIZE"] if world is None else world)
        if backend == "nccl":
            if world > torch.cuda.device_count():
                raise ValueError(f"init_group_mesh: {world} nccl ranks over "
                                 f"{torch.cuda.device_count()} cards")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return GroupMesh(sizes, axes, backend=backend, device=device)


def _rank_main(fn, rank, world, backend, init_file, timeout_s, args, out):
    """One rank of ``spawn``: joins the group, runs ``fn(rank, world,
    *args)`` and sends (rank, ok, result or traceback) to the parent."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method="file://" + init_file, rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(rank, world, *args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class SpawnError(RuntimeError):
    """A rank of ``spawn`` raised, died or overran the time limit."""


def spawn(fn: Callable, world: int, *, backend: str, init_file: str,
          timeout: float = 120.0, args=()) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` processes of this host
    (the ``spawn`` start method), each one rank of a process group over
    ``backend`` with a ``file://`` rendezvous at ``init_file`` (a path
    that does not exist yet).  ``fn`` must be importable by name (a
    module-level function) and return something picklable.  Returns the
    ranks' results in rank order.  Raises ``SpawnError`` with the rank's
    traceback as soon as one rank fails or dies, or when ``timeout``
    seconds pass; every rank still running is then terminated, so no
    process outlives the call."""
    import torch.multiprocessing as mp
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"spawn: {world} nccl ranks over "
                         f"{torch.cuda.device_count()} cards")
    if os.path.exists(init_file):
        raise ValueError(f"spawn: rendezvous file {init_file} exists")
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, init_file, timeout,
                               tuple(args), out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and failure is None:
            while not out.empty():
                rank, ok, value = out.get()
                if ok:
                    results[rank] = value
                else:
                    failure = f"rank {rank} raised:\n{value}"
                    break
            if failure or len(results) == world:
                break
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in results]
            if dead and out.empty():
                failure = f"rank {dead[0][0]} died (exit code {dead[0][1]})"
            elif time.monotonic() > deadline:
                failure = f"timed out after {timeout} s with ranks " \
                          f"{sorted(set(range(world)) - set(results))} " \
                          "running"
            else:
                time.sleep(0.02)
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10 if failure is None else 5)
            if p.is_alive():
                p.kill()
                p.join(5)
        out.close()
    if failure is not None:
        raise SpawnError(failure)
    return [results[r] for r in range(world)]


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
