"""Sharding-spec inference for parameters, optimizer states, batches and
decode caches (``src/repro/launch/sharding.py``), over the port's
``LocalMesh`` of named axes.

Rule-based tensor parallelism over the "model" axis, data parallelism over
("pod", "data"), and a ZeRO-1 extension that additionally shards optimizer
states over the DP axes on the largest still-unsharded, divisible
dimension.  Every rule checks divisibility; anything that doesn't divide
cleanly is replicated.

The rules read only a mesh's ``shape`` and ``axis_names`` and a leaf's
``shape``, so they take ``meta`` tensors (``Model.init_shapes``) and give
the reference's specs entry for entry.  ``PartitionSpec`` is the port's
own (``launch/mesh.py``), and ``NamedSharding(mesh, spec)`` cuts a
tensor into the blocks each logical shard holds.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

from ..models.config import ModelConfig
from .mesh import LocalMesh, PartitionSpec as P, dp_axes

__all__ = ["P", "NamedSharding", "param_spec", "param_specs",
           "zero_extend", "opt_specs", "batch_specs", "cache_spec",
           "cache_specs", "to_named", "model_shardings"]

# leaf-name classes: which dim (from the right) gets the "model" axis
_SHARD_LAST = {"wq", "wk", "wv", "wg", "wu", "wuq", "wuk", "wuv", "up",
               "in_proj", "dt_proj", "lm_head", "wi", "wf", "wz", "wo_gate"}
_SHARD_FIRST = {"wo", "wd", "down", "out_proj", "x_proj"}
_BIAS_LIKE = {"bq", "bk", "bv", "conv_b", "dt_bias", "D", "conv_w",
              "A_log"}
_REPLICATE = {"ln1", "ln2", "ln_f", "ln_enc", "ln_x", "q_norm", "k_norm",
              "kv_norm", "gn", "router", "bi", "bf", "bz", "bo",
              "step"}


class NamedSharding:
    """A ``PartitionSpec`` over a mesh: where a tensor's blocks live."""

    def __init__(self, mesh: LocalMesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and other.spec == self.spec

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def blocks(self, x):
        """``x``'s blocks on the shards of this process, in shard order
        (the reference's ``addressable_shards`` in device order): every
        shard's on a ``LocalMesh``, this rank's one on a ``GroupMesh``;
        raises ValueError if the spec does not divide ``x``."""
        return self.mesh.addressable_blocks(x, self.spec)


def _divisible(n: int, mesh, axis) -> bool:
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= mesh.shape[a]
    return n % size == 0 and n >= size


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> P:
    name = path[-1]
    nd = len(shape)
    # MoE expert weights are (..., E, d, f): 4-D when layer-stacked, 3-D
    # never (dense MLPs are (L', d, f)) — require the expert dim present
    in_expert = any(p in ("ffn",) for p in path) and nd >= 4 and \
        name in ("wg", "wu", "wd")

    def spec_with(dim_from_right: int):
        dim = nd - dim_from_right
        if dim < 0 or not _divisible(shape[dim], mesh, "model"):
            return P()
        out = [None] * nd
        out[dim] = "model"
        return P(*out)

    if name == "embed":
        # vocab-sharded embedding table
        if _divisible(shape[0], mesh, "model"):
            return P("model", *([None] * (nd - 1)))
        return P()
    if name in _REPLICATE or name in _BIAS_LIKE and nd <= 2:
        return P()
    if in_expert:
        # experts over "model" (expert parallelism): dim -3
        return spec_with(3)
    if name in _SHARD_LAST:
        return spec_with(1)
    if name in _SHARD_FIRST:
        return spec_with(2)
    return P()


def _walk(tree, path, leaf):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, path + (str(i),), leaf)
                          for i, v in enumerate(tree))
    return leaf(path, tuple(tree.shape))


def param_specs(cfg: ModelConfig, params_shape, mesh):
    """Tree of PartitionSpec mirroring the params tree."""
    return _walk(params_shape, (),
                 lambda path, shape: param_spec(path, shape, mesh))


def zero_extend(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """ZeRO-1: add DP sharding on the largest unsharded divisible dim."""
    dp = dp_axes(mesh)
    if not dp:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (s, n) in enumerate(zip(entries, shape)):
        if s is None and _divisible(n, mesh, dp) and n > best_size:
            best, best_size = i, n
    if best is None:
        return spec
    entries[best] = dp if len(dp) > 1 else dp[0]
    return P(*entries)


def opt_specs(cfg: ModelConfig, params_shape, mesh):
    base = param_specs(cfg, params_shape, mesh)

    def walk(spec_tree, shape_tree):
        if isinstance(spec_tree, dict):
            return {k: walk(spec_tree[k], shape_tree[k]) for k in spec_tree}
        if isinstance(spec_tree, tuple) and \
                not isinstance(spec_tree, P):
            return tuple(walk(s, sh) for s, sh in
                         zip(spec_tree, shape_tree))
        return zero_extend(spec_tree, tuple(shape_tree.shape), mesh)

    mv = walk(base, params_shape)
    return {"m": mv, "v": mv, "step": P()}


def batch_specs(cfg: ModelConfig, batch_shapes: Dict, mesh):
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)

    def spec(name, shape):
        nd = len(shape)
        if name in ("positions", "enc_positions") and nd <= 1:
            return P()
        if name == "positions" and nd == 3:        # m-rope (3, B, S)
            return P(None, dp, None)
        if nd == 0:
            return P()
        if shape[0] == 1:                          # long_500k batch 1
            return P(*([None] * nd))
        return P(dp, *([None] * (nd - 1)))

    return {k: spec(k, tuple(v.shape)) for k, v in batch_shapes.items()}


def cache_spec(path, shape: Tuple[int, ...], cfg: ModelConfig, mesh):
    """Decode caches: (L', B, ...).  Batch over DP when divisible; the
    longest remaining divisible dim (heads or sequence) over "model"."""
    dp = dp_axes(mesh)
    nd = len(shape)
    entries = [None] * nd
    if nd >= 2 and _divisible(shape[1], mesh, dp):
        entries[1] = dp if len(dp) > 1 else dp[0]
    # choose a model-sharded dim among the rest (prefer heads, then seq)
    for dim in range(2, nd):
        if _divisible(shape[dim], mesh, "model") and shape[dim] >= 128:
            entries[dim] = "model"
            break
    return P(*entries)


def cache_specs(cfg: ModelConfig, cache_shapes, mesh):
    return _walk(cache_shapes, (),
                 lambda path, shape: cache_spec(path, shape, cfg, mesh))


def to_named(tree_specs, mesh: LocalMesh):
    """A tree of ``NamedSharding`` over ``mesh``, one per spec."""
    def walk(t):
        if isinstance(t, P):
            return NamedSharding(mesh, t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return type(t)(walk(v) for v in t)
    return walk(tree_specs)


def model_shardings(model, mesh):
    """(``param_specs``, ``opt_specs``) of ``model``'s whole parameter
    shapes over ``mesh``, as ``NamedSharding`` trees: the layout a
    sharded step reads every call, its specs worked out once per
    (config, mesh shape) (``Model.init_shapes`` is host work that a step
    need not repeat)."""
    p, o = _whole_specs(model.cfg, mesh.sizes, mesh.axis_names)
    return to_named(p, mesh), to_named(o, mesh)


@functools.lru_cache(maxsize=32)
def _whole_specs(cfg: ModelConfig, sizes, axes):
    from ..models.api import build
    shapes = build(cfg, device="meta").init_shapes()
    mesh = LocalMesh(sizes, axes, device="meta")    # its shape is read
    return param_specs(cfg, shapes, mesh), opt_specs(cfg, shapes, mesh)
