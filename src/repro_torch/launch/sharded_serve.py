"""The sharded prefill and decode steps: the port's counterparts of the
reference's serving steps jitted with their shardings
(``src/repro/launch/dryrun.py::_compile_step``: ``in_shardings=(p_shard,
b_shard, c_shard)``, ``out_shardings=(None, c_shard)``), over a mesh of
ranks (``GroupMesh``), of logical shards (``LocalMesh``) or of counted
ranks (``CountingMesh``, the dry-run's per-device model).

Blocks in, blocks out: the process holds its parameter blocks under
``param_specs`` and its cache blocks under ``cache_specs``
(``launch/sharding.py``; on a ``LocalMesh`` every block is the whole
value), and gives the whole batch, of which each shard takes its block
under ``batch_specs``, as ``sharded_train_step`` takes it.  The cache's
shardings are the caller's (``cache_shardings``: ``cache_specs`` of the
whole cache's shapes), as the reference's ``c_shard``.  A step writes
the new cache into the blocks it was given and returns the logits
whole.

The baseline is the design of ``launch/train.py::sharded_loss_and_grads``:

  * each parameter leaf is gathered whole (``mesh.globalize``);
  * each cache leaf is gathered over the non-DP axes its spec names, so
    the rank holds its DP block of the cache whole;
  * the one-device call runs with no mesh set, on the rank's DP block
    (on a ``LocalMesh``, on each DP block in turn);
  * the cache is cut back to the rank's blocks, and the logits are
    gathered over the DP axes.

``optimized`` (the reference's ``--opt``: ``dist.set_mesh(mesh)``,
``dist.set_optimized(True)``) runs the model with the mesh set, and
takes a route per leaf:

  * the MoE's expert stacks stay the rank's blocks (the expert-parallel
    MoE, ``models/layers.py::_moe_forward_shard_map``);
  * GQA attention's K and V (``models/lm.py::seq_sharded_keys``) stay
    the rank's S-slice, for the sequence-sharded decode (a leaf whose
    spec does not split S over "model" is gathered and cut to its
    S-slice, and back afterwards); a prefill of 8192 queries or more
    takes chunked attention;
  * every other leaf takes the baseline's gather, so MLA, the recurrent
    states and the cross-attention's K and V are served whole, as the
    reference leaves those mixers to GSPMD.

On a ``LocalMesh`` each DP block's call sees the mesh of that block's
shards (the DP axes of size 1), so that its shards compute what the
ranks at their coordinates compute, bit for bit.  A GQA cache whose length the "model" axis does not split
cannot be sequence-sharded over ranks and raises
(``models/lm.py::seq_slice_len``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..models import dist
from ..models.api import META
from ..models.lm import SEQ_SPEC, seq_sharded_keys
from ..tree import tree_flatten, tree_leaves, tree_leaves_with_path, \
    tree_map, tree_unflatten
from .mesh import LocalMesh, PartitionSpec as P, _names, dp_axes
from .sharding import batch_specs, cache_specs, model_shardings, to_named
from .train import _dp_blocks

__all__ = ["cache_shardings", "sharded_prefill", "sharded_decode_step"]


def cache_shardings(model, mesh, batch: int, max_len: int,
                    enc_len: int = 0):
    """The ``NamedSharding`` tree of a cache of ``batch`` rows and
    ``max_len`` positions over ``mesh`` (an encoder-decoder model's cross
    K and V at ``enc_len`` frames, default ``max_len``): ``cache_specs``
    of the whole cache's shapes."""
    with _mesh_set(None, False):
        whole = dataclasses.replace(model, device=META).init_cache(
            batch, max_len, enc_len)
    return to_named(cache_specs(model.cfg, whole, mesh), mesh)


def sharded_prefill(model, param_blocks, batch, cache_blocks, mesh, *,
                    cache_shardings, optimized: bool = False):
    """The prefill over ``mesh`` (the module's docstring): writes into
    ``cache_blocks`` and returns (the whole last-token logits,
    ``cache_blocks``)."""
    return _serve(model, param_blocks, batch, cache_blocks, mesh,
                  cache_shardings, optimized,
                  lambda p, b, c: model.prefill(p, b, c))


def sharded_decode_step(model, param_blocks, batch, cache_blocks,
                        index: int, mesh, *, cache_shardings,
                        optimized: bool = False):
    """One decode step at ``index`` (one int for every row) over ``mesh``:
    writes into ``cache_blocks`` and returns (the whole logits,
    ``cache_blocks``)."""
    return _serve(model, param_blocks, batch, cache_blocks, mesh,
                  cache_shardings, optimized,
                  lambda p, b, c: model.decode_step(p, b, c, index))


@contextlib.contextmanager
def _mesh_set(mesh, optimized: bool):
    """The model's ambient mesh for one call: ``mesh`` with the optimized
    paths, or none (the one-device model)."""
    prev = dist.get_mesh(), dist.optimized()
    dist.set_mesh(mesh)
    dist.set_optimized(optimized)
    try:
        yield
    finally:
        dist.set_mesh(prev[0])
        dist.set_optimized(prev[1])


def _drop(spec: P, axes) -> P:
    """``spec`` without the entries that name any of ``axes``."""
    return P(*(None if e is not None and set(_names(e)) & set(axes) else e
               for e in spec))


def _keep(spec: P, axes) -> P:
    """``spec`` with only the entries that name ``axes`` alone."""
    return P(*(e if e is not None and set(_names(e)) <= set(axes) else None
               for e in spec))


def _is_expert(path, x) -> bool:
    """An MoE expert stack: a layer-stacked (..., E, d, f) ``ffn`` leaf
    wg, wu or wd (``param_spec`` splits E over "model")."""
    return "ffn" in path and path[-1] in ("wg", "wu", "wd") and x.ndim >= 4


def _call_params(param_blocks, p_named, mesh, keep_experts: bool):
    """The parameters a call takes: every leaf gathered whole, but the
    expert stacks kept as the rank's blocks under ``keep_experts``."""
    leaves, pdef = tree_flatten(param_blocks)
    return tree_unflatten(pdef, [
        x if keep_experts and _is_expert(path, x) else
        mesh.globalize(x, sh.spec)
        for (path, x), sh in zip(tree_leaves_with_path(param_blocks),
                                 tree_leaves(p_named))])


def _given(mesh, x, spec, c, sliced: bool):
    """A held cache block ``x`` (under ``spec``) as the call at DP block
    ``c`` takes it: on a ``LocalMesh`` a view of that DP block; on ranks
    the DP block gathered over every other axis its spec names, or, for
    a ``sliced`` (GQA, ``optimized``) leaf, its S-slice."""
    dp = dp_axes(mesh)
    rest = _drop(spec, dp)
    if not mesh.spans_processes:
        return mesh.block(x, _keep(spec, dp), c)
    if not sliced:
        return mesh.globalize(x, rest)
    if rest == SEQ_SPEC:
        return x
    return mesh.block(mesh.globalize(x, rest), SEQ_SPEC, c)


def _put_back(mesh, x, spec, c, sliced: bool, g, y):
    """The call's cache leaf ``y`` (given to it as ``g``, by ``_given``)
    into the held block ``x``: nothing where the call wrote into ``x``
    itself or into a view of it, else the block of ``y`` under
    ``spec`` (a sliced leaf's S-slices gathered first)."""
    dp = dp_axes(mesh)
    rest = _drop(spec, dp)
    ranks = mesh.spans_processes
    if ranks and sliced and rest != SEQ_SPEC:
        x.copy_(mesh.block(mesh.globalize(y, SEQ_SPEC), rest, c))
    elif y is x or (not ranks and y is g):
        return
    elif ranks:
        x.copy_(mesh.block(y, rest, c))
    else:
        mesh.block(x, _keep(spec, dp), c).copy_(y)


def _serve(model, param_blocks, batch, cache_blocks, mesh, c_named,
           optimized, call):
    cfg = model.cfg
    ranks = mesh.spans_processes
    p_named, _ = model_shardings(model, mesh)
    b_named = to_named(batch_specs(cfg, batch, mesh), mesh)
    params = _call_params(param_blocks, p_named, mesh, optimized and ranks)
    dp = dp_axes(mesh)
    # the mesh a call sees: the rank's; on a LocalMesh, one DP block's
    # shards (its DP axes of size 1), so that each shard computes what
    # the rank at its coordinates computes
    at = mesh if ranks else LocalMesh(
        tuple(1 if a in dp else n for a, n in zip(mesh.axis_names,
                                                  mesh.sizes)),
        mesh.axis_names, mesh.device)
    seq = seq_sharded_keys(cfg) if optimized and ranks \
        and "model" in mesh.shape else ()
    rows = b_named["tokens" if "tokens" in batch else "embeds"].spec[0]
    coords = _dp_blocks(mesh)[:None if rows is not None else 1]
    logits = []
    for c in coords:
        held = {k: tree_map(lambda x, sh: _given(mesh, x, sh.spec, c,
                                                 k in seq), v, c_named[k])
                for k, v in cache_blocks.items()}
        with _mesh_set(at if optimized else None, optimized):
            lg, out = call(params, {k: mesh.block(v, b_named[k].spec, c)
                                    for k, v in batch.items()}, held)
        logits.append(lg)
        for k, v in cache_blocks.items():
            tree_map(lambda x, sh, g, y: _put_back(mesh, x, sh.spec, c,
                                                   k in seq, g, y),
                     v, c_named[k], held[k], out[k])
    if not ranks:
        return (logits[0] if len(logits) == 1 else
                torch.cat(logits)), cache_blocks
    return (logits[0] if rows is None else
            mesh.globalize(logits[0], P(rows, None, None))), cache_blocks
