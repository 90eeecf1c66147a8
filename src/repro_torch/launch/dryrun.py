"""Dry-run of the port (``src/repro/launch/dryrun.py``): every
(architecture x input shape) cell's step on the ``meta`` device, which
has shapes and dtypes and no storage, with the numbers the roofline
analysis (``roofline/analysis.py``) reads.  No card is needed: on one
H100, or per device of a production mesh of them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-350m \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 6
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k --multi-pod --opt
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16

The reference lowers and compiles each cell with XLA on a production
mesh and reads the compiled cost.  The port has no compile step: the
step runs eagerly on ``meta``, through the entry points a user calls:

* train: ``launch/train.py::batch_step`` (``Model.loss_fn``,
  ``backward()`` and ``AdamW.update``, the moments in bfloat16 above
  1.5e11 parameters, as the reference's);
* prefill: ``Model.prefill`` into a cache of the shape's length;
* decode: one ``Model.decode_step`` at the cache's last position.

``CostMode`` sees every aten op the step dispatches, the backward's
included.  FLOPs are the matmul-class ops' (``torch.utils.flop_counter``'s
formulas), kept by dtype, so the roofline prices float32 products at the
float32 rate; elementwise ops count in bytes only.  Bytes are each op's
tensor inputs read once and outputs written once (views and allocations
move none): the port's eager traffic, not XLA's count after fusion.
Memory is the simulated allocator's peak: the storages every op makes,
held while a tensor keeps them (autograd's saved tensors and remat's
recomputations included), over the parameters, moments, batch and cache
resident before the step.  On ``meta`` the kernels' wrappers take their
plain versions (``if not q.is_cuda``), so attention counts as its plain
version computes it, which is how XLA counts the reference's ``_sdpa``.

Depth is extrapolated as the reference does: depth-1 and depth-2
superblock variants, the difference per period times the full count.
Length likewise for the xLSTM cells, whose loops over time are Python
loops: every step runs the same ops at the same shapes, so one step's
cost is exact, and counting at LOOP_STEPS and 2 LOOP_STEPS steps and
extrapolating to S counts each step once, the first and last steps'
different backward included.

Without a mesh option the cell runs on one card (``MESH``, "1xH100") and
the collective fields stay at zero.  ``--mesh 16x16`` (the reference's
default mesh), ``--multi-pod`` (2x16x16 over ("pod", "data", "model"))
and ``--opt`` (on 16x16 unless another mesh is named) make the report
per device: rank 0's step over a ``launch/mesh.py::CountingMesh`` of the
mesh's shape, from rank 0's blocks (the reference's in_shardings):

* train: ``launch/train.py::sharded_train_step`` (every parameter
  gathered whole, the DP mean of the whole gradient, the ZeRO-1 update
  of the rank's moment blocks and its parameter blocks' gather);
* prefill and decode: ``launch/sharded_serve.py``'s steps, and under
  ``--opt`` their routes (the expert-parallel MoE, the sequence-sharded
  GQA cache, chunked prefill from 8192 queries); the train step has no
  other route, so ``--opt`` leaves it as it is.

The counting mesh is ``GroupMesh`` above its transport primitives, so
the counted program is the one that runs on ranks.  Its collectives
carry the reference's names and the bytes of their results
(``collective_bytes``, ``collective_counts``), split by link
(``collective_bytes_by_link``: a call whose group spans two nodes of 8
cards is on the network), extrapolated over depth and time with the
rest.
``memory`` reports rank 0's resident blocks (its batch and cache blocks
too) and its simulated peak; ``fits_one_card`` compares the peak with
one card's 80 GB.  Report files carry the reference's tags,
``{arch}_{shape}_16x16[_opt].json``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import multiprocessing
from multiprocessing.pool import ThreadPool
import os
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, get_config
from ..models.api import META, SHAPES, build, shape_applicable
from ..models.lm import block_period
from ..models.ssm import REMAT_STEPS, ROWS
from ..train.optimizer import AdamW
from ..tree import tree_leaves, tree_map
from .mesh import NODE_RANKS, CountingMesh
from .sharded_serve import sharded_decode_step, sharded_prefill
from .sharding import (batch_specs, cache_specs, opt_specs, param_specs,
                       to_named)
from .train import batch_step, sharded_train_step

MESH = "1xH100"
# the production meshes (``launch/mesh.py::make_production_mesh``):
# (sizes, axes) by the reference's tag
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CARD_BYTES = 80e9                # one H100's HBM
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
NO_COLLECTIVES = "one card: no collective"
LINKS = ("nvlink", "network")
# the xLSTM loops are counted at this many steps and twice as many, then
# extrapolated: a multiple of the row blocks and of remat's chunks
LOOP_STEPS = math.lcm(REMAT_STEPS, ROWS)
_ALLOCS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided,
           torch.ops.aten.empty_like, torch.ops.aten.new_empty,
           torch.ops.aten.new_empty_strided, torch.ops.aten._unsafe_view,
           torch.ops.aten.lift_fresh}


def _key(t) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t) -> int:
    """The bytes a read of ``t`` touches: its elements, or the span of
    its storage they cover where strides repeat them (an expand)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()) if n > 1)
    return min(t.numel(), span) * t.element_size()


def _flat(x) -> list:
    """The leaves of an aten op's arguments or results: tensors and
    scalars, lists and tuples taken apart."""
    if isinstance(x, (list, tuple)):
        return [y for z in x for y in _flat(z)]
    return [x]


def _signature(x):
    """What an op's results on ``meta`` depend on: a tensor's shape,
    strides, dtype and device; the type and value of anything else."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return (list,) + tuple(_signature(y) for y in x)
    return (type(x), x)


def _returns(func):
    """How ``func``'s results relate to its inputs: "new" (every result a
    new tensor), "self" (an in-place op returning its first argument) or
    None (a view, several aliases, or results that are not tensors)."""
    rets = func._schema.returns
    if func.is_view or not rets or any(
            str(r.type) not in ("Tensor", "List[Tensor]") for r in rets):
        return None
    if all(r.alias_info is None for r in rets):
        return "new"
    if len(rets) == 1 and rets[0].alias_info.is_write \
            and func._schema.arguments[0].alias_info == rets[0].alias_info:
        return "self"
    return None


class CostMode(TorchDispatchMode):
    """Counts the aten ops dispatched under it: ``flops`` by dtype,
    ``bytes`` and the peak of the storages they make (``peak_new``),
    apart from the ``resident`` tensors' storages, which existed before.

    An op's results on ``meta`` depend on its inputs' shapes, strides
    and dtypes only, so their metadata are kept by that signature and a
    repeated call (every step of a loop over time) makes its results
    from it, without running the meta kernel again."""

    def __init__(self, resident=()):
        super().__init__()
        self.flops = defaultdict(int)
        self.bytes = 0
        self.resident = {_key(t): t.untyped_storage().nbytes()
                         for t in resident}
        self._live, self._refs = {}, defaultdict(int)
        self.cur = self.peak_new = 0
        self._seen = {}

    def _drop(self, key):
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.cur -= self._live.pop(key)

    def _track(self, t):
        key = _key(t)
        if key in self.resident:
            return
        if key not in self._live:
            self._live[key] = t.untyped_storage().nbytes()
            self.cur += self._live[key]
            self.peak_new = max(self.peak_new, self.cur)
        self._refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _call(self, func, args, kwargs, leaves):
        kind = _returns(func)
        if kind is None or not all(
                x.device == META for x in leaves
                if isinstance(x, torch.Tensor)):
            return func(*args, **kwargs)
        sig = (func, _signature(args),
               tuple((k, _signature(v)) for k, v in kwargs.items()))
        if sig in self._seen:
            if kind == "self":
                return args[0]
            metas, single = self._seen[sig]
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device=META)
                    for shape, stride, dtype in metas]
            return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        self._seen[sig] = ([(t.shape, t.stride(), t.dtype)
                            for t in _flat(out)], single)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _flat(args) + _flat(tuple(kwargs.values()))
        out = self._call(func, args, kwargs, leaves)
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        outs = [t for t in _flat(out) if isinstance(t, torch.Tensor)]
        if func.overloadpacket in flop_registry:
            self.flops[str(ins[0].dtype).replace("torch.", "")] += \
                flop_registry[func.overloadpacket](*args, **kwargs,
                                                   out_val=out)
        if not (func.is_view or func in _ALLOCS):
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


def _step_cost(cfg, kind: str, seq: int, batch: int,
               enc_seq: int = None, mesh=None, optimized: bool = False
               ) -> dict:
    """The step of ``kind`` for ``cfg`` at ``batch`` rows of ``seq``
    tokens (an encoder-decoder model's encoder at ``enc_seq`` frames,
    default ``seq``), run once on ``meta`` under ``CostMode``: on one
    card, or with ``mesh`` (sizes, axes) rank 0's step over a
    ``CountingMesh`` of that shape (``_mesh_step``)."""
    model = build(cfg, device=META)
    params = model.init_shapes()
    spec = model.specs(kind, seq, batch, enc_seq)
    if mesh is not None:
        return _mesh_step(model, kind, seq, spec, mesh, optimized)
    opt_state = {}
    if kind == "train":
        opt = _adamw(cfg)
        opt_state = opt.init(params)
    parts = {"parameters": params, "optimizer": opt_state, "inputs": spec}
    mode = CostMode([t for tree in parts.values()
                     for t in tree_leaves(tree)])
    with mode:
        if kind == "train":
            batch_step(model, opt, params, opt_state, spec)
        else:
            with torch.no_grad():
                if kind == "prefill":
                    model.prefill(params, spec["batch"], spec["cache"])
                else:
                    model.decode_step(params, spec["batch"], spec["cache"],
                                      seq - 1)
    return {"flops": float(sum(mode.flops.values())),
            "flops_by_dtype": {k: float(v) for k, v in mode.flops.items()},
            "bytes": float(mode.bytes),
            "peak_bytes": float(sum(mode.resident.values())
                                + mode.peak_new),
            "resident_bytes": {k: float(_tree_bytes(v))
                               for k, v in parts.items()}}


def _adamw(cfg) -> AdamW:
    """The reference's optimizer: bfloat16 moments above 1.5e11
    parameters."""
    return AdamW(state_dtype="bfloat16" if cfg.total_params() > 1.5e11
                 else "float32")


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _mesh_step(model, kind, seq, spec, mesh, optimized) -> dict:
    """Rank 0's step over a ``CountingMesh`` of ``mesh`` = (sizes, axes),
    on ``meta`` under ``CostMode``, from rank 0's blocks (``localize``
    of the whole shapes): train ``launch/train.py::sharded_train_step``
    (parameter and moment blocks, the whole batch of which it cuts its
    block), prefill and decode ``launch/sharded_serve.py``'s steps
    (parameter and cache blocks), ``optimized`` their ``--opt`` routes.
    The resident bytes are the rank's blocks (the batch's too, and a
    decode's 0-d index), the reference's compiled argument bytes; the
    peak adds the storages the step makes over them."""
    cfg = model.cfg
    cm = CountingMesh(*mesh, device=META)
    params = model.init_shapes()

    def blocks(tree, named):
        return tree_map(lambda x, sh: cm.localize(x, sh.spec), tree, named)
    pb = blocks(params, to_named(param_specs(cfg, params, cm), cm))
    parts = {"parameters": pb, "optimizer": {}}
    inputs = spec if kind == "train" else spec["batch"]
    parts["inputs"] = blocks(inputs, to_named(batch_specs(cfg, inputs, cm),
                                              cm))
    if kind == "train":
        opt = _adamw(cfg)
        parts["optimizer"] = blocks(opt.init(params), to_named(
            opt_specs(cfg, params, cm), cm))
    else:
        c_named = to_named(cache_specs(cfg, spec["cache"], cm), cm)
        parts["inputs"] = {"batch": parts["inputs"],
                           "cache": blocks(spec["cache"], c_named)}
        if kind == "decode":
            parts["inputs"]["index"] = spec["index"]
    mode = CostMode([t for tree in (parts, inputs) for t in
                     tree_leaves(tree)])
    with mode:
        if kind == "train":
            sharded_train_step(model, opt, pb, parts["optimizer"], spec, cm)
        else:
            with torch.no_grad():
                step = sharded_prefill if kind == "prefill" else \
                    functools.partial(sharded_decode_step, index=seq - 1)
                step(model, pb, spec["batch"], parts["inputs"]["cache"],
                     mesh=cm, cache_shardings=c_named, optimized=optimized)
    resident = {k: float(_tree_bytes(v)) for k, v in parts.items()}
    return {"flops": float(sum(mode.flops.values())),
            "flops_by_dtype": {k: float(v) for k, v in mode.flops.items()},
            "bytes": float(mode.bytes),
            "peak_bytes": float(sum(resident.values()) + mode.peak_new),
            "resident_bytes": resident,
            "collective_bytes": {k: float(cm.collective_bytes.get(k, 0))
                                 for k in COLLECTIVES},
            "collective_counts": {k: float(cm.collective_counts.get(k, 0))
                                  for k in COLLECTIVES},
            "collective_bytes_by_link": {k: float(cm.link_bytes[k])
                                         for k in LINKS}}


# ---------------------------------------------------------------------------
# Depth and length extrapolation.  Each superblock runs the same ops, so
# the cost of depth-1 and depth-2 variants gives the per-period delta,
# extrapolated to the full depth; the xLSTM cells' loops over time are
# counted at LOOP_STEPS and 2 LOOP_STEPS steps and extrapolated to S.


def _depth_variant(cfg, k: int):
    """``k`` superblock periods (an encoder-decoder model: ``k`` encoder
    and ``k`` decoder layers).  Unlike the reference's, nothing is
    unrolled: eager counting sees every op."""
    if cfg.family == "encdec":
        return cfg.with_(n_layers=k, n_encoder_layers=k)
    return cfg.with_(n_layers=k * block_period(cfg))


def _n_periods(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.n_layers
    return cfg.n_layers // block_period(cfg)


def _ext(c1: dict, c2: dict, n: float) -> dict:
    """``c1 + (n - 1) (c2 - c1)`` on every number of a cost dict."""
    out = {}
    for k, a in c1.items():
        if isinstance(a, dict):
            out[k] = {d: a.get(d, 0.0) + (n - 1) * (c2[k].get(d, 0.0)
                                                    - a.get(d, 0.0))
                      for d in set(a) | set(c2[k])}
        else:
            out[k] = a + (n - 1) * (c2[k] - a)
    return out


def _loop_steps(cfg, kind: str, seq: int) -> bool:
    """Whether the cell's cost is counted at LOOP_STEPS and 2 LOOP_STEPS
    steps and extrapolated: the xLSTM family's loops over time at a
    length that is a multiple of LOOP_STEPS beyond 2 LOOP_STEPS."""
    return (cfg.family == "ssm" and kind != "decode"
            and seq > 2 * LOOP_STEPS and seq % LOOP_STEPS == 0)


def _counts(cfg, kind: str, seq: int, batch: int, enc_seq: int = None,
            mesh=None, optimized: bool = False):
    """The ``_step_cost`` arguments a cell's cost at this depth is made
    of: the step at ``seq``, or at LOOP_STEPS and 2 LOOP_STEPS."""
    if _loop_steps(cfg, kind, seq):
        return [(cfg, kind, n, batch, None, mesh, optimized)
                for n in (LOOP_STEPS, 2 * LOOP_STEPS)]
    return [(cfg, kind, seq, batch, enc_seq, mesh, optimized)]


def _count(args) -> dict:
    return _step_cost(*args)


def _cell_cost(cfg, kind: str, seq: int, batch: int,
               enc_seq: int = None, costs=None, mesh=None,
               optimized: bool = False) -> dict:
    """The cost at ``cfg``'s depth, from ``_counts``' step costs (``costs``
    if given, in their order)."""
    if costs is None:
        costs = list(map(_count, _counts(cfg, kind, seq, batch, enc_seq,
                                         mesh, optimized)))
    if _loop_steps(cfg, kind, seq):
        return _ext(*costs, seq // LOOP_STEPS)
    return costs[0]


def extrapolated_cost(cfg, kind: str, seq: int, batch: int,
                      enc_seq: int = None, pmap=map, mesh=None,
                      optimized: bool = False) -> dict:
    """FLOPs (by dtype), bytes and the peak of one step at the full
    depth, from the depth-1 and depth-2 variants; their step counts run
    through ``pmap`` (``map``, or a process pool's, all of them at
    once).  With ``mesh`` (sizes, axes): rank 0's step over a mesh of
    that shape, its collectives (bytes and counts under the reference's
    names, bytes by link) extrapolated with the rest."""
    n = _n_periods(cfg)
    variants = [_depth_variant(cfg, k) for k in (1, 2)]
    tasks = [_counts(v, kind, seq, batch, enc_seq, mesh, optimized)
             for v in variants]
    costs = iter(pmap(_count, tasks[0] + tasks[1]))
    out = _ext(*(_cell_cost(v, kind, seq, batch, enc_seq,
                            [next(costs) for _ in t])
                 for v, t in zip(variants, tasks)), n)
    out["transcendentals"] = 0.0
    loops = (f"; the loops over time counted at {LOOP_STEPS} and "
             f"{2 * LOOP_STEPS} steps, extrapolated to {seq}"
             if _loop_steps(cfg, kind, seq) else "")
    method = (
        "eager aten ops of the step on the meta device (CostMode): "
        "matmul-class FLOPs by dtype (torch.utils.flop_counter's "
        "formulas), each op's inputs and outputs once as bytes (eager "
        "traffic, not XLA's post-fusion count), the simulated allocator's "
        "peak; per-period differencing over depth-1/-2 variants, "
        f"extrapolated to {n} periods" + loops)
    if mesh is None:
        out["collective_bytes"] = {k: 0 for k in COLLECTIVES}
        out["collective_counts"] = {k: 0 for k in COLLECTIVES}
        out["collective_reason"] = NO_COLLECTIVES
        out["method"] = method
        return out
    for k in ("collective_bytes", "collective_counts",
              "collective_bytes_by_link"):
        out[k] = {d: int(round(v)) for d, v in out[k].items()}
    out["collective_reason"] = (
        f"rank 0 of {_mesh_tag(mesh)} counted by launch/mesh.py::"
        "CountingMesh: the result bytes of each all_gather, all_reduce "
        "and all_to_all its step issues, on the network where the call's "
        f"group spans nodes of {NODE_RANKS} cards, else on NVLink")
    out["method"] = (f"rank 0's step over a {_mesh_tag(mesh)} mesh "
                     + ("(--opt) " if optimized else "") + "from its "
                     "blocks; " + method)
    return out


def _mesh_tag(mesh) -> str:
    return "x".join(map(str, mesh[0]))


def lower_cell(arch, shape, multi_pod=False, *, seq=None, batch=None,
               enc_seq=None, pmap=map, mesh=None, optimized=False):
    """The dry-run report of (arch, shape) at ``arch``'s full config, or
    at another ``seq`` x ``batch`` of the shape's kind (an
    encoder-decoder model's encoder at ``enc_seq`` frames), its step
    counts through ``pmap``.

    On one card ("1xH100") without ``multi_pod``, ``mesh`` or
    ``optimized``.  Otherwise per device of a mesh: ``mesh`` (sizes,
    axes), or the production mesh, "2x16x16" with ``multi_pod``, else
    "16x16" (``MESHES``); rank 0's step over it, ``optimized`` the
    reference's ``--opt`` routes (the serving steps' expert-parallel MoE,
    sequence-sharded GQA cache and chunked prefill; the train step has
    no other route).  The memory estimate is the step's peak (over rank
    0's resident blocks on a mesh); ``fits_one_card`` compares it with
    the card's 80 GB."""
    if multi_pod or optimized or mesh is not None:
        mesh = mesh or MESHES["2x16x16" if multi_pod else "16x16"]
        mesh = (tuple(mesh[0]), tuple(mesh[1]))
    tag = MESH if mesh is None else _mesh_tag(mesh)
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": tag,
                "status": "skipped", "reason": why}
    s0, b0, kind = SHAPES[shape]
    seq, batch = seq or s0, batch or b0
    t0 = time.time()
    cost = extrapolated_cost(cfg, kind, seq, batch, enc_seq, pmap, mesh,
                             optimized)
    peak = cost.pop("peak_bytes")
    resident = cost.pop("resident_bytes")
    grads = 0.0
    if kind == "train":
        grads = resident["parameters"] if mesh is None else \
            float(_tree_bytes(build(cfg, device=META).init_shapes()))
    return {
        "arch": arch, "shape": shape, "mesh": tag, "status": "ok",
        **({"optimized": bool(optimized), "rank": 0} if mesh else {}),
        "count_s": round(time.time() - t0, 1),
        "cost_extrapolated": cost,
        # the resident parts before the step, the gradients (the whole
        # parameters' shapes and dtypes: the sharded step's DP-mean
        # gradient is whole) and the step's simulated peak, which holds
        # all of them with the activations
        "memory": {"parameter_bytes": resident["parameters"],
                   "gradient_bytes": grads,
                   "optimizer_bytes": resident["optimizer"],
                   "input_and_cache_bytes": resident["inputs"],
                   "peak_bytes": peak, "card_bytes": CARD_BYTES},
        "fits_one_card": peak <= CARD_BYTES,
        "total_params": cfg.total_params(),
        "active_params": cfg.active_params(),
        "seq": seq, "global_batch": batch, "kind": kind,
        **({"enc_seq": enc_seq} if enc_seq else {}),
    }


def _report(cell, **kw) -> dict:
    """``lower_cell`` of (arch, shape) with ``kw`` (its ``seq``, ``batch``,
    ``enc_seq``, ``pmap``, ``mesh``, ``optimized``), or its failure as a
    report."""
    arch, shape = cell
    try:
        return lower_cell(arch, shape, **kw)
    except Exception as e:
        return {"arch": arch, "shape": shape, "mesh": _tag_of(kw),
                "status": "FAILED", "error": str(e)[-2000:],
                "traceback": traceback.format_exc()[-4000:]}


def _tag_of(kw) -> str:
    """The mesh tag of ``main``'s keywords to ``lower_cell``."""
    return _mesh_tag(kw["mesh"]) if kw.get("mesh") else MESH


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry-run of the port: each (arch x shape) cell's step "
                    "on the meta device, on one H100 or per device of a "
                    "production mesh, with its FLOPs, bytes, collectives "
                    "and memory peak for roofline/analysis.py.")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) cells")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the cells' step counts "
                         "(a cell has 2 or 4, counted at once)")
    ap.add_argument("--seq", type=int, default=None,
                    help="with --arch and --shape: this many tokens in "
                         "place of the shape's")
    ap.add_argument("--batch", type=int, default=None,
                    help="with --arch and --shape: this many rows in "
                         "place of the shape's")
    ap.add_argument("--enc-seq", type=int, default=None,
                    help="with --arch and --shape: an encoder-decoder "
                         "model's encoder frames (default --seq)")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default=MESH, choices=[MESH] + list(MESHES),
                    help="one card (default), or per device of the 16x16 "
                         "or 2x16x16 production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="per device of the 2x16x16 mesh over (pod, data, "
                         "model): --mesh 2x16x16")
    ap.add_argument("--opt", action="store_true",
                    help="the distributed layer paths (the expert-parallel "
                         "MoE, the sequence-sharded GQA cache, chunked "
                         "prefill) per device of a mesh (16x16 unless "
                         "--multi-pod or --mesh says otherwise)")
    args = ap.parse_args(argv)
    if args.multi_pod and args.mesh not in (MESH, "2x16x16"):
        ap.error("--multi-pod is --mesh 2x16x16")
    tag = "2x16x16" if args.multi_pod else args.mesh
    if args.opt and tag == MESH:
        tag = "16x16"
    if args.all:
        # the xLSTM loops' cells take longest: start them first
        cells = sorted(((a, s) for a in ARCH_IDS for s in SHAPES),
                       key=lambda c: get_config(c[0]).family != "ssm")
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    dims = {k: v for k, v in (("seq", args.seq), ("batch", args.batch),
                              ("enc_seq", args.enc_seq)) if v}
    if dims and args.all:
        ap.error("--seq, --batch and --enc-seq take one cell, not --all")
    kw = dict(dims)
    if tag != MESH:
        kw.update(mesh=MESHES[tag], optimized=args.opt)

    os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    with contextlib.ExitStack() as stack:
        if args.jobs == 1:
            reports = map(functools.partial(_report, **kw), cells)
        else:
            # cells in threads, their step counts in the processes: the
            # longest cell takes its longest count's time
            procs = stack.enter_context(
                multiprocessing.get_context("spawn").Pool(args.jobs))
            threads = stack.enter_context(ThreadPool(args.jobs))
            reports = threads.imap_unordered(
                functools.partial(_report, pmap=procs.map, **kw), cells)
        for rep in reports:
            # the reference's tags on a mesh: {arch}_{shape}_16x16[_opt]
            tag_ = "_".join([rep["arch"], rep["shape"]]
                            + [f"{k}{v}" for k, v in dims.items()] + [tag]
                            + (["opt"] if args.opt else []))
            with open(os.path.join(args.out_dir, tag_ + ".json"), "w") as f:
                json.dump(rep, f, indent=1)
            extra = ""
            if rep["status"] == "ok":
                c = rep["cost_extrapolated"]
                extra = (f"count={rep['count_s']}s flops={c['flops']:.3g} "
                         f"bytes={c['bytes']:.3g} peak="
                         f"{rep['memory']['peak_bytes'] / 1e9:.1f}GB "
                         f"fits_one_card={rep['fits_one_card']}")
                if tag != MESH:
                    extra += (" collective="
                              f"{sum(c['collective_bytes'].values()):.3g}B")
            failures += rep["status"] == "FAILED"
            print(f"[{rep['status']:>7s}] {tag_} {extra}", flush=True)
    print(f"done: {len(cells)} cells, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
