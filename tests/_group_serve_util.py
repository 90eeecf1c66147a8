"""Rank bodies for the sharded serving steps over a ``GroupMesh``
(``tests/test_torch_group_serve.py``): ``launch/sharded_serve.py``'s
prefill and decode steps, baseline and ``optimized``, and the transport
of ``launch/train.py::sharded_train_step``.

``launch.mesh.spawn`` starts each rank in a fresh interpreter that
imports its function by name, so the bodies live here, in a module that
imports torch, numpy and the port only (no JAX, no pytest).  Each program
is one function of a mesh: a rank calls it with its ``GroupMesh``, the
parent with a ``LocalMesh`` of the same shape (the yardstick) and with a
``CountingMesh`` of each rank on the ``meta`` device (the count), on the
same seeded inputs.
"""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import GroupMesh
from repro_torch.launch.sharded_serve import (cache_shardings,
                                              sharded_decode_step,
                                              sharded_prefill)
from repro_torch.launch.sharding import opt_specs, param_specs, to_named
from repro_torch.launch.train import sharded_train_step
from repro_torch.models.api import build
from repro_torch.train.optimizer import AdamW
from repro_torch.tree import tree_leaves, tree_map

AXES = ("data", "model")
SHAPE = (2, 2)
# dense, experts (the expert-parallel MoE under ``optimized``) and MLA
# (a cache served whole under ``optimized``)
ARCHS = ("qwen3-1.7b", "llama4-maverick-400b-a17b", "minicpm3-4b")
# a T-token prefill into SMAX slots (cache_specs splits S over "model"
# from 128 positions), then K decode steps: the one at 63 writes into the
# first S-slice, the one at 64 into the second
B, T, K, SMAX = 4, 63, 2, 128


def tokens(cfg):
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T + K))
                            .astype(np.int64))


def _transport(mesh):
    return {k: (v["calls"], v["bytes"])
            for k, v in getattr(mesh, "transport", {}).items()}


def _delta(mesh, before):
    return {k: (c - before.get(k, (0, 0))[0], b - before.get(k, (0, 0))[1])
            for k, (c, b) in _transport(mesh).items()
            if c > before.get(k, (0, 0))[0]}


def _blocks(mesh, tree, named):
    return tree_map(lambda x, sh: mesh.localize(x, sh.spec), tree, named)


def serve(mesh, arch, optimized):
    """``arch``'s smoke config over ``mesh``: a T-token prefill and K
    decode steps from the process's blocks (the seeded parameters under
    ``param_specs``, a zero cache under ``cache_shardings``), the batch
    whole.  On ``meta`` (a ``CountingMesh``) only the transport counts.
    Returns every call's whole logits, the cache blocks held after the
    last call and each call's transport (calls, bytes by kind)."""
    dev = mesh.device
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device=dev)
    params = model.init_shapes() if dev.type == "meta" else model.init(0)
    toks = tokens(cfg).to(dev)
    pb = _blocks(mesh, params, to_named(param_specs(cfg, params, mesh),
                                        mesh))
    named = cache_shardings(model, mesh, B, SMAX)
    cb = _blocks(mesh, model.init_cache(B, SMAX), named)
    del params
    kw = dict(cache_shardings=named, optimized=optimized)
    before = _transport(mesh)
    lg, cb = sharded_prefill(model, pb, {
        "tokens": toks[:, :T],
        "positions": torch.arange(T, dtype=torch.int32, device=dev)},
        cb, mesh, **kw)
    logits, calls = [lg], [_delta(mesh, before)]
    for t in range(T, T + K):
        before = _transport(mesh)
        lg, cb = sharded_decode_step(model, pb, {
            "tokens": toks[:, t:t + 1],
            "positions": torch.tensor([t], dtype=torch.int32, device=dev)},
            cb, t, mesh, **kw)
        logits.append(lg)
        calls.append(_delta(mesh, before))
    if dev.type == "meta":
        return {"calls": calls}
    return {"logits": np.stack([x[:, -1].float().numpy() for x in logits]),
            "cache": [x.float().numpy() for x in tree_leaves(cb)],
            "calls": calls}


def train_transport(mesh):
    """One ``sharded_train_step`` of qwen3-1.7b's smoke config over
    ``mesh`` at 4 x 16 tokens, from the process's blocks: its transport
    and, off ``meta``, the loss."""
    dev = mesh.device
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build(cfg, device=dev)
    params = model.init_shapes() if dev.type == "meta" else model.init(0)
    opt = AdamW()
    pb = _blocks(mesh, params, to_named(param_specs(cfg, params, mesh),
                                        mesh))
    ob = _blocks(mesh, opt.init(params), to_named(opt_specs(cfg, params,
                                                            mesh), mesh))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int64)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "positions": torch.arange(16, dtype=torch.int32, device=dev)}
    before = _transport(mesh)
    _, _, loss, _ = sharded_train_step(model, opt, pb, ob, batch, mesh)
    return {"calls": _delta(mesh, before),
            "loss": None if dev.type == "meta" else float(loss)}


def rank_serve(rank, world):
    """Every program of the file on this rank of a (2, 2) GroupMesh."""
    mesh = GroupMesh(SHAPE, AXES, backend="gloo", device="cpu")
    out = {"coords": dict(mesh.my_coords), "train": train_transport(mesh)}
    for arch in ARCHS:
        for opt in (False, True):
            out[arch, opt] = serve(mesh, arch, opt)
    return out
