"""Rank bodies for the model programs over a ``GroupMesh``
(``tests/test_torch_group_model.py``): the float collectives, the
expert-parallel MoE, the sequence-sharded rollout, the sharded training
step and ``train(mesh=...)``.

``launch.mesh.spawn`` starts each rank in a fresh interpreter that
imports its function by name, so the bodies live here, in a module that
imports torch, numpy and the port only (no JAX, no pytest).  Each program
is one function of a mesh: a rank calls it with its ``GroupMesh``, the
parent with a ``LocalMesh`` of the same shape, on the same seeded inputs
(numpy seeds and the port's seeded init, the same numbers in every
process); a rank keeps only its blocks and returns numpy arrays.
"""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import GroupMesh, LocalMesh, P
from repro_torch.launch.sharding import (opt_specs, param_spec,
                                         param_specs, to_named)
from repro_torch.launch.train import (sharded_loss_and_grads,
                                      sharded_train_step, train)
from repro_torch.models import dist
from repro_torch.models import layers as L
from repro_torch.models.api import build
from repro_torch.train.optimizer import AdamW
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

# where the programs run: the CPU, or (tests/test_torch_group_model_cuda.py)
# the card, which the ranks then share
DEVICE = "cpu"
AXES = ("data", "model")
MOE, ROLL, DENSE = "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", \
    "qwen3-1.7b"
# the rollout: cache_specs splits the sequence over "model" from 128
# positions, so 60 prefill and 8 decode steps into 128 slots: the steps
# at 64-67 write into the second S-slice and merge both ranks' partials
T, K, B, SMAX = 60, 8, 4, 128
STEPS = 3                          # sharded steps
TRAIN = dict(arch=DENSE, batch_size=4, seq_len=16, ckpt_every=2,
             quiet=True, device="cpu")


def group(shape):
    return GroupMesh(shape, AXES, backend="gloo", device=DEVICE)


def local(shape):
    return LocalMesh(shape, AXES, device=DEVICE)


def _np(x):
    return x.detach().float().cpu().numpy()


# ------------------------------------------------------------ float sums
def float_inputs():
    """Per-shard float32 values over six decades, so the order of a sum
    shows in its last bits."""
    rng = np.random.default_rng(11)
    mag = 10.0 ** rng.uniform(-3, 3, (4, 3, 5))
    return (rng.normal(size=(4, 3, 5)) * mag).astype(np.float32)


def float_sums(mesh, r):
    """psum and pmean over each axis and both, in float32 and bf16, and
    bf16's pmax, on shard ``r``'s row (every row on a ``LocalMesh``: ``r``
    None)."""
    x = torch.from_numpy(float_inputs())
    out = {}
    for name, v in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        mine = v if r is None else v[r:r + 1]
        for ax in ("data", "model", AXES):
            tag = ax if isinstance(ax, str) else "both"
            for op in ("psum", "pmean"):
                got = getattr(mesh, op)(mine, ax)
                assert got.dtype == v.dtype
                out[f"{op}_{name}_{tag}"] = _np(got)
        out[f"pmax_{name}_model"] = _np(mesh.pmax(mine, "model"))
    return out


# ------------------------------------------------------------ the MoE
def moe_inputs():
    cfg = get_config(MOE, smoke=True)
    p = L.init_moe(cfg, torch.Generator().manual_seed(0))
    x = np.random.default_rng(1).normal(size=(4, 8, cfg.d_model))
    return cfg, tree_map(lambda t: t.to(DEVICE), p), \
        torch.from_numpy(x.astype(np.float32)).to(DEVICE)


def moe(mesh):
    """The MoE sublayer on ``mesh``: the process holds the rows of its DP
    block and its experts (``P("model", ...)``), the router whole."""
    cfg, p, x = moe_inputs()
    ex = P("model", None, None)
    held = {k: mesh.localize(v, ex) if k in ("wg", "wu", "wd") else v
            for k, v in p.items()}
    rows = mesh.localize(x, P("data", None, None))
    dist.set_mesh(mesh)
    try:
        out, aux = L.moe_forward(cfg, held, rows)
    finally:
        dist.set_mesh(None)
    return {"out": _np(out), "aux": _np(aux),
            "experts_held": np.asarray([held[k].numel()
                                        for k in ("wg", "wu", "wd")])}


def expert_specs(params, mesh):
    """What a rank holds of the parameters to serve over a mesh (the
    expert-parallel MoE, the sequence-sharded decode): the MoE's expert
    stacks (the 4-D ``ffn`` leaves wg, wu, wd) as ``param_specs`` splits
    them over "model", every other leaf whole (``P()``)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, path + (str(i),))
                              for i, v in enumerate(tree))
        expert = "ffn" in path and tree.ndim >= 4 and \
            path[-1] in ("wg", "wu", "wd")
        return param_spec(path, tuple(tree.shape), mesh) if expert else P()
    return walk(params, ())


# ------------------------------------------------------------ the rollout
def rollout_tokens(cfg):
    return torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, T + K)).astype(np.int64))


def rollout(mesh):
    """llama4-maverick's smoke config: a T-token prefill and K decode
    steps into SMAX slots.  With a mesh the process holds its DP block of
    the batch, its experts (``expert_specs``) and its cache block
    (``Model.init_cache``: the DP block's S-slice on a ``GroupMesh``),
    under ``dist.optimized()``; without one, the unsharded rollout."""
    cfg = get_config(ROLL, smoke=True)
    m = build(cfg, device="cpu")
    params = m.init(seed=0)
    toks = rollout_tokens(cfg)
    if mesh is not None:
        named = to_named(expert_specs(params, mesh), mesh)
        params = tree_map(lambda x, sh: mesh.localize(x, sh.spec), params,
                          named)
        toks = mesh.localize(toks, P("data", None))
    dist.set_mesh(mesh)
    dist.set_optimized(mesh is not None)
    try:
        cache = m.init_cache(toks.shape[0], SMAX)
        lg, cache = m.prefill(params, {
            "tokens": toks[:, :T],
            "positions": torch.arange(T, dtype=torch.int32)}, cache)
        got = [lg]
        for t in range(T, T + K):
            lg, cache = m.decode_step(params, {
                "tokens": toks[:, t:t + 1],
                "positions": torch.tensor([t], dtype=torch.int32)},
                cache, t)
            got.append(lg)
    finally:
        dist.set_mesh(None)
        dist.set_optimized(False)
    experts = [x.numel() for path, x in tree_leaves_with_path(params)
               if path[-1] in ("wg", "wu", "wd") and x.ndim == 4]
    return {"logits": np.stack([_np(g) for g in got]),
            "cache_held": np.asarray([x.numel() for x in
                                      tree_leaves(cache)]),
            "experts_held": np.asarray(experts)}


def spec_leaves(tree):
    """A spec tree's PartitionSpecs in leaf order (a spec is a tuple, so
    the tree helpers would walk into it)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return [x for t in tree for x in spec_leaves(t)]
    return [tree]


# ------------------------------------------------------------ the step
def step_inputs():
    cfg = get_config(DENSE, smoke=True)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 17))
    toks = torch.from_numpy(toks.astype(np.int64)).to(DEVICE)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "positions": torch.arange(16, dtype=torch.int32,
                                       device=DEVICE)}
    return build(cfg, device=DEVICE), batch


def sharded_step(mesh):
    """qwen3-1.7b's smoke config over ``mesh``: the loss and whole
    gradients of the sharded step, then STEPS steps of
    ``sharded_train_step`` from the process's blocks (``param_specs``,
    ``opt_specs``).  Returns the loss, the gradient leaves, each step's
    loss and gnorm, and the blocks held after the steps."""
    model, batch = step_inputs()
    cfg = model.cfg
    params = tree_map(lambda t: t.to(DEVICE), build(cfg, device="cpu")
                      .init(seed=0))
    opt = AdamW()
    state = opt.init(params)
    p_named = to_named(param_specs(cfg, params, mesh), mesh)
    o_named = to_named(opt_specs(cfg, params, mesh), mesh)
    pb = tree_map(lambda x, sh: mesh.localize(x, sh.spec), params, p_named)
    ob = tree_map(lambda x, sh: mesh.localize(x, sh.spec), state, o_named)
    del params, state
    loss, grads = sharded_loss_and_grads(model, pb, batch, mesh)
    out = {"loss": _np(loss), "losses": [], "gnorms": []}
    for i, g in enumerate(tree_leaves(grads)):
        out[f"grad{i}"] = _np(g)
    for _ in range(STEPS):
        pb, ob, lo, gn = sharded_train_step(model, opt, pb, ob, batch, mesh)
        out["losses"].append(float(lo))
        out["gnorms"].append(float(gn))
    for i, x in enumerate(tree_leaves(pb)):
        out[f"param{i}"] = _np(x)
    for k in ("m", "v"):
        for i, x in enumerate(tree_leaves(ob[k])):
            out[f"{k}{i}"] = _np(x)
    out["step"] = int(ob["step"])
    out["losses"], out["gnorms"] = (np.asarray(out[k])
                                    for k in ("losses", "gnorms"))
    return out


# ------------------------------------------------------------ refusals
def refusals(mesh):
    """What a program over ``mesh`` (a ``GroupMesh``) cannot lay out or
    move raises, on every rank before any collective: {case: the
    exception's type name, or "" if nothing was raised}."""
    out = {}

    def caught(name, fn):
        try:
            fn()
            out[name] = ""
        except (ValueError, TypeError) as e:
            out[name] = type(e).__name__

    dist.set_mesh(mesh)
    dist.set_optimized(True)
    try:
        for arch in ("xlstm-350m", "minicpm3-4b", "seamless-m4t-medium"):
            m = build(get_config(arch, smoke=True), device=DEVICE)
            caught(f"cache_{arch}", lambda: m.init_cache(2, SMAX))
        m = build(get_config(ROLL, smoke=True), device=DEVICE)
        # 15 positions do not split into the "model" axis' 2 S-slices
        caught("cache_15_positions", lambda: m.init_cache(2, 15))
        cfg, p, x = moe_inputs()
        caught("moe_whole_experts", lambda: L.moe_forward(
            cfg, p, mesh.localize(x, P("data", None, None))))
    finally:
        dist.set_mesh(None)
        dist.set_optimized(False)
    caught("all_reduce_bf16",
           lambda: mesh.sum_ranks(torch.ones(2, dtype=torch.bfloat16)))
    return out


# ------------------------------------------------------------ rank bodies
def rank_models(rank, world, ckpt):
    """Every program of the file on this rank: the float sums and the
    MoE on (2, 2) and (1, 4), the rollout and the sharded step on
    (2, 2), then ``train`` on (2, 2) for 2 steps into ``ckpt``."""
    m22, m14 = group((2, 2)), group((1, 4))
    out = {"coords": np.asarray([m22.my_coords[a] for a in AXES])}
    for k, v in float_sums(m22, rank).items():
        out[f"sum_{k}"] = v
    for tag, mesh in (("22", m22), ("14", m14)):
        for k, v in moe(mesh).items():
            out[f"moe{tag}_{k}"] = v
    for k, v in rollout(m22).items():
        out[f"roll_{k}"] = v
    for k, v in sharded_step(m22).items():
        out[f"step_{k}"] = v
    out["refusals"] = refusals(m22)
    out["train"] = np.asarray(train(steps=2, ckpt_dir=ckpt, mesh=m22,
                                    **TRAIN))
    return out


def rank_resume(rank, world, ckpt):
    """``train`` on (1, 2) to 4 steps from the newest checkpoint in
    ``ckpt`` (written by (2, 2))."""
    return np.asarray(train(steps=4, ckpt_dir=ckpt, mesh=group((1, 2)),
                            **TRAIN))
