"""End-to-end training driver with fault tolerance
(``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --steps 4

  * data from the ReStore-backed pipeline (``train/data.py``: repeated
    runs reuse its stages);
  * each step is ``train_step``: the loss, ``backward()`` (attention's
    gradient through the backward kernel on the card; the recurrent
    families' loops over time by autograd, in chunks under ``cfg.remat``,
    ``models/ssm.py``) and ``AdamW.update``;
  * atomic checkpoints every ``--ckpt-every`` steps; on start, resume
    from the newest valid checkpoint and skip the data stream ahead
    (deterministic batcher => exact-once sample consumption);
  * ``--simulate-failure N`` kills the process at step N (exit code 17);
  * runs on the card unless ``--device cpu`` (or ``device="cpu"``) asks
    for the CPU;
  * ``train(mesh=...)`` runs ``sharded_train_step`` over a mesh (the
    ranks of a ``GroupMesh``, or a ``LocalMesh``'s logical shards): a
    rank holds its blocks of the parameters and moments between steps,
    checkpoints them with their shardings, and resumes onto the blocks of
    whatever mesh it runs on (the reference's "checkpoints are
    mesh-agnostic, restore re-shards").

The sharded step (the reference's jitted step with ``in_shardings`` and
``out_shardings``, ``src/repro/launch/dryrun.py``): each parameter leaf
is gathered whole over the axes its ``param_specs`` entry names, the
whole model runs on the shard's DP block of the batch (``batch_specs``),
the gradients are averaged over the DP axes by the mesh's exact
``pmean``, the global norm is summed from the moment blocks (each
element once), and each shard updates its moment blocks (``opt_specs``,
ZeRO-1) and the parameter elements they cover, then gathers its
parameter block over the DP axes the moments add.  Every rank sees the
same view of the model: its DP block, every weight whole; tensor-
parallel compute is not done, and the MoE takes its one-device dispatch
inside the step, its capacity from the DP block's tokens, as the
expert-parallel path computes it.

The model is the smoke config of ``--arch``, as in the reference, or at
``--scale 100`` its "100m" preset (12 layers, d_model 640, vocab 32768).
Parameters come from ``Model.init(seed=0)``, a torch generator, so they
are not the reference's numbers; the data are.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs import ARCH_IDS, get_config
from ..core.restore import ReStore
from ..device import resolve
from ..models import dist
from ..models.api import build
from ..store.artifacts import ArtifactStore, Catalog
from ..train.checkpoint import latest_step, restore_checkpoint, \
    save_checkpoint
from ..train.data import batches_from_table, run_pipeline, synthetic_corpus
from ..train.optimizer import AdamW
from ..tree import tree_flatten, tree_leaves, tree_leaves_with_path, \
    tree_map, tree_unflatten
from .mesh import PartitionSpec as P, dp_axes
from .sharding import batch_specs, model_shardings, to_named

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train_step(model, opt: AdamW, params, opt_state, tokens, labels):
    """One training step on ``tokens``/``labels`` ((B, S) int tensors on
    the model's device): loss -> ``backward()`` -> ``opt.update``.  The
    parameters and moments are updated in place; returns (params,
    opt_state, loss, gnorm) with loss and gnorm as 0-d float32 tensors."""
    batch = {"tokens": tokens, "labels": labels,
             "positions": torch.arange(tokens.shape[1], dtype=torch.int32,
                                       device=tokens.device)}
    return batch_step(model, opt, params, opt_state, batch)


def batch_step(model, opt: AdamW, params, opt_state, batch):
    """``train_step`` on a whole batch as ``Model.loss_fn`` takes it (an
    encoder-decoder model's ``enc_embeds``, ``enc_positions``, ``tokens``,
    ``positions`` and ``labels``, say)."""
    loss, grads = loss_and_grads(model, params, batch)
    params, opt_state, gnorm = opt.update(grads, opt_state, params)
    return params, opt_state, loss, gnorm


def loss_and_grads(model, params, batch):
    """(loss, gradient tree) of ``Model.loss_fn`` at ``params``:
    ``backward()`` of the total (the loss plus the MoE's weighted aux),
    every leaf's gradient taken and cleared."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    total, (loss, _aux) = model.loss_fn(params, batch)
    total.backward()
    if model.cfg.frontend == "embeds" and params["embed"].grad is None:
        # the embeddings frontend leaves the table unused: its gradient
        # is zero, as JAX's autodiff gives the reference's
        params["embed"].grad = torch.zeros_like(params["embed"])
    missing = ["/".join(map(str, path))
               for path, p in tree_leaves_with_path(params) if p.grad is None]
    if missing:
        raise RuntimeError(f"no gradient reached {missing}")
    grads = tree_map(lambda p: p.grad, params)
    for p in leaves:
        p.grad = None
    return loss.detach(), grads


def _layout(model, mesh, batch):
    """The shardings of the step's parameters, moments and batch over
    ``mesh`` (``param_specs``, ``opt_specs``, ``batch_specs`` of the
    whole shapes), as ``NamedSharding`` trees."""
    return model_shardings(model, mesh) + (
        None if batch is None else
        to_named(batch_specs(model.cfg, batch, mesh), mesh),)


def _dp_blocks(mesh):
    """The coordinates of the DP blocks this process computes: the rank's
    own on a ``GroupMesh``; on a ``LocalMesh`` one shard per DP block
    (its other coordinates 0), since the shards of a DP block compute
    the same whole-weight model."""
    if mesh.spans_processes:
        return [mesh.my_coords]
    dp = dp_axes(mesh)
    return [c for c in mesh.coords()
            if all(c[a] == 0 for a in mesh.axis_names if a not in dp)]


def _dp_mean(mesh, blocks, values):
    """The mean over the DP axes of one value per DP block (``values`` in
    ``blocks``' order), by the mesh's ``pmean``: on a ``GroupMesh`` this
    rank's row, on a ``LocalMesh`` every shard's row stacked by its DP
    block; the rows agree, the first is returned."""
    dp = dp_axes(mesh)
    if not dp:
        return values[0]
    if mesh.spans_processes:
        return mesh.pmean(values[0][None], dp)[0]
    at = {tuple(c[a] for a in dp): v for c, v in zip(blocks, values)}
    stack = torch.stack([at[tuple(c[a] for a in dp)] for c in mesh.coords()])
    return mesh.pmean(stack, dp)[0]


def sharded_loss_and_grads(model, param_blocks, batch, mesh):
    """The sharded step's (loss, whole gradient tree), the loss and every
    gradient leaf averaged over the DP axes (``pmean``, exact: the same
    bits on every rank and on a ``LocalMesh`` of the mesh's shape).
    ``param_blocks`` are what the process holds under ``param_specs``,
    ``batch`` the whole batch (each shard takes its ``batch_specs``
    block).  The model runs with no mesh set: every leaf whole, on one
    DP block at a time."""
    p_named, _, b_named = _layout(model, mesh, batch)
    leaves, pdef = tree_flatten(param_blocks)
    whole = [mesh.globalize(x, sh.spec)
             for x, sh in zip(leaves, tree_leaves(p_named))]
    params = tree_unflatten(pdef, whole)
    blocks = _dp_blocks(mesh)
    prev = dist.get_mesh()
    dist.set_mesh(None)
    try:
        per = [loss_and_grads(model, params, {
            k: mesh.block(v, b_named[k].spec, c) for k, v in batch.items()})
            for c in blocks]
    finally:
        dist.set_mesh(prev)
    loss = _dp_mean(mesh, blocks, [lo for lo, _ in per])
    flat = [tree_leaves(g) for _, g in per]
    grads = [_dp_mean(mesh, blocks, [f[i] for f in flat])
             for i in range(len(leaves))]
    return loss, tree_unflatten(pdef, grads)


def _extra(mspec: P, pspec: P) -> P:
    """The entries a moment spec adds to its parameter's (ZeRO-1's DP
    axes on a dim the parameter keeps whole)."""
    pad = list(pspec) + [None] * (len(mspec) - len(pspec))
    return P(*(m if m != q else None for m, q in zip(mspec, pad)))


def sharded_train_step(model, opt: AdamW, param_blocks, opt_blocks, batch,
                       mesh):
    """One training step over ``mesh``, blocks in and blocks out: the
    port's counterpart of the reference's step jitted with
    ``in_shardings=(p_shard, o_shard, b_shard)`` and ``out_shardings=
    (p_shard, o_shard, ...)`` (``src/repro/launch/dryrun.py``).

    ``param_blocks`` and ``opt_blocks`` are what the process holds under
    ``param_specs`` and ``opt_specs`` (a rank's blocks on a ``GroupMesh``,
    whole on a ``LocalMesh``), ``batch`` the whole batch: the gradients
    of ``sharded_loss_and_grads``, then ``sharded_update``.  Returns
    (param_blocks, opt_blocks, loss, gnorm), the blocks updated in
    place."""
    loss, grads = sharded_loss_and_grads(model, param_blocks, batch, mesh)
    params, state, gnorm = sharded_update(model, opt, param_blocks,
                                          opt_blocks, grads, mesh)
    return params, state, loss, gnorm


def sharded_update(model, opt: AdamW, param_blocks, opt_blocks, grads,
                   mesh):
    """The sharded step's update from the whole DP-mean ``grads``: the
    global norm sums each moment block's squares once (on the shard at
    coordinate 0 of every axis its spec leaves out) over the mesh
    (``psum``), so a block held by several shards counts once; each
    shard updates its moment blocks and the parameter elements they cover
    (``AdamW.apply``, the one-device arithmetic), then gathers its
    parameter block over the DP axes the moment spec adds.  Returns
    (param_blocks, opt_blocks, gnorm)."""
    p_named, o_named, _ = _layout(model, mesh, None)
    g_leaves = tree_leaves(grads)
    p_leaves = tree_leaves(param_blocks)
    m_leaves, v_leaves = (tree_leaves(opt_blocks[k]) for k in ("m", "v"))
    p_specs = [sh.spec for sh in tree_leaves(p_named)]
    m_specs = [sh.spec for sh in tree_leaves(o_named["m"])]
    with torch.no_grad():
        # the global norm: each element of the whole gradient once
        local = mesh.local_coords()
        sq = []
        for c in local:
            acc = torch.zeros((), device=g_leaves[0].device)
            for g, ms in zip(g_leaves, m_specs):
                named = {a for e in ms if e is not None
                         for a in ((e,) if isinstance(e, str) else e)}
                if all(c[a] == 0 for a in mesh.axis_names if a not in named):
                    acc = acc + torch.sum(torch.square(
                        mesh.block(g, ms, c).float()))
            sq.append(acc)
        gnorm = torch.sqrt(mesh.psum(torch.stack(sq), mesh.axis_names)[0])
        if not mesh.spans_processes:
            return opt.apply(grads, opt_blocks, param_blocks, gnorm)
        me = mesh.my_coords
        extra = [_extra(ms, ps) for ms, ps in zip(m_specs, p_specs)]
        g_sub = [mesh.block(g, ms, me) for g, ms in zip(g_leaves, m_specs)]
        p_sub = [mesh.block(p, ex, me)
                 for p, ex in zip(p_leaves, extra)]
        _, state, gnorm = opt.apply(
            g_sub, {"m": m_leaves, "v": v_leaves, "step": opt_blocks["step"]},
            p_sub, gnorm)
        for p, sub, ex in zip(p_leaves, p_sub, extra):
            if any(e is not None for e in ex):
                p.copy_(mesh.globalize(sub, ex))
    return param_blocks, {"m": opt_blocks["m"], "v": opt_blocks["v"],
                          "step": state["step"]}, gnorm


def train(arch: str = "qwen3-1.7b", steps: int = 50, batch_size: int = 8,
          seq_len: int = 64, lr: float = 3e-4, ckpt_every: int = 10,
          ckpt_dir: str = DEFAULT_CKPT_DIR, simulate_failure: int = -1,
          scale: float = 1.0, log_every: int = 5, data_dir=None,
          quiet: bool = False, device=None, mesh=None):
    """Train ``steps`` steps (resuming from the newest checkpoint in
    ``ckpt_dir``); returns the losses of the steps this call ran.  With
    ``mesh`` each step is ``sharded_train_step`` on the process's blocks
    (on the mesh's device), saved with their shardings and resumed onto
    this mesh's blocks whatever mesh saved them."""
    dev = resolve(device) if mesh is None else mesh.device
    cfg = get_config(arch, smoke=True)
    if scale == 100.0:  # "100m" preset: a genuine ~100M-param model
        cfg = cfg.with_(n_layers=12, d_model=640, n_heads=10,
                        n_kv_heads=5, head_dim=64, d_ff=2560,
                        vocab_size=32768)
    elif scale != 1.0:
        cfg = cfg.with_(d_model=int(cfg.d_model * scale),
                        d_ff=int(cfg.d_ff * scale),
                        vocab_size=max(cfg.vocab_size, 8192))
    model = build(cfg, device=dev)
    opt = AdamW(lr=lr)

    # ---- data through the ReStore pipeline --------------------------------
    store = ArtifactStore(root=data_dir, device=dev)
    catalog = Catalog(store, device=dev)
    restore = ReStore(catalog, store, heuristic="aggressive", device=dev)
    corpus = synthetic_corpus(n_docs=256, seq_len=seq_len + 1,
                              vocab=cfg.vocab_size, device=dev)
    catalog.register("corpus", corpus)
    table, report = run_pipeline(restore, corpus)
    if not quiet:
        print(f"pipeline: {report.n_executed} executed, "
              f"{report.n_reused} artifacts reused")
    batches = batches_from_table(table, batch_size, seq_len)

    # ---- init or resume ----------------------------------------------------
    params = model.init(seed=0)
    opt_state = opt.init(params)
    shardings = None
    if mesh is not None:
        p_named, o_named, _ = _layout(model, mesh, None)
        shardings = (p_named, o_named)
    start_step = 0
    last = latest_step(ckpt_dir)
    if last is not None:
        (params, opt_state), manifest = restore_checkpoint(
            ckpt_dir, last, (params, opt_state), shardings)
        start_step = manifest["step"]
        if not quiet:
            print(f"resumed from checkpoint step {start_step}")
    elif mesh is not None:
        params, opt_state = (tree_map(
            lambda x, sh: mesh.localize(x, sh.spec), t, named)
            for t, named in ((params, p_named), (opt_state, o_named)))
    for _ in range(start_step):          # deterministic skip-ahead
        next(batches)

    losses = []
    for step in range(start_step, steps):
        tokens, labels = next(batches)
        t0 = time.time()
        tokens = torch.from_numpy(tokens).to(dev)
        labels = torch.from_numpy(labels).to(dev)
        if mesh is None:
            params, opt_state, loss, gnorm = train_step(
                model, opt, params, opt_state, tokens, labels)
        else:
            params, opt_state, loss, gnorm = sharded_train_step(
                model, opt, params, opt_state,
                {"tokens": tokens, "labels": labels,
                 "positions": torch.arange(tokens.shape[1],
                                           dtype=torch.int32, device=dev)},
                mesh)
        loss = float(loss)
        losses.append(loss)
        if not quiet and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:4d} loss {loss:7.4f} gnorm {float(gnorm):6.2f}"
                  f" {time.time() - t0:5.2f}s")
        if (step + 1) % ckpt_every == 0 or step == steps - 1:
            save_checkpoint(ckpt_dir, step + 1, (params, opt_state),
                            extra={"arch": arch, "loss": loss},
                            shardings=shardings)
        if simulate_failure == step:
            print(f"simulating node failure at step {step}", flush=True)
            os._exit(17)     # hard kill: no cleanup, like a real failure
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    train(**{k.replace("-", "_"): v for k, v in vars(args).items()})


if __name__ == "__main__":
    main()
