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
    for the CPU.

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
from ..models.api import build
from ..store.artifacts import ArtifactStore, Catalog
from ..train.checkpoint import latest_step, restore_checkpoint, \
    save_checkpoint
from ..train.data import batches_from_table, run_pipeline, synthetic_corpus
from ..train.optimizer import AdamW
from ..tree import tree_leaves, tree_leaves_with_path, tree_map

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
    params, opt_state, gnorm = opt.update(grads, opt_state, params)
    for p in leaves:
        p.grad = None
    return params, opt_state, loss.detach(), gnorm


def train(arch: str = "qwen3-1.7b", steps: int = 50, batch_size: int = 8,
          seq_len: int = 64, lr: float = 3e-4, ckpt_every: int = 10,
          ckpt_dir: str = DEFAULT_CKPT_DIR, simulate_failure: int = -1,
          scale: float = 1.0, log_every: int = 5, data_dir=None,
          quiet: bool = False, device=None):
    dev = resolve(device)
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
    start_step = 0
    last = latest_step(ckpt_dir)
    if last is not None:
        (params, opt_state), manifest = restore_checkpoint(
            ckpt_dir, last, (params, opt_state))
        start_step = manifest["step"]
        if not quiet:
            print(f"resumed from checkpoint step {start_step}")
    for _ in range(start_step):          # deterministic skip-ahead
        next(batches)

    losses = []
    for step in range(start_step, steps):
        tokens, labels = next(batches)
        t0 = time.time()
        params, opt_state, loss, gnorm = train_step(
            model, opt, params, opt_state,
            torch.from_numpy(tokens).to(dev), torch.from_numpy(labels).to(dev))
        loss = float(loss)
        losses.append(loss)
        if not quiet and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:4d} loss {loss:7.4f} gnorm {float(gnorm):6.2f}"
                  f" {time.time() - t0:5.2f}s")
        if (step + 1) % ckpt_every == 0 or step == steps - 1:
            save_checkpoint(ckpt_dir, step + 1, (params, opt_state),
                            extra={"arch": arch, "loss": loss})
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
