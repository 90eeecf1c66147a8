"""Wall time of a training step of this checkout against another's, in one
process, on the card: ``chip_smoke.py`` phase 8 (b)'s step (qwen3-1.7b
at its full config, bf16, remat, random weights from a seed; batch 8 x
seq 64).  One parameter tree and one optimizer state are driven in turn
by each checkout's ``build`` and ``train_step``, turns in A B B A order,
so drift of the shared host falls on both alike.

    PYTHONPATH=src python -m repro_torch.launch.step_ab --against SRC

SRC is the other checkout's ``src`` directory (loaded beside this one
by ``kernels.abtiming.load_other``).  Prints one JSON object: each
checkout's step times (ms) with their median and quartiles, the card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..kernels.abtiming import card, load_other, summary
from ..train.optimizer import AdamW


def _step_fns(pkg, dev, arch):
    """(model, train_step) of one checkout, given its package's
    ``configs``, ``models.api`` and ``launch.train`` modules."""
    cfg = pkg["configs"].get_config(arch)
    return pkg["models.api"].build(cfg, device=dev), \
        pkg["launch.train"].train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", metavar="SRC", required=True)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5,
                    help="timed steps per turn")
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed steps per checkout before the turns")
    args = ap.parse_args()
    dev = torch.device("cuda")
    mods = ("configs", "models.api", "launch.train")
    this = {m: __import__(f"repro_torch.{m}", fromlist=["_"]) for m in mods}
    other = {m: load_other(args.against, m) for m in mods}
    arms = {"this": _step_fns(this, dev, args.arch),
            "other": _step_fns(other, dev, args.arch)}
    model = arms["this"][0]
    params = model.init(seed=0)
    opt = AdamW()
    opt_state = opt.init(params)
    g = torch.Generator(device=dev).manual_seed(0)
    v = model.cfg.vocab_size
    tokens, labels = (torch.randint(0, v, (args.batch, args.seq),
                                    generator=g, device=dev)
                      for _ in range(2))

    def turn(name, n):
        nonlocal params, opt_state
        m, step = arms[name]
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, loss, _ = step(m, opt, params, opt_state,
                                              tokens, labels)
            float(loss)
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for name in arms:          # warm-up: kernels built and loaded
        turn(name, args.warmup)
    times = {k: [] for k in arms}
    for _ in range(args.rounds):
        for name in ("this", "other", "other", "this"):
            times[name] += turn(name, args.steps)
    print(json.dumps({
        "arch": args.arch, "batch": args.batch, "seq": args.seq,
        "card": card(), "against": args.against,
        "step_ms": {k: dict(summary(v), times=v) for k, v in times.items()},
    }))


if __name__ == "__main__":
    main()
