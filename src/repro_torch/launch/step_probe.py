"""One model's first training steps on the card, and how far its bf16
gradient is from the float32 one.

Run as a file, so that ``--src`` (another checkout's ``src``) decides
which ``repro_torch`` it measures; two checkouts in one call, in the
order A B B A, compare two versions on the same card:

    python3 src/repro_torch/launch/step_probe.py [--src SRC]
        [--arch xlstm-350m] [--batch 4] [--seq 1024] [--steps 1]
        [--grad-seq 80] [--drop 1e-3] [--seed 0] [--out FILE]
        [--device cpu --smoke]

At the model's full config in bf16 with ``Model.init(seed)``'s weights:
  * on 1 x ``grad_seq`` tokens, the bf16 gradient and the gradient of a
    float32 copy of the same weights: their cosine, whole and the least
    leaf's; and the float32 loss along its own gradient
    (``central_difference``) against the gradient's prediction;
  * ``1 + steps`` AdamW steps (lr 3e-4) on one repeated batch of
    ``batch`` x ``seq`` tokens: losses, gradient norms and each step's
    seconds, synced.
Tokens are uniform from a numpy seed.  Prints one JSON line with the
card's name and power limit, and writes it to ``--out``.  Uses only what
every checkout since ``launch/train.py::batch_step`` has.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def grads_of(model, params, batch):
    """(loss, [gradient leaves]) of ``Model.loss_fn`` at ``params``."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    total, (loss, _) = model.loss_fn(params, batch)
    total.backward()
    grads = [p.grad.detach() for p in leaves]
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return float(loss.detach()), grads


def _dot(a, b):
    return sum(float(x.reshape(-1).double() @ y.reshape(-1).double())
               for x, y in zip(a, b))


def cosine(a, b):
    """The cosine of two lists of tensors taken whole, in float64."""
    return _dot(a, b) / max((_dot(a, a) * _dot(b, b)) ** 0.5, 1e-300)


def central_difference(model, params, grads, batch, drop):
    """The loss of ``model`` at ``params`` moved along ``grads`` (its
    gradient there, leaf by leaf) by ``s g`` each way, s = drop / |g|^2,
    so that the first-order change is ``drop`` each way: (L(p + s g),
    L(p - s g), g . (p+ - p-) with the points as the parameters' dtype
    rounds them).  ``params`` is left as it was."""
    import torch
    from repro_torch.tree import tree_leaves
    s = drop / _dot(grads, grads)
    leaves = tree_leaves(params)
    base = [t.detach().clone() for t in leaves]
    moved = []
    with torch.no_grad():
        for k in (1.0, -1.0):
            for t, b, g in zip(leaves, base, grads):
                t.copy_(b + (k * s) * g)
            moved.append(float(model.loss_fn(params, batch)[1][0]))
        want = sum(_dot([g], [(b + s * g) - (b + (-s) * g)])
                   for b, g in zip(base, grads))
        for t, b in zip(leaves, base):
            t.copy_(b)
    return moved[0], moved[1], want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--grad-seq", type=int, default=80)
    ap.add_argument("--drop", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda",
                    help="cpu: the plain versions, for a rehearsal")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config")
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("step_probe: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_step
    from repro_torch.models.api import build
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_map
    card = "cpu"
    if args.device == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    else:
        dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build(cfg, device=dev)
    params = model.init(args.seed)
    toks = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.seq + 1))

    def batch_of(b, s):
        t = torch.from_numpy(toks[:b, :s + 1]).to(dev)
        return {"tokens": t[:, :-1], "labels": t[:, 1:],
                "positions": torch.arange(s, dtype=torch.int32, device=dev)}

    out = dict(src=os.path.abspath(args.src), arch=args.arch,
               dtype=cfg.dtype, card=card, seed=args.seed)
    small = batch_of(1, args.grad_seq)
    t0 = time.perf_counter()
    loss16, g16 = grads_of(model, params, small)
    model32 = build(cfg.with_(dtype="float32"), device=dev)
    p32 = tree_map(lambda t: t.detach().to(torch.float32, copy=True), params)
    loss32, g32 = grads_of(model32, p32, small)
    leaf_cos = [cosine([a], [b]) for a, b in zip(g16, g32)]
    out.update(grad_seq=args.grad_seq, loss_bf16=loss16, loss_f32=loss32,
               gnorm_bf16=_dot(g16, g16) ** 0.5,
               gnorm_f32=_dot(g32, g32) ** 0.5, cosine=cosine(g16, g32),
               least_leaf_cosine=min(leaf_cos),
               least_leaf=int(np.argmin(leaf_cos)), leaves=len(g32))
    up, down, want = central_difference(model32, p32, g32, small, args.drop)
    del model32, p32, g16, g32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.update(drop=args.drop, loss_up=up, loss_down=down,
               central_change=up - down, predicted_change=want,
               central_rel_err=(up - down - want) / want,
               grad_probe_s=time.perf_counter() - t0)

    opt = AdamW()
    state = opt.init(params)
    batch = batch_of(args.batch, args.seq)
    losses, gnorms, step_s = [], [], []
    for _ in range(1 + args.steps):
        sync()
        t1 = time.perf_counter()
        params, state, loss, gnorm = batch_step(model, opt, params, state,
                                                batch)
        sync()
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        step_s.append(time.perf_counter() - t1)
    out.update(batch=args.batch, seq=args.seq, losses=losses, gnorms=gnorms,
               step_s=step_s, peak_gb=torch.cuda.max_memory_allocated(dev)
               / 1e9 if dev.type == "cuda" else None)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
