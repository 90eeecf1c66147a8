"""Time the join probe at the main path's shape on one CUDA card, and the
cases that hold it against its plain version.

    PYTHONPATH=src python3 src/repro_torch/kernels/hash_join/bench.py \\
        [--against OTHER_SRC] [--bits 13 14 15] [--rounds 10]

Two shapes, every probe a hit: the main path's (L3/L5's probe of
``page_views.user`` into ``users.name``: 2**24 int64 probe lanes into
2**16 sorted build keys) and the mesh phase's single-device arm (2**24
probes into 2**21 keys, above the directory's cap).  Prints one JSON line
with, per shape, the median and quartiles of ``2 * --rounds`` timings
(CUDA events around 20 calls) of each variant, taken in ABBA order in
this one process: this checkout's ``ops.probe``; with ``--against``, the
same wrapper of the checkout whose ``src`` directory is given (loaded
under another package name, its kernels built into its own ``build/``);
with ``--bits``, this checkout's kernel at each directory size; ``left.to(torch.int32)``, a pass that moves the same 12
bytes per probe and searches nothing; and ``torch.searchsorted``, the
library call that computes the same function.
"""
import argparse
import json

import numpy as np

MAIN_N, MAIN_R = 1 << 24, 1 << 16
SHAPES = {"main": (MAIN_N, MAIN_R), "mesh t_single": (MAIN_N, 1 << 21)}
SENTINEL = 0xFFFFFFFF        # the engine's masked build rows (physical._masked)


def _uniform(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.int64)


def main_case(dev, seed=0, n=MAIN_N, r=MAIN_R):
    """(left, right): r distinct sorted build keys (2**16 at the main
    shape), n probes drawn from them."""
    import torch
    rng = np.random.default_rng(seed)
    right = np.unique(_uniform(rng, r + r // 64 + 64))[:r]
    left = right[rng.integers(0, len(right), n)]
    return torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)


def edge_cases(dev, seed=0):
    """(label, left, right) int64 tensors of uint32 lanes on ``dev``: build
    sides of 2**16 and 2**17 + 3 keys, uniform and tie-heavy; probes at
    every bucket edge and one below it, 0 and 0xFFFFFFFF; build sides of
    0 and 1 keys, all keys equal, and half of them the masked sentinel;
    an odd probe count and a probe side that is not 16-byte aligned."""
    import torch

    from .ops import probe_bits
    rng = np.random.default_rng(seed)
    cases = []

    def add(label, left, right):
        cases.append((label, torch.from_numpy(np.asarray(left, np.int64))
                      .to(dev), torch.from_numpy(np.sort(np.asarray(
                          right, np.int64))).to(dev)))

    def probes(right, n):
        hits = right[rng.integers(0, len(right), n // 2)] if len(right) \
            else _uniform(rng, n // 2)
        return np.concatenate([hits, _uniform(rng, n - n // 2),
                               [0, SENTINEL]])

    for r in (1 << 16, (1 << 17) + 3):
        uni = _uniform(rng, r)
        pool = _uniform(rng, max(1, r // 64))
        few = pool[rng.integers(0, len(pool), r)]
        add(f"uniform R={r}", probes(uni, 1 << 18), uni)
        add(f"tie-heavy R={r}", probes(few, 1 << 18), few)
    for r in ((1 << 17) + 3, 1 << 16, 1000, 5):
        b = probe_bits(r)
        edges = np.arange((1 << b) + 1, dtype=np.int64) << (32 - b)
        at = np.clip(np.concatenate([edges, edges - 1, edges + 1]), 0,
                     SENTINEL)
        right = np.concatenate([_uniform(rng, r - r // 4),
                                rng.choice(at, r // 4)])
        add(f"bucket edges R={r} b={b}", rng.permutation(at), right)
    add("R=0", _uniform(rng, 1001), [])
    one = _uniform(rng, 1)
    add("R=1", np.concatenate([_uniform(rng, 999), one, one - 1, one + 1,
                               [0, SENTINEL]]), one)
    c = 0xDEADBEEF
    add("all keys equal", np.concatenate([_uniform(rng, 4096),
                                          [c, c - 1, c + 1, 0, SENTINEL]]),
        np.full(1 << 16, c))
    masked = _uniform(rng, 1 << 16)
    masked[rng.random(1 << 16) < 0.5] = SENTINEL
    add("half masked", probes(masked, 1 << 16), masked)
    label, left, right = cases[0]
    add("odd N", left[:-1].cpu().numpy(), right.cpu().numpy())
    shifted = torch.cat([left[:1], left])[1:]          # 8 bytes off 16
    cases.append(("unaligned probe side", shifted, right))
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", metavar="OTHER_SRC",
                    help="the src directory of another checkout")
    ap.add_argument("--bits", type=int, nargs="*", default=[],
                    help="directory sizes to time this kernel at")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels import abtiming
    from repro_torch.kernels.hash_join import ops
    from repro_torch.kernels.hash_join.ref import join_probe_ref

    dev = torch.device("cuda", 0)
    other = abtiming.load_other(args.against, "kernels.hash_join.ops") \
        if args.against else None
    out = {}
    for shape, (n, r) in SHAPES.items():
        left, right = main_case(dev, n=n, r=r)
        want = join_probe_ref(left, right)
        variants = {"this": lambda: ops.probe(left, right)}
        if other is not None:
            variants["other"] = lambda: other.probe(left, right)
        for b in args.bits:
            variants[f"bits={b}"] = (lambda b=b: ops._launch(left, right, b))
        for name, fn in variants.items():
            if not torch.equal(fn(), want):
                raise SystemExit(f"{name} differs from the plain version")
        variants["stream 12 B/probe"] = lambda: left.to(torch.int32)
        variants["torch.searchsorted"] = \
            lambda: torch.searchsorted(right, left)
        out[shape] = dict(n=n, r=r, bits=ops.probe_bits(r),
                          times=abtiming.abba(variants, args.rounds))
        del left, right, want
    print(json.dumps({"kernel": "join_probe", "card": abtiming.card(),
                      "against": args.against, "shapes": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
