"""Time the sorted segment sum at the main path's shape on one CUDA card,
and the cases that hold it against its plain version.

    PYTHONPATH=src python3 src/repro_torch/kernels/segment_reduce/bench.py \\
        [--against OTHER_SRC] [--rounds 10]

The main shape is L3's GROUPBY of the joined rows by user
(``physical._segment_aggregate``): 2**24 rows x 2 f32 lanes (the count
lane and the revenue lane), dense sorted int32 ids over 2**16 users, and
``num_segments`` = the table's capacity, 2**24, so the output is
(2**24, 2).  Prints one JSON line with the median and quartiles of
``2 * --rounds`` timings (CUDA events around 20 calls) of each variant,
taken in ABBA order in this one process: this checkout's
``ops.segment_sum``; with ``--against``, the same wrapper of the checkout
whose ``src`` directory is given (loaded under another package name, its
kernels built into its own ``build/``); the zero fill of the output
alone; and ``index_add_`` into a zeroed output, the library call that
computes the same function.
"""
import argparse
import json

import numpy as np

MAIN_N, MAIN_USERS, MAIN_D = 1 << 24, 1 << 16, 2


def main_case(dev, seed=0):
    """(vals, ids, num_segments) at the main shape."""
    import torch
    rng = np.random.default_rng(seed)
    user = np.sort(rng.integers(0, MAIN_USERS, MAIN_N))
    ids = np.unique(user, return_inverse=True)[1].astype(np.int32)
    rev = rng.uniform(0, 100, MAIN_N).astype(np.float32)
    vals = np.stack([np.ones(MAIN_N, np.float32), rev], 1)
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(ids).to(dev),
            MAIN_N)


def edge_cases(dev, tile=4096, seed=0):
    """(label, vals, ids, num_segments, exact) on ``dev``: sizes at tile -
    1, tile, tile + 1, 2 tile + 1 and 2**20 + 3; one segment spanning three
    tiles and all rows in one segment; ids that start above or below 0,
    ids with gaps, invalid rows parked at num_segments - 1 (as the engine
    parks them); D from 1 to 5, and 11 (passes of up to 8 lanes); values
    not 16-byte aligned.  ``exact`` cases carry integer-valued
    floats, so any order of addition gives the same bits; the others are
    uniform floats."""
    import torch
    rng = np.random.default_rng(seed)
    cases = []

    def add(label, ids, d, num_segments, exact=True):
        n = len(ids)
        vals = rng.integers(-50, 50, (n, d)).astype(np.float32) if exact \
            else rng.uniform(-1, 1, (n, d)).astype(np.float32)
        cases.append((f"{label} D={d}", torch.from_numpy(vals).to(dev),
                      torch.from_numpy(np.asarray(ids, np.int32)).to(dev),
                      num_segments, exact))

    def runs(n, start=0, step=2):
        return start + np.cumsum(rng.integers(0, step, n)) - 1

    for i, n in enumerate([tile - 1, tile, tile + 1, 2 * tile + 1,
                           (1 << 20) + 3]):
        add(f"n={n}", runs(n, 1), 1 + i % 5, n)
    for d in range(1, 6):
        t3 = np.concatenate([np.zeros(100), np.ones(3 * tile),
                             np.full(77, 2)])
        add("one segment over three tiles", t3, d, 3)
        add("all rows in one segment", np.full(3 * tile + 5, 7), d, 8)
        add("ids from 1000", runs(2 * tile + 9, 1000), d, 1 << 14)
        add("ids from -5", runs(2 * tile + 9, -5), d, 1 << 14)
        add("ids with gaps", runs(3 * tile, 0, 9), d, 1 << 15)
        cap = 3 * tile
        parked = np.where(np.arange(cap) < cap - 700,
                          np.minimum(runs(cap), cap - 2), cap - 1)
        add("invalid rows parked at cap - 1", parked, d, cap)
    add("float lanes", runs((1 << 20) + 3, 0, 3), 2, 1 << 20, exact=False)
    add("n=2 tile + 1", runs(2 * tile + 1), 11, 2 * tile)
    label, vals, ids, ns, exact = cases[0]
    shifted = torch.cat([vals[:1], vals])[1:]        # D = 1: 4 bytes off
    cases.append((f"unaligned values {label}", shifted, ids, ns, exact))
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", metavar="OTHER_SRC",
                    help="the src directory of another checkout")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels import abtiming
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref

    dev = torch.device("cuda", 0)
    vals, ids, s = main_case(dev)
    want = segment_sum_ref(vals, ids, num_segments=s)
    variants = {"this": lambda: ops.segment_sum(vals, ids, num_segments=s)}
    if args.against:
        other = abtiming.load_other(args.against,
                                    "kernels.segment_reduce.ops")
        variants["other"] = lambda: other.segment_sum(vals, ids,
                                                      num_segments=s)
    for name, fn in variants.items():
        got = fn()
        rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
        if not (torch.equal(got[:, 0], want[:, 0]) and rel <= 1e-4):
            raise SystemExit(f"{name} differs from the plain version: {rel}")
    out = torch.empty(s, MAIN_D, device=dev)

    def library():
        out.zero_()
        out.index_add_(0, ids, vals)
    variants["zero fill"] = lambda: torch.zeros(s, MAIN_D, device=dev)
    variants["index_add_"] = library
    times = abtiming.abba(variants, args.rounds)
    print(json.dumps({"kernel": "segment_sum", "card": abtiming.card(),
                      "shape": f"N={MAIN_N} rows x D={MAIN_D} f32, "
                               f"{MAIN_USERS} segments, output ({s}, "
                               f"{MAIN_D})",
                      "tile": ops.library().restore_segment_sum_tile(),
                      "against": args.against, "times": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
