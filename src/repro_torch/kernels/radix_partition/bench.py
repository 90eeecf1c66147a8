"""Time the partition scatter and the radix partition at the mesh
exchange's shapes on one CUDA card, and the cases that hold both against
their plain versions.

    PYTHONPATH=src python3 src/repro_torch/kernels/radix_partition/bench.py \\
        [--against OTHER_SRC] [--rounds 10]

Shapes (``SCATTER_SHAPES``, ``PARTITION_N``): the main one that
``chip_smoke.py`` times, the page_views side of the mesh phase's join
exchange (8 shards x 2**21 int64 lanes, P = 8, bucket 2**20: 2**24 rows
at skew 4); the largest of the mesh arms' launches (``chip_smoke.py``
phase 4 records them by shape), a lossless retry's exchange of as many
rows with a bucket of a whole shard, 2**21; ``radix_partition``
over 2**24 lanes in tiles of 256; and the MoE dispatch (``MOE_SHAPES``:
qwen3-moe's top-8 of 128 experts for a 2048-token prefill, N = 16384
entries with a capacity of 160, and for a batched decode of 8 tokens, 64
entries with a capacity of 8; expert ids drawn at zipf 1.2, so the
hottest experts overflow).  Prints one JSON line with, per shape, the
median and quartiles of ``2 * --rounds`` timings (CUDA events around 20
calls) of each variant, taken in ABBA order in this one process: this
checkout's wrapper; with ``--against``, the same wrapper of the
checkout whose ``src`` directory is given (loaded under another package
name, its kernels built into its own ``build/``); a pass that streams
the same 13 B a row (the int64 lane and the valid byte in, an int32
out) and ranks nothing; and the library call that computes the same
function (``torch.sort(pid, stable=True)``, ``torch.bincount``).
"""
import argparse
import json

import numpy as np

P = 8                                        # the mesh's shards
SCATTER_SHAPES = {                           # (S, N, valid share, bucket)
    "main": (8, 1 << 21, 1.0, 1 << 20),
    "mesh lossless retry": (8, 1 << 21, 1.0, 1 << 21),
}
PARTITION_N, PARTITION_TILE = 1 << 24, 256
MOE_EXPERTS = 128                            # qwen3-moe-235b-a22b's E
MOE_SHAPES = {"moe prefill T=2048": (2048 * 8, 160),   # (N = T k, cap)
              "moe decode B=8": (8 * 8, 8)}


def moe_case(dev, n, seed=0, experts=MOE_EXPERTS):
    """(expert ids as int64 lanes, all-valid mask): ``n`` top-k entries
    over ``experts`` experts at zipf 1.2."""
    import torch
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, experts + 1) ** 1.2
    e = rng.choice(experts, n, p=w / w.sum()).astype(np.int64)
    return (torch.from_numpy(e).to(dev),
            torch.ones(n, dtype=torch.bool, device=dev))


def _uniform(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.int64)


def main_case(dev, s, n, share, seed=0):
    """(hashes, valid): uniform uint32 lanes, ``share`` of rows valid."""
    import torch
    rng = np.random.default_rng(seed)
    h = _uniform(rng, (s, n))
    v = rng.random((s, n)) < share if share < 1 else np.ones((s, n), bool)
    return torch.from_numpy(h).to(dev), torch.from_numpy(v).to(dev)


def edge_cases(dev, seed=0):
    """dicts of (label, hashes, valid, n_parts, bucket, tile_n) on ``dev``;
    ``tile_n`` is None for (S, N) cases (``partition`` takes (N,) only).
    N of 1, 31, 4095, 4097 and 2**21 + 3 with P of 1, 2, 8, 256 and 8192
    (8192 up to N = 4097: the plain version holds an N x P one-hot);
    every row invalid; every row bound for one partition (overflow);
    bucket 1; (1, N) and (8, N) segments with ragged N; a scatter tile's
    boundary right at a partition's bucket edge (and one off); histogram
    tiles of 256, 1024, 100 and 4128 rows and clamped ones."""
    import torch

    from .ops import SCATTER_TILE as TILE
    rng = np.random.default_rng(seed)
    cases = []

    def add(label, h, v, n_parts, bucket, tile_n=256):
        h = np.asarray(h, np.int64)
        cases.append(dict(
            label=label, hashes=torch.from_numpy(h).to(dev),
            valid=torch.from_numpy(np.asarray(v, bool)).to(dev),
            n_parts=n_parts, bucket=bucket,
            tile_n=tile_n if h.ndim == 1 else None))

    tiles = (256, 1024, 100, 4128)
    for i, n in enumerate((1, 31, 4095, 4097, (1 << 21) + 3)):
        for j, n_parts in enumerate((1, 2, 8, 256, 8192)):
            if n > 4097 and n_parts > 256:
                continue
            add(f"N={n} P={n_parts}", _uniform(rng, n), rng.random(n) < 0.7,
                n_parts, n // n_parts + 2, tiles[(i + j) % len(tiles)])
    n = 4097
    add("all invalid", _uniform(rng, n), np.zeros(n, bool), 8, 600)
    add("one partition", np.full(n, 8 * 12345 + 3), np.ones(n, bool), 8,
        1000, 1024)
    pool = _uniform(rng, 16)
    add("bucket 1", pool[rng.integers(0, 16, n)], rng.random(n) < 0.9, 8, 1,
        100)
    add("S=1 ragged", _uniform(rng, (1, 5000)), rng.random((1, 5000)) < 0.7,
        8, 700)
    add("S=8 ragged", _uniform(rng, (8, 4099)), rng.random((8, 4099)) < 0.7,
        8, 300)
    add("S=8 P=256", _uniform(rng, (8, 9001)), rng.random((8, 9001)) < 0.7,
        256, 40)
    add("S=2 P=8192", _uniform(rng, (2, 5000)), rng.random((2, 5000)) < 0.7,
        8192, 1)
    # every row bound for partition 0 of 2: the first row of tile 1 has
    # rank TILE, the first that overflows a bucket of TILE
    n = 3 * TILE + 5
    for bucket in (TILE - 1, TILE, TILE + 1):
        add(f"tile edge bucket={bucket}", np.full(n, 2 * 777),
            np.ones(n, bool), 2, bucket, 4096)
    add("clamped tile", _uniform(rng, 200), rng.random(200) < 0.7, 8, 30,
        1024)
    return cases


def check_case(case):
    """Both wrappers against their plain versions on one of
    ``edge_cases``, bit for bit (slots, overflow counts, pids,
    histograms).  Returns the name of the function that differs, or
    None."""
    import torch

    from .ops import _pad_invalid, partition, scatter_slots
    from .ref import partition_scatter_ref, radix_partition_ref
    h, v, n_parts = case["hashes"], case["valid"], case["n_parts"]
    got = scatter_slots(h, v, n_parts=n_parts, bucket=case["bucket"])
    want = partition_scatter_ref(h, v, n_parts=n_parts,
                                 bucket=case["bucket"])
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        return "partition_scatter"
    if case["tile_n"] is not None:
        pid, hist = partition(h, v, n_parts=n_parts, tile_n=case["tile_n"])
        hp, vp, n = _pad_invalid(h, v, case["tile_n"])
        pid_r, hist_r = radix_partition_ref(hp, vp, n_parts=n_parts,
                                            tile_n=case["tile_n"])
        if not (torch.equal(pid, pid_r[:n]) and torch.equal(hist, hist_r)):
            return "radix_partition"
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", metavar="OTHER_SRC",
                    help="the src directory of another checkout")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels import abtiming
    from repro_torch.kernels.radix_partition import ops
    from repro_torch.kernels.radix_partition.ref import (
        partition_scatter_ref, radix_partition_ref)

    dev = torch.device("cuda", 0)
    other = abtiming.load_other(args.against,
                                "kernels.radix_partition.ops") \
        if args.against else None
    wrappers = {"this": ops} if other is None else {"this": ops,
                                                    "other": other}
    out = {}
    for shape, (s, n, share, bucket) in SCATTER_SHAPES.items():
        h, v = main_case(dev, s, n, share)
        want = partition_scatter_ref(h, v, n_parts=P, bucket=bucket)
        variants = {}
        for name, mod in wrappers.items():
            fn = (lambda mod=mod: mod.scatter_slots(h, v, n_parts=P,
                                                    bucket=bucket))
            got = fn()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise SystemExit(f"{name} differs from the plain version "
                                 f"at {shape}")
            variants[name] = fn
        del want
        lo = h.view(torch.int32)[..., ::2]
        pid = h & (P - 1)
        variants["stream 13 B/row"] = lambda: torch.add(lo, v)
        variants["torch.sort"] = lambda: torch.sort(pid, stable=True)
        out[f"partition_scatter {shape}"] = dict(
            s=s, n=n, valid_share=share, bucket=bucket,
            overflow=int(ops.scatter_slots(h, v, n_parts=P,
                                           bucket=bucket)[1].sum()),
            times=abtiming.abba(variants, args.rounds))
        del h, v, lo, pid, variants

    for shape, (n, cap) in MOE_SHAPES.items():
        h, v = moe_case(dev, n)
        want = partition_scatter_ref(h, v, n_parts=MOE_EXPERTS, bucket=cap)
        variants = {}
        for name, mod in wrappers.items():
            fn = (lambda mod=mod: mod.scatter_slots(
                h, v, n_parts=MOE_EXPERTS, bucket=cap))
            got = fn()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise SystemExit(f"{name} differs from the plain version "
                                 f"at {shape}")
            variants[name] = fn
        variants["torch.sort"] = lambda: torch.sort(h, stable=True)
        out[f"partition_scatter {shape}"] = dict(
            n=n, n_parts=MOE_EXPERTS, bucket=cap,
            overflow=int(want[1]), times=abtiming.abba(variants, args.rounds))

    h, v = main_case(dev, 1, PARTITION_N, 1.0)
    h, v = h[0], v[0]
    want = radix_partition_ref(h, v, n_parts=P, tile_n=PARTITION_TILE)
    variants = {}
    for name, mod in wrappers.items():
        fn = (lambda mod=mod: mod.partition(h, v, n_parts=P,
                                            tile_n=PARTITION_TILE))
        got = fn()
        if not (torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            raise SystemExit(f"{name} differs from the plain version")
        variants[name] = fn
    n_tiles = PARTITION_N // PARTITION_TILE
    binned = (torch.arange(PARTITION_N, device=dev) // PARTITION_TILE) \
        * (P + 1) + want[0]
    lo = h.view(torch.int32)[::2]
    variants["stream 13 B/row"] = lambda: torch.add(lo, v)
    variants["torch.bincount"] = \
        lambda: torch.bincount(binned, minlength=n_tiles * (P + 1))
    out["radix_partition main"] = dict(
        n=PARTITION_N, tile_n=PARTITION_TILE,
        times=abtiming.abba(variants, args.rounds))
    print(json.dumps({"kernel": "radix_partition", "card": abtiming.card(),
                      "against": args.against, "shapes": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
