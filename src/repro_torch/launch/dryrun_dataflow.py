"""Dry-run of the relational engine's distributed GROUPBY on one card
(``src/repro/launch/dryrun_dataflow.py``): the paper's own workload at
warehouse scale through the hash exchange.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_dataflow \\
        --rows 16777216

The reference compiles ``distributed_groupby`` on a 256-chip mesh and
reads the compiled cost.  The port's exchange reads its overflow count on
the host (a skewed or colliding exchange is retried lossless, as the
engine retries it), so it cannot run on the ``meta`` device: it runs on
the card over ``LocalMesh(SHARDS)``, with the reference's columns, a
20-byte ``key`` (page_views' ``user``) and an f32 ``val``
(``estimated_revenue``), seeded.  ``--multi-pod`` and ``--production``
run it over the production mesh's DP axes as logical shards, as the
reference shards the rows over them: 16 shards ("16x16"), or 32 with the
pod axis ("2x16x16").  The report keeps the reference's keys:
the peak memory (``torch.cuda.max_memory_allocated``; not measured on the
CPU), the exchange's buffer as ``collective_bytes["all-to-all"]`` (every
shard's bucket of packed rows, which a mesh of cards would move over its
links), the kernels' launches and the wall time.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..dataflow.shuffle import _bucket_size, distributed_groupby
from ..dataflow.table import Table, pack_rows, pad_capacity
from .. import trace
from ..device import resolve
from ..workloads import pigmix
from .dryrun import COLLECTIVES
from .mesh import LocalMesh, dp_axes, make_production_mesh

KEYS = ["key"]
AGGS = {"total": ("sum", "val"), "cnt": ("count", "val")}
SKEW = 4.0                       # distributed_groupby's default
SHARDS = 8                       # the mesh phase's LocalMesh
USERS = 1 << 16                  # distinct keys, as the mesh bench draws


def _launches() -> dict:
    """Every registered kernel's launches so far, by the name its
    LaunchCounter registered in repro_torch.trace."""
    return {k: c.count for k, c in trace.launch_counters().items()}


def groupby_table(n_rows: int, seed: int = 0, device=None) -> Table:
    """The reference's two columns from PigMix's page_views generator
    over USERS users: ``key`` its 20-byte ``user``, ``val`` its f32
    ``estimated_revenue``."""
    pv = pigmix.gen_page_views(n_rows, seed, n_users=USERS, device=device)
    return Table({"key": pv.col("user"), "val": pv.col("estimated_revenue")},
                 pv.valid)


def exchange_bytes(table: Table, skew: float = SKEW,
                   shards: int = SHARDS) -> int:
    """The exchange's received buffer: ``shards`` destinations x
    ``shards`` sources x one bucket of packed rows (the columns, the
    validity byte and the shipped key-hash lane)."""
    table = pad_capacity(table, shards)
    bucket = _bucket_size(table.capacity // shards, shards, skew)
    row = {n: c[:1] for n, c in table.columns.items()}
    row["__h1__"] = torch.zeros(1, dtype=torch.int64, device=table.device)
    row_bytes = pack_rows(row, table.valid[:1])[0].shape[1]
    return shards * shards * bucket * row_bytes


def production_shards(multi_pod: bool) -> tuple:
    """(shards, mesh name): the production mesh's DP shards, over which
    the reference shards the rows."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n, "x".join(str(s) for s in mesh.sizes)


def run(table: Table, shards: int = SHARDS, mesh_name: str = None):
    """The GROUPBY of ``table`` over ``LocalMesh(shards)`` on its device:
    (grouped Table, report).  An exchange that overflowed or whose key
    hashes collided is run again lossless, as the engine retries it."""
    dev = table.device
    mesh = LocalMesh(shards, device=dev)
    before = _launches()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    grouped, overflow = distributed_groupby(table, KEYS, AGGS, mesh,
                                            skew_factor=SKEW)
    overflow = int(overflow)
    if overflow:
        grouped, _ = distributed_groupby(table, KEYS, AGGS, mesh,
                                         skew_factor=float(shards),
                                         lossless=True)
    groups = int(grouped.num_valid())
    wall = time.perf_counter() - t0
    cb = {k: 0 for k in COLLECTIVES}
    cc = dict(cb)
    cb["all-to-all"] = exchange_bytes(table, SKEW, shards) + (
        exchange_bytes(table, float(shards), shards) if overflow else 0)
    cc["all-to-all"] = 2 if overflow else 1
    rep = {"rows": table.capacity,
           "mesh": mesh_name or f"LocalMesh({shards})", "shards": shards,
           "device": (torch.cuda.get_device_name(dev) if on_card
                      else str(dev)),
           "status": "ok", "wall_s": wall, "groups": groups,
           "overflow": overflow, "retried_lossless": bool(overflow),
           "memory": {"peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if on_card else None)},
           "collective_bytes": cb, "collective_counts": cc,
           "launches": {k: n - before.get(k, 0)
                        for k, n in _launches().items()}}
    return grouped, rep


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The distributed GROUPBY over LocalMesh on one card: "
                    "wall time, peak memory, exchange bytes, launches.")
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--production", action="store_true",
                    help="shard the rows over the 16x16 production mesh's "
                         "DP axis (16 logical shards)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="shard the rows over the 2x16x16 production "
                         "mesh's DP axes (32 logical shards)")
    ap.add_argument("--out",
                    default="experiments/dryrun_torch/dataflow_groupby.json")
    args = ap.parse_args(argv)
    table = groupby_table(args.rows, args.seed, resolve(args.device))
    if args.multi_pod or args.production:
        _, rep = run(table, *production_shards(args.multi_pod))
    else:
        _, rep = run(table)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    peak = rep["memory"]["peak_bytes"]
    print(f"[ok] dataflow groupby {rep['rows']} rows on {rep['mesh']} "
          f"({rep['device']}): {rep['groups']} groups, wall "
          f"{rep['wall_s']:.3f} s, all-to-all="
          f"{rep['collective_bytes']['all-to-all']:.3g}B, peak="
          + ("not measured" if peak is None else f"{peak / 2**30:.2f}GiB")
          + f", launches {rep['launches']}")


if __name__ == "__main__":
    main()
