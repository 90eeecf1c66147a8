"""Rank bodies for the GroupMesh tests (``tests/test_torch_group_*.py``).

``launch.mesh.spawn`` starts each rank in a fresh interpreter that
imports the rank's function by name, so the bodies live here, in a module
that imports torch, numpy and the port only (no JAX, no pytest): a rank
then starts in about a second.  Every body builds the same seeded inputs
the parent builds, takes its own block and returns numpy arrays, which
the tests hold against ``LocalMesh`` runs in the parent and against the
reference's 4-device runs.
"""
import numpy as np
import torch

from repro_torch.core import plan as P
from repro_torch.core.restore import ReStore
from repro_torch.dataflow import shuffle as S
from repro_torch.dataflow.table import Table, encode_strings
from repro_torch.launch.mesh import (GroupMesh, LocalMesh, PartitionSpec,
                                     shard_map)
from repro_torch.store.artifacts import ArtifactStore, Catalog

CPU = "cpu"
N = 4
AGGS = {"s": ("sum", "v"), "n": ("count", "v"), "m": ("mean", "v"),
        "lo": ("min", "w"), "hi": ("max", "w")}
COG_L = {"sv": ("sum", "v"), "cv": ("count", "v")}
COG_R = {"sz": ("sum", "z")}


# ------------------------------------------------------------ collectives
def collective_inputs():
    """Seeded per-shard values: integer-valued floats, so every sum is
    exact in any order."""
    rng = np.random.default_rng(5)
    return {"x": rng.integers(-50, 50, (N, 3, 5)).astype(np.float32),
            "ix": rng.integers(-2**20, 2**20, (N, 7)).astype(np.int32),
            "a2a": rng.integers(0, 1000, (N, 2, 6)).astype(np.int64),
            "a2a1": rng.integers(0, 1000, (N, N, 3)).astype(np.int32),
            "w": rng.integers(-9, 9, (4, 6, 2)).astype(np.float32),
            "rows": rng.integers(0, 99, (N * 5, 3)).astype(np.int32)}


def collectives(mesh2, mesh1, inp, r):
    """Every collective of a (2, 2) mesh and of a 1-D mesh of 4, on
    shard ``r``'s values (a ``LocalMesh`` gets every shard's: ``r`` is
    None).  Returns {case: array}, per-shard rows stacked."""
    T = {k: torch.from_numpy(v) for k, v in inp.items()}

    def mine(x):
        return x if r is None else x[r:r + 1]

    out = {}
    for ax in ("data", "model", ("data", "model")):
        name = ax if isinstance(ax, str) else "both"
        out[f"psum_{name}"] = mesh2.psum(mine(T["x"]), ax)
        out[f"pmax_{name}"] = mesh2.pmax(mine(T["x"]), ax)
        out[f"pmean_{name}"] = mesh2.pmean(mine(T["x"]), ax)
        out[f"ipsum_{name}"] = mesh2.psum(mine(T["ix"]), ax)
    for ax in ("data", "model"):
        out[f"index_{ax}"] = mesh2.axis_index(ax)
        out[f"a2a_{ax}"] = mesh2.all_to_all(mine(T["a2a"]), ax)
    # shard_map over specs: blocks in, blocks (or the gathered whole) out
    spec = PartitionSpec("data", "model")

    def body(w, x):
        return w * 2 + mesh2.shape["model"], x.sum(0, keepdim=True)

    f = shard_map(body, mesh2, (spec, PartitionSpec(None)),
                  (spec, PartitionSpec(("data", "model"))))
    blk, per = f(T["w"], T["x"].sum(0))
    out["sm_block"] = blk
    out["sm_whole"] = mesh2.globalize(blk, spec)
    out["sm_stack"] = per
    # the 1-D engine API
    out["psum1"] = mesh1.psum(mine(T["ix"])[:, 0])
    out["a2a1"] = mesh1.all_to_all(mine(T["a2a1"]))
    rows = T["rows"] if r is None else T["rows"][r * 5:(r + 1) * 5]
    blocks = mesh1.blocks(rows)
    out["blocks"] = torch.stack([b.sum(0) for b in blocks])
    got = mesh1.shard_map(lambda b: (b * 3, b.sum()), rows)
    out["smap_rows"], out["smap_stack"] = got
    out["gather_rows"] = mesh1.gather_rows(rows)
    # 16-bit and bool values travel as bytes
    out["gather_bf16"] = mesh1.gather_rows(rows.to(torch.bfloat16)).float()
    out["gather_bool"] = mesh1.gather_rows(rows > 50)
    out["a2a_bf16"] = mesh1.all_to_all(
        mine(T["a2a1"]).to(torch.bfloat16)).float()
    return {k: v.numpy() for k, v in out.items()}


def rank_collectives(rank, world):
    mesh2 = GroupMesh((2, 2), ("data", "model"), backend="gloo",
                      device=CPU)
    mesh1 = GroupMesh(N, "data", backend="gloo", device=CPU)
    out = collectives(mesh2, mesh1, collective_inputs(), rank)
    out["transport"] = np.asarray(sorted(mesh1.transport))
    return out


def local_collectives():
    return collectives(LocalMesh((2, 2), ("data", "model"), device=CPU),
                       LocalMesh(N, "data", device=CPU),
                       collective_inputs(), None)


# ------------------------------------------------------------ relational
def relational_inputs():
    """name -> {column: array}; float payloads are integer-valued."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, 40, 500).astype(np.int32)
    fact = {"k": k, "s": encode_strings([f"user{x}" for x in k]),
            "v": rng.integers(0, 100, 500).astype(np.float32),
            "w": rng.integers(-50, 50, 500).astype(np.int32)}
    dist = {"x": rng.integers(0, 12, 512).astype(np.int32),
            "y": rng.integers(0, 3, 512).astype(np.int32)}
    left = {"k": rng.integers(0, 16, 250).astype(np.int32),
            "a": rng.integers(0, 9, 250).astype(np.int32)}
    rk = np.repeat(np.arange(16, dtype=np.int32), 2)[:30]
    right = {"rk": rk, "a": (rk * 3 % 7).astype(np.int32),
             "a_r": (rk * 5 % 11).astype(np.int32)}
    ca = {"u": rng.integers(0, 10, 256).astype(np.int32),
          "v": rng.integers(0, 50, 256).astype(np.float32)}
    cb = {"w": rng.integers(0, 10, 128).astype(np.int32),
          "z": rng.integers(0, 50, 128).astype(np.float32)}
    return dict(fact=fact, dist=dist, left=left, right=right, ca=ca, cb=cb)


def relational(mesh):
    """The four distributed operators on ``mesh`` (every table cut to
    this process's blocks).  Returns {case__column: array} of this
    process's output blocks and the overflow counts."""
    T = {n: mesh.local_table(Table.from_numpy(c, device=CPU))
         for n, c in relational_inputs().items()}
    out = {}

    def put(case, table, *scalars):
        for c, a in table.columns.items():
            out[f"{case}__{c}"] = a.cpu().numpy()
        out[f"{case}__valid"] = table.valid.cpu().numpy()
        for i, x in enumerate(scalars):
            out[f"{case}__s{i}"] = x.cpu().numpy()

    put("gb", *S.distributed_groupby(T["fact"], ["k"], AGGS, mesh,
                                     skew_factor=4.0))
    put("gb_str", *S.distributed_groupby(T["fact"], ["s"], AGGS, mesh,
                                         skew_factor=4.0))
    put("dist", *S.distributed_distinct(T["dist"], mesh, skew_factor=4.0))
    j, lane, so, jo = S.distributed_join(
        T["left"], T["right"], ["k"], ["rk"], mesh, expansion=2,
        skew_factor=4.0, return_pre=True)
    put("join", j, so, jo)
    out["join__lane"] = lane.cpu().numpy()
    put("gb_copart", *S.distributed_groupby(
        j, ["k"], {"s": ("sum", "a")}, mesh, co_partitioned=True,
        pre_lane=lane))
    put("cog", *S.distributed_cogroup(T["ca"], T["cb"], ["u"], ["w"],
                                      COG_L, COG_R, mesh, skew_factor=4.0))
    return out


def rank_relational(rank, world):
    mesh = GroupMesh(N, "data", backend="gloo", device=CPU)
    out = relational(mesh)
    out["__bytes__"] = np.asarray(mesh.transport["all_to_all"]["bytes"])
    return out


# ------------------------------------------------------------ ReStore
def fact(n=512):
    rng = np.random.default_rng(0)
    return Table.from_numpy(
        {"k": rng.integers(0, 24, n).astype(np.int32),
         "v": rng.integers(0, 100, n).astype(np.int32),
         "w": rng.integers(0, 50, n).astype(np.float32)}, device=CPU)


def dim():
    ks = np.arange(24, dtype=np.int32)
    return Table.from_numpy({"dk": ks, "e": (ks * 7 % 5).astype(np.int32)},
                            device=CPU)


def join_groupby(aggs):
    j = P.join(P.load("fact"), P.load("dim"), ["k"], ["dk"])
    g = P.groupby(j, ["k"], aggs)
    return P.PhysicalPlan([P.store(g, "out")])


A1 = {"s": ("sum", "w")}
A2 = {"s": ("sum", "w"), "n": ("count", "w"), "m": ("max", "v")}


def restore_run(mesh, root, **kw):
    """A cold workflow (A1) and a warm one (A2) on ``mesh`` over a disk
    store at ``root``.  Returns (the two results' rows on this process,
    the reports' facts, the store's partitioned artifacts, and on a
    GroupMesh the all_to_all calls made by the end of each workflow)."""
    store = ArtifactStore(root=root, device=CPU, mesh=mesh)
    cat = Catalog(store, device=CPU)
    cat.register("fact", mesh.local_table(fact()))
    cat.register("dim", mesh.local_table(dim()))
    rs = ReStore(cat, store, heuristic="aggressive", mesh=mesh,
                 skew_factor=4.0, **kw)
    res, facts, calls = [], [], []
    for aggs in (A1, A2):
        got, rep = rs.run_plan(join_groupby(aggs))
        res.append(got["out"].to_numpy())
        facts.append(report_facts(rep))
        if mesh.spans_processes:
            calls.append(mesh.transport["all_to_all"]["calls"])
    store.flush()
    parts = sorted(n for n in store.names() if store.partitioning(n))
    store.close()
    return res, facts, parts, calls


def report_facts(rep):
    """What must agree on every rank: each job's plan, reuse and
    storage decisions and its statistics."""
    return [dict(executed=j.executed, reused=sorted(j.reused_artifacts),
                 stored=sorted(j.stored_candidates),
                 rejected=sorted(j.rejected_candidates),
                 ops=(j.n_ops_before, j.n_ops_after),
                 stats=None if j.stats is None else dict(
                     wall=j.stats.wall_s, rows_in=j.stats.rows_in,
                     rows_out=j.stats.rows_out, bytes_in=j.stats.bytes_in,
                     bytes_out=j.stats.bytes_out,
                     op_rows=sorted(j.stats.op_rows.values()),
                     shuffles=j.stats.shuffles,
                     skipped=j.stats.shuffles_skipped,
                     overflow=j.stats.shuffle_overflow))
            for j in rep.jobs]


def rank_restore(rank, world, root, skew_rank=None):
    """``restore_run`` on a GroupMesh of ``world`` gloo ranks.  With
    ``skew_rank``, that rank's engine measures every job a million times
    slower than it ran (its raw walls are returned too): the plan must
    not change."""
    from repro_torch.dataflow import executor
    mesh = GroupMesh(world, "data", backend="gloo", device=CPU)
    raw = []
    if rank == skew_rank:
        timed = executor.Engine._timed

        def slow(self, *a, **kw):
            out = timed(self, *a, **kw)
            raw.append(out[3] * 1e6)
            return out[:3] + (out[3] * 1e6,)
        executor.Engine._timed = slow
    res, facts, parts, calls = restore_run(mesh, root)
    return dict(res=res, facts=facts, parts=parts, raw=raw, calls=calls,
                bytes=mesh.transport["all_to_all"]["bytes"])


def rank_cost_restore(rank, world, root, skew_rank):
    """The "cost" heuristic (whose keep decisions read the measured
    walls) over three workflows, rank ``skew_rank`` skewed as above."""
    from repro_torch.dataflow import executor
    mesh = GroupMesh(world, "data", backend="gloo", device=CPU)
    raw = []
    if rank == skew_rank:
        timed = executor.Engine._timed

        def slow(self, *a, **kw):
            out = timed(self, *a, **kw)
            raw.append(out[3] * 1e6)
            return out[:3] + (out[3] * 1e6,)
        executor.Engine._timed = slow
    store = ArtifactStore(root=root, device=CPU, mesh=mesh)
    cat = Catalog(store, device=CPU)
    cat.register("fact", mesh.local_table(fact()))
    cat.register("dim", mesh.local_table(dim()))
    rs = ReStore(cat, store, heuristic="cost", mesh=mesh, skew_factor=4.0)
    facts, res = [], []
    for aggs in (A1, A1, A2):
        got, rep = rs.run_plan(join_groupby(aggs))
        facts.append(report_facts(rep))
        res.append(got["out"].to_numpy())
    entries = sorted((e.artifact, e.signature) for e in rs.repo.entries)
    store.close()
    return dict(facts=facts, res=res, entries=entries, raw=raw)


# ------------------------------------------------------------ training
def sync_inputs(steps=3):
    rng = np.random.default_rng(7)
    return [{"w": rng.normal(size=(N, 33, 5)).astype(np.float32)
             * (1 + s), "b": rng.normal(size=(N, 17)).astype(np.float32)}
            for s in range(steps)]


def int8_sync(mesh, r):
    """Three error-fed steps of ``make_compressed_sync`` over "data";
    returns each step's means and this process's errors."""
    from repro_torch.train.compression import make_compressed_sync
    sync = make_compressed_sync(mesh, ("data",))
    errors = {"w": torch.zeros(33, 5), "b": torch.zeros(17)}
    out = {}
    for s, g in enumerate(sync_inputs()):
        g = {k: torch.from_numpy(v if r is None else v[r:r + 1])
             for k, v in g.items()}
        mean, errors = sync(g, errors)
        for k in ("w", "b"):
            out[f"mean{s}_{k}"] = mean[k].numpy()
            out[f"err{s}_{k}"] = errors[k].numpy()
    return out


def model_params():
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    cfg = get_config("qwen3-1.7b", smoke=True)
    return cfg, build(cfg, device=CPU).init(0)


def shardings(cfg, params, mesh):
    from repro_torch.launch.sharding import param_specs, to_named
    return to_named(param_specs(cfg, params, mesh), mesh)


def rank_save(rank, world, ckpt, data, model):
    """Save the smoke model's parameters from a (data, model) GroupMesh:
    each rank holds its blocks only."""
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.tree import tree_map
    mesh = GroupMesh((data, model), ("data", "model"), backend="gloo",
                     device=CPU)
    cfg, params = model_params()
    sh = shardings(cfg, params, mesh)
    mine = tree_map(lambda x, s: mesh.localize(x, s.spec), params, sh)
    save_checkpoint(ckpt, 1, mine, extra={"world": world}, shardings=sh)
    return mesh.my_coords


def rank_restore_ckpt(rank, world, ckpt, data, model):
    """Restore the step on a (data, model) GroupMesh; returns this rank's
    coordinates and its blocks with their paths."""
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.tree import tree_leaves_with_path, tree_map
    mesh = GroupMesh((data, model), ("data", "model"), backend="gloo",
                     device=CPU)
    cfg, params = model_params()
    sh = shardings(cfg, params, mesh)
    target = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                            device="meta"), params)
    got, manifest = restore_checkpoint(ckpt, 1, target, sh)
    return dict(coords=mesh.my_coords, extra=manifest["extra"],
                blocks={"/".join(map(str, p)): x.numpy()
                        for p, x in tree_leaves_with_path(got)})


def rank_train(rank, world, ckpt_in, ckpt_out):
    """On a GroupMesh of 4 ("data" 2, "model" 2): the int8 sync over a
    1-D mesh of 4, the 2 -> 4 restore of ``ckpt_in``, and a save from 4
    ranks to ``ckpt_out``."""
    mesh1 = GroupMesh(N, "data", backend="gloo", device=CPU)
    out = {"sync": int8_sync(mesh1, rank)}
    out["restore"] = rank_restore_ckpt(rank, world, ckpt_in, 2, 2)
    out["save"] = rank_save(rank, world, ckpt_out, 2, 2)
    return out


# ------------------------------------------------------------ spawn faults
def rank_fails(rank, world):
    """Rank 2 raises while the others wait in a collective."""
    mesh = GroupMesh(world, "data", backend="gloo", device=CPU)
    if rank == 2:
        raise RuntimeError("rank 2 fails on purpose")
    mesh.barrier()
    return rank


def rank_hangs(rank, world):
    """Every rank but 0 returns; rank 0 waits far past the time limit."""
    import time
    if rank == 0:
        time.sleep(600)
    return rank


# ------------------------------------------------------------ store paths
def store_paths(store, mesh):
    """A monolithic put (the whole table written by rank 0), its read
    from the cache and, after ``drop_caches``, from disk; the table
    re-partitioned on read on "k" into 4 shards and put back
    partitioned.  Returns this process's rows of each step."""
    t = mesh.local_table(fact())
    store.put("mono", t)
    store.flush()
    out = {"cached": store.get("mono").to_numpy()}
    store.drop_caches()
    out["disk"] = store.get("mono").to_numpy()
    tp, part = store.get_partitioned("mono", ["k"], N)
    out["repart"] = tp.to_numpy(only_valid=False)
    out["repart_valid"] = {"v": tp.valid.numpy()}
    store.put("part", tp, partitioning=part)
    store.flush()
    out["part"] = {"shard_rows": np.asarray(part["shard_rows"])}
    return out


def rank_store_paths(rank, world, root):
    mesh = GroupMesh(world, "data", backend="gloo", device=CPU)
    store = ArtifactStore(root=root, device=CPU, mesh=mesh)
    out = store_paths(store, mesh)
    store.close()
    return out
