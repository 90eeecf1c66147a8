"""The port's mesh path against the reference's.

``distributed_groupby``/``_distinct``/``_join`` (with ``return_pre``) and
``_cogroup`` run on ``LocalMesh(8, device="cpu")`` in the port and under
``shard_map`` on 8 forced host devices in the reference, on the same
seeded inputs.  The reference runs in ONE subprocess (XLA_FLAGS must be
set before JAX is imported, as tests/test_mesh_exec.py does), which reads
the inputs from an npz file and writes its outputs to another.  Every
output is compared whole: every slot of every column and of the validity
mask, so the shard layout and the row order agree too, as do the
overflow counts and the shipped hash lane.  Tolerance: none — the float
payloads are integer-valued, so sums are exact in any order.

The port also passes the two ReStore scenarios of test_mesh_exec.py
(warm co-partitioned reuse skips the exchange, the partition-blind arm
does not; a P=4 artifact answers a P=8 mesh by re-partitioning on read),
held against the port's own single-device runs.
"""
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.restore import ReStore  # noqa: E402
from repro_torch.dataflow import shuffle as S  # noqa: E402
from repro_torch.dataflow.physical import op_join  # noqa: E402
from repro_torch.dataflow.table import Table, encode_strings  # noqa: E402
from repro_torch.launch.mesh import LocalMesh  # noqa: E402
from repro_torch.store.artifacts import ArtifactStore, Catalog  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"

AGGS = {"s": ("sum", "v"), "n": ("count", "v"), "m": ("mean", "v"),
        "lo": ("min", "w"), "hi": ("max", "w")}
COG_L = {"sv": ("sum", "v"), "cv": ("count", "v")}
COG_R = {"sz": ("sum", "z")}


def make_inputs():
    """name -> {column: array}; every float payload is integer-valued."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, 40, 500).astype(np.int32)
    fact = {"k": k, "s": encode_strings([f"user{x}" for x in k]),
            "v": rng.integers(0, 100, 500).astype(np.float32),
            "w": rng.integers(-50, 50, 500).astype(np.int32)}
    hot = fact.copy()
    hot["k"] = np.where(rng.random(500) < 0.6, 7, k).astype(np.int32)
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
    return dict(fact=fact, hot=hot, dist=dist, left=left, right=right,
                ca=ca, cb=cb)


# The reference side: runs in a subprocess with 8 forced host devices.
_REFERENCE = f"AGGS, COG_L, COG_R = {AGGS!r}, {COG_L!r}, {COG_R!r}\n" + \
    textwrap.dedent("""
    import sys
    import numpy as np, jax
    from repro.dataflow.table import Table
    from repro.dataflow import shuffle as S

    z = np.load(sys.argv[1])
    ins = {}
    for key in z.files:
        t, c = key.split("__")
        ins.setdefault(t, {})[c] = z[key]
    T = {n: Table.from_numpy(c) for n, c in ins.items()}
    mesh = jax.make_mesh((8,), ("data",))
    out = {}

    def put(case, table, *scalars):
        for c, a in table.columns.items():
            out[f"{case}__{c}"] = np.asarray(a)
        out[f"{case}__valid"] = np.asarray(table.valid)
        for i, x in enumerate(scalars):
            out[f"{case}__s{i}"] = np.asarray(x)

    with mesh:
        for case, kw in (("gb", dict(skew_factor=8.0)),
                         ("gb_skew", dict(skew_factor=1.25)),
                         ("gb_lossless", dict(skew_factor=8.0,
                                              lossless=True))):
            src = T["hot"] if case == "gb_skew" else T["fact"]
            g, o = jax.jit(lambda t: S.distributed_groupby(
                t, ["k"], AGGS, mesh, **kw))(src)
            put(case, g, o)
        g, o = jax.jit(lambda t: S.distributed_groupby(
            t, ["s"], AGGS, mesh, skew_factor=4.0))(T["fact"])
        put("gb_str", g, o)
        d, o = jax.jit(lambda t: S.distributed_distinct(
            t, mesh, skew_factor=8.0))(T["dist"])
        put("dist", d, o)
        j, lane, so, jo = jax.jit(lambda l, r: S.distributed_join(
            l, r, ["k"], ["rk"], mesh, expansion=2, skew_factor=8.0,
            return_pre=True))(T["left"], T["right"])
        put("join", j, so, jo)
        out["join__lane"] = np.asarray(lane)
        g, o = jax.jit(lambda t, ln: S.distributed_groupby(
            t, ["k"], {"s": ("sum", "a")}, mesh, co_partitioned=True,
            pre_lane=ln))(j, lane)
        put("gb_copart", g, o)
        c, o = jax.jit(lambda a, b: S.distributed_cogroup(
            a, b, ["u"], ["w"], COG_L, COG_R, mesh, skew_factor=8.0))(
            T["ca"], T["cb"])
        put("cog", c, o)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def reference():
    """The reference's outputs, from one 8-device subprocess."""
    pytest.importorskip("jax")
    tmp = tempfile.mkdtemp(prefix="torch_shuffle_")
    inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(inp, **{f"{t}__{c}": a for t, cols in make_inputs().items()
                     for c, a in cols.items()})
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, inp, outp],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    z = np.load(outp)
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port():
    """The port's outputs on LocalMesh(8) on the CPU, keyed alike."""
    T = {n: Table.from_numpy(c, device=CPU)
         for n, c in make_inputs().items()}
    mesh = LocalMesh(8, device=CPU)
    out = {}

    def put(case, table, *scalars):
        for c, a in table.columns.items():
            out[f"{case}__{c}"] = a.numpy()
        out[f"{case}__valid"] = table.valid.numpy()
        for i, x in enumerate(scalars):
            out[f"{case}__s{i}"] = x.numpy()

    for case, kw in (("gb", dict(skew_factor=8.0)),
                     ("gb_skew", dict(skew_factor=1.25)),
                     ("gb_lossless", dict(skew_factor=8.0, lossless=True))):
        src = T["hot"] if case == "gb_skew" else T["fact"]
        put(case, *S.distributed_groupby(src, ["k"], AGGS, mesh, **kw))
    put("gb_str", *S.distributed_groupby(T["fact"], ["s"], AGGS, mesh,
                                         skew_factor=4.0))
    put("dist", *S.distributed_distinct(T["dist"], mesh, skew_factor=8.0))
    j, lane, so, jo = S.distributed_join(
        T["left"], T["right"], ["k"], ["rk"], mesh, expansion=2,
        skew_factor=8.0, return_pre=True)
    put("join", j, so, jo)
    out["join__lane"] = lane.numpy()
    put("gb_copart", *S.distributed_groupby(
        j, ["k"], {"s": ("sum", "a")}, mesh, co_partitioned=True,
        pre_lane=lane))
    put("cog", *S.distributed_cogroup(T["ca"], T["cb"], ["u"], ["w"],
                                      COG_L, COG_R, mesh, skew_factor=8.0))
    return out


CASES = ["gb", "gb_skew", "gb_lossless", "gb_str", "dist", "join",
         "gb_copart", "cog"]


@pytest.mark.parametrize("case", CASES)
def test_distributed_operator_matches_reference(reference, port, case):
    ref = {k: v for k, v in reference.items() if k.startswith(case + "__")}
    got = {k: v for k, v in port.items() if k.startswith(case + "__")}
    assert sorted(ref) == sorted(got)
    for k, want in ref.items():
        have = got[k]
        if k == "join__lane":      # uint32 lane vs its int64 carrier
            want = want.astype(np.int64)
        assert have.shape == want.shape, k
        assert np.array_equal(have.astype(want.dtype), want), k
    if case == "gb_skew":
        assert int(got["gb_skew__s0"]) > 0, "the hot key must overflow"


def test_join_rename_chain_matches_single_device():
    """Right side carrying BOTH "v" and "v_r" beside a left "v": the
    sequential rename (v -> v_r -> v_r_r) holds through the mesh."""
    left = Table.from_numpy({"k": np.arange(16, dtype=np.int32),
                             "v": np.arange(16, dtype=np.int32)},
                            device=CPU)
    right = Table.from_numpy({"k2": np.arange(16, dtype=np.int32),
                              "v": (np.arange(16) * 2).astype(np.int32),
                              "v_r": (np.arange(16) * 3).astype(np.int32)},
                             device=CPU)
    ref, _ = op_join(left, right, ["k"], ["k2"])
    got, so, jo = S.distributed_join(left, right, ["k"], ["k2"],
                                     LocalMesh(8, device=CPU),
                                     skew_factor=8.0)
    assert int(so) == 0 and int(jo) == 0
    assert_rows_equal(ref, got)


# ------------------------------------------------- ReStore on the mesh


def canon(tb):
    d = tb.to_numpy()
    order = np.lexsort(tuple(d[c] for c in sorted(d, reverse=True)))
    return {c: d[c][order] for c in sorted(d)}


def assert_rows_equal(a, b):
    ca, cb = canon(a), canon(b)
    assert sorted(ca) == sorted(cb)
    for c in ca:
        assert np.array_equal(ca[c], cb[c]), c


def _fact(n=512, with_v=True):
    rng = np.random.default_rng(0)
    cols = {"k": rng.integers(0, 24, n).astype(np.int32)}
    v = rng.integers(0, 100, n).astype(np.int32)
    if with_v:
        cols["v"] = v
    cols["w"] = rng.integers(0, 50, n).astype(np.float32)
    return Table.from_numpy(cols, device=CPU)


def _dim():
    ks = np.arange(24, dtype=np.int32)
    return Table.from_numpy({"dk": ks, "e": (ks * 7 % 5).astype(np.int32)},
                            device=CPU)


def _q(aggs):
    j = P.join(P.load("fact"), P.load("dim"), ["k"], ["dk"])
    g = P.groupby(j, ["k"], aggs)
    return P.PhysicalPlan([P.store(g, "out")])


def test_mesh_restore_warm_run_skips_shuffle_and_matches_plain():
    """test_mesh_exec.py:105 on the port: warm co-partitioned reuse skips
    the group-by exchange; the partition-blind arm reuses but does not
    skip; both equal the single-device plain run."""
    def fresh(**kw):
        s = ArtifactStore(device=CPU)
        c = Catalog(s, device=CPU)
        c.register("fact", _fact())
        c.register("dim", _dim())
        return ReStore(c, s, device=CPU, **kw)

    a1 = {"s": ("sum", "w")}
    a2 = {"s": ("sum", "w"), "n": ("count", "w"), "m": ("max", "v")}
    rs0 = fresh(heuristic="off", rewrite_enabled=False, semantic=False)
    ref1, _ = rs0.run_plan(_q(a1))
    ref2, _ = rs0.run_plan(_q(a2))

    mesh = LocalMesh(8, device=CPU)
    rs = fresh(heuristic="aggressive", mesh=mesh, skew_factor=8.0)
    got1, rep1 = rs.run_plan(_q(a1))
    assert_rows_equal(ref1["out"], got1["out"])
    assert all(j.stats.shuffle_overflow == 0 and j.stats.join_overflow == 0
               for j in rep1.jobs if j.stats)
    got2, rep2 = rs.run_plan(_q(a2))
    assert_rows_equal(ref2["out"], got2["out"])
    assert rep2.n_reused > 0
    assert any(j.stats.shuffles_skipped > 0 for j in rep2.jobs if j.stats)
    e = next(e for e in rs.repo.entries if e.partitioning)
    assert e.partitioning["keys"] == ["k"]

    blind = fresh(heuristic="aggressive", mesh=mesh, skew_factor=8.0,
                  partition_aware=False)
    blind.run_plan(_q(a1))
    got3, rep3 = blind.run_plan(_q(a2))
    assert_rows_equal(ref2["out"], got3["out"])
    assert rep3.n_reused > 0
    assert all(j.stats.shuffles_skipped == 0 for j in rep3.jobs if j.stats)


def test_mesh_restore_disk_store_repartition_on_read():
    """test_mesh_exec.py:168 on the port: an artifact stored with P=4
    shards answers a P=8 mesh by re-partitioning on read, and the
    consumer still skips its exchange."""
    root = tempfile.mkdtemp(prefix="torch_mesh_repart_")
    store = ArtifactStore(root=root, device=CPU)
    cat = Catalog(store, device=CPU)
    store.put("fact", _fact(with_v=False))
    store.put("dim", _dim())
    a1 = {"s": ("sum", "w")}
    a2 = {"s": ("sum", "w"), "n": ("count", "w")}
    ref_store = ArtifactStore(device=CPU)
    ref_store.put("fact", _fact(with_v=False))
    ref_store.put("dim", _dim())
    ref, _ = ReStore(Catalog(ref_store, device=CPU), ref_store,
                     heuristic="off", rewrite_enabled=False, semantic=False,
                     device=CPU).run_plan(_q(a2))

    rs4 = ReStore(cat, store, heuristic="aggressive",
                  mesh=LocalMesh(4, device=CPU), skew_factor=4.0)
    rs4.run_plan(_q(a1))
    store.flush()
    parts = [store.partitioning(n) for n in store.names()
             if store.partitioning(n)]
    assert any(p["n_parts"] == 4 and p["keys"] == ["k"] for p in parts)

    rs8 = ReStore(cat, store, repository=rs4.repo, heuristic="aggressive",
                  mesh=LocalMesh(8, device=CPU), skew_factor=8.0)
    got, rep = rs8.run_plan(_q(a2))
    assert_rows_equal(ref["out"], got["out"])
    assert rep.n_reused > 0
    assert any(j.stats.shuffles_skipped > 0 for j in rep.jobs if j.stats)
    store.close()


def test_skewed_mesh_job_takes_the_lossless_retry():
    """One hot key at skew 1.25 overflows a bucket: the engine reruns
    the job losslessly once and still equals the single-device run."""
    rng = np.random.default_rng(3)
    k = np.where(rng.random(512) < 0.7, 5, rng.integers(0, 24, 512))
    w = rng.integers(0, 50, 512).astype(np.float32)

    def fresh(**kw):
        s = ArtifactStore(device=CPU)
        c = Catalog(s, device=CPU)
        c.register("fact", Table.from_numpy(
            {"k": k.astype(np.int32), "w": w}, device=CPU))
        c.register("dim", _dim())
        return ReStore(c, s, heuristic="off", rewrite_enabled=False,
                       semantic=False, device=CPU, **kw)

    ref, _ = fresh().run_plan(_q({"s": ("sum", "w")}))
    got, rep = fresh(mesh=LocalMesh(8, device=CPU),
                     skew_factor=1.25).run_plan(_q({"s": ("sum", "w")}))
    assert_rows_equal(ref["out"], got["out"])
    stats = [j.stats for j in rep.jobs if j.stats]
    assert sum(s.shuffle_retries for s in stats) == 1
    assert sum(s.shuffle_overflow for s in stats) > 0


def test_copartitioned_input_must_split_into_shards():
    """A co-partitioned input whose capacity the shard count does not
    divide raises, as the reference's ``_skip`` does."""
    from repro_torch.core.plan import Partitioning, plan_physical_props
    from repro_torch.dataflow.physical import execute_plan
    t = Table.from_numpy({"k": np.arange(12, dtype=np.int32),
                          "w": np.ones(12, np.float32)}, device=CPU)
    plan = P.PhysicalPlan([P.store(P.groupby(P.load("t"), ["k"],
                                             {"s": ("sum", "w")}), "o")])
    props = plan_physical_props(plan, {"t": Partitioning(("k",), 8)},
                                {"t": ("k", "w")}, 8)
    with pytest.raises(ValueError, match="not divisible"):
        execute_plan(plan, {"t": t}, mesh=LocalMesh(8, device=CPU),
                     props=props)


def test_fnv_colliding_string_keys_split_alike_in_both_packages():
    """A fault both packages share: the seed-independent FNV fold of a
    string key makes h1 AND h2 collide together, so two keys whose folds
    collide interleave in the (h1, h2) sort and the sort-based GROUPBY
    splits their groups; the hashed reduce counts them as collisions and
    its lossless retry lands on the same split.  The port keeps the
    reference's answer (ROADMAP queue 3); this pins the parity."""
    pytest.importorskip("jax")
    from repro.dataflow.physical import op_groupby as ref_groupby
    from repro.dataflow.table import Table as JTable
    from repro_torch.dataflow.physical import op_groupby, op_groupby_hashed
    cols = {"s": encode_strings(["user1006693", "user40481",
                                 "user1006693", "user40481"]),
            "v": np.arange(4, dtype=np.float32)}
    aggs = {"n": ("count", "v"), "t": ("sum", "v")}
    want = ref_groupby(JTable.from_numpy(cols), ["s"], aggs).to_numpy()
    t = Table.from_numpy(cols, device=CPU)
    got = op_groupby(t, ["s"], aggs).to_numpy()
    assert len(want["s"]) == len(got["s"]) == 4     # 2 keys, 4 groups
    for c in want:
        assert np.array_equal(got[c], want[c]), c
    _, collisions = op_groupby_hashed(t, ["s"], aggs)
    assert int(collisions) == 2
