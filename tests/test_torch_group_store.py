"""The store and the training pieces over 4 gloo ranks on the CPU.

  * ReStore on a ``GroupMesh`` of 4 over one disk store: the cold
    workflow (join -> group-by) stores partitioned artifacts, each rank
    writing its own shard file; the warm one (other aggregates) reuses
    the join artifact and runs no exchange; both answers equal the
    single-process plain run, and every rank holds the same report.  The
    artifacts' names, manifests (less the write time and the files'
    crc32s, which cover zip headers stamped with it) and the arrays of
    every shard file are byte for byte those the reference's ReStore
    writes on 4 forced host devices (one JAX subprocess) and those the
    port's ``LocalMesh(4)`` writes.
  * The int8 gradient sync (``make_compressed_sync``) over the 4 ranks:
    three error-fed steps, every mean and every rank's error bit-equal to
    ``LocalMesh(4)``'s.
  * The elastic restore at qwen3-1.7b's smoke config: parameters saved
    from a (1, 2) mesh of 2 ranks restore on a (2, 2) mesh of 4, and the
    4 ranks' save restores on (1, 2): every rank holds exactly the blocks
    ``NamedSharding.blocks`` gives its coordinates of the source tree.
"""
import io
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _group_mesh_util as U  # noqa: E402
from repro_torch.launch.mesh import LocalMesh, spawn  # noqa: E402
from repro_torch.launch.sharding import NamedSharding  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(fn, world=4, args=()):
    d = tempfile.mkdtemp(prefix="group_store_")
    return spawn(fn, world, backend="gloo", init_file=os.path.join(d, "rdv"),
                 timeout=150, args=args)


_REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np, jax
    from repro.core import plan as P
    from repro.core.restore import ReStore
    from repro.dataflow.table import Table
    from repro.store.artifacts import ArtifactStore, Catalog

    rng = np.random.default_rng(0)
    n = 512
    fact = Table.from_numpy({
        "k": rng.integers(0, 24, n).astype(np.int32),
        "v": rng.integers(0, 100, n).astype(np.int32),
        "w": rng.integers(0, 50, n).astype(np.float32)})
    ks = np.arange(24, dtype=np.int32)
    dim = Table.from_numpy({"dk": ks, "e": (ks * 7 % 5).astype(np.int32)})

    def q(aggs):
        j = P.join(P.load("fact"), P.load("dim"), ["k"], ["dk"])
        g = P.groupby(j, ["k"], aggs)
        return P.PhysicalPlan([P.store(g, "out")])

    store = ArtifactStore(root=sys.argv[1])
    cat = Catalog(store)
    cat.register("fact", fact)
    cat.register("dim", dim)
    rs = ReStore(cat, store, heuristic="aggressive",
                 mesh=jax.make_mesh((4,), ("data",)), skew_factor=4.0)
    with jax.make_mesh((4,), ("data",)):
        for aggs in ({"s": ("sum", "w")},
                     {"s": ("sum", "w"), "n": ("count", "w"),
                      "m": ("max", "v")}):
            rs.run_plan(q(aggs))
    store.flush()
    store.close()
""")


def _artifacts(root):
    """{dir: (manifest less time and crc32s, {file: {member: bytes}})}
    of every partitioned artifact under ``root``."""
    out = {}
    for d in sorted(os.listdir(root)):
        mpath = os.path.join(root, d, "manifest.json")
        if d.startswith(".") or not os.path.exists(mpath):
            continue
        with open(mpath) as f:
            m = json.load(f)
        if m.get("partitioning") is None:
            continue
        files = {}
        for fn in sorted(os.listdir(os.path.join(root, d))):
            if fn.endswith(".npz"):
                with open(os.path.join(root, d, fn), "rb") as f:
                    z = zipfile.ZipFile(io.BytesIO(f.read()))
                files[fn] = {i.filename: z.read(i) for i in z.infolist()}
        m.pop("created")
        assert sorted(m.pop("checksums")) == sorted(files)
        out[d] = (m, files)
    return out


@pytest.fixture(scope="module")
def restore_runs():
    pytest.importorskip("jax")
    tmp = tempfile.mkdtemp(prefix="group_restore_")
    roots = {k: os.path.join(tmp, k) for k in ("ref", "local", "group")}
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, roots["ref"]],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ranks = _spawn(U.rank_restore, args=(roots["group"],))
    local = U.restore_run(LocalMesh(U.N, device=U.CPU), roots["local"])
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return ranks, local, {k: _artifacts(r) for k, r in roots.items()}


def test_group_restore_warm_run_skips_the_shuffle(restore_runs):
    ranks, (local_res, local_facts, *_), _ = restore_runs
    for r in ranks[1:]:
        assert r["facts"] == ranks[0]["facts"]
        assert r["parts"] == ranks[0]["parts"]
    cold, warm = ranks[0]["facts"]
    assert any(j["stored"] for j in cold) and ranks[0]["parts"]
    assert any(j["reused"] for j in warm)
    # every exchange site of the warm run is skipped, and no rank sends
    # a row: the join is the artifact, co-partitioned on the key
    executed = [j for j in warm if j["stats"] is not None]
    assert executed and all(
        j["stats"]["shuffles"] == j["stats"]["skipped"] > 0
        for j in executed)
    assert all(r["calls"][1] == r["calls"][0] > 0 for r in ranks)
    # the statistics are the whole mesh's: LocalMesh's rows, exchanges
    # and overflows (the bytes count capacities, and a GroupMesh's
    # store compacts its artifacts when it writes them, inline, where
    # one process's write-behind may not have yet)
    def strip(facts):
        return [[{**j, "stats": j["stats"] and {
            k: v for k, v in j["stats"].items()
            if k not in ("wall", "bytes_in", "bytes_out")}} for j in f]
            for f in facts]
    assert strip(ranks[0]["facts"]) == strip(local_facts)
    assert all(r["bytes"] > 0 for r in ranks)


@pytest.mark.parametrize("run", [0, 1])
def test_group_restore_answers_equal_plain(restore_runs, run):
    ranks, (local_res, *_), _ = restore_runs
    store = U.ArtifactStore(device=U.CPU)
    cat = U.Catalog(store, device=U.CPU)
    cat.register("fact", U.fact())
    cat.register("dim", U.dim())
    plain = U.ReStore(cat, store, heuristic="off", rewrite_enabled=False,
                      semantic=False, device=U.CPU)
    want = plain.run_plan(U.join_groupby((U.A1, U.A2)[run]))[0]["out"]
    got = {c: np.concatenate([r["res"][run][c] for r in ranks])
           for c in ranks[0]["res"][run]}
    _assert_rows_equal(got, want.to_numpy())
    # and slot for slot LocalMesh(4)'s
    for c in got:
        np.testing.assert_array_equal(got[c], local_res[run][c])


@pytest.mark.parametrize("other", ["ref", "local"])
def test_group_shard_files_are_the_references(restore_runs, other):
    *_, arts = restore_runs
    assert arts["group"] and sorted(arts["group"]) == sorted(arts[other])
    for name, (m, files) in arts["group"].items():
        om, ofiles = arts[other][name]
        assert m == om, name
        assert sorted(files) == [f"shard_{p:05d}.npz" for p in range(4)]
        assert files == ofiles, name


def _canon(d):
    order = np.lexsort(tuple(d[c] for c in sorted(d, reverse=True)))
    return {c: d[c][order] for c in sorted(d)}


def _assert_rows_equal(a, b):
    ca, cb = _canon(a), _canon(b)
    assert sorted(ca) == sorted(cb)
    for c in ca:
        np.testing.assert_array_equal(ca[c], cb[c], err_msg=c)


# ------------------------------------------------------------ training
@pytest.fixture(scope="module")
def training():
    """2 ranks save at (1, 2); 4 ranks sync, restore that at (2, 2) and
    save; 2 ranks restore the 4 ranks' save at (1, 2)."""
    tmp = tempfile.mkdtemp(prefix="group_train_")
    two, four = os.path.join(tmp, "two"), os.path.join(tmp, "four")
    saved2 = _spawn(U.rank_save, world=2, args=(two, 1, 2))
    ranks = _spawn(U.rank_train, args=(two, four))
    back = _spawn(U.rank_restore_ckpt, world=2, args=(four, 1, 2))
    return saved2, ranks, back


def test_int8_sync_over_ranks_is_local_mesh_bit_for_bit(training):
    _, ranks, _ = training
    want = U.int8_sync(LocalMesh(U.N, device=U.CPU), None)
    for r, got in enumerate(ranks):
        for k, w in want.items():
            g = got["sync"][k]
            if k.startswith("err"):    # each rank's own row of errors
                w = w[r:r + 1]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def _check_blocks(results, data, model):
    cfg, params = U.model_params()
    mesh = LocalMesh((data, model), ("data", "model"), device=U.CPU)
    sh = U.shardings(cfg, params, mesh)
    whole = {"/".join(map(str, p)): (x, s) for (p, x), (_, s) in zip(
        tree_leaves_with_path(params), tree_leaves_with_path(sh))}
    n_split = 0
    for res in results:
        assert sorted(res["blocks"]) == sorted(whole)
        for key, (x, s) in whole.items():
            assert isinstance(s, NamedSharding)
            want = mesh.block(x, s.spec, res["coords"])
            n_split += want.shape != x.shape
            np.testing.assert_array_equal(res["blocks"][key], want.numpy(),
                                          err_msg=key)
    assert n_split > 0        # some leaves really are split


def test_elastic_restore_two_to_four(training):
    saved2, ranks, _ = training
    assert [c["model"] for c in saved2] == [0, 1]
    _check_blocks([r["restore"] for r in ranks], 2, 2)
    assert all(r["restore"]["extra"] == {"world": 2} for r in ranks)


def test_elastic_restore_four_to_two(training):
    *_, back = training
    _check_blocks(back, 1, 2)
    assert all(r["extra"] == {"world": 4} for r in back)


# ------------------------------------------------------------ store paths
def test_monolithic_and_repartitioned_artifacts_over_ranks(tmp_path):
    """A monolithic artifact put from 4 ranks' blocks is the whole
    table, written once (its data.npz members byte-equal to a single
    process's put of the whole table); a rank reads back its own rows
    from the cache and its block of the stored table from disk; the
    re-partition on read gives each rank its partition of the
    single-process re-partition, and the partitioned put writes the
    single process's shard files."""
    roots = {k: str(tmp_path / k) for k in ("group", "one")}
    ranks = _spawn(U.rank_store_paths, args=(roots["group"],))
    store = U.ArtifactStore(root=roots["one"], device=U.CPU)
    one = U.store_paths(store, LocalMesh(1, device=U.CPU))
    store.close()
    whole = U.fact().to_numpy()
    for c in whole:
        np.testing.assert_array_equal(
            np.concatenate([r["cached"][c] for r in ranks]), whole[c])
        np.testing.assert_array_equal(
            np.concatenate([r["disk"][c] for r in ranks]), one["disk"][c])
        np.testing.assert_array_equal(
            np.concatenate([r["repart"][c] for r in ranks]),
            one["repart"][c])
    np.testing.assert_array_equal(
        np.concatenate([r["repart_valid"]["v"] for r in ranks]),
        one["repart_valid"]["v"])
    for name in ("mono", "part"):
        g = _files(os.path.join(roots["group"], name))
        o = _files(os.path.join(roots["one"], name))
        assert g == o and g, name


def _files(d):
    """{file: {npz member: bytes}} and the manifest less its write time
    and crc32s, of one artifact directory."""
    out = {}
    for fn in sorted(os.listdir(d)):
        path = os.path.join(d, fn)
        if fn.endswith(".npz"):
            with open(path, "rb") as f:
                z = zipfile.ZipFile(io.BytesIO(f.read()))
            out[fn] = {i.filename: z.read(i) for i in z.infolist()}
        elif fn == "manifest.json":
            with open(path) as f:
                m = json.load(f)
            m.pop("created")
            m.pop("checksums")
            out[fn] = m
    return out
