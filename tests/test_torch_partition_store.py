"""The port's sharded artifact storage against the reference's.

The cases of tests/test_partition_store.py run on the port's store
(per-partition shard files, the manifest's partition property, bit-exact
round trips against the monolithic layout, re-partition on read, derived
views dropped by delete and re-put and bounded per artifact).  Then both
packages store the same table with the same partitioning: the port must
write the reference's shard arrays and manifest fields
(``shard_capacity``, ``shard_rows``, capacity, rows, bytes), and each
package must reopen the other's partitioned artifacts and derive the
same re-partitioned views.  Tolerance: none — every comparison is exact.
"""
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dataflow.table import Table, partition_hash  # noqa: E402
from repro_torch.store.artifacts import ArtifactStore  # noqa: E402

CPU = "cpu"


def make_cols(n=200, nkeys=13, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, nkeys, n).astype(np.int32),
            "k2": rng.integers(0, 5, n).astype(np.int32),
            "v": rng.integers(0, 100, n).astype(np.float32),
            "s": rng.integers(0, 256, (n, 6)).astype(np.uint8)}


def make_table(n=200, nkeys=13, seed=0):
    return Table.from_numpy(make_cols(n, nkeys, seed), device=CPU)


def canon(d):
    order = np.lexsort(tuple(d[c].reshape(len(d[c]), -1)[:, 0]
                             for c in sorted(d, reverse=True)))
    return {c: d[c][order] for c in sorted(d)}


def assert_rows_equal(a, b):
    ca, cb = canon(a.to_numpy()), canon(b.to_numpy())
    assert sorted(ca) == sorted(cb)
    for c in ca:
        assert ca[c].dtype == cb[c].dtype, c
        assert np.array_equal(ca[c], cb[c]), c


def assert_block_layout(t: Table, part: dict):
    """Every valid row of block i must hash to partition i."""
    n_parts = part["n_parts"]
    assert t.capacity % n_parts == 0
    blk = t.capacity // n_parts
    pid = (partition_hash(t, part["keys"]) % n_parts).numpy()
    mask = t.valid.numpy()
    assert np.array_equal(pid[mask], (np.arange(t.capacity) // blk)[mask])


def partitioned(store, name, keys, n_parts):
    """Put ``name``'s table back re-laid-out in partition blocks, with
    the partition property (the layout a mesh producer creates)."""
    tp, _ = store.get_partitioned(name, keys, n_parts)
    store.put("art", tp, partitioning={"keys": keys, "n_parts": n_parts})
    return tp


# ------------------------------------ test_partition_store.py on the port


def test_sharded_roundtrip_bit_identical_to_monolithic():
    root = tempfile.mkdtemp(prefix="torch_part_")
    s = ArtifactStore(root=root, device=CPU)
    s.put("mono", make_table())
    partitioned(s, "mono", ["k"], 4)
    s.flush()
    s.close()
    s2 = ArtifactStore(root=root, device=CPU)   # fresh open: from disk
    part = s2.partitioning("art")
    assert part["keys"] == ["k"] and part["n_parts"] == 4
    assert part["shard_capacity"] * 4 == s2.get("art").capacity
    assert sum(part["shard_rows"]) == 200
    assert s2.partitioning("mono") is None
    assert sorted(os.listdir(os.path.join(root, "art"))) == [
        "manifest.json"] + [f"shard_{p:05d}.npz" for p in range(4)]
    assert_rows_equal(s2.get("mono"), s2.get("art"))
    assert_block_layout(s2.get("art"), part)
    assert s2.column_names("art") == ("k", "k2", "s", "v")
    assert s2.verify("art")
    s2.close()


def test_mismatched_p_repartitions_on_read():
    t = make_table(seed=3)
    s = ArtifactStore(root=tempfile.mkdtemp(prefix="torch_part_"),
                      device=CPU)
    s.put("a", t)
    partitioned(s, "a", ["k"], 4)
    s.flush()
    got, part = s.get_partitioned("art", ["k"], 8)
    assert part["n_parts"] == 8
    assert_rows_equal(t, got)
    assert_block_layout(got, part)
    got2, part2 = s.get_partitioned("art", ["k"], 8)   # the cached view
    assert got2 is got and part2 == part
    s.close()


def test_compatible_partitioning_loads_shuffle_free():
    s = ArtifactStore(root=tempfile.mkdtemp(prefix="torch_part_"),
                      device=CPU)
    s.put("a", make_table(seed=4))
    partitioned(s, "a", ["k"], 8)
    got, part = s.get_partitioned("art", ["k", "k2"], 8)
    assert part["keys"] == ["k"]                # stored property served
    assert got.capacity == s.get("art").capacity
    s.close()


def test_put_rejects_layout_violating_partition_claim():
    s = ArtifactStore(root=tempfile.mkdtemp(prefix="torch_part_"),
                      device=CPU)
    with pytest.raises(ValueError):
        s.put("bad", make_table(seed=5),
              partitioning={"keys": ["k"], "n_parts": 4})
    assert not s.exists("bad")
    s.close()


def test_delete_drops_shards_and_derived_views():
    s = ArtifactStore(root=tempfile.mkdtemp(prefix="torch_part_"),
                      device=CPU)
    s.put("a", make_table(seed=6))
    partitioned(s, "a", ["k"], 4)
    s.flush()
    s.get_partitioned("art", ["k"], 8)
    s.delete("art")
    assert not s.exists("art")
    with pytest.raises(KeyError):
        s.get("art")
    assert not any(k.startswith("art#") for k in s._repart_meta)
    assert "art#repart8:k" not in s.cache
    s.close()


def test_reput_invalidates_derived_repartition_views():
    s = ArtifactStore(root=tempfile.mkdtemp(prefix="torch_part_"),
                      device=CPU)
    s.put("a", make_table(seed=8))
    v1, _ = s.get_partitioned("a", ["k"], 8)
    t2 = make_table(seed=9)
    s.put("a", t2)
    v2, part = s.get_partitioned("a", ["k"], 8)
    assert v2 is not v1
    assert_rows_equal(t2, v2)
    assert_block_layout(v2, part)
    s.close()


def test_memory_backend_partitioned_roundtrip():
    t = make_table(seed=7)
    s = ArtifactStore(device=CPU)
    s.put("a", t)
    partitioned(s, "a", ["k"], 4)
    assert s.partitioning("art")["n_parts"] == 4
    assert_rows_equal(t, s.get("art"))
    s.close()


def test_derived_views_are_bounded_per_artifact():
    s = ArtifactStore(root=tempfile.mkdtemp(prefix="torch_part_"),
                      device=CPU)
    s.put("a", make_table(seed=11))
    for p in (2, 4, 8, 16, 32, 64, 128, 256, 512):
        s.get_partitioned("a", ["k"], p)
    live = [k for k in s._repart_meta if k.startswith("a#repart")]
    assert len(live) <= s.max_derived_views
    assert {int(k.split("#repart")[1].split(":")[0]) for k in live} \
        == {64, 128, 256, 512}
    assert s.cache.total_bytes == s.cache.recount()
    s.close()


def test_evicted_derived_view_is_rebuilt_never_served_stale():
    """The port's device cache has no eviction hook (the reference's
    prunes a view's metadata when byte pressure evicts it).  A view
    squeezed out of the cache is forgotten at the next registration, and
    a request for it rebuilds it: data and metadata are served only
    together."""
    t = make_table(n=400, seed=14)
    s = ArtifactStore(root=tempfile.mkdtemp(prefix="torch_part_"),
                      cache_bytes=3 * t.nbytes(), device=CPU)
    s.put("a", t)
    v1, _ = s.get_partitioned("a", ["k"], 8)
    ck = "a#repart8:k"
    for i in range(4):                  # pressure evicts the view
        s.put(f"f{i}", make_table(n=400, seed=20 + i))
    # the flusher swaps compacted tables into the cache after publishing
    # them; wait it out so no swap evicts an entry under the checks below
    s.flush()
    assert ck not in s.cache
    v2, part = s.get_partitioned("a", ["k"], 8)
    assert v2 is not v1
    assert_rows_equal(t, v2)
    assert_block_layout(v2, part)
    s.get_partitioned("a", ["k"], 4)
    assert all(k in s.cache for k in s._derived_order["a"])
    assert s.cache.total_bytes == s.cache.recount()
    s.close()


def test_view_evicted_by_a_newer_view_is_forgotten_at_once():
    """A byte short of room for the base and both views: registering the
    P=4 view evicts the P=8 one (the least recently used entry), and the
    registration forgets it in the same step, so no metadata outlives
    its data."""
    t = make_table(n=400, seed=15)
    sizes = ArtifactStore(device=CPU)
    sizes.put("a", t)
    room = t.nbytes() + sum(sizes.get_partitioned("a", ["k"], p)[0].nbytes()
                            for p in (8, 4)) - 1
    s = ArtifactStore(cache_bytes=room, device=CPU)
    s.put("a", t)
    s.get_partitioned("a", ["k"], 8)
    assert s._derived_order["a"] == ["a#repart8:k"]
    s.get_partitioned("a", ["k"], 4)
    assert "a#repart8:k" not in s.cache
    assert s._derived_order["a"] == ["a#repart4:k"]
    assert set(s._repart_meta) == {"a#repart4:k"}
    v, part = s.get_partitioned("a", ["k"], 8)
    assert_rows_equal(t, v)
    assert_block_layout(v, part)


# ------------------------------------------------------ across packages


@pytest.fixture
def jref():
    """The reference's store and Table (JAX)."""
    pytest.importorskip("jax")
    from repro.dataflow.table import Table as JTable
    from repro.store.artifacts import ArtifactStore as JStore
    return JTable, JStore


def _shards(root, name, n_parts):
    out = []
    for p in range(n_parts):
        with np.load(os.path.join(root, name, f"shard_{p:05d}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _manifest(root, name):
    with open(os.path.join(root, name, "manifest.json")) as f:
        m = json.load(f)
    return {k: m[k] for k in ("capacity", "rows", "nbytes",
                              "partitioning")}


@pytest.mark.parametrize("keys,n_parts", [(["k"], 4), (["k", "s"], 8),
                                          (["s"], 2)])
def test_port_writes_the_reference_shards(jref, keys, n_parts):
    JTable, JStore = jref
    cols = make_cols(n=300, seed=21)
    roots = {}
    for pkg in ("port", "ref"):
        roots[pkg] = tempfile.mkdtemp(prefix=f"torch_part_{pkg}_")
        if pkg == "port":
            s = ArtifactStore(root=roots[pkg], device=CPU)
            s.put("a", Table.from_numpy(cols, device=CPU))
        else:
            s = JStore(root=roots[pkg])
            s.put("a", JTable.from_numpy(cols))
        tp, _ = s.get_partitioned("a", keys, n_parts)
        s.put("art", tp, partitioning={"keys": keys, "n_parts": n_parts})
        s.flush()
        s.close()
    assert _manifest(roots["port"], "art") == _manifest(roots["ref"], "art")
    got = _shards(roots["port"], "art", n_parts)
    want = _shards(roots["ref"], "art", n_parts)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


def test_each_package_reopens_the_others_partitioned_artifacts(jref):
    JTable, JStore = jref
    cols = make_cols(n=300, seed=22)
    port_root = tempfile.mkdtemp(prefix="torch_part_port_")
    ref_root = tempfile.mkdtemp(prefix="torch_part_ref_")
    s = ArtifactStore(root=port_root, device=CPU)
    s.put("a", Table.from_numpy(cols, device=CPU))
    partitioned(s, "a", ["k"], 4)
    s.flush()
    s.close()
    j = JStore(root=ref_root)
    j.put("a", JTable.from_numpy(cols))
    tp, _ = j.get_partitioned("a", ["k"], 4)
    j.put("art", tp, partitioning={"keys": ["k"], "n_parts": 4})
    j.flush()
    j.close()

    def whole(t):
        return {**{c: np.asarray(a) for c, a in t.columns.items()},
                "__valid__": np.asarray(t.valid)}

    for root in (port_root, ref_root):
        ps = ArtifactStore(root=root, device=CPU)
        js = JStore(root=root)
        assert ps.partitioning("art") == js.partitioning("art")
        pairs = [(ps.get("art"), js.get("art")),
                 (ps.get_partitioned("art", ["k"], 8)[0],
                  js.get_partitioned("art", ["k"], 8)[0]),
                 (ps.get_partitioned("art", ["k2", "k"], 4)[0],
                  js.get_partitioned("art", ["k2", "k"], 4)[0]),
                 (ps.get_partitioned("a", ["k2"], 8)[0],
                  js.get_partitioned("a", ["k2"], 8)[0])]
        for p, r in pairs:
            wp = {c: a.numpy() for c, a in p.columns.items()}
            wp["__valid__"] = p.valid.numpy()
            wr = whole(r)
            assert sorted(wp) == sorted(wr)
            for c in wr:
                assert np.array_equal(wp[c], wr[c]), (root, c)
        ps.close()
        js.close()
