"""The service path of the port on the card, held against the same runs
with ``device="cpu"`` (where every kernel wrapper takes its plain
version): a delta refresh through the engine (GROUPBY and JOIN, so the
segment-sum and probe kernels run, and the re-aggregation merge),
``merge_shards`` on a partitioned artifact, and a 4-worker
``ReStoreService`` over a disk store (the compaction kernel on the write
path).  The refresh and merge cases hold integer-valued data, so they
are bit-identical; the service's float sums of ``estimated_revenue`` add
in another order on the card and agree within 1e-4.  These tests need a
CUDA card and skip without one; this file imports the port only, so it
also runs where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import delta as D  # noqa: E402
from repro_torch.core import plan as P  # noqa: E402
from repro_torch.core.repository import Repository  # noqa: E402
from repro_torch.core.restore import ReStore  # noqa: E402
from repro_torch.dataflow.expr import Col  # noqa: E402
from repro_torch.dataflow.physical import op_groupby  # noqa: E402
from repro_torch.dataflow.table import Table  # noqa: E402
from repro_torch.service.service import ReStoreService  # noqa: E402
from repro_torch.store.artifacts import ArtifactStore, Catalog  # noqa: E402
from repro_torch.workloads import pigmix  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fact(seed, n, dev):
    rng = np.random.default_rng(seed)
    return Table.from_numpy({
        "k": rng.integers(0, 64, n).astype(np.int32),
        "v": rng.integers(0, 100, n).astype(np.int32),
        "w": rng.integers(0, 50, n).astype(np.float32)}, device=dev)


def _dim(dev):
    ks = np.arange(64, dtype=np.int32)
    return Table.from_numpy({"dk": ks, "x": ks * 3}, device=dev)


def _sortable(a):
    if a.ndim == 2:          # a byte-string column: one bytes key a row
        return np.ascontiguousarray(a).view(f"S{a.shape[1]}").ravel()
    return a


def _assert_same(a, b, rtol=0.0):
    """Equal valid rows after a sort by the non-float columns, then the
    float ones; float columns within ``rtol`` (0: bit-identical)."""
    da, db = a.to_numpy(), b.to_numpy()
    assert sorted(da) == sorted(db)
    cols = sorted(da, key=lambda c: (da[c].dtype.kind == "f", c))

    def order(d):
        return np.lexsort(tuple(_sortable(d[c]) for c in reversed(cols)))
    oa, ob = order(da), order(db)
    for c in cols:
        x, y = da[c][oa], db[c][ob]
        assert x.dtype == y.dtype, c
        if rtol and x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-3)
        else:
            assert np.array_equal(x, y), c


def _groupby_plan():
    f = P.filter_(P.load("fact"), Col("v") > 10)
    g = P.groupby(f, ["k"], {"s": ("sum", "w"), "n": ("count", "v"),
                             "mn": ("min", "v"), "mx": ("max", "v")})
    return P.PhysicalPlan([P.store(g, "out")])


def _join_plan():
    j = P.join(P.project(P.load("fact"), ["k", "v"]), P.load("dim"),
               ["k"], ["dk"])
    return P.PhysicalPlan([P.store(j, "out")])


def _refreshed(build, dev):
    store = ArtifactStore(device=dev)
    cat = Catalog(store, device=dev)
    cat.register("fact", _fact(0, 1 << 14, dev))
    cat.register("dim", _dim(dev))
    rs = ReStore(cat, store, heuristic="aggressive",
                 min_splice_benefit_s=0.0, device=dev)
    rs.run_plan(build())
    cat.append("fact", _fact(1, 1 << 11, dev))
    rep = rs.maintain(mode="refresh")
    out, run_rep = rs.run_plan(P.rebind_load_versions(build(),
                                                      {"fact": 1}))
    assert rep["refreshed"] >= 1 and run_rep.n_executed == 0
    return out["out"]


@pytest.mark.cuda
@pytest.mark.parametrize("build", [_groupby_plan, _join_plan],
                         ids=["groupby", "join"])
def test_refresh_on_card_matches_cpu(cuda, build):
    got = _refreshed(build, cuda)
    assert got.device.type == "cuda"
    _assert_same(got, _refreshed(build, "cpu"))


def _merged(dev):
    store = ArtifactStore(device=dev)
    old = op_groupby(_fact(0, 1 << 14, dev), ["k"],
                     {"s": ("sum", "w"), "n": ("count", "v")})
    store.put("tmp", old)
    tp, _ = store.get_partitioned("tmp", ["k"], 8)
    store.put("agg", tp, partitioning={"keys": ["k"], "n_parts": 8})
    partial = op_groupby(_fact(1, 1 << 11, dev), ["k"],
                         {"s": ("sum", "w"), "n": ("count", "v")})
    merge = D._reagg_merge(("k",), {"s": ("sum", "s"), "n": ("sum", "n")})
    store.merge_shards("agg", partial, merge_fn=merge)
    return store.get("agg"), store.partitioning("agg")


@pytest.mark.cuda
def test_merge_shards_on_card_matches_cpu(cuda):
    (a, pa), (b, pb) = _merged(cuda), _merged("cpu")
    assert a.device.type == "cuda" and pa == pb
    for c in a.names:
        assert np.array_equal(a.col(c).cpu().numpy(), b.col(c).numpy()), c
    assert np.array_equal(a.valid.cpu().numpy(), b.valid.numpy())


def _service_run(dev, root):
    store = ArtifactStore(root=str(root), device=dev)
    cat = Catalog(store, device=dev)
    pigmix.register_all(cat, n_rows=1 << 14)
    svc = ReStoreService(cat, store, Repository(), n_workers=4, device=dev)
    try:
        queries = [pigmix.L2, lambda: pigmix.L3("sum"), pigmix.L4,
                   lambda: pigmix.L3("mean"), pigmix.L5, pigmix.L6]
        tickets = [svc.submit(q(), tenant=f"t{i % 3}")
                   for i, q in enumerate(queries)]
        # a stampede of one plan collapses onto one execution
        burst = [svc.submit(pigmix.L7(), tenant=f"b{i}") for i in range(4)]
        out = [t.result(timeout=300)[0] for t in tickets + burst]
        st = svc.stats()
    finally:
        svc.stop()
    assert st["failed"] == 0 and st["dup_executions"] == 0
    assert st["singleflight_hits"] >= 1
    return out


@pytest.mark.cuda
def test_four_worker_service_on_card_matches_cpu(cuda, tmp_path):
    got = _service_run(cuda, tmp_path / "card")
    want = _service_run("cpu", tmp_path / "cpu")
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            # float sums of estimated_revenue add in another order
            _assert_same(g[k], w[k], rtol=1e-4)
