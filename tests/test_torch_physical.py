"""The port's physical operators against ``repro.dataflow.physical`` on
the cases of ``tests/test_table_ops.py`` and ``tests/test_join_probe.py``.

Both engines sort by the same hashes with the same stable order, so the
outputs are compared whole — every slot, valid or not, in order: keys,
row routing and integer-valued aggregates exactly, float sums and means
within ``RTOL``/``ATOL`` (the port adds in another association)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import plan as RP  # noqa: E402
from repro.dataflow import expr as RE  # noqa: E402
from repro.dataflow import physical as RPH  # noqa: E402
from repro.dataflow import table as RT  # noqa: E402
from repro_torch.core import plan as TP  # noqa: E402
from repro_torch.dataflow import expr as TE  # noqa: E402
from repro_torch.dataflow import physical as TPH  # noqa: E402
from repro_torch.dataflow import table as TT  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4


def make_cols(n, n_keys, seed=0, capacity=None):
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(n_keys)]
    cols = {
        "key": RT.encode_strings([keys[i] for i in
                                  rng.integers(0, n_keys, n)]),
        "ikey": rng.integers(0, n_keys, n).astype(np.int32),
        "val": rng.uniform(-5, 5, n).astype(np.float32),
        "cnt": rng.integers(0, 10, n).astype(np.int32),
    }
    cap = capacity or n
    valid = np.arange(cap) < n
    cols = {k: np.pad(a, [(0, cap - n)] + [(0, 0)] * (a.ndim - 1))
            for k, a in cols.items()}
    return cols, valid


def _pair(cols, valid):
    ref = RT.Table({n: jnp.asarray(a) for n, a in cols.items()},
                   jnp.asarray(valid))
    return ref, TT.Table.from_numpy(cols, valid=valid, device="cpu")


def assert_same(port_t, ref_t, approx=()):
    np.testing.assert_array_equal(port_t.valid.numpy(),
                                  np.asarray(ref_t.valid))
    assert sorted(port_t.columns) == sorted(ref_t.columns)
    for k in ref_t.columns:
        got, want = port_t.col(k).numpy(), np.asarray(ref_t.col(k))
        assert got.dtype == want.dtype, k
        if k in approx:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def run_both(build, datasets, approx=()):
    """build(P, E) -> plan in module P with expressions from E."""
    ref_ds, port_ds = {}, {}
    for name, (cols, valid) in datasets.items():
        ref_ds[name], port_ds[name] = _pair(cols, valid)
    r_out, r_stats = RPH.execute_plan(build(RP, RE), ref_ds)
    t_out, t_stats = TPH.execute_plan(build(TP, TE), port_ds)
    assert sorted(t_out) == sorted(r_out)
    for k in r_out:
        assert_same(t_out[k], r_out[k], approx)
    r_rows = sorted(int(s["rows_out"]) for s in r_stats.values())
    t_rows = sorted(int(s["rows_out"]) for s in t_stats.values())
    assert t_rows == r_rows
    return t_out, r_out


def test_filter():
    run_both(lambda P, E: P.PhysicalPlan([P.store(
        P.filter_(P.load("t"), E.Col("val") > 0.0), "out")]),
        {"t": make_cols(500, 7)})


def test_groupby_all_aggregates():
    run_both(lambda P, E: P.PhysicalPlan([P.store(P.groupby(
        P.load("t"), ["key"], {"s": ("sum", "val"), "c": ("count", "val"),
                               "mx": ("max", "val"), "mn": ("min", "val"),
                               "m": ("mean", "val"),
                               "ci": ("sum", "cnt")}), "out")]),
        {"t": make_cols(512, 9, capacity=640)}, approx={"s", "m"})


def test_groupby_two_keys_integer_sums_exact():
    run_both(lambda P, E: P.PhysicalPlan([P.store(P.groupby(
        P.load("t"), ["key", "ikey"], {"t": ("sum", "cnt"),
                                       "n": ("count", "cnt")}), "out")]),
        {"t": make_cols(700, 5, seed=3)})


def test_join():
    rng = np.random.default_rng(2)
    rkeys = [f"k{i}" for i in range(8)]
    right = {"key": RT.encode_strings(rkeys),
             "payload": rng.integers(0, 100, len(rkeys)).astype(np.int32)}
    run_both(lambda P, E: P.PhysicalPlan([P.store(P.join(
        P.load("l"), P.load("r"), ["key"], ["key"]), "out")]),
        {"l": make_cols(300, 11, seed=1),
         "r": (right, np.ones(len(rkeys), bool))})


def test_distinct_union():
    run_both(lambda P, E: P.PhysicalPlan([P.store(P.distinct(P.union(
        P.project(P.load("t"), ["key"]),
        P.project(P.load("t2"), ["key"]))), "out")]),
        {"t": make_cols(200, 5), "t2": make_cols(100, 8, seed=9)})


def test_cogroup_counts_and_sums():
    run_both(lambda P, E: P.PhysicalPlan([P.store(P.cogroup(
        P.load("a"), P.load("b"), ["key"], ["key"],
        {"na": ("count", "val"), "sa": ("sum", "val")},
        {"nb": ("count", "val"), "xb": ("max", "val")}), "out")]),
        {"a": make_cols(256, 6, seed=3), "b": make_cols(128, 6, seed=4)},
        approx={"l_sa"})


@pytest.mark.parametrize("seed", [0, 17, 333])
def test_seeded_groupby_filter_distinct_properties(seed):
    rng = np.random.default_rng(seed)
    n, n_keys = int(rng.integers(4, 200)), int(rng.integers(1, 20))
    ds = {"t": make_cols(n, n_keys, seed=seed)}
    out, _ = run_both(lambda P, E: P.PhysicalPlan([P.store(P.groupby(
        P.load("t"), ["ikey"], {"s": ("sum", "val")}), "out")]), ds,
        approx={"s"})
    got = out["out"].to_numpy()
    ref = TT.Table.from_numpy(ds["t"][0], device="cpu").to_numpy()
    assert abs(got["s"].sum() - ref["val"].sum()) < 1e-2
    thresh = float(np.quantile(ref["val"], rng.random()))
    run_both(lambda P, E: P.PhysicalPlan([P.store(
        P.filter_(P.load("t"), E.Col("val") <= thresh), "out")]), ds)
    run_both(lambda P, E: P.PhysicalPlan([P.store(P.distinct(
        P.project(P.load("t"), ["key"])), "out")]), ds)


def test_foreach_const_broadcast_and_cast():
    run_both(lambda P, E: P.PhysicalPlan([P.store(P.foreach(
        P.load("t"), {"all": E.Const(1), "x": E.Cast(E.Col("val") > 0,
                                                     "int32") * E.Col("cnt"),
                      "r": E.Col("cnt") / E.Col("ikey")}), "out")]),
        {"t": make_cols(100, 4)})


# -------------------------------------------- tests/test_join_probe.py


def _join_both(left, right, expansion):
    lr, lt = _pair(left, np.ones(len(left["k"]), bool))
    rr, rt = _pair(right, np.ones(len(right["k"]), bool))
    r_out, r_ovf = RPH.op_join(lr, rr, ["k"], ["k"], expansion=expansion)
    t_out, t_ovf = TPH.op_join(lt, rt, ["k"], ["k"], expansion=expansion)
    assert int(t_ovf) == int(r_ovf)
    assert_same(t_out, r_out)
    return t_out, int(t_ovf)


def test_duplicate_right_keys_with_expansion():
    left = {"k": np.array([7, 5, 3, 5], np.int32),
            "lv": np.array([10, 20, 30, 40], np.int32)}
    filler = np.arange(1000, 1012, dtype=np.int32)
    right = {"k": np.concatenate([np.array([5, 5, 3], np.int32), filler]),
             "rv": np.concatenate([np.array([100, 200, 300], np.int32),
                                   np.zeros(12, np.int32)])}
    out, ovf = _join_both(left, right, 2)
    assert ovf == 0
    got = out.to_numpy()
    assert sorted(zip(got["k"], got["lv"], got["rv"])) == [
        (3, 30, 300), (5, 20, 100), (5, 20, 200), (5, 40, 100), (5, 40, 200)]


def test_unmatched_first_row_does_not_poison_gather():
    left = {"k": np.array([99, 1, 2, 3], np.int32),
            "lv": np.arange(4, dtype=np.int32)}
    right = {"k": np.array([3, 2, 1], np.int32),
             "rv": np.array([30, 20, 10], np.int32)}
    out, _ = _join_both(left, right, 1)
    got = out.to_numpy()
    assert sorted(zip(got["k"], got["rv"])) == [(1, 10), (2, 20), (3, 30)]


def test_join_overflow_counted_like_reference():
    # every right key collides in one window: the tail witnesses overflow
    left = {"k": np.array([5, 6, 5], np.int32),
            "lv": np.arange(3, dtype=np.int32)}
    right = {"k": np.full(20, 5, np.int32),
             "rv": np.arange(20, dtype=np.int32)}
    _, ovf = _join_both(left, right, 1)
    assert ovf > 0


def test_join_probe_at_32k_rows():
    rng = np.random.default_rng(0)
    n = 1 << 15
    left = {"k": rng.integers(0, 64, n).astype(np.int32),
            "lv": rng.integers(0, 100, n).astype(np.int32)}
    right = {"k": np.arange(64, dtype=np.int32),
             "rv": np.arange(64, dtype=np.int32)}
    _join_both(left, right, 1)
