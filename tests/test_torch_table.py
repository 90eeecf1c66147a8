"""The port's Table and hashes against the JAX reference's, on the same
numpy inputs.  Hashes must be bit-equal: artifact names, fingerprints
and the store's partition layout all rest on them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.dataflow import table as RT  # noqa: E402
from repro_torch.dataflow import table as TT  # noqa: E402


def _int_col(rng, n):
    a = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    a[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return a


def _float_col(rng, n):
    a = rng.standard_normal(n).astype(np.float32) * 1e3
    a[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40]
    return a


def _str_col(rng, n):
    words = [f"user{i:04d}" for i in range(37)] + ["", "x" * 25, "émoji"]
    return RT.encode_strings([words[i] for i in
                              rng.integers(0, len(words), n)])


def _pair(cols, valid):
    ref = RT.Table({n: jnp.asarray(a) for n, a in cols.items()},
                   jnp.asarray(valid))
    port = TT.Table.from_numpy(cols, valid=valid, device="cpu")
    return ref, port


@pytest.mark.parametrize("kind", ["int32", "float32", "string"])
@pytest.mark.parametrize("seed", [0, 101, 7])
def test_hash_column_bit_equal(kind, seed):
    rng = np.random.default_rng(seed)
    gen = {"int32": _int_col, "float32": _float_col, "string": _str_col}
    col = gen[kind](rng, 1500)
    want = np.asarray(RT.hash_column(jnp.asarray(col), seed))
    got = TT.hash_column(torch.from_numpy(col), seed).numpy()
    assert got.dtype == np.int64 and (got >> 32 == 0).all()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_negative_zero_and_nan_keep_their_bits():
    col = np.array([0.0, -0.0, np.nan, -np.nan], np.float32)
    h = TT.hash_column(torch.from_numpy(col)).numpy()
    assert h[0] != h[1]            # -0.0 hashes by its bits, not its value
    assert len(set(h.tolist())) == 4


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_column_hashes_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n = 777
    cols = {"a": _int_col(rng, n), "b": _float_col(rng, n),
            "s": _str_col(rng, n)}
    valid = rng.random(n) < 0.8
    ref, port = _pair(cols, valid)
    for keys in (["a"], ["s", "a"], ["b", "s", "a"]):
        np.testing.assert_array_equal(
            TT.hash_columns(port, keys, seed).numpy().astype(np.uint32),
            np.asarray(RT.hash_columns(ref, keys, seed)))
        np.testing.assert_array_equal(
            TT.key_hash(port, keys, seed).numpy().astype(np.uint32),
            np.asarray(RT.key_hash(ref, keys, seed)))
        np.testing.assert_array_equal(
            TT.partition_hash(port, keys).numpy().astype(np.uint32),
            np.asarray(RT.partition_hash(ref, keys)))


@pytest.mark.parametrize("vmode", ["mixed", "all", "none"])
def test_host_compact_equal(vmode):
    rng = np.random.default_rng(3)
    n = 300
    cols = {"a": _int_col(rng, n), "b": _float_col(rng, n),
            "s": _str_col(rng, n)}
    valid = {"mixed": rng.random(n) < 0.4, "all": np.ones(n, bool),
             "none": np.zeros(n, bool)}[vmode]
    ref, port = _pair(cols, valid)
    nvalid = int(valid.sum())
    cap = max(8, 1 << (max(nvalid, 1) - 1).bit_length())
    want = ref.host_compact(cap, nvalid)
    got = port.host_compact(cap, nvalid)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_table_ops_match_reference():
    rng = np.random.default_rng(5)
    n = 64
    cols = {"a": _int_col(rng, n), "s": _str_col(rng, n)}
    valid = rng.random(n) < 0.5
    ref, port = _pair(cols, valid)
    assert {n: c.key() for n, c in port.schema().items()} == \
        {n: c.key() for n, c in ref.schema().items()}
    assert port.nbytes() == ref.nbytes()
    assert int(port.num_valid()) == int(ref.num_valid())
    rc, pc = ref.compact(), port.compact()
    np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(rc.valid))
    for k in cols:
        np.testing.assert_array_equal(pc.col(k).numpy(),
                                      np.asarray(rc.col(k)))
    for lo, hi in ((0, 5), (3, None)):
        rs, ps = RT.slice_valid(ref, lo, hi), TT.slice_valid(port, lo, hi)
        assert ps.capacity == rs.capacity
        for k in cols:
            np.testing.assert_array_equal(ps.col(k).numpy(),
                                          np.asarray(rs.col(k)))
    rcat = RT.concat_tables([ref, ref])
    pcat = TT.concat_tables([port, port])
    np.testing.assert_array_equal(pcat.valid.numpy(), np.asarray(rcat.valid))
    pp = TT.pad_capacity(port, 48)
    assert pp.capacity == RT.pad_capacity(ref, 48).capacity == 96
    idx = np.arange(n)[::-1].copy()
    np.testing.assert_array_equal(
        TT.cols_equal(port, torch.from_numpy(idx), port,
                      torch.from_numpy(idx[::-1].copy()), ["a", "s"]).numpy(),
        np.asarray(RT.cols_equal(ref, jnp.asarray(idx), ref,
                                 jnp.asarray(idx[::-1].copy()), ["a", "s"])))
    assert TT.decode_strings(port.col("s").numpy()) == \
        RT.decode_strings(np.asarray(ref.col("s")))


def test_from_numpy_round_trips_reference_to_numpy():
    """The port's Table.from_numpy takes what the reference's
    to_numpy(only_valid=False) and valid mask give."""
    rng = np.random.default_rng(9)
    ref = RT.Table.from_numpy({"a": _int_col(rng, 20),
                               "s": _str_col(rng, 20)}, nvalid=11,
                              capacity=32)
    port = TT.Table.from_numpy(ref.to_numpy(only_valid=False),
                               valid=np.asarray(ref.valid), device="cpu")
    got, want = port.to_numpy(), ref.to_numpy()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
