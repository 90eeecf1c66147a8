"""The Hopper design of the partition scatter, and the cases that hold
both radix kernels against their plain versions.

The scatter kernel ranks a row by its warp's votes, a scan over the
warps of a tile and a chained prefix over the tiles;
``ref.partition_scatter_tiled_ref`` repeats that decomposition step for
step in plain PyTorch, so on the CPU it is held against the plain version
and the reference's Pallas ``partition_scatter`` (interpret mode), at the
card's tile (16 rounds x 8 warps x 32 rows) and at a small one (2 x 2 x
32) that puts many tiles into a few hundred rows.  Tolerance: none —
slots and overflow counts are integers.  The ``cuda`` cases hold both
kernels against their plain versions on the card, on every case of
``bench.edge_cases``, and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.radix_partition import bench  # noqa: E402
from repro_torch.kernels.radix_partition import ops  # noqa: E402
from repro_torch.kernels.radix_partition.ref import (  # noqa: E402
    partition_scatter_ref, partition_scatter_tiled_ref)

SIZES = [1, 7, 129, 333, 1000]
GEOMETRIES = [dict(rounds=2, warps=2), dict(rounds=16, warps=8)]


@pytest.fixture(scope="module")
def ref():
    """The reference's scatter wrapper (JAX, Pallas in interpret mode)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.radix_partition.ops import scatter_slots
    return jnp, scatter_slots


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hashes(rng, n, ties):
    """uint32 hash lanes: uniform, few-distinct (tie-heavy), constant."""
    if ties == "uniform":
        return rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if ties == "few":
        pool = rng.integers(0, 1 << 32, max(1, n // 8), dtype=np.uint32)
        return pool[rng.integers(0, len(pool), n)]
    return np.full(n, np.uint32(0xDEADBEEF))


def _valid(rng, n, mode):
    if mode == "none":
        return np.zeros(n, bool)
    if mode == "all":
        return np.ones(n, bool)
    return rng.random(n) < 0.7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _held(ref, h, v, n_parts, bucket, geometry):
    """The tiled decomposition equals the plain version and the
    reference's Pallas kernel on one (N,) case."""
    jnp, scatter_slots = ref
    slot, ovf = partition_scatter_tiled_ref(
        _t(h.astype(np.int64)), _t(v), n_parts=n_parts, bucket=bucket,
        **geometry)
    s_p, o_p = partition_scatter_ref(_t(h.astype(np.int64)), _t(v),
                                     n_parts=n_parts, bucket=bucket)
    assert torch.equal(slot, s_p) and torch.equal(ovf, o_p)
    s_r, o_r = scatter_slots(jnp.asarray(h), jnp.asarray(v),
                             n_parts=n_parts, bucket=bucket, impl="pallas")
    np.testing.assert_array_equal(slot.numpy(), np.asarray(s_r))
    assert int(ovf) == int(o_r)


# ---------------------------------------- the tiled ranking, on the CPU


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=lambda g: f"{g['rounds']}x{g['warps']}")
@pytest.mark.parametrize("n_parts", [1, 8, 256])
@pytest.mark.parametrize("ties,vmode", [("uniform", "mixed"),
                                        ("few", "all"), ("const", "none")])
def test_tiled_ranking_matches_reference(ref, geometry, n_parts, ties,
                                         vmode):
    """Ragged N; the bucket is small enough that tie-heavy and constant
    lanes overflow it."""
    for i, n in enumerate(SIZES):
        rng = np.random.default_rng(i)
        _held(ref, _hashes(rng, n, ties), _valid(rng, n, vmode), n_parts,
              max(1, n // n_parts + 2), geometry)


@pytest.mark.parametrize("bucket", [1, 127, 128, 129, 600])
def test_tiled_ranking_at_bucket_edges(ref, bucket):
    """Every valid row bound for one partition, so the bucket overflows;
    at the small geometry a tile is 128 rows, so buckets of 127-129 put
    the first dropped row at a tile boundary and one off."""
    n = 5 * 128 + 3
    rng = np.random.default_rng(bucket)
    h = np.full(n, np.uint32(8 * 99 + 5))
    _held(ref, h, np.ones(n, bool), 8, bucket, GEOMETRIES[0])
    _held(ref, h, _valid(rng, n, "mixed"), 8, bucket, GEOMETRIES[0])


def test_tiled_ranking_ranks_each_segment_alone():
    """(S, N) lanes with ragged N: each segment equals a call of its own,
    and the whole equals the plain version."""
    rng = np.random.default_rng(5)
    for s_, n in [(1, 5000), (8, 301), (3, 4097)]:
        h = _t(rng.integers(0, 1 << 32, (s_, n)).astype(np.int64))
        v = _t(rng.random((s_, n)) < 0.7)
        for n_parts, bucket in [(8, n // 8), (256, 3), (1, n)]:
            got = partition_scatter_tiled_ref(h, v, n_parts=n_parts,
                                              bucket=bucket)
            want = partition_scatter_ref(h, v, n_parts=n_parts,
                                         bucket=bucket)
            assert got[1].shape == (s_,)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1])
            for i in range(s_):
                one = partition_scatter_tiled_ref(h[i], v[i],
                                                  n_parts=n_parts,
                                                  bucket=bucket)
                assert torch.equal(one[0], got[0][i]) and \
                    int(one[1]) == int(got[1][i])


def test_tiled_ranking_on_the_edge_cases():
    """``bench.edge_cases`` on the CPU, those small enough for the
    one-hot of the decomposition: the tiled ranking equals the plain
    version, and the wrappers' CPU path agrees with itself."""
    n_held = 0
    for case in bench.edge_cases("cpu"):
        h, v = case["hashes"], case["valid"]
        padded = -(-h.shape[-1] // ops.SCATTER_TILE) * ops.SCATTER_TILE
        if h.numel() // h.shape[-1] * padded * case["n_parts"] > 2**22:
            continue
        got = partition_scatter_tiled_ref(h, v, n_parts=case["n_parts"],
                                          bucket=case["bucket"])
        want = partition_scatter_ref(h, v, n_parts=case["n_parts"],
                                     bucket=case["bucket"])
        assert torch.equal(got[0], want[0]) and \
            torch.equal(got[1], want[1]), case["label"]
        assert bench.check_case(case) is None, case["label"]
        n_held += 1
    assert n_held >= 20


def test_edge_cases_cover_the_contract():
    cases = bench.edge_cases("cpu")
    rows = {c["hashes"].shape[-1] for c in cases}
    assert {1, 31, 4095, 4097, 2**21 + 3} <= rows
    assert {1, 2, 8, 256, 8192} <= {c["n_parts"] for c in cases}
    assert {1, 8} <= {c["hashes"].shape[0] for c in cases
                      if c["hashes"].ndim == 2}
    assert any(not c["valid"].any() for c in cases)
    assert any(c["bucket"] == 1 for c in cases)
    assert any(c["bucket"] == ops.SCATTER_TILE for c in cases)
    assert ops.SCATTER_TILE == 16 * 8 * 32


# ------------------------------------------------- the kernels on the card


@pytest.mark.cuda
def test_cuda_edge_cases_match_plain(cuda):
    for case in bench.edge_cases(cuda):
        assert bench.check_case(case) is None, case["label"]
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_scatter_tile_is_the_kernels(cuda):
    assert ops.library().restore_partition_scatter_tile() == \
        ops.SCATTER_TILE


@pytest.mark.cuda
def test_cuda_scatter_records_its_shapes_and_repeats_its_bits(cuda):
    """Each launch is counted once with its (S, N, P, bucket); two calls
    give the same slots (the look-back's order does not show)."""
    rng = np.random.default_rng(3)
    h = _t(rng.integers(0, 1 << 32, (8, 100003)).astype(np.int64)).to(cuda)
    v = _t(rng.random((8, 100003)) < 0.5).to(cuda)
    ops.scatter_launches.reset()
    a = ops.scatter_slots(h, v, n_parts=8, bucket=6000)
    b = ops.scatter_slots(h, v, n_parts=8, bucket=6000)
    assert ops.scatter_launches.count == 2
    assert ops.scatter_launches.shapes == {(8, 100003, 8, 6000): 2}
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    want = partition_scatter_ref(h, v, n_parts=8, bucket=6000)
    assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    h = torch.zeros(10, dtype=torch.int64, device=cuda)
    v = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="power of two"):
        ops.scatter_slots(h, v, n_parts=16384, bucket=4)
    with pytest.raises(ValueError, match="int32"):
        ops.scatter_slots(h, v, n_parts=8, bucket=2**28)
    with pytest.raises(ValueError, match="tile_n"):
        ops.partition(h, v, n_parts=8, tile_n=0)
    with pytest.raises(ValueError, match="int64"):
        ops.scatter_slots(h.int(), v, n_parts=8, bucket=4)
