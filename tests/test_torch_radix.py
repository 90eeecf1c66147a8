"""The port's radix-partition and partition-scatter wrappers against the
reference's.

On the CPU the port's ``partition``/``scatter_slots`` take their plain
PyTorch versions (the tensors lie on the CPU).  They are held against
the reference's ``ref.py`` and its Pallas kernels in interpret mode on
the generators of ``tests/test_kernel_parity.py`` (``check_partition``,
``check_scatter``), plus partition counts that are not a power of two.
Tolerance: none — routing is bit-identical (pids, histograms, slots and
overflow counts are integers).  The ``cuda`` cases hold the CUDA
kernels against the plain versions on the card and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.radix_partition import ops  # noqa: E402
from repro_torch.kernels.radix_partition.ref import (  # noqa: E402
    partition_scatter_ref, radix_partition_ref)

SIZES = [1, 7, 127, 128, 129, 333, 1024]
TILES = [128, 256]


@pytest.fixture(scope="module")
def ref():
    """The reference's wrappers (JAX, Pallas in interpret mode)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.radix_partition.ops import partition, scatter_slots
    return dict(jnp=jnp, partition=partition, scatter_slots=scatter_slots)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hashes(rng, n, ties):
    """uint32 hash lanes (the parity generator): uniform, few-distinct
    (tie-heavy), constant."""
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


def _lane(h, dev="cpu"):
    """uint32 numpy lane -> the port's int64 carrier."""
    return torch.from_numpy(h.astype(np.int64)).to(dev)


def _mask(v, dev="cpu"):
    return torch.from_numpy(v.copy()).to(dev)


def scatter_case(seed, n, ties, vmode, n_parts):
    rng = np.random.default_rng(seed)
    h, v = _hashes(rng, n, ties), _valid(rng, n, vmode)
    # small bucket so tie-heavy hashes overflow (check_scatter's rule)
    return h, v, max(2, (n // n_parts) + 2)


# ------------------------------------------- plain versions vs reference


@pytest.mark.parametrize("ties", ["uniform", "few", "const"])
@pytest.mark.parametrize("vmode", ["mixed", "all", "none"])
def test_partition_matches_reference(ref, ties, vmode):
    jnp = ref["jnp"]
    for i, n in enumerate(SIZES):
        tile = TILES[i % len(TILES)]
        rng = np.random.default_rng(i)
        h, v = _hashes(rng, n, ties), _valid(rng, n, vmode)
        pid, hist = ops.partition(_lane(h), _mask(v), n_parts=8,
                                  tile_n=tile)
        for impl in ("ref", "pallas"):
            pid_r, hist_r = ref["partition"](
                jnp.asarray(h), jnp.asarray(v), n_parts=8, impl=impl,
                tile_n=tile)
            np.testing.assert_array_equal(pid.numpy(), np.asarray(pid_r))
            hr = np.asarray(hist_r)
            np.testing.assert_array_equal(hist.numpy().sum(0), hr.sum(0))
            if hr.shape == tuple(hist.shape):
                np.testing.assert_array_equal(hist.numpy(), hr)


@pytest.mark.parametrize("ties", ["uniform", "few", "const"])
@pytest.mark.parametrize("vmode", ["mixed", "all", "none"])
def test_scatter_slots_match_reference(ref, ties, vmode):
    jnp = ref["jnp"]
    for i, n in enumerate(SIZES):
        tile = TILES[i % len(TILES)]
        h, v, bucket = scatter_case(100 + i, n, ties, vmode, 8)
        slot, ovf = ops.scatter_slots(_lane(h), _mask(v), n_parts=8,
                                      bucket=bucket)
        for impl in ("ref", "pallas"):
            s_r, o_r = ref["scatter_slots"](
                jnp.asarray(h), jnp.asarray(v), n_parts=8, bucket=bucket,
                impl=impl, tile_n=tile)
            np.testing.assert_array_equal(slot.numpy(), np.asarray(s_r))
            assert int(ovf) == int(o_r)


@pytest.mark.parametrize("n_parts", [3, 6, 12])
def test_scatter_non_pow2_parts_match_reference(ref, n_parts):
    """P not a power of two routes by ``h % P`` in the plain version,
    as the reference dispatches it."""
    jnp = ref["jnp"]
    for seed, (ties, vmode) in enumerate([("uniform", "mixed"),
                                          ("few", "all"),
                                          ("const", "mixed")]):
        h, v, bucket = scatter_case(seed, 200, ties, vmode, n_parts)
        slot, ovf = ops.scatter_slots(_lane(h), _mask(v), n_parts=n_parts,
                                      bucket=bucket)
        s_r, o_r = ref["scatter_slots"](jnp.asarray(h), jnp.asarray(v),
                                        n_parts=n_parts, bucket=bucket,
                                        impl="pallas")
        np.testing.assert_array_equal(slot.numpy(), np.asarray(s_r))
        assert int(ovf) == int(o_r)


def test_segmented_scatter_ranks_each_segment_alone():
    """(S, N) lanes rank every segment (mesh shard) independently: the
    batched call equals one call per segment."""
    rng = np.random.default_rng(7)
    s_, n = 8, 300
    h = np.stack([_hashes(rng, n, t) for t in
                  ["uniform", "few", "const", "uniform"] * 2])
    v = np.stack([_valid(rng, n, m) for m in ["mixed", "all"] * 4])
    slot, ovf = ops.scatter_slots(_lane(h), _mask(v), n_parts=8, bucket=30)
    assert slot.shape == (s_, n) and ovf.shape == (s_,)
    for s in range(s_):
        one, o1 = ops.scatter_slots(_lane(h[s]), _mask(v[s]), n_parts=8,
                                    bucket=30)
        assert torch.equal(slot[s], one) and int(ovf[s]) == int(o1)


# ------------------------------------------------- the kernels on the card


def _kernel_cases():
    """The card's bit-identity cases: ragged N, P in {2, 8, 256}, every
    row bound for one partition (overflow), all rows invalid, bucket 1,
    tile_n 256 and 1024."""
    for n in (1, 255, 257, 2**16 + 3):
        for n_parts in (2, 8, 256):
            for ties, vmode in (("uniform", "mixed"), ("const", "all"),
                                ("few", "none")):
                for tile in (256, 1024):
                    yield n, n_parts, ties, vmode, tile


@pytest.mark.cuda
def test_cuda_radix_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    for n, n_parts, ties, vmode, tile in _kernel_cases():
        h = _lane(_hashes(rng, n, ties), cuda)
        v = _mask(_valid(rng, n, vmode), cuda)
        pid, hist = ops.partition(h, v, n_parts=n_parts, tile_n=tile)
        hp, vp, _ = ops._pad_invalid(h, v, tile)
        pid_r, hist_r = radix_partition_ref(hp, vp, n_parts=n_parts,
                                            tile_n=tile)
        assert torch.equal(pid, pid_r[:n]) and torch.equal(hist, hist_r)
        for bucket in (1, max(2, n // n_parts + 2), n):
            slot, ovf = ops.scatter_slots(h, v, n_parts=n_parts,
                                          bucket=bucket)
            s_r, o_r = partition_scatter_ref(h, v, n_parts=n_parts,
                                             bucket=bucket)
            assert torch.equal(slot, s_r) and int(ovf) == int(o_r), \
                (n, n_parts, ties, vmode, tile, bucket)
    # the mesh form: 8 segments in one launch
    h = _lane(_hashes(rng, 8 * 4099, "few").reshape(8, 4099), cuda)
    v = _mask(_valid(rng, 8 * 4099, "mixed").reshape(8, 4099), cuda)
    slot, ovf = ops.scatter_slots(h, v, n_parts=8, bucket=700)
    s_r, o_r = partition_scatter_ref(h, v, n_parts=8, bucket=700)
    assert torch.equal(slot, s_r) and torch.equal(ovf, o_r)
    torch.cuda.synchronize()
