"""The Hopper designs of the join probe and the sorted segment sum.

The probe kernel looks each key up in a bucket directory of 2**b entries
and searches only inside the key's bucket; ``ref.probe_bucketed_ref``
repeats that search step for step in plain PyTorch, so on the CPU it is
held against the plain version and the reference's Pallas kernel
(interpret mode).  The segment-sum kernel's tiles of 4096 rows show on
the CPU only in its scratch sizes.  The ``cuda`` cases hold both kernels
against their plain versions on the card, on the cases of each kernel's
``bench.edge_cases``, and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.hash_join import bench as hj_bench  # noqa: E402
from repro_torch.kernels.hash_join import ops as hj  # noqa: E402
from repro_torch.kernels.hash_join.ref import (  # noqa: E402
    join_probe_ref, probe_bucketed_ref, probe_directory_ref)
from repro_torch.kernels.segment_reduce import bench as sr_bench  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import segment_sum_ref  # noqa: E402

BITS = [1, 8, 12, 14, 15]
TILE = 4096                      # rows of a segment-sum tile on the card
SIZES = [1, 7, 127, 128, 129, 333, 1024]
TILES = [128, 256]
SENTINEL = 0xFFFFFFFF


@pytest.fixture
def ref():
    """The reference's probe wrapper (JAX, interpret mode)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.hash_join.ops import probe
    return jnp, probe


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hashes(rng, n, ties):
    """uint32 hash lanes (the reference's parity generator): uniform,
    few-distinct (tie-heavy), constant."""
    if ties == "uniform":
        return rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if ties == "few":
        pool = rng.integers(0, 1 << 32, max(1, n // 8), dtype=np.uint32)
        return pool[rng.integers(0, len(pool), n)]
    return np.full(n, np.uint32(0xDEADBEEF))


def _edges(bits):
    """Every bucket edge of a 2**bits directory, one below and one above
    it, and 0 and 0xFFFFFFFF (uint32 values as int64)."""
    e = np.arange((1 << bits) + 1, dtype=np.int64) << (32 - bits)
    return np.clip(np.concatenate([e, e - 1, e + 1, [0, SENTINEL]]), 0,
                   SENTINEL)


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ------------------------------------------------ the directory, on the CPU


@pytest.mark.parametrize("bits", BITS)
def test_directory_is_the_lower_bound_of_every_edge(bits):
    rng = np.random.default_rng(bits)
    right = np.sort(rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
                    .astype(np.int64))
    d = probe_directory_ref(_t(right), bits).numpy()
    edges = np.arange((1 << bits) + 1, dtype=np.int64) << (32 - bits)
    assert d.dtype == np.int32 and d.shape == ((1 << bits) + 1,)
    np.testing.assert_array_equal(d, np.searchsorted(right, edges))
    assert d[0] == 0 and d[-1] == len(right)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("ties", ["uniform", "few", "const"])
def test_bucket_search_matches_plain(bits, ties):
    """Each probe searched only inside its bucket gives the plain answer:
    parity generators, keys at and beside every bucket edge, 0,
    0xFFFFFFFF, and a build side with masked (sentinel) rows."""
    rng = np.random.default_rng(bits)
    for n in (1, 129, 4097, 40000):
        right = _hashes(rng, max(1, n // 2), ties).astype(np.int64)
        right[rng.random(len(right)) < 0.2] = SENTINEL
        right = np.sort(right)
        left = np.concatenate([_hashes(rng, n, ties).astype(np.int64),
                               right[rng.integers(0, len(right), 64)],
                               _edges(bits)])
        lt, rt = _t(left), _t(right)
        got = probe_bucketed_ref(lt, rt, bits)
        assert got.dtype == torch.int32
        assert torch.equal(got, join_probe_ref(lt, rt))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("ties", ["uniform", "few", "const"])
def test_bucket_search_matches_reference_kernel(ref, bits, ties):
    jnp, probe = ref
    for i, n in enumerate(SIZES):
        rng = np.random.default_rng(i)
        lh = _hashes(rng, n, ties)
        rh = np.sort(_hashes(rng, max(1, n // 2), ties))
        want = np.asarray(probe(jnp.asarray(lh), jnp.asarray(rh),
                                impl="pallas", tile_n=TILES[i % 2]))
        got = probe_bucketed_ref(_t(lh.astype(np.int64)),
                                 _t(rh.astype(np.int64)), bits)
        np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_search_on_the_edge_cases():
    for label, left, right in hj_bench.edge_cases("cpu"):
        want = join_probe_ref(left, right)
        for bits in {1, 15, hj.probe_bits(right.shape[0])}:
            assert torch.equal(probe_bucketed_ref(left, right, bits),
                               want), (label, bits)


@pytest.mark.parametrize("r", [0, 1, 7, 8, 1000, 1 << 14, 1 << 16,
                               (1 << 16) + 1, (1 << 17) + 3, 1 << 21])
def test_probe_bits_gives_buckets_of_two_to_four_keys(r):
    """Buckets of 2-4 keys on average, up to the cap: B_L1 while L1 can
    hold most of the build keys, B_MAX (the kernel's largest) beyond."""
    b = hj.probe_bits(r)
    cap = hj.B_L1 if r <= hj.L1_KEYS else hj.B_MAX
    assert 1 <= b <= cap and hj.B_L1 < hj.B_MAX == 15
    if 8 <= r < 4 << cap:
        assert 2 <= r / (1 << b) < 4
    elif r >= 4 << cap:
        assert b == cap


def test_cpu_probe_launches_no_directory():
    before = (hj.launches.count, hj.directory_launches.count)
    left, right = hj_bench.edge_cases("cpu")[0][1:]
    assert torch.equal(hj.probe(left, right), join_probe_ref(left, right))
    assert (hj.launches.count, hj.directory_launches.count) == before


# ------------------------------------------- the segment sum, on the CPU


@pytest.mark.parametrize("n, want", [(TILE, 0), (TILE + 1, 4),
                                     (1 << 24, 8192 + 4)])
def test_scratch_sizes_at_the_hopper_tile(n, want):
    # 2**24 rows: 4096 tiles -> 8192 partials -> 4 partials -> final
    assert sr.scratch_entries(n, TILE) == want


def test_segment_edge_cases_plain_match_numpy():
    """The card's cases are sorted, and the plain version (the card
    tests' yardstick) equals a numpy scatter-add on them."""
    for label, vals, ids, ns, exact in sr_bench.edge_cases("cpu"):
        i = ids.numpy()
        assert (np.diff(i) >= 0).all(), label
        v = vals.numpy().astype(np.float64)
        want = np.zeros((ns + 1, v.shape[1]))
        ok = (i >= 0) & (i < ns)
        np.add.at(want, np.where(ok, i, ns), v * ok[:, None])
        got = sr.segment_sum(vals, ids, num_segments=ns).numpy()
        if exact:
            np.testing.assert_array_equal(got, want[:ns], err_msg=label)
        else:
            np.testing.assert_allclose(got, want[:ns], rtol=1e-4,
                                       atol=1e-4, err_msg=label)


# ------------------------------------------------------- on the card


@pytest.mark.cuda
def test_probe_kernel_on_the_edge_cases(cuda):
    for label, left, right in hj_bench.edge_cases(cuda):
        before = (hj.launches.count, hj.directory_launches.count)
        got = hj.probe(left, right)
        want = join_probe_ref(left, right)
        torch.cuda.synchronize()
        assert torch.equal(got, want), label
        assert (hj.launches.count, hj.directory_launches.count) == \
            (before[0] + 1, before[1] + 1), label


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 8, 12, 13, 14, 15])
def test_probe_kernel_at_every_directory_size(cuda, bits):
    for label, left, right in hj_bench.edge_cases(cuda):
        got = hj._launch(left, right, bits)
        torch.cuda.synchronize()
        assert torch.equal(got, join_probe_ref(left, right)), (label, bits)


@pytest.mark.cuda
def test_probe_wrapper_checks(cuda):
    left = _t(np.arange(10, dtype=np.int64), cuda)
    right = _t(np.arange(0, 20, 3, dtype=np.int64), cuda)
    for bad_left, bad_right in ((left.int(), right), (left, right.int()),
                                (left.reshape(2, 5), right),
                                (left[::2], right), (left, right.cpu())):
        with pytest.raises(ValueError):
            hj.probe(bad_left, bad_right)
    empty = torch.empty(0, dtype=torch.int64, device=cuda)
    assert not hj.probe(left, empty).any()
    before = hj.launches.count
    assert hj.probe(empty, right).shape == (0,)
    assert hj.launches.count == before


@pytest.mark.cuda
def test_segment_sum_kernel_on_the_edge_cases(cuda):
    assert sr.library().restore_segment_sum_tile() == TILE
    for label, vals, ids, ns, exact in sr_bench.edge_cases(cuda):
        got = sr.segment_sum(vals, ids, num_segments=ns)
        again = sr.segment_sum(vals, ids, num_segments=ns)
        want = segment_sum_ref(vals, ids, num_segments=ns)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{label}: two calls differ"
        if exact:
            assert torch.equal(got, want), label
        else:
            rel = ((got - want).abs() / want.abs().clamp(min=1.0)).max()
            assert float(rel) <= 1e-4, label


@pytest.mark.cuda
def test_segment_sum_wrapper_checks(cuda):
    vals = torch.ones(8, 2, device=cuda)
    ids = torch.arange(8, dtype=torch.int32, device=cuda)
    for bad_vals, bad_ids in ((vals.double(), ids), (vals[:, 0], ids),
                              (vals, ids.long()), (vals, ids[:7]),
                              (vals.t().contiguous().t(), ids),
                              (vals, ids.cpu())):
        with pytest.raises(ValueError):
            sr.segment_sum(bad_vals, bad_ids, num_segments=8)
