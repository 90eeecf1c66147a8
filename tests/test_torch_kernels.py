"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions (the
tensors lie on the CPU); these are held against the reference's
``ops.*(impl="pallas")`` in interpret mode, on the generators of
``tests/test_kernel_parity.py``: bit-identical for the probe, the
compaction and integer-valued segment sums.  The ``cuda`` cases hold
each CUDA kernel against its plain version on the card and skip here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D  # noqa: E402
from repro_torch.kernels.filter_project import ops as fp  # noqa: E402
from repro_torch.kernels.hash_join import ops as hj  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as sr  # noqa: E402

SIZES = [1, 7, 127, 128, 129, 333, 1024]
TILES = [128, 256]


@pytest.fixture
def ref():
    """The reference's kernel wrappers (JAX, interpret mode)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.filter_project.ops import compact
    from repro.kernels.hash_join.ops import probe
    from repro.kernels.segment_reduce.ops import segment_sum
    return dict(jnp=jnp, compact=compact, probe=probe,
                segment_sum=segment_sum)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------- shared generators


def _hashes(rng, n, ties):
    """uint32 hash lanes (the reference's generator): uniform,
    few-distinct (tie-heavy), constant."""
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


def probe_case(seed, n, ties):
    rng = np.random.default_rng(seed)
    lh = _hashes(rng, n, ties)
    rh = np.sort(_hashes(rng, max(1, n // 2), ties))
    return lh, rh


def compact_case(seed, n, vmode, dtype):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(1, 5))
    vals = rng.integers(-100, 100, (n, d)).astype(dtype)
    return vals, _valid(rng, n, vmode)


def segsum_case(seed, n, dtype, num_segments=16):
    rng = np.random.default_rng(seed)
    d = int(rng.integers(1, 4))
    # integer-valued payloads: float addition is then exact in any order
    vals = rng.integers(-50, 50, (n, d)).astype(dtype)
    start = int(rng.integers(-1, 2))
    sid = (start + np.cumsum(rng.integers(0, 2, n))).astype(np.int32)
    return vals, sid, num_segments


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ------------------------------------ plain versions vs the reference


@pytest.mark.parametrize("ties", ["uniform", "few", "const"])
def test_probe_plain_matches_reference_kernel(ref, ties):
    jnp = ref["jnp"]
    for i, n in enumerate(SIZES):
        lh, rh = probe_case(i, n, ties)
        want = np.asarray(ref["probe"](jnp.asarray(lh), jnp.asarray(rh),
                                       impl="pallas",
                                       tile_n=TILES[i % 2]))
        got = hj.probe(_t(lh.astype(np.int64)), _t(rh.astype(np.int64)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_compact_plain_matches_reference_kernel(ref, dtype):
    jnp = ref["jnp"]
    for i, n in enumerate(SIZES):
        for vmode in ("mixed", "all", "none"):
            vals, m = compact_case(i, n, vmode, dtype)
            out_r, tot_r = ref["compact"](jnp.asarray(vals), jnp.asarray(m),
                                          impl="pallas", tile_n=TILES[i % 2])
            out_p, tot_p = fp.compact(_t(vals), _t(m))
            assert out_p.dtype == _t(vals).dtype      # bytes move as-is
            np.testing.assert_array_equal(out_p.numpy().astype(np.float32),
                                          np.asarray(out_r))
            assert int(tot_p) == int(tot_r) == int(m.sum())


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_sum_plain_matches_reference_kernel(ref, dtype):
    jnp = ref["jnp"]
    for i, n in enumerate(SIZES):
        vals, sid, s = segsum_case(i, n, dtype)
        want = np.asarray(ref["segment_sum"](
            jnp.asarray(vals), jnp.asarray(sid), num_segments=s,
            impl="pallas", tile_n=TILES[i % 2]))
        got = sr.segment_sum(_t(vals.astype(np.float32)), _t(sid),
                             num_segments=s)
        np.testing.assert_array_equal(got.numpy(), want)


def test_compact_plain_handles_string_rows():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 256, (100, 20)).astype(np.uint8)
    m = rng.random(100) < 0.3
    out, tot = fp.compact(_t(rows), _t(m))
    k = int(m.sum())
    assert int(tot) == k
    np.testing.assert_array_equal(out.numpy()[:k], rows[m])
    assert not out.numpy()[k:].any()


def _mixed_columns(rng, n):
    return [rng.integers(-100, 100, n).astype(np.int32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(0, 256, (n, 20)).astype(np.uint8)]


def test_compact_columns_plain_matches_compact_per_column():
    rng = np.random.default_rng(6)
    cols = [_t(c) for c in _mixed_columns(rng, 300)]
    m = _t(rng.random(300) < 0.4)
    outs, tot = fp.compact_columns(cols, m)
    assert int(tot) == int(m.sum())
    for c, o in zip(cols, outs):
        want, wtot = fp.compact(c, m)
        assert torch.equal(o, want) and int(wtot) == int(tot)


def test_scratch_sizes_follow_the_level_recurrence():
    assert sr.scratch_entries(1024, 1024) == 0
    assert sr.scratch_entries(1025, 1024) == 4
    # 2**24 rows: 16384 tiles -> 32768 partials -> 64 partials -> final
    assert sr.scratch_entries(1 << 24, 1024) == 32768 + 64


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.default_device()
    with pytest.raises(RuntimeError):
        D.resolve(None)
    assert D.resolve("cpu") == torch.device("cpu")


def test_cpu_tensors_never_launch_kernels():
    before = (hj.launches.count, sr.launches.count, fp.launches.count)
    lh, rh = probe_case(0, 64, "few")
    hj.probe(_t(lh.astype(np.int64)), _t(rh.astype(np.int64)))
    vals, sid, s = segsum_case(0, 64, np.float32)
    sr.segment_sum(_t(vals), _t(sid), num_segments=s)
    fp.compact(*(_t(a) for a in compact_case(0, 64, "mixed", np.int32)))
    assert (hj.launches.count, sr.launches.count,
            fp.launches.count) == before


# ----------------------------------------- CUDA kernels vs plain, card


@pytest.mark.cuda
@pytest.mark.parametrize("ties", ["uniform", "few", "const"])
def test_probe_kernel_matches_plain(cuda, ties):
    for i, n in enumerate(SIZES + [50000]):
        lh, rh = probe_case(i, n, ties)
        lt, rt = _t(lh.astype(np.int64), cuda), _t(rh.astype(np.int64), cuda)
        got = hj.probe(lt, rt)
        want = hj.join_probe_ref(lt, rt)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    empty = torch.empty(0, dtype=torch.int64, device=cuda)
    assert not hj.probe(_t(np.arange(5, dtype=np.int64), cuda), empty).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_compact_kernel_matches_plain(cuda, dtype):
    for i, n in enumerate(SIZES + [70001]):
        for vmode in ("mixed", "all", "none"):
            vals, m = compact_case(i, n, vmode, dtype)
            v, mt = _t(vals, cuda), _t(m, cuda)
            out, tot = fp.compact(v, mt)
            want, wtot = fp.filter_compact_ref(v, mt)
            torch.cuda.synchronize()
            assert torch.equal(out, want) and int(tot) == int(wtot)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_sum_kernel_matches_plain(cuda, dtype):
    for i, n in enumerate(SIZES + [5000, 1 << 20]):
        vals, sid, s = segsum_case(i, n, dtype, num_segments=max(16, n // 3))
        v, st = _t(vals.astype(np.float32), cuda), _t(sid, cuda)
        got = sr.segment_sum(v, st, num_segments=s)
        want = sr.segment_sum_ref(v, st, num_segments=s)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_compact_columns_kernel_matches_plain(cuda):
    for i, n in enumerate(SIZES + [70001]):
        rng = np.random.default_rng(300 + i)
        cols = [_t(c, cuda) for c in _mixed_columns(rng, n)]
        for vmode in ("mixed", "all", "none"):
            m = _t(_valid(rng, n, vmode), cuda)
            outs, tot = fp.compact_columns(cols, m)
            torch.cuda.synchronize()
            assert int(tot) == int(m.sum())
            for c, o in zip(cols, outs):
                want, _ = fp.filter_compact_ref(c, m)
                assert torch.equal(o, want)
