"""The port's tiered artifact store (DESIGN.md §15) against the reference:
twins of ``tests/test_tier_store.py`` and of ``test_crash_recovery.py::
test_sigkill_mid_demotion_lower_tier_wins`` on the port's store with
``device="cpu"``, then the cross-package properties: RSB1 blobs that both
packages demote from one disk root are byte-equal, a store one package
has demoted reopens in the other with the same owners, and the host
tier's demotions and LRU order are the reference's under one put/get
sequence.

The twins' tables keep the reference test's five dtypes; the port keeps
int64 and float64 columns as they are (the reference, without x64, holds
them as int32 and float32), so the cross-package tests use only dtypes
both packages hold alike: int32, float32 and uint8.
"""
import os
import shutil
import signal
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dataflow.table import Table as RTable  # noqa: E402
from repro.store import artifacts as RA  # noqa: E402
from repro.store import tiers as RT  # noqa: E402
from repro_torch.dataflow.table import Table  # noqa: E402
from repro_torch.service.faults import (FaultInjector,  # noqa: E402
                                        FaultSchedule)
from repro_torch.store.artifacts import (ArtifactStore,  # noqa: E402
                                         CorruptArtifactError,
                                         SimulatedCrash, _encode_name)
from repro_torch.store.prefetch import SpeculativePrefetcher  # noqa: E402
from repro_torch.store.tiers import (HostCache,  # noqa: E402
                                     RemoteObjectStore,
                                     decode_artifact_blob,
                                     encode_artifact_blob, verify_blob)
from repro_torch.train.compression import (decode_array,  # noqa: E402
                                           encode_array)

DTYPES = (np.int32, np.int64, np.uint8, np.float32, np.float64)
SHARED_DTYPES = (np.int32, np.uint8, np.float32)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cols(n, seed, dtypes=DTYPES):
    rng = np.random.default_rng(seed)
    return {f"c_{dt.__name__}": rng.integers(0, 100, n).astype(dt)
            for dt in dtypes}


def _table(n=64, seed=0):
    return Table.from_numpy(_cols(n, seed), device="cpu")


def _crc(t) -> int:
    d = t.to_numpy()
    acc = 0
    for c in sorted(d):
        acc = zlib.crc32(np.ascontiguousarray(d[c]).tobytes(),
                         zlib.crc32(c.encode(), acc))
    return acc


def _tiered_store(tmp_path, latency_s=0.0, **kw):
    remote = RemoteObjectStore(str(tmp_path / "remote"),
                               latency_s=latency_s)
    return ArtifactStore(root=str(tmp_path / "store"), remote=remote,
                         write_behind=False, device="cpu", **kw), remote


# ----------------------------------------------------- lossless codec


@pytest.mark.parametrize("dt", DTYPES)
def test_codec_roundtrip_bit_exact(dt):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 255, 1000).astype(dt)
    b = decode_array(encode_array(a))
    assert b.dtype == a.dtype and np.array_equal(a, b)


def test_codec_roundtrip_empty_and_noncontiguous():
    assert decode_array(encode_array(np.empty(0, np.float32))).size == 0
    a = np.arange(100, dtype=np.int64)[::2]          # non-contiguous view
    assert np.array_equal(decode_array(encode_array(a)), a)


def test_blob_roundtrip_and_corruption_detected():
    manifest = {"name": "x", "nbytes": 123}
    files = {"data.npz": {"a": np.arange(256, dtype=np.int64),
                          "__valid__": np.ones(256, dtype=bool)}}
    blob = encode_artifact_blob(manifest, files)
    assert blob == RT.encode_artifact_blob(manifest, files)
    m2, f2 = decode_artifact_blob(blob)
    assert m2 == manifest
    assert np.array_equal(f2["data.npz"]["a"], files["data.npz"]["a"])
    assert verify_blob(blob)
    body = bytearray(blob)
    body[-10] ^= 0xFF                                # checksum mismatch
    with pytest.raises(ValueError):
        decode_artifact_blob(bytes(body))
    with pytest.raises(ValueError):                  # structural damage
        decode_artifact_blob(blob[:len(blob) - 7])
    assert not verify_blob(blob[:8])


# ------------------------------------------------------- host tier LRU


def test_host_cache_lru_eviction_and_accounting():
    h = HostCache(max_bytes=3000)
    pay = lambda i: {"a": torch.full((100,), i, dtype=torch.int64)}  # 800 B
    for i in range(4):
        h.put(f"p{i}", pay(i))
    assert "p0" not in h and "p1" in h               # oldest evicted first
    assert h.total_bytes == h.recount() <= 3000
    h.get("p1")                                       # touch: most recent
    h.put("p4", pay(4))
    assert "p1" in h and "p2" not in h
    h.put("p4", pay(5))                               # replaces, no double
    assert h.total_bytes == h.recount()
    h.put("huge", {"a": torch.zeros(1000, dtype=torch.int64)})
    assert "huge" not in h                            # oversized
    assert h.total_bytes == h.recount()


# ------------------------------------------------ remote object store


def test_remote_batched_ops_charge_one_request(tmp_path):
    r = RemoteObjectStore(str(tmp_path))
    blobs = {f"k{i}": encode_artifact_blob(
        {"name": f"k{i}"}, {"d": {"a": np.arange(i + 1, dtype=np.int32)}})
        for i in range(5)}
    for k, b in blobs.items():
        r.put_object(k, b)
    base = r.stats["requests"]
    got = r.get_many(list(blobs) + ["missing"])
    assert r.stats["requests"] == base + 1           # ONE round-trip
    assert sorted(got) == sorted(blobs)
    assert all(got[k] == blobs[k] for k in blobs)
    heads = r.head_many(list(blobs))
    assert r.stats["requests"] == base + 2
    assert all(heads[k]["manifest"]["name"] == k for k in blobs)
    with pytest.raises(KeyError):
        r.get_object("missing")
    assert r.keys() == sorted(blobs)
    open(os.path.join(str(tmp_path), ".tmp-orphan"), "wb").close()
    assert r.keys() == sorted(blobs)
    assert r.gc_tmp() == 1


# ------------------------------------------- residency / authoritative


def test_residency_ladder_and_single_authoritative_tier(tmp_path):
    s, remote = _tiered_store(tmp_path, host_bytes=1 << 20)
    t = _table(seed=1)
    ref = _crc(t)
    s.put("a", t)
    assert s.residency("a") == "device"
    assert s.authoritative_tier("a") == "disk"
    s.demote_to_remote("a")
    assert s.authoritative_tier("a") == "remote"
    assert not os.path.exists(os.path.join(s._path("a"), "manifest.json"))
    assert s.residency("a") == "device"              # cache copy valid
    s.cache.drop("a")
    s.host.drop("a")
    assert s.residency("a") == "remote"
    assert _crc(s.get("a")) == ref                   # cold remote read
    s.promote_from_remote("a")
    assert s.authoritative_tier("a") == "disk"
    assert not remote.exists(s._remote_key("a"))     # exactly one owner
    assert _crc(s.get("a")) == ref
    s.close()


def test_promote_demote_promote_bit_identical(tmp_path):
    s, _ = _tiered_store(tmp_path)
    t = _table(n=500, seed=2)
    ref = _crc(t)
    s.put("a", t)
    for _ in range(2):
        s.demote_to_remote("a")
        s.cache.drop("a")
        assert _crc(s.get("a")) == ref               # from the remote
        s.promote_from_remote("a")
        s.cache.drop("a")
        assert _crc(s.get("a")) == ref               # from disk
    s.close()


def test_partitioned_artifact_survives_remote_roundtrip(tmp_path):
    s, _ = _tiered_store(tmp_path)
    s.put("base", _table(n=240, seed=3))
    tp, _part = s.get_partitioned("base", ["c_int32"], 4)
    s.put("a", tp, partitioning={"keys": ["c_int32"], "n_parts": 4})
    ref = _crc(s.get("a"))
    s.demote_to_remote("a")
    s.cache.drop("a")
    s.drop_caches()
    assert _crc(s.get("a")) == ref
    s.promote_from_remote("a")
    assert s.partitioning("a")["n_parts"] == 4
    s.close()


def test_random_population_has_exactly_one_durable_owner(tmp_path):
    rng = np.random.default_rng(7)
    s, remote = _tiered_store(tmp_path, host_bytes=1 << 18,
                              cache_bytes=1 << 18)
    refs = {}
    for i in range(12):
        t = _table(n=int(rng.integers(16, 400)), seed=100 + i)
        s.put(f"art{i}", t)
        refs[f"art{i}"] = _crc(t)
    demoted = [n for n in refs if rng.random() < 0.5]
    for n in demoted:
        s.demote_to_remote(n)
    s.drop_caches()
    for n, ref in refs.items():
        assert s.authoritative_tier(n) == (
            "remote" if n in demoted else "disk"), n
        on_disk = os.path.exists(os.path.join(s._path(n), "manifest.json"))
        assert on_disk != remote.exists(s._remote_key(n)), n
        assert _crc(s.get(n)) == ref, n
    s.close()


def test_device_eviction_demotes_to_host_and_serves_back(tmp_path):
    nb = _table(n=256, seed=4).nbytes()
    s = ArtifactStore(root=str(tmp_path / "store"), cache_bytes=2 * nb,
                      host_bytes=16 * nb, write_behind=False, device="cpu")
    refs = {}
    for i in range(4):
        t = _table(n=256, seed=10 + i)
        refs[f"a{i}"] = _crc(t)
        s.put(f"a{i}", t)
    assert s.residency("a0") == "host"               # squeezed out
    before = dict(s.io_stats())
    assert _crc(s.get("a0")) == refs["a0"]
    assert s.io_stats()["hostload_bytes"] > before["hostload_bytes"]
    assert s.residency("a0") == "device"             # promoted back up
    s.close()


def test_corrupt_remote_blob_raises_corrupt_error(tmp_path):
    s, remote = _tiered_store(tmp_path)
    s.put("a", _table(seed=5))
    s.demote_to_remote("a")
    s.drop_caches()
    p = remote.path(s._remote_key("a"))
    with open(p, "r+b") as f:                        # flip a payload byte
        f.seek(-5, os.SEEK_END)
        b = f.read(1)
        f.seek(-5, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CorruptArtifactError):
        s.get("a")
    s.close()


def test_prewarm_batches_remote_and_fills_device(tmp_path):
    s, remote = _tiered_store(tmp_path)
    refs = {}
    for i in range(3):
        t = _table(seed=20 + i)
        refs[f"a{i}"] = _crc(t)
        s.put(f"a{i}", t)
        s.demote_to_remote(f"a{i}")
    s.drop_caches()
    base = remote.stats["requests"]
    warmed = s.prewarm(list(refs) + ["missing"])
    assert sorted(warmed) == sorted(refs)
    assert remote.stats["requests"] == base + 1      # ONE batched fetch
    for n in refs:
        assert s.residency(n) == "device"
        assert s.authoritative_tier(n) == "remote"   # warm, not migrate
        assert _crc(s.get(n)) == refs[n]
    s.close()


# ------------------------------------------------------- crash windows


def _armed_injector(point):
    inj = FaultInjector(FaultSchedule(seed=0, rates={}, max_faults=0))
    inj.arm(point)
    return inj


def _crashed_mid_demotion(tmp_path, point, t):
    remote = RemoteObjectStore(str(tmp_path / "remote"))
    s = ArtifactStore(root=str(tmp_path / "store"), remote=remote,
                      write_behind=False, fault_injector=_armed_injector(
                          point), device="cpu")
    s.put("a", t)
    with pytest.raises(SimulatedCrash):
        s.demote_to_remote("a")
    return s, remote


def _reopen(tmp_path, remote):
    return ArtifactStore(root=str(tmp_path / "store"), remote=remote,
                         write_behind=False, device="cpu")


def test_crash_before_remote_upload_leaves_disk_authoritative(tmp_path):
    t = _table(seed=6)
    _s, remote = _crashed_mid_demotion(tmp_path, "remote_write", t)
    s2 = _reopen(tmp_path, remote)
    assert s2.authoritative_tier("a") == "disk"
    assert not remote.exists(s2._remote_key("a"))
    assert _crc(s2.get("a")) == _crc(t)
    s2.close()


def test_crash_after_remote_publish_reconciles_to_remote(tmp_path):
    t = _table(seed=7)
    s, remote = _crashed_mid_demotion(tmp_path, "remote_published", t)
    assert os.path.exists(os.path.join(s._path("a"), "manifest.json"))
    assert remote.exists(s._remote_key("a"))         # both copies
    s2 = _reopen(tmp_path, remote)
    assert s2.stats["remote_reconciled"] == 1
    assert s2.authoritative_tier("a") == "remote"
    assert not os.path.exists(os.path.join(s2._path("a"), "manifest.json"))
    assert _crc(s2.get("a")) == _crc(t)
    s2.close()


def test_torn_remote_blob_on_reopen_keeps_disk_copy(tmp_path):
    t = _table(seed=8)
    s, remote = _crashed_mid_demotion(tmp_path, "remote_published", t)
    p = remote.path(s._remote_key("a"))
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)          # torn upload
    s2 = _reopen(tmp_path, remote)
    assert s2.authoritative_tier("a") == "disk"
    assert not remote.exists(s2._remote_key("a"))
    assert _crc(s2.get("a")) == _crc(t)
    s2.close()


def test_fault_points_cover_remote_reads(tmp_path):
    s, _remote = _tiered_store(tmp_path)
    s.put("a", _table(seed=9))
    s.demote_to_remote("a")
    s.drop_caches()
    s.fault_injector = _armed_injector("remote_read")
    with pytest.raises(SimulatedCrash):
        s.get("a")
    s.fault_injector = None
    assert s.get("a") is not None                    # recoverable
    s.close()


_DEMOTE_CHILD = r"""
import sys, time
import numpy as np
from repro_torch.dataflow.table import Table
from repro_torch.store.artifacts import ArtifactStore
from repro_torch.store.tiers import RemoteObjectStore

root, remote_root, marker = sys.argv[1], sys.argv[2], sys.argv[3]


class StallAfterRemotePublish:
    # blob published to the remote tier, local delete not yet issued —
    # a SIGKILL here leaves BOTH durable copies
    def on(self, point, name, path=None):
        if point == "remote_published":
            import os
            with open(marker + ".tmp", "w") as f:
                f.write(name)
            os.replace(marker + ".tmp", marker)
            time.sleep(600)


store = ArtifactStore(root=root, remote=RemoteObjectStore(remote_root),
                      write_behind=False, device="cpu",
                      fault_injector=StallAfterRemotePublish())
rng = np.random.default_rng(0)
t = Table.from_numpy({"k": rng.integers(0, 99, 512).astype(np.int64),
                      "v": rng.random(512).astype(np.float32)},
                     device="cpu")
store.put("victim", t)
store.demote_to_remote("victim")   # stalls mid-demotion; parent SIGKILLs
"""


def test_sigkill_mid_demotion_lower_tier_wins(tmp_path):
    root = str(tmp_path / "store")
    remote_root = str(tmp_path / "remote")
    marker = str(tmp_path / "mid_demote")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    proc = subprocess.Popen(
        [sys.executable, "-c", _DEMOTE_CHILD, root, remote_root, marker],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + 300
    while not os.path.exists(marker):
        if proc.poll() is not None:
            _, err = proc.communicate()
            raise AssertionError(
                f"child died before the kill point:\n{err.decode()}")
        assert time.time() < deadline, "child never reached mid-demotion"
        time.sleep(0.01)
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)
    assert os.path.exists(os.path.join(root, _encode_name("victim"),
                                       "manifest.json"))
    remote = RemoteObjectStore(remote_root)
    assert remote.exists(_encode_name("victim"))
    store = ArtifactStore(root=root, remote=remote, write_behind=False,
                          device="cpu")
    assert store.stats["remote_reconciled"] == 1
    assert store.authoritative_tier("victim") == "remote"
    assert not os.path.exists(os.path.join(root, _encode_name("victim"),
                                           "manifest.json"))
    rng = np.random.default_rng(0)
    expect = Table.from_numpy(
        {"k": rng.integers(0, 99, 512).astype(np.int64),
         "v": rng.random(512).astype(np.float32)}, device="cpu")
    assert _crc(store.get("victim")) == _crc(expect)
    store.close()


# ------------------------------------------------ speculative prefetch


class _LogOnlyStore:
    """Minimal store stub: a read_log plus a prewarm that records."""

    def __init__(self):
        import collections
        self.read_log = collections.deque()
        self.prewarmed = []

    def prewarm(self, names):
        self.prewarmed.append(list(names))
        return list(names)


def test_prefetcher_ranks_by_decayed_popularity():
    st = _LogOnlyStore()
    pf = SpeculativePrefetcher(st, k=2, decay=0.5)
    for name in ["a", "a", "b", "a", "c", "a"]:
        st.read_log.append((name, "disk"))
    pf.poll()
    assert pf.predict()[0] == "a"
    for _ in range(10):
        st.read_log.append(("c", "disk"))
    pf.poll()
    assert pf.predict()[0] == "c"
    assert pf.observed == 16


def test_prefetcher_accounts_hits_against_warmed_set():
    st = _LogOnlyStore()
    pf = SpeculativePrefetcher(st, k=1)
    st.read_log.append(("hot", "disk"))
    assert pf.prefetch() == ["hot"]
    assert pf.prefetched == 1
    st.read_log.append(("hot", "device"))            # prediction came true
    pf.poll()
    assert pf.hits == 1 and pf.hit_rate == 1.0
    pf.prefetch()
    assert pf.hit_rate == pytest.approx(0.5)


def test_observe_append_refreshes_hot_set_ahead_of_arrival():
    st = _LogOnlyStore()
    calls = []

    def maintainer(names):
        calls.append(set(names))
        return {"refreshed": len(names)}

    pf = SpeculativePrefetcher(st, k=2, maintainer=maintainer)
    for name in ["x", "x", "y"]:
        st.read_log.append((name, "disk"))
    pf.observe_append("ds")
    assert calls == [{"x", "y"}]
    assert pf.refreshed_ahead == 2
    assert st.prewarmed[-1] == ["x", "y"]
    pf.observe_append("ds")
    assert pf.appends == 2 and pf.append_gap is not None
    st_stats = pf.stats()
    assert st_stats["appends"] == 2
    assert st_stats["predictions"][0] == "x"


def test_observe_append_tolerates_maintainer_failure():
    st = _LogOnlyStore()

    def broken(names):
        raise RuntimeError("refresh blew up")

    pf = SpeculativePrefetcher(st, k=1, maintainer=broken)
    st.read_log.append(("x", "disk"))
    assert pf.observe_append("ds") == {}
    assert pf.refreshed_ahead == 0
    assert st.prewarmed


# ------------------------------------------------- across the packages


def _pair(n, seed):
    cols = _cols(n, seed, SHARED_DTYPES)
    return RTable.from_numpy(cols), Table.from_numpy(cols, device="cpu")


def _store(pkg, root, remote_root=None, **kw):
    if pkg == "ref":
        remote = (None if remote_root is None
                  else RT.RemoteObjectStore(str(remote_root)))
        return RA.ArtifactStore(root=str(root), remote=remote,
                                write_behind=False, **kw)
    remote = (None if remote_root is None
              else RemoteObjectStore(str(remote_root)))
    return ArtifactStore(root=str(root), remote=remote, write_behind=False,
                         device="cpu", **kw)


def _populate_reference(root):
    """One disk root written by the reference: two monolithic artifacts
    and one partitioned over 4 shards."""
    s = _store("ref", root)
    for i in range(2):
        s.put(f"art/{i}", _pair(100 + 37 * i, 30 + i)[0])
    s.put("base", _pair(240, 40)[0])
    tp, _ = s.get_partitioned("base", ["c_int32"], 4)
    s.put("part", tp, partitioning={"keys": ["c_int32"], "n_parts": 4})
    s.flush()
    s.close()
    return ["art/0", "art/1", "part"]


def test_rsb1_blobs_byte_equal_across_packages(tmp_path):
    names = _populate_reference(tmp_path / "root")
    for pkg in ("ref", "port"):
        shutil.copytree(tmp_path / "root", tmp_path / pkg)
        s = _store(pkg, tmp_path / pkg, tmp_path / f"remote_{pkg}")
        for n in names:
            s.demote_to_remote(n)
        s.close()
    for n in names:
        blobs = [open(os.path.join(str(tmp_path / f"remote_{pkg}"),
                                   _encode_name(n) + ".blob"), "rb").read()
                 for pkg in ("ref", "port")]
        assert blobs[0][:4] == b"RSB1"
        assert blobs[0] == blobs[1], n


@pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                           ("ref", "port")])
def test_demoted_store_reopens_in_the_other_package(tmp_path, writer,
                                                    reader):
    """Demote two of four artifacts with one package, crash a third
    mid-demotion after its remote publish, and reopen with the other:
    every name has the same residency and owner in both packages, the
    crashed one reconciles to the remote, and the bytes read back
    equal."""
    root, rroot = tmp_path / "store", tmp_path / "remote"
    tables = {f"a{i}": _pair(64 + 16 * i, 50 + i) for i in range(4)}
    s = _store(writer, root, rroot)
    for n, pair in tables.items():
        s.put(n, pair[0] if writer == "ref" else pair[1])
    s.demote_to_remote("a0")
    s.demote_to_remote("a1")
    if writer == "ref":
        from repro.service.faults import FaultInjector as RFI
        from repro.service.faults import FaultSchedule as RFS
        inj = RFI(RFS(seed=0, rates={}, max_faults=0))
        crash = RA.SimulatedCrash
    else:
        inj = FaultInjector(FaultSchedule(seed=0, rates={}, max_faults=0))
        crash = SimulatedCrash
    inj.arm("remote_published")
    s.fault_injector = inj
    with pytest.raises(crash):
        s.demote_to_remote("a2")
    s.fault_injector = None
    s.close()
    state = {}
    for pkg in (reader, writer):
        st = _store(pkg, root, rroot)
        state[pkg] = {n: (st.residency(n), st.authoritative_tier(n),
                          _crc(st.get(n))) for n in tables}
        if pkg == reader:
            assert st.stats["remote_reconciled"] == 1
        st.close()
    assert state[reader] == state[writer]
    assert {n: v[1] for n, v in state[reader].items()} == {
        "a0": "remote", "a1": "remote", "a2": "remote", "a3": "disk"}
    assert all(v[2] == _crc(tables[n][1])
               for n, v in state[reader].items())


def test_host_demotions_and_lru_order_match_reference(tmp_path):
    """One put/get sequence through both packages' stores with a small
    device cache and host tier: the same demotions, the same host LRU
    order and bytes, the same device-cache order."""
    pairs = [_pair(128, 60 + i) for i in range(6)]
    nb = pairs[0][1].nbytes()
    seen = {}
    for pkg in ("ref", "port"):
        s = _store(pkg, tmp_path / pkg, cache_bytes=2 * nb,
                   host_bytes=3 * nb)
        k = 0 if pkg == "ref" else 1
        for i, pair in enumerate(pairs):
            s.put(f"t{i}", pair[k])
            if i % 2:
                s.get(f"t{i - 1}")
        s.get("t0")
        s.get("t3")
        seen[pkg] = (s.stats["host_demotions"], list(s.host._entries),
                     s.host.total_bytes, list(s.cache._entries),
                     [s.residency(f"t{i}") for i in range(6)])
        assert s.host.total_bytes == s.host.recount()
        s.close()
    assert seen["ref"] == seen["port"]
    assert seen["port"][0] > 0


def test_concurrent_puts_and_gets_keep_the_tiers_consistent(tmp_path):
    """Eight threads put and get through a device cache of two tables and
    a host tier of three (more workers than cores, a short switch
    interval): the eviction hook runs outside the cache lock, so nothing
    deadlocks, every read returns its table's bytes, and both ledgers
    equal their recounts."""
    import sys
    import threading
    tables = [_table(n=128, seed=70 + i) for i in range(6)]
    crcs = [_crc(t) for t in tables]
    nb = tables[0].nbytes()
    s = ArtifactStore(root=str(tmp_path / "store"), cache_bytes=2 * nb,
                      host_bytes=3 * nb, device="cpu")
    for i, t in enumerate(tables):
        s.put(f"t{i}", t)
    errors = []

    def worker(w):
        rng = np.random.default_rng(w)
        try:
            for _ in range(40):
                i = int(rng.integers(0, 6))
                if rng.random() < 0.3:
                    s.put(f"t{i}", tables[i])
                elif _crc(s.get(f"t{i}")) != crcs[i]:
                    errors.append(i)
        except Exception as e:          # reported below, with the worker
            errors.append((w, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    assert errors == []
    assert s.cache.total_bytes == s.cache.recount()
    assert s.host.total_bytes == s.host.recount()
    assert s.stats["host_demotions"] > 0
    s.flush()
    s.close()

