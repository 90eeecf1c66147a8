"""The port's tiered artifact store on the card: a pressure eviction of
the device cache demotes into pinned host tensors, and the host, disk
and remote tiers serve a table back with the bytes it went in with.
These tests need a CUDA card and skip without one; this file imports the
port only, so it also runs where JAX is absent.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dataflow.table import Table  # noqa: E402
from repro_torch.store.artifacts import ArtifactStore  # noqa: E402
from repro_torch.store.tiers import RemoteObjectStore  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    return {f"c_{dt.__name__}": rng.integers(0, 100, n).astype(dt)
            for dt in (np.int32, np.uint8, np.float32)}


def _crc(t) -> int:
    d = t.to_numpy()
    acc = 0
    for c in sorted(d):
        acc = zlib.crc32(np.ascontiguousarray(d[c]).tobytes(),
                         zlib.crc32(c.encode(), acc))
    return acc


@pytest.mark.cuda
def test_card_store_demotes_into_pinned_memory_and_round_trips(cuda,
                                                               tmp_path):
    cols = _cols(4096, 90)
    t = Table.from_numpy(cols, device=cuda)
    ref = _crc(Table.from_numpy(cols, device="cpu"))
    nb = t.nbytes()
    s = ArtifactStore(root=str(tmp_path / "store"), cache_bytes=nb,
                      host_bytes=4 * nb, write_behind=False, device=cuda,
                      remote=RemoteObjectStore(str(tmp_path / "remote")))
    s.put("a", t)
    s.put("b", Table.from_numpy(_cols(4096, 91), device=cuda))
    assert s.residency("a") == "host"
    assert all(x.is_pinned() for x in s.host.get("a").values())
    got = s.get("a")
    assert got.device == cuda and _crc(got) == ref
    s.demote_to_remote("a")
    s.drop_caches()
    assert _crc(s.get("a")) == ref
    s.close()
