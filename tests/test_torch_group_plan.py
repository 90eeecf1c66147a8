"""The ReStore driver over 4 gloo ranks keeps one plan, and ``spawn``
and the backends fail loudly (the rank bodies are in
``tests/_group_mesh_util.py``):

  * a driver whose rank 1 measures every job a million times slower
    than it ran still takes rank 0's plan on every rank, and its answers
    equal a single-process plain run;
  * a rank that raises, or one that never returns, makes ``spawn`` raise
    within its time limit and leaves no process behind;
  * ``nccl`` asks for one card a rank and raises without them; a
    ``GroupMesh`` outside a process group raises.
"""
import multiprocessing
import os
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _group_mesh_util as U  # noqa: E402
from repro_torch.launch.mesh import (GroupMesh, SpawnError,  # noqa: E402
                                     init_group_mesh, spawn)


def _spawn(fn, world=4, timeout=120, args=()):
    d = tempfile.mkdtemp(prefix="group_plan_")
    return spawn(fn, world, backend="gloo", init_file=os.path.join(d, "rdv"),
                 timeout=timeout, args=args)


# ------------------------------------------------------------ one plan
def test_skewed_clock_on_one_rank_keeps_one_plan(tmp_path):
    """The "cost" heuristic's keep decisions read the measured walls.
    Rank 1 measures every job a million times slower than it ran; every
    rank still stores, reuses and skips alike (rank 0's decisions), its
    statistics are rank 0's, and the answers equal a single-process
    plain run."""
    root = str(tmp_path / "store")
    ranks = _spawn(U.rank_cost_restore, args=(root, 1))
    assert ranks[1]["raw"] and not ranks[0]["raw"]
    for r in ranks[1:]:
        assert r["facts"] == ranks[0]["facts"]
        assert r["entries"] == ranks[0]["entries"]
    walls = [j["stats"]["wall"] for f in ranks[0]["facts"] for j in f
             if j["stats"] is not None]
    assert max(walls) < min(ranks[1]["raw"])
    store = U.ArtifactStore(device=U.CPU)
    cat = U.Catalog(store, device=U.CPU)
    cat.register("fact", U.fact())
    cat.register("dim", U.dim())
    plain = U.ReStore(cat, store, heuristic="off", rewrite_enabled=False,
                      semantic=False, device=U.CPU)
    for i, aggs in enumerate((U.A1, U.A1, U.A2)):
        want = plain.run_plan(U.join_groupby(aggs))[0]["out"]
        got = {c: np.concatenate([r["res"][i][c] for r in ranks])
               for c in ranks[0]["res"][i]}
        _assert_rows_equal(got, want.to_numpy())


def _canon(d):
    order = np.lexsort(tuple(d[c] for c in sorted(d, reverse=True)))
    return {c: d[c][order] for c in sorted(d)}


def _assert_rows_equal(a, b):
    ca, cb = _canon(a), _canon(b)
    assert sorted(ca) == sorted(cb)
    for c in ca:
        np.testing.assert_array_equal(ca[c], cb[c], err_msg=c)


# ------------------------------------------------------------ faults
def test_failing_rank_makes_spawn_raise_and_leaves_nothing(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(SpawnError, match="rank 2 fails on purpose"):
        _spawn(U.rank_fails, world=3, timeout=60)
    assert time.monotonic() - t0 < 60
    assert multiprocessing.active_children() == []


def test_rank_past_the_time_limit_makes_spawn_raise(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(SpawnError, match="timed out"):
        _spawn(U.rank_hangs, world=2, timeout=4)
    assert time.monotonic() - t0 < 30
    assert multiprocessing.active_children() == []


def test_backends_and_devices_are_named_not_chosen(tmp_path):
    """nccl takes one card a rank: asking for more ranks than cards
    raises before any process starts; an unknown backend raises; a
    GroupMesh outside a process group raises."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="nccl"):
        init_group_mesh(n + 1, backend="nccl", rank=0, world=n + 1,
                        init_method="file://" + str(tmp_path / "rdv"))
    with pytest.raises(ValueError, match="nccl ranks"):
        spawn(U.rank_fails, n + 1, backend="nccl",
              init_file=str(tmp_path / "rdv2"))
    with pytest.raises(RuntimeError, match="no process group"):
        GroupMesh(1, backend="gloo", device=U.CPU)
