"""``GroupMesh`` over 4 gloo ranks on the CPU against ``LocalMesh(4)``
and against the reference's 4-device mesh.

Each rank is a process started by ``launch.mesh.spawn`` (a ``file://``
rendezvous under the test's temporary directory, one thread a rank); the
rank bodies are in ``tests/_group_mesh_util.py``.  The same seeded inputs
go through:

  * every collective of a (2, 2) ("data", "model") mesh and of a 1-D
    mesh of 4 (``psum``, ``pmax``, ``pmean`` over each axis and both,
    ``axis_index``, ``all_to_all`` on a named axis, ``shard_map`` over
    specs with a sharded and a stacked output and ``globalize``, and the
    1-D API: ``blocks``, ``shard_map``, ``all_to_all``, ``psum``), each
    rank's value equal to its row of the ``LocalMesh`` result, bit for
    bit (integer-valued floats: sums are exact in any order);
  * the four distributed operators (group-by on an int and a string key,
    distinct, join with its shipped hash lane, the co-partitioned
    group-by after it, cogroup), the ranks' output blocks concatenated
    in rank order equal to ``LocalMesh(4)``'s output and to the
    reference's ``shard_map`` output on 4 forced host devices (one JAX
    subprocess), every slot of every column;
The driver's one plan under a skewed clock, ``spawn``'s failures and the
backends' refusals are in ``tests/test_torch_group_plan.py``.
"""
import os
import re
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _group_mesh_util as U  # noqa: E402
from repro_torch.launch.mesh import LocalMesh, spawn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(fn, world=4, timeout=120, args=()):
    d = tempfile.mkdtemp(prefix="group_mesh_")
    return spawn(fn, world, backend="gloo", init_file=os.path.join(d, "rdv"),
                 timeout=timeout, args=args)


# ------------------------------------------------------------ collectives
@pytest.fixture(scope="module")
def collectives():
    return _spawn(U.rank_collectives), U.local_collectives()


# how a rank's value relates to the LocalMesh one
STACKED = ["psum_data", "psum_model", "psum_both", "pmax_data",
           "pmax_model", "pmax_both", "pmean_data", "pmean_model",
           "pmean_both", "ipsum_data", "ipsum_model", "ipsum_both",
           "index_data", "index_model", "a2a_data", "a2a_model",
           "sm_stack", "a2a1", "a2a_bf16", "smap_stack", "blocks"]
WHOLE = ["psum1", "sm_whole", "gather_rows", "gather_bf16", "gather_bool"]


@pytest.mark.parametrize("case", STACKED)
def test_stacked_collective_matches_local_mesh(collectives, case):
    """Rank r's (1, ...) value is row r of LocalMesh's (4, ...) stack."""
    ranks, local = collectives
    for r, got in enumerate(ranks):
        want = local[case][r:r + 1]
        assert got[case].dtype == want.dtype, case
        np.testing.assert_array_equal(got[case], want, err_msg=case)


@pytest.mark.parametrize("case", WHOLE)
def test_whole_value_matches_local_mesh(collectives, case):
    """A value every shard holds whole (the 1-D ``psum``, a
    ``globalize``d output, every rank's rows) is LocalMesh's."""
    ranks, local = collectives
    for got in ranks:
        np.testing.assert_array_equal(got[case], local[case], err_msg=case)


def test_sharded_outputs_stay_each_ranks_block(collectives):
    """``shard_map`` leaves a sharded output where it is: rank r holds
    the block of LocalMesh's whole output at its coordinates, and a
    row-sharded 1-D output holds rank r's rows."""
    ranks, local = collectives
    for r, got in enumerate(ranks):
        d, m = divmod(r, 2)
        want = local["sm_block"][2 * d:2 * d + 2, 3 * m:3 * m + 3]
        np.testing.assert_array_equal(got["sm_block"], want)
        np.testing.assert_array_equal(got["smap_rows"],
                                      local["smap_rows"][5 * r:5 * r + 5])
        assert "all_to_all" in list(got["transport"])


# ------------------------------------------------------------ relational
_REFERENCE = f"AGGS, COG_L, COG_R = {U.AGGS!r}, {U.COG_L!r}, {U.COG_R!r}\n" \
    + textwrap.dedent("""
    import sys
    import numpy as np, jax
    from repro.dataflow.table import Table
    from repro.dataflow import shuffle as S

    z = np.load(sys.argv[1])
    ins = {}
    for key in z.files:
        t, c = key.split("__")
        ins.setdefault(t, {})[c] = z[key]
    T = {n: Table.from_numpy(c) for n, c in ins.items()}
    mesh = jax.make_mesh((4,), ("data",))
    out = {}

    def put(case, table, *scalars):
        for c, a in table.columns.items():
            out[f"{case}__{c}"] = np.asarray(a)
        out[f"{case}__valid"] = np.asarray(table.valid)
        for i, x in enumerate(scalars):
            out[f"{case}__s{i}"] = np.asarray(x)

    with mesh:
        g, o = jax.jit(lambda t: S.distributed_groupby(
            t, ["k"], AGGS, mesh, skew_factor=4.0))(T["fact"])
        put("gb", g, o)
        g, o = jax.jit(lambda t: S.distributed_groupby(
            t, ["s"], AGGS, mesh, skew_factor=4.0))(T["fact"])
        put("gb_str", g, o)
        d, o = jax.jit(lambda t: S.distributed_distinct(
            t, mesh, skew_factor=4.0))(T["dist"])
        put("dist", d, o)
        j, lane, so, jo = jax.jit(lambda l, r: S.distributed_join(
            l, r, ["k"], ["rk"], mesh, expansion=2, skew_factor=4.0,
            return_pre=True))(T["left"], T["right"])
        put("join", j, so, jo)
        out["join__lane"] = np.asarray(lane)
        g, o = jax.jit(lambda t, ln: S.distributed_groupby(
            t, ["k"], {"s": ("sum", "a")}, mesh, co_partitioned=True,
            pre_lane=ln))(j, lane)
        put("gb_copart", g, o)
        c, o = jax.jit(lambda a, b: S.distributed_cogroup(
            a, b, ["u"], ["w"], COG_L, COG_R, mesh, skew_factor=4.0))(
            T["ca"], T["cb"])
        put("cog", c, o)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def relational():
    """(the reference's 4-device outputs, LocalMesh(4)'s, and the 4 gloo
    ranks' outputs concatenated in rank order, scalars from rank 0)."""
    pytest.importorskip("jax")
    tmp = tempfile.mkdtemp(prefix="group_rel_")
    inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(inp, **{f"{t}__{c}": a
                     for t, cols in U.relational_inputs().items()
                     for c, a in cols.items()})
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, inp, outp],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ranks = _spawn(U.rank_relational)
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    z = np.load(outp)
    ref = {k: z[k] for k in z.files}
    local = U.relational(LocalMesh(U.N, device=U.CPU))
    group = {}
    for k in local:
        if re.search(r"__s\d$", k):   # the mesh's overflow counts
            for r in ranks:
                np.testing.assert_array_equal(r[k], ranks[0][k])
            group[k] = ranks[0][k]
        else:
            group[k] = np.concatenate([r[k] for r in ranks])
    return ref, local, group, ranks


CASES = ["gb", "gb_str", "dist", "join", "gb_copart", "cog"]


@pytest.mark.parametrize("case", CASES)
def test_distributed_operator_over_ranks(relational, case):
    ref, local, group, _ = relational
    want = {k: v for k, v in ref.items() if k.startswith(case + "__")}
    for name, got in (("local", local), ("group", group)):
        have = {k: v for k, v in got.items() if k.startswith(case + "__")}
        assert sorted(have) == sorted(want), name
        for k, w in want.items():
            h = have[k]
            if k == "join__lane":      # uint32 lane vs its int64 carrier
                w = w.astype(np.int64)
            assert h.shape == w.shape, (name, k)
            np.testing.assert_array_equal(h.astype(w.dtype), w,
                                          err_msg=f"{name} {k}")
    # the group's rows are LocalMesh's, slot for slot
    for k in want:
        np.testing.assert_array_equal(group[k], local[k], err_msg=k)


def test_exchange_moves_rows_between_ranks(relational):
    """Every rank sent its packed rows through ``all_to_all``."""
    *_, ranks = relational
    assert all(int(r["__bytes__"]) > 0 for r in ranks)
