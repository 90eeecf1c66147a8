"""Same plans, same bytes: every PigMix template gets the same operator
fingerprints and ``plan_signature`` in the port as in the reference, the
compiled workflows agree, and the port's generators (the vectorised
page_views one included) give the reference's tables."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import plan as RP  # noqa: E402
from repro.dataflow import compiler as RC  # noqa: E402
from repro.workloads import pigmix as RW  # noqa: E402
from repro_torch.core import plan as TP  # noqa: E402
from repro_torch.dataflow import compiler as TC  # noqa: E402
from repro_torch.workloads import pigmix as TW  # noqa: E402


def _templates(W):
    out = {f"Q:{k}": f for k, f in W.QUERIES.items()}
    out.update({f"LEGACY:{k}": f for k, f in W.LEGACY.items()})
    out["Q:L3mean"] = lambda: W.L3("mean")
    out["Q:L11users"] = lambda: W.L11("users")
    for n in (1, 3, 5):
        out[f"QP{n}"] = (lambda n=n: W.QP(n))
        out[f"LEGACY:QP{n}"] = (lambda n=n: W._legacy_QP(n))
    for f in ("field6", "field9", "field12"):
        out[f"QF:{f}"] = (lambda f=f: W.QF(f))
        out[f"LEGACY:QF:{f}"] = (lambda f=f: W._legacy_QF(f))
    return out


def _fps(plan):
    fps = plan.fingerprints()
    return [fps[id(op)] for op in plan.topo()]


@pytest.mark.parametrize("name", sorted(_templates(RW)))
def test_fingerprints_and_signature_equal(name):
    ref_plan = _templates(RW)[name]()
    port_plan = _templates(TW)[name]()
    assert _fps(port_plan) == _fps(ref_plan)
    assert [op.kind for op in port_plan.topo()] == \
        [op.kind for op in ref_plan.topo()]
    sfp_r = ref_plan.structural_fingerprints()
    sfp_t = port_plan.structural_fingerprints()
    assert [sfp_t[id(op)] for op in port_plan.topo()] == \
        [sfp_r[id(op)] for op in ref_plan.topo()]
    for sink_r, sink_t in zip(ref_plan.sinks, port_plan.sinks):
        sub_r = RP.PhysicalPlan([sink_r.inputs[0]])
        sub_t = TP.PhysicalPlan([sink_t.inputs[0]])
        assert TP.plan_signature(sub_t) == RP.plan_signature(sub_r)
    wf_r, wf_t = RC.compile_workflow(ref_plan), TC.compile_workflow(port_plan)
    assert wf_t.final_outputs == wf_r.final_outputs
    assert [(j.inputs, j.outputs) for j in wf_t.jobs] == \
        [(j.inputs, j.outputs) for j in wf_r.jobs]


def _assert_tables_equal(port_t, ref_t):
    got = port_t.to_numpy(only_valid=False)
    want = ref_t.to_numpy(only_valid=False)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    np.testing.assert_array_equal(port_t.valid.numpy(),
                                  np.asarray(ref_t.valid))


@pytest.mark.parametrize("n_rows,seed,n_users", [(1000, 0, 200),
                                                 (2048, 5, 16384),
                                                 (7, 3, 1)])
def test_page_views_generator_equal(n_rows, seed, n_users):
    _assert_tables_equal(
        TW.gen_page_views(n_rows, seed, n_users=n_users, capacity=2048,
                          device="cpu"),
        RW.gen_page_views(n_rows, seed, n_users=n_users, capacity=2048))


def test_other_generators_equal():
    _assert_tables_equal(TW.gen_users(device="cpu"), RW.gen_users())
    _assert_tables_equal(TW.gen_users(n_users=4096, device="cpu"),
                         RW.gen_users(n_users=4096))
    _assert_tables_equal(TW.gen_power_users(device="cpu"),
                         RW.gen_power_users())
    _assert_tables_equal(TW.gen_synth(300, device="cpu"),
                         RW.gen_synth(300))


def test_vectorised_column_matches_per_row_encoding():
    vocab = [f"user{i:04d}" for i in range(50)]
    a = TW._vocab_column(np.random.default_rng(11), vocab, 999)
    r = np.random.default_rng(11)
    b = TW.encode_strings([vocab[i] for i in r.integers(0, 50, 999)])
    assert a.tobytes() == b.tobytes()
