"""The port's dry-run counts (``launch/dryrun.py``) on the CPU: the
step of each family on the ``meta`` device under ``CostMode``.

The counts are exact integers, so the extrapolations are held exactly:
the depth-1/-2 extrapolation equals a full-depth count, and the xLSTM
loops' length extrapolation equals the full loop's count (FLOPs, FLOPs by
dtype, bytes).  CostMode's FLOPs equal ``FlopCounterMode``'s, and a dense
train step's lie within 1% of an analytic count of its products.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import api  # noqa: E402


def _exact(a, b):
    assert a["flops"] == b["flops"] and a["bytes"] == b["bytes"]
    assert {k: v for k, v in a["flops_by_dtype"].items() if v} == \
        {k: v for k, v in b["flops_by_dtype"].items() if v}


# one architecture of each family, at three periods (remat on) so that
# the extrapolation from one and two reaches past them
FAMILIES = ["qwen3-1.7b", "minicpm3-4b", "llama4-maverick-400b-a17b",
            "seamless-m4t-medium", "xlstm-350m", "qwen2-vl-72b",
            "jamba-1.5-large-398b"]


def _xlstm(**kw):
    """xlstm-350m's smoke config cut to one mLSTM and one sLSTM layer."""
    cfg = get_config("xlstm-350m", smoke=True)
    return cfg.with_(n_layers=2, xlstm=dataclasses.replace(cfg.xlstm,
                                                           slstm_every=2),
                     **kw)


def _three_periods(arch):
    cfg = _xlstm(remat=True) if arch == "xlstm-350m" else \
        get_config(arch, smoke=True).with_(remat=True)
    if cfg.family == "encdec":
        return cfg.with_(n_layers=3, n_encoder_layers=3)
    return D._depth_variant(cfg, 3)


@pytest.mark.parametrize("arch", FAMILIES)
def test_depth_extrapolation_equals_a_full_depth_count(arch):
    cfg = _three_periods(arch)
    for kind in ("train", "decode"):
        got = D.extrapolated_cost(cfg, kind, 32, 2)
        _exact(got, D._step_cost(cfg, kind, 32, 2))
        assert got["collective_bytes"] == {k: 0 for k in D.COLLECTIVES}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_loop_extrapolation_equals_the_full_loop_count(kind):
    """xLSTM's loops over time counted at LOOP_STEPS and twice as many,
    extrapolated to four times as many: exactly the full loop's count,
    chunked remat included."""
    cfg = _xlstm(remat=True)
    s = 4 * D.LOOP_STEPS
    assert D._loop_steps(cfg, kind, s)
    _exact(D._cell_cost(cfg, kind, s, 1), D._step_cost(cfg, kind, s, 1))


def test_cost_mode_flops_are_the_flop_counters():
    """CostMode's FLOPs (metadata reused for repeated ops) equal
    ``torch.utils.flop_counter.FlopCounterMode``'s on the same step."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.train import batch_step
    from repro_torch.train.optimizer import AdamW
    cfg = get_config("jamba-1.5-large-398b", smoke=True).with_(remat=True)
    model = api.build(cfg, device=api.META)
    params = model.init_shapes()
    opt = AdamW()
    with FlopCounterMode(display=False) as fc:
        batch_step(model, opt, params, opt.init(params),
                   model.specs("train", 64, 2))
    assert D._step_cost(cfg, "train", 64, 2)["flops"] == \
        fc.get_total_flops()


def test_dense_train_step_flops_match_an_analytic_count():
    """qwen3-1.7b's smoke config: each layer's products run once forward
    and twice in the backward (input and weight gradients), the
    unembedding's too; attention counts its plain version's two (S x S)
    products a head; AdamW adds no product.  Under remat the recompute
    adds at most one more forward of the layers (it stops once the saved
    tensors are back)."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    b, s, d, dh = 2, 64, cfg.d_model, cfg.head_dim
    t = b * s
    proj = 2 * t * (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                    + 3 * d * cfg.d_ff)
    attn = 2 * 2 * b * cfg.n_heads * s * s * dh
    unembed = 2 * t * d * cfg.vocab_size
    want = cfg.n_layers * 3 * (proj + attn) + 3 * unembed
    got = D._step_cost(cfg.with_(remat=False), "train", s, b)["flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    remat = D._step_cost(cfg.with_(remat=True), "train", s, b)["flops"]
    assert got < remat <= got + cfg.n_layers * (proj + attn)


def test_lower_cell_reports_one_card():
    rep = D.lower_cell("xlstm-350m", "decode_32k")
    assert rep["status"] == "ok" and rep["mesh"] == "1xH100"
    c = rep["cost_extrapolated"]
    assert c["flops"] > 0 and c["bytes"] > 0
    assert set(c["flops_by_dtype"]) <= {"bfloat16", "float32"}
    assert c["collective_reason"] == D.NO_COLLECTIVES
    m = rep["memory"]
    assert m["parameter_bytes"] < m["peak_bytes"] <= D.CARD_BYTES
    assert rep["fits_one_card"] is True
    assert rep["active_params"] == get_config("xlstm-350m").active_params()
    skip = D.lower_cell("qwen3-1.7b", "long_500k")
    assert skip["status"] == "skipped" and "long_500k" in skip["reason"]


def test_remat_chunks_lower_the_xlstm_peak():
    """The simulated peak of a train step falls under chunked remat (the
    loops keep carries at chunk edges, not every step's state)."""
    cfg = _xlstm()
    on = D._step_cost(cfg.with_(remat=True), "train", 4 * D.LOOP_STEPS, 1)
    off = D._step_cost(cfg, "train", 4 * D.LOOP_STEPS, 1)
    assert on["peak_bytes"] < 0.5 * off["peak_bytes"]
    assert on["flops"] > off["flops"]          # the recompute


def test_dryrun_cli_writes_a_report_and_refuses_the_mesh_options(
        tmp_path, capsys):
    """One card, then ``--multi-pod`` and ``--opt`` (on 16x16 unless
    ``--multi-pod``) write their reports under the reference's tags
    (``{arch}_{shape}_16x16[_opt].json``), rank 0's per-device report
    with collectives; contradictory mesh options are refused."""
    import json
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "xlstm-350m", "--shape", "long_500k",
                "--out-dir", str(tmp_path)])
    assert e.value.code == 0
    rep = json.loads((tmp_path / "xlstm-350m_long_500k_1xH100.json")
                     .read_text())
    assert rep["status"] == "ok"
    assert "[     ok] xlstm-350m_long_500k_1xH100" in capsys.readouterr().out
    for opts, tag, mesh in ((["--multi-pod"], "2x16x16", "2x16x16"),
                            (["--opt"], "16x16_opt", "16x16"),
                            (["--multi-pod", "--opt"], "2x16x16_opt",
                             "2x16x16")):
        with pytest.raises(SystemExit) as e:
            D.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                    "--out-dir", str(tmp_path)] + opts)
        assert e.value.code == 0
        rep = json.loads((tmp_path / f"qwen3-1.7b_decode_32k_{tag}.json")
                         .read_text())
        c = rep["cost_extrapolated"]
        assert (rep["status"], rep["mesh"], rep["rank"]) == ("ok", mesh, 0)
        assert rep["optimized"] == ("--opt" in opts)
        assert c["collective_bytes"]["all-gather"] > 0
        assert sum(c["collective_bytes_by_link"].values()) == \
            sum(c["collective_bytes"].values())
    with pytest.raises(SystemExit) as e:
        D.main(["--all", "--multi-pod", "--mesh", "16x16"])
    assert e.value.code == 2


def test_dryrun_cli_takes_one_cell_at_other_dims(tmp_path):
    """``--seq``/``--batch`` give one cell's report at those dims, under a
    name that carries them; ``--all`` refuses them."""
    import json
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                "--seq", "1024", "--batch", "2", "--out-dir",
                str(tmp_path)])
    assert e.value.code == 0
    rep = json.loads((tmp_path / "xlstm-350m_decode_32k_seq1024_batch2"
                                 "_1xH100.json").read_text())
    assert rep["status"] == "ok"
    assert (rep["seq"], rep["global_batch"]) == (1024, 2)
    assert rep == D.lower_cell("xlstm-350m", "decode_32k", seq=1024,
                               batch=2) | {"count_s": rep["count_s"]}
    with pytest.raises(SystemExit) as e:
        D.main(["--all", "--seq", "1024"])
    assert e.value.code == 2
