"""``launch/step_probe.py`` on the CPU at xlstm-350m's smoke config: the
probe runs end to end and writes its JSON line, and its central
difference predicts the float32 loss's change along the gradient within
FD_RTOL (the bound ``chip_smoke.py``'s phase 12 (b) holds at full width)
and leaves the parameters as they were."""
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import step_probe  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

FD_RTOL = 0.05


def test_probe_writes_its_line(tmp_path):
    out = tmp_path / "probe.json"
    assert step_probe.main(["--device", "cpu", "--smoke", "--batch", "2",
                            "--seq", "16", "--grad-seq", "12", "--steps",
                            "1", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["card"] == "cpu" and got["leaves"] > 0
    assert len(got["losses"]) == 2 and all(map(math.isfinite, got["losses"]))
    assert abs(got["central_rel_err"]) <= FD_RTOL


def test_central_difference_predicts_the_change_and_restores():
    model = build(get_config("xlstm-350m", smoke=True), device="cpu")
    params = model.init(1)
    batch = model.demo_batch(0, 24, 2)
    before = [t.clone() for t in tree_leaves(params)]
    _, grads = step_probe.grads_of(model, params, batch)
    up, down, want = step_probe.central_difference(model, params, grads,
                                                   batch, 1e-3)
    assert down < up and abs(up - down - want) <= FD_RTOL * abs(want)
    for a, b in zip(tree_leaves(params), before):
        assert torch.equal(a, b)
