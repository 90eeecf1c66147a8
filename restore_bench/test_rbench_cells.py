"""Each cell driven end to end on the CPU at a small size: the result
line's shape, a sound run judged correct, and the control (the
reference one precision lower, put in the program's place) reading
clearly above the program.  The same control at each cell's own size
runs on the card (``cuda``)."""
import json

import pytest
import torch

from restore_bench import harness, smoke

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
# the benchmark's cells, and the PigMix traffic that BENCHMARK.json does not
# run yet (PERF.md), with their config files
SMOKE = [(w["name"], w["config"]) for w in SPEC["workloads"]] + \
    [("pigmix.recurring", "pigmix-2e24")]


@pytest.mark.parametrize("cell,config", SMOKE)
def test_sound_run_is_correct_and_controls_fail(cell, config):
    out = smoke.run(cell, trace=cell.startswith("minicpm3"),
                    config_name=config)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    public = {k: v for k, v in out.items() if not k.startswith("_")}
    assert list(public)[-1] == "compared"
    json.dumps(public)
    drv = out["_driver"]
    ctl = drv.control()
    prog = out["compared"]
    assert any(ctl[k] > max(3 * prog[k]["value"], 1e-6) for k in ctl
               if k in prog), (ctl, prog)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    """Three seeds at the cell's own size: the control exceeds a limit,
    the program does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    limits = harness.load_json("workloads", cell + ".json")["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out = harness.run_cell(cell, seed, 20.0, False, "cuda:0",
                               time.perf_counter())
        assert out["correct"], out["compared"]
        ctl = out["_driver"].control()
        assert any(ctl[k] > lim for k, lim in limits.items()), ctl
        del out
        torch.cuda.empty_cache()
