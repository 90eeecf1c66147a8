"""A run with the timed path broken underneath comes out not correct:
half of a reused result's rows left out, an aggregate of a reused result
altered where the store hands it out, a served token altered where the
model produces it (in the prefill and in a decode step)."""
import pytest
import torch

from restore_bench import smoke


def _half_rows(drv):
    inner = drv.store.get

    def get(name):
        t = inner(name)
        keep = torch.arange(t.capacity, device=t.valid.device) < \
            t.capacity // 2
        return t.with_valid(t.valid & keep)
    drv.store.get = get


def _altered_sums(drv):
    from repro_torch.dataflow.table import Table
    inner = drv.store.get

    def get(name):
        t = inner(name)
        return Table({c: v * 1.01 if v.is_floating_point() else v
                      for c, v in t.columns.items()}, t.valid)
    drv.store.get = get


def _flip(logits):
    top = logits[..., -1, :].argmax(-1)
    out = logits.clone()
    out[..., -1, :].scatter_(-1, ((top + 1) % out.shape[-1])[..., None],
                             1e4)
    return out


def _altered_decode(drv):
    inner = drv.model.decode_step

    def decode_step(params, batch, cache, index):
        logits, cache = inner(params, batch, cache, index)
        return _flip(logits), cache
    drv.model.decode_step = decode_step


def _altered_prefill(drv):
    inner = drv.model.prefill

    def prefill(params, batch, cache, start=None):
        logits, cache = inner(params, batch, cache, start)
        return _flip(logits), cache
    drv.model.prefill = prefill


@pytest.mark.parametrize("cell,config,fault", [
    ("pigmix.recurring", "pigmix-2e24", _half_rows),
    ("pigmix.recurring", "pigmix-2e24", _altered_sums),
    ("minicpm3.docqa", "minicpm3-4b", _altered_decode),
    ("minicpm3.docqa", "minicpm3-4b", _altered_prefill),
])
def test_broken_path_is_not_correct(cell, config, fault):
    out = smoke.run(cell, hooks=fault, config_name=config)
    assert out["correct"] is False, out["compared"]
