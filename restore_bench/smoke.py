"""Small versions of the cells for the CPU tests: the same config and
traffic files with their sizes cut, run through ``harness.run_cell`` on
the CPU (the program's kernel wrappers take their plain versions)."""
from __future__ import annotations

import time

from . import harness

MLA_SMOKE = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=4,
                 q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                 qk_rope_head_dim=8, v_head_dim=16, vocab_size=256,
                 torch_dtype="float32", kv_budget_bytes=1 << 30)


def config(cell: str, name: str = None):
    """The cell's config file (or the named one, for a traffic file that
    ``BENCHMARK.json`` does not run yet), cut to a small size."""
    name = name or harness.cell_entry(harness.load_spec(), cell)["config"]
    cfg = harness.load_json("configs", name + ".json")
    if cfg["driver"] == "pigmix":
        cfg.update(page_views_rows=1 << 11, users=1 << 7, workers=2,
                   repository_budget_bytes=1 << 30)
    else:
        cfg.update(MLA_SMOKE)
    return cfg


def traffic(cell: str):
    tr = harness.load_json("workloads", cell + ".json")
    if "tenants" in tr:
        tr.update(tenants=2, outstanding=2, setup_passes=1, per_tenant=64)
    elif tr["kind"] == "doc":
        tr.update(doc_tokens=[24, 48], question_tokens=[4, 8],
                  answer_tokens=[2, 4], max_len=64, max_requests=5000,
                  live_docs=4, check_requests=4)
    else:
        tr.update(prompt_tokens=[16, 64], answer_tokens=[4, 8], max_len=72,
                  max_requests=5000, check_requests=8)
    return tr


def run(cell: str, seed: int = 2**31 + 11, seconds: float = 1.0,
        trace: bool = False, hooks=None, config_name: str = None):
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter(),
                            config=config(cell, config_name),
                            traffic=traffic(cell), hooks=hooks)
