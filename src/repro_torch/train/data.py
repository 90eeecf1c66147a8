"""LM data pipeline built ON the dataflow engine — ReStore's integration
into training (``src/repro/train/data.py``, DESIGN.md §4).

Corpus preparation (tokenize-stub -> quality/length filter -> dedup ->
select token columns) is a physical plan run by the ``ReStore`` driver,
so repeated training runs that share pipeline prefixes reuse each
other's intermediate artifacts exactly like PigMix queries do.  The
corpus comes from the reference's numpy generator with the same seed, so
the rows, the DISTINCT's output order and the batcher's order are the
reference's.
"""
from __future__ import annotations

import numpy as np

from ..core import plan as P
from ..core.restore import ReStore
from ..dataflow.expr import Col
from ..dataflow.table import Table


def synthetic_corpus(n_docs: int, seq_len: int, vocab: int,
                     seed: int = 0, capacity: int | None = None,
                     device=None) -> Table:
    """Documents with token rows, length and quality columns, on
    ``device`` (None: the card).  Duplicate documents are injected so the
    dedup stage has work to do."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (n_docs, seq_len)).astype(np.int32)
    n_dup = max(1, n_docs // 10)
    toks[-n_dup:] = toks[:n_dup]                 # 10% exact duplicates
    return Table.from_numpy({
        "doc_id": np.arange(n_docs, dtype=np.int32),
        "tokens": toks,
        "length": rng.integers(seq_len // 4, seq_len, n_docs)
        .astype(np.int32),
        "quality": rng.uniform(0, 1, n_docs).astype(np.float32),
    }, capacity=capacity or n_docs, device=device)


def pipeline_plan(min_quality: float = 0.3, min_length: int = 0,
                  out_name: str = "train_corpus") -> P.PhysicalPlan:
    """tokenize-stub -> quality filter [-> length filter] -> dedup.

    Filters are CHAINED (not fused into one predicate) so pipelines that
    differ only in later stages share the earlier filter sub-jobs — the
    reuse-opportunity structure of paper §2.1."""
    src = P.load("corpus")
    filt = P.filter_(src, Col("quality") > min_quality)
    if min_length:
        filt = P.filter_(filt, Col("length") > min_length)
    proj = P.project(filt, ["tokens", "doc_id"])
    dedup = P.distinct(P.project(proj, ["tokens"]))
    return P.PhysicalPlan([P.store(dedup, out_name)])


def run_pipeline(restore: ReStore, corpus: Table, *, min_quality=0.3,
                 min_length=0, out_name="train_corpus"):
    if "corpus" not in restore.catalog.sources:
        restore.catalog.register("corpus", corpus)
    results, report = restore.run_plan(
        pipeline_plan(min_quality, min_length, out_name))
    return results[out_name], report


def batches_from_table(table: Table, batch_size: int, seq_len: int,
                       seed: int = 0):
    """Thin host-side batcher over a pipeline artifact: yields
    (tokens, labels) numpy batches forever (deterministic order, so a
    restarted trainer can skip ahead)."""
    toks = table.to_numpy()["tokens"]
    n = len(toks)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    i = 0
    while True:
        idx = [order[(i + j) % n] for j in range(batch_size)]
        i += batch_size
        chunk = toks[idx][:, :seq_len + 1]
        if chunk.shape[1] < seq_len + 1:
            chunk = np.pad(chunk, ((0, 0), (0, seq_len + 1 - chunk.shape[1])))
        yield chunk[:, :-1].astype(np.int32), chunk[:, 1:].astype(np.int32)
