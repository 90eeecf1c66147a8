#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--log2-rows 24] [--seed 0]

Phase 0  the card: name and power limit, torch/CUDA versions, and the
         build of the port's CUDA kernels from ``src/repro_torch/csrc``.
Phase 1  every kernel against its plain PyTorch version on the card: the
         ragged and tie-heavy generators of the kernel parity tests
         (sizes 1-4097; for the radix kernels ragged sizes up to
         2**21+3, 2 to 256 partitions, overflowing and all-invalid
         rows, bucket 1, tiles of 256 and 1024), the probe's, the
         segment sum's and the radix kernels' edge cases
         (``bench.edge_cases`` of each: bucket edges, ties, tile
         boundaries, D 1-5, two calls bit-identical; 1 to 8192
         partitions, scatter tiles ending at a bucket's edge) and the
         main path's shapes, with times for the kernel, the plain
         version and one PyTorch library call that computes the same
         function (a yardstick the port never calls).
Phase 2  the main path: the ReStore loop over PigMix at ``page_views`` =
         2**log2_rows rows (n_users = 2**16) held on the card.  Every
         query runs plain -> store -> reuse as
         ``benchmarks/common.py::measure_query`` does, with disk-rooted
         stores so artifacts take the write path and its compaction
         kernel.  Each arm's rows are checked: the plain arm against a
         numpy oracle computed from the generator's draws, the store and
         reuse arms against the plain arm.  The kernels' launch counters
         are zeroed just before this phase and must all be positive
         after it (the probe's directory pre-pass counted beside the
         probe, one each).
Phase 3  where the time goes: L3's plain arm plus its flush under
         torch.profiler (after phase 2's counts were read).
Phase 4  the mesh path: ``benchmarks/distributed_bench.py``'s workload
         (join(project(page_views), project(users)) -> group by user)
         at page_views = 2**log2_rows rows and n_users = rows / 8, on a
         ``LocalMesh(8)`` of the card at skew factor 4, in the bench's
         four arms (single device; mesh, no reuse; mesh reusing the join
         artifact partition-blind; and co-partitioned).  Every arm's
         groups are held against a numpy oracle from the generator's
         draws (only users whose names share a key hash may come back
         split into several groups), and every mesh arm's rows against
         the single-device arm's.  The co-partitioned arm must skip an
         exchange and the blind arm's timed run must launch one.  The
         launch counters are zeroed just before the three mesh arms and
         read just after them, the partition scatter's also by launch
         shape (S, N, P, bucket).  Then one more t_mesh_plain run goes
         under torch.profiler, and a small skewed case must overflow a
         bucket, take the lossless retry and still agree.

Phase 5  the serving path: qwen3-1.7b at its full config (bf16, 28
         layers, random weights from a seeded generator).  (a) The
         flash-attention kernels (bf16: the tensor-core kernel of
         ``csrc/flash_attention_sm90.cu``; f32: the CUDA-core kernel)
         against their plain version (the ragged and kv_len cases of
         the reference's attention tests, per-row kv_len and q_offset,
         GQA, kv_len = 1, kv_len at the 128-key split boundaries and one
         off, all four head dims, f32 and bf16; rows with kv_len = 0
         or causal before every key, which get the mean of V, in both
         forms of the bf16 kernel) and their batch invariance, then the
         bf16 kernel's device times at the path's shapes (CUDA-graph
         replays, so the host's dispatch is not timed) beside its eager
         times and the wrapper's host time per decode call.  (b)
         ``benchmarks/prefix_reuse_bench.py``'s protocol through
         ``ServeSession.serve``: a cold arm and a ``KVRepository`` arm,
         with teacher-forced logits of every step held against the cold
         arm's.  (c) A round trip of snapshots through the host tier.
         (d) Continuous batching (``submit``/``run``, 4 slots) against
         ``serve()``.  (e) The flash-attention launch counter, zeroed
         before (b) and read after (d): one launch per layer per
         prefill or decode step (the split-KV merges counted beside
         it).  (f) The smoke config, f32, on the card against the CPU.
Phase 6  the service path over PigMix (n_users 200, as the stream
         driver registers it).  (a) ``run_stream("cost")`` at page_views
         = 2**log2_rows rows: 24 events from 3 tenants at zipf 1.1, 10%
         appended every 8 events, ``maintain="auto"``, the prefetcher on;
         then every live repository entry against a cold recompute of its
         plan (reuse off) on the final tables.  (b) ``run_batch`` of 8
         queries that share sub-plans against the same queries run one by
         one, with no shared sub-plan executed twice.  (c) A 4-worker
         ``ReStoreService`` over the stream's events on a disk store with
         a journal, every ticket against a serial cold baseline, and a
         stampede of one plan that must collapse onto one execution;
         goodput and latency.  (d) The store reopened and the journal
         replayed: a repeated query is answered by reuse.  (e) The seeded
         fault sweep of ``tests/test_faults.py`` (8 schedules) at 2**20
         rows against the fault-free answers.  The launch counters are
         zeroed before (a) and read after (e).  Float aggregates are held
         within RTOL_FLOAT_AGG, everything else exactly.  (f) Where the
         time goes: (c)'s events once more under torch.profiler.

Prints one JSON line of kernel measurements, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  Needs the repository's ``src/`` beside this file and
a CUDA card; without either it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
RTOL_FLOAT_AGG = 1e-4            # float sums/means added in another order
N_USERS = 1 << 16
N_SHARDS = 8                     # the mesh phase's LocalMesh
MESH_SKEW = 4.0                  # distributed_bench.py's default skew


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing


def cuda_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------- phase 1: kernels vs plain


def _hashes(rng, n, ties):
    if ties == "uniform":
        return rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if ties == "few":
        pool = rng.integers(0, 1 << 32, max(1, n // 8), dtype=np.uint32)
        return pool[rng.integers(0, len(pool), n)]
    return np.full(n, np.uint32(0xDEADBEEF))


def _valid(rng, n, mode):
    if mode == "none":
        return np.zeros(n, bool)
    if mode == "all":
        return np.ones(n, bool)
    return rng.random(n) < 0.7


def ragged_checks(dev):
    """The parity generators at sizes 1-4097: bit-identity throughout
    (segment-sum payloads are integer-valued)."""
    import torch
    from repro_torch.kernels.filter_project import ops as fp
    from repro_torch.kernels.hash_join import ops as hj
    from repro_torch.kernels.segment_reduce import ops as sr

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sizes = [1, 7, 127, 128, 129, 333, 1024, 4097]
    n_cases = 0
    for i, n in enumerate(sizes):
        for ties in ("uniform", "few", "const"):
            rng = np.random.default_rng(i)
            lh = t(_hashes(rng, n, ties).astype(np.int64))
            rh = t(np.sort(_hashes(rng, max(1, n // 2), ties))
                   .astype(np.int64))
            check(torch.equal(hj.probe(lh, rh), hj.join_probe_ref(lh, rh)),
                  f"probe differs from plain at n={n} ties={ties}")
            n_cases += 1
        for vmode in ("mixed", "all", "none"):
            for dtype in (np.float32, np.int32, np.uint8):
                rng = np.random.default_rng(100 + i)
                d = int(rng.integers(1, 5))
                vals = t(rng.integers(-100, 100, (n, d)).astype(dtype))
                m = t(_valid(rng, n, vmode))
                got, tot = fp.compact(vals, m)
                want, wtot = fp.filter_compact_ref(vals, m)
                check(torch.equal(got, want) and int(tot) == int(wtot),
                      f"compact differs at n={n} {vmode} {dtype.__name__}")
                n_cases += 1
            # the store's form: one mask count, a scatter per column
            rng = np.random.default_rng(300 + i)
            cols = [t(rng.integers(-100, 100, n).astype(np.int32)),
                    t(rng.standard_normal(n).astype(np.float32)),
                    t(rng.integers(0, 256, (n, 20)).astype(np.uint8))]
            m = t(_valid(rng, n, vmode))
            outs, tot = fp.compact_columns(cols, m)
            check(int(tot) == int(m.sum()) and all(
                torch.equal(o, fp.filter_compact_ref(c, m)[0])
                for c, o in zip(cols, outs)),
                f"compact_columns differs at n={n} {vmode}")
            n_cases += 1
        for dtype in (np.float32, np.int32):
            rng = np.random.default_rng(200 + i)
            d = int(rng.integers(1, 4))
            vals = t(rng.integers(-50, 50, (n, d)).astype(np.float32))
            start = int(rng.integers(-1, 2))
            sid = t((start + np.cumsum(rng.integers(0, 2, n)))
                    .astype(np.int32))
            s = 16
            check(torch.equal(sr.segment_sum(vals, sid, num_segments=s),
                              sr.segment_sum_ref(vals, sid,
                                                 num_segments=s)),
                  f"segment_sum differs at n={n}")
            n_cases += 1
    torch.cuda.synchronize()
    return n_cases


def edge_case_checks(dev):
    """The probe and the segment sum against their plain versions on each
    kernel's ``bench.edge_cases``: probe positions and integer-valued
    segment sums bit for bit, float lanes within RTOL_FLOAT_AGG, and two
    segment-sum calls bit-identical."""
    import torch
    from repro_torch.kernels.hash_join import bench as hj_bench
    from repro_torch.kernels.hash_join import ops as hj
    from repro_torch.kernels.segment_reduce import bench as sr_bench
    from repro_torch.kernels.segment_reduce import ops as sr

    n_cases = 0
    for label, left, right in hj_bench.edge_cases(dev):
        check(torch.equal(hj.probe(left, right),
                          hj.join_probe_ref(left, right)),
              f"probe differs from plain on {label}")
        n_cases += 1
    tile = sr.library().restore_segment_sum_tile()
    for label, vals, ids, ns, exact in sr_bench.edge_cases(dev, tile=tile):
        got = sr.segment_sum(vals, ids, num_segments=ns)
        again = sr.segment_sum(vals, ids, num_segments=ns)
        want = sr.segment_sum_ref(vals, ids, num_segments=ns)
        check(torch.equal(got, again), f"segment_sum: two calls differ on "
                                       f"{label}")
        if exact:
            check(torch.equal(got, want),
                  f"segment_sum differs from plain on {label}")
        else:
            rel = float(((got - want).abs() / want.abs().clamp(min=1.0))
                        .max())
            check(rel <= RTOL_FLOAT_AGG,
                  f"segment_sum on {label}: rel err {rel}")
        n_cases += 1
    torch.cuda.synchronize()
    return n_cases


def radix_checks(dev):
    """Both radix kernels bit for bit against their plain versions:
    ragged N, P in {2, 8, 256}, every row bound for one partition (so
    the bucket overflows), all rows invalid, bucket 1 and histogram tiles
    of 256 and 1024; the mesh form, eight segments in one launch; then
    ``bench.edge_cases`` (N up to 2**21 + 3, P up to 8192, tile and
    bucket edges)."""
    import torch
    from repro_torch.kernels.radix_partition import bench as rp_bench
    from repro_torch.kernels.radix_partition import ops as rp
    from repro_torch.kernels.radix_partition.ref import (
        partition_scatter_ref, radix_partition_ref)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n_cases = 0
    for i, n in enumerate([1, 255, 257, (1 << 21) + 3]):
        for n_parts in (2, 8, 256):
            for ties, vmode in (("uniform", "mixed"), ("const", "all"),
                                ("few", "none")):
                rng = np.random.default_rng(i)
                h = t(_hashes(rng, n, ties).astype(np.int64))
                v = t(_valid(rng, n, vmode))
                for tile in (256, 1024):
                    pid, hist = rp.partition(h, v, n_parts=n_parts,
                                             tile_n=tile)
                    hp, vp, _ = rp._pad_invalid(h, v, tile)
                    pid_r, hist_r = radix_partition_ref(
                        hp, vp, n_parts=n_parts, tile_n=tile)
                    check(torch.equal(pid, pid_r[:n])
                          and torch.equal(hist, hist_r),
                          f"radix_partition differs at n={n} P={n_parts}"
                          f" {ties}/{vmode} tile={tile}")
                    n_cases += 1
                for bucket in (1, n // n_parts + 2):
                    slot, ovf = rp.scatter_slots(h, v, n_parts=n_parts,
                                                 bucket=bucket)
                    s_r, o_r = partition_scatter_ref(
                        h, v, n_parts=n_parts, bucket=bucket)
                    check(torch.equal(slot, s_r) and int(ovf) == int(o_r),
                          f"partition_scatter differs at n={n} "
                          f"P={n_parts} {ties}/{vmode} bucket={bucket}")
                    n_cases += 1
    rng = np.random.default_rng(9)
    h = t(_hashes(rng, 8 * 4099, "few").astype(np.int64).reshape(8, 4099))
    v = t(_valid(rng, 8 * 4099, "mixed").reshape(8, 4099))
    slot, ovf = rp.scatter_slots(h, v, n_parts=8, bucket=300)
    s_r, o_r = partition_scatter_ref(h, v, n_parts=8, bucket=300)
    check(torch.equal(slot, s_r) and torch.equal(ovf, o_r),
          "partition_scatter differs on 8 segments")
    n_cases += 1
    for case in rp_bench.edge_cases(dev):
        bad = rp_bench.check_case(case)
        check(bad is None, f"{bad} differs from plain on {case['label']}")
        n_cases += 1
    torch.cuda.synchronize()
    return n_cases


def main_shape_measurements(dev, pv, users):
    """Each kernel at the main path's shapes: correctness against the
    plain version, then kernel / plain / library times and the bound."""
    import torch
    from repro_torch.dataflow.table import hash_columns, key_hash
    from repro_torch.kernels.filter_project import ops as fp
    from repro_torch.kernels.hash_join import ops as hj
    from repro_torch.kernels.segment_reduce import ops as sr

    n = pv.capacity
    out = []

    # JOIN probe: L3/L5's probe of page_views.user into users.name
    left = key_hash(pv, ["user"])
    right = torch.sort(key_hash(users, ["name"])).values
    got = hj.probe(left, right)
    want = hj.join_probe_ref(left, right)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"probe differs from plain at main shape (err {err})")
    # the function's bytes: a 4-byte key in and a 4-byte position out
    # per probe, 4 bytes per build key (uint32 lanes, as on the TPU).
    # The port carries hashes in int64, so the kernel reads 12 B per
    # probe and 8 B per build key: that figure is carrier_bound_ms.
    r = right.shape[0]
    rounds = max(1, r.bit_length())
    bits = hj.probe_bits(r)
    b, by = bound_ms(8 * n + 4 * r, n * rounds)
    carrier_b, _ = bound_ms(12 * n + 8 * r, n * rounds)
    out.append(dict(
        name="join_probe", route="cuda",
        source="src/repro_torch/csrc/join_probe.cu",
        replaces="src/repro/kernels/hash_join/hash_join.py:51",
        max_abs_err=float(err),
        ms=cuda_ms(lambda: hj.probe(left, right)),
        plain_ms=cuda_ms(lambda: hj.join_probe_ref(left, right)),
        library_ms=cuda_ms(lambda: torch.searchsorted(right, left)),
        bound_ms=b, bound_by=by, carrier_bound_ms=carrier_b,
        directory_bits=bits,
        shape=f"N={n} probes (int64 lanes), R={r} sorted build keys, "
              f"a directory of 2**{bits} buckets"))

    # segment sum: L3's GROUPBY of the joined rows by user — the count
    # lane and the revenue lane in one (N, 2) call; ids from the
    # engine's own sort of the hashes, dense, sorted
    h = hash_columns(pv, ["user"])
    h_sorted, order = torch.sort(h, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = h_sorted[1:] != h_sorted[:-1]
    ids = (torch.cumsum(new.int(), 0, dtype=torch.int32) - 1).contiguous()
    timespent = pv.col("timespent").index_select(0, order).float()
    rev = pv.col("estimated_revenue").index_select(0, order)
    exact_vals = torch.stack([torch.ones_like(timespent), timespent], 1)
    float_vals = torch.stack([torch.ones_like(rev), rev], 1)
    s = n
    got = sr.segment_sum(exact_vals, ids, num_segments=s)
    want = sr.segment_sum_ref(exact_vals, ids, num_segments=s)
    check(torch.equal(got, want),
          "segment_sum differs from plain on integer-valued lanes")
    got = sr.segment_sum(float_vals, ids, num_segments=s)
    want = sr.segment_sum_ref(float_vals, ids, num_segments=s)
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    check(rel <= RTOL_FLOAT_AGG, f"segment_sum float lane rel err {rel}")
    d = float_vals.shape[1]
    b, by = bound_ms(4 * n + 4 * n * d + 4 * s * d, n * d)
    lib_out = torch.zeros(s, d, device=dev)

    def library():
        lib_out.zero_()
        lib_out.index_add_(0, ids, float_vals)
    out.append(dict(
        name="segment_sum", route="cuda",
        source="src/repro_torch/csrc/segment_sum.cu",
        replaces="src/repro/kernels/segment_reduce/segment_reduce.py:52",
        max_abs_err=err,
        ms=cuda_ms(lambda: sr.segment_sum(float_vals, ids,
                                          num_segments=s)),
        plain_ms=cuda_ms(lambda: sr.segment_sum_ref(float_vals, ids,
                                                    num_segments=s)),
        library_ms=cuda_ms(library),
        bound_ms=b, bound_by=by, tile=sr.library().restore_segment_sum_tile(),
        shape=f"N={n} rows x D={d} f32 lanes over {int(ids[-1]) + 1} "
              f"distinct ids, output ({s}, {d})"))

    # compaction: the store's write path on the 20-byte user column under
    # a selective mask (FILTER estimated_revenue > 50, about half)
    col = pv.col("user")
    mask = pv.col("estimated_revenue") > 50.0
    got, tot = fp.compact(col, mask)
    want, wtot = fp.filter_compact_ref(col, mask)
    check(int(tot) == int(wtot), "compact count differs from plain")
    err = int((got.int() - want.int()).abs().max())
    check(err == 0, "compact differs from plain at main shape")
    w = col.shape[1]
    b, by = bound_ms((2 * w + 1) * n, 0)
    out.append(dict(
        name="filter_compact", route="cuda",
        source="src/repro_torch/csrc/filter_compact.cu",
        replaces="src/repro/kernels/filter_project/filter_project.py:47",
        max_abs_err=float(err),
        ms=cuda_ms(lambda: fp.compact(col, mask)),
        plain_ms=cuda_ms(lambda: fp.filter_compact_ref(col, mask)),
        library_ms=cuda_ms(lambda: col[mask]),
        bound_ms=b, bound_by=by,
        shape=f"N={n} rows x {w} bytes, {int(tot)} survivors"))
    out += radix_measurements(dev, pv)
    return out


def radix_measurements(dev, pv):
    """The radix kernels at the mesh exchange's shape: the page_views
    side of the probe's join, 2**log2_rows rows routed on ``user`` over
    8 shards at skew 4 (one segment of rows / 8 per shard)."""
    import torch
    from repro_torch.dataflow.table import key_hash, partition_finalize
    from repro_torch.kernels.radix_partition import ops as rp
    from repro_torch.kernels.radix_partition.ref import (
        partition_scatter_ref, radix_partition_ref)

    n = pv.capacity
    p_ = N_SHARDS
    cap_loc = n // p_
    bucket = int(cap_loc * MESH_SKEW / p_)
    lanes = partition_finalize(key_hash(pv, ["user"]))
    h2, v2 = lanes.reshape(p_, cap_loc), pv.valid.reshape(p_, cap_loc)
    out = []

    slot, ovf = rp.scatter_slots(h2, v2, n_parts=p_, bucket=bucket)
    s_r, o_r = partition_scatter_ref(h2, v2, n_parts=p_, bucket=bucket)
    err = int((slot.long() - s_r.long()).abs().max())
    check(err == 0 and torch.equal(ovf, o_r),
          f"partition_scatter differs from plain at main shape ({err})")
    pid = lanes & (p_ - 1)
    # the function's bytes at the reference's widths: a 4-byte hash and
    # a valid byte in, a 4-byte slot out; the int64 carrier reads 8
    b, by = bound_ms(9 * n, 0)
    carrier_b, _ = bound_ms(13 * n, 0)
    out.append(dict(
        name="partition_scatter", route="cuda",
        source="src/repro_torch/csrc/radix_partition.cu",
        replaces="src/repro/kernels/radix_partition/radix_partition.py:112",
        max_abs_err=float(err),
        ms=cuda_ms(lambda: rp.scatter_slots(h2, v2, n_parts=p_,
                                            bucket=bucket)),
        plain_ms=cuda_ms(lambda: partition_scatter_ref(
            h2, v2, n_parts=p_, bucket=bucket), iters=3),
        library_ms=cuda_ms(lambda: torch.sort(pid.reshape(p_, cap_loc),
                                              stable=True)),
        bound_ms=b, bound_by=by, carrier_bound_ms=carrier_b,
        shape=f"{p_} shards x {cap_loc} rows (int64 lanes), P={p_}, "
              f"bucket={bucket}, overflow {int(ovf.sum())}"))

    tile = 256
    got_pid, hist = rp.partition(lanes, pv.valid, n_parts=p_, tile_n=tile)
    want_pid, want_hist = radix_partition_ref(lanes, pv.valid, n_parts=p_,
                                              tile_n=tile)
    check(got_pid.shape == want_pid.shape and hist.shape == want_hist.shape,
          "radix_partition's shapes differ from plain at main shape")
    err = max(int((got_pid.long() - want_pid.long()).abs().max()),
              int((hist.long() - want_hist.long()).abs().max()))
    check(err == 0, f"radix_partition differs from plain at main shape "
                    f"({err})")
    n_tiles = n // tile
    b, by = bound_ms(9 * n + 4 * n_tiles * p_, 0)
    carrier_b, _ = bound_ms(13 * n + 4 * n_tiles * p_, 0)
    binned = (torch.arange(n, device=dev) // tile) * (p_ + 1) + \
        torch.where(pv.valid, pid, torch.full_like(pid, p_))
    out.append(dict(
        name="radix_partition", route="cuda",
        source="src/repro_torch/csrc/radix_partition.cu",
        replaces="src/repro/kernels/radix_partition/radix_partition.py:48",
        max_abs_err=float(err),
        ms=cuda_ms(lambda: rp.partition(lanes, pv.valid, n_parts=p_,
                                        tile_n=tile)),
        plain_ms=cuda_ms(lambda: radix_partition_ref(
            lanes, pv.valid, n_parts=p_, tile_n=tile), iters=3),
        library_ms=cuda_ms(lambda: torch.bincount(
            binned, minlength=n_tiles * (p_ + 1))),
        bound_ms=b, bound_by=by, carrier_bound_ms=carrier_b,
        shape=f"N={n} rows (int64 lanes), P={p_}, tile_n={tile}"))
    return out


# ------------------------------------------------ phase 2: main path


def _uid(strings: np.ndarray) -> np.ndarray:
    """b"user<digits>" (or b"term<digits>") rows -> the integer id."""
    digits = strings[:, 4:12].astype(np.int64)
    val = np.zeros(len(strings), np.int64)
    for j in range(digits.shape[1]):
        live = digits[:, j] != 0
        val = np.where(live, val * 10 + digits[:, j] - 48, val)
    return val


class Oracle:
    """Numpy answers of every PigMix query, computed from the page_views
    generator's own draws (same seed, same order) — independent of the
    engine under test."""

    def __init__(self, n_rows, seed, n_users, users_phone, users_zip):
        rng = np.random.default_rng(seed)
        self.u = rng.integers(0, n_users, n_rows)
        self.action = rng.integers(1, 3, n_rows)
        self.ts = rng.integers(0, 100, n_rows)
        self.term = rng.integers(0, 50, n_rows)
        self.hour = rng.integers(0, 24, n_rows)
        self.rev = rng.uniform(0, 100, n_rows).astype(np.float32)
        self.n_users = n_users
        self.power = np.arange(0, 200, 4)
        self.users_phone, self.users_zip = users_phone, users_zip

    def _per_user(self, w):
        return np.bincount(self.u, weights=w, minlength=self.n_users)

    def check(self, q, res):
        (t,) = res.values()
        d = t.to_numpy()
        close = dict(rtol=RTOL_FLOAT_AGG, atol=1e-3)
        if q == "L2":
            sel = np.isin(self.u, self.power)
            check(len(d["user"]) == int(sel.sum()), "L2 row count")
            check(np.array_equal(_uid(d["user"]), _uid(d["name"])),
                  "L2 join keys")
            check(np.isclose(d["estimated_revenue"].astype(np.float64).sum(),
                             self.rev[sel].astype(np.float64).sum(),
                             rtol=1e-9), "L2 revenue")
        elif q in ("L3", "L3F"):
            uid = _uid(d["user"])
            tot = self._per_user(self.rev.astype(np.float64))
            cnt = np.bincount(self.u, minlength=self.n_users)
            check(len(uid) == int((cnt > 0).sum()), f"{q} group count")
            if q == "L3":
                check(np.allclose(d["total"], tot[uid], **close),
                      "L3 totals")
            else:
                check(np.allclose(d["avg_rev"], tot[uid] / cnt[uid],
                                  **close), "L3F averages")
        elif q == "L4":
            uid = _uid(d["user"])
            pairs = np.unique(self.u * 3 + self.action)
            n_act = np.bincount(pairs // 3, minlength=self.n_users)
            check(np.array_equal(d["n_actions"], n_act[uid]), "L4 counts")
        elif q == "L5":
            check(len(d["user"]) == len(self.u), "L5 row count")
            uid = _uid(d["user"])
            check(np.array_equal(uid, _uid(d["name"])), "L5 join keys")
            check(np.array_equal(d["phone"], self.users_phone[uid]) and
                  np.array_equal(d["zip"], self.users_zip[uid]),
                  "L5 build-side payload")
            check(int(d["timespent"].astype(np.int64).sum())
                  == int(self.ts.sum()), "L5 timespent")
        elif q == "L6":
            key = _uid(d["user"]) * 50 + _uid(d["query_term"])
            want = np.bincount(self.u * 50 + self.term, weights=self.ts,
                               minlength=self.n_users * 50)
            check(len(key) == int((np.bincount(
                self.u * 50 + self.term, minlength=self.n_users * 50)
                > 0).sum()), "L6 group count")
            check(np.array_equal(d["total_time"], want[key]), "L6 totals")
        elif q == "L7":
            uid = _uid(d["user"])
            m = self._per_user(np.where(self.hour < 12, self.ts, 0))
            a = self._per_user(np.where(self.hour >= 12, self.ts, 0))
            check(np.array_equal(d["m"], m[uid]) and
                  np.array_equal(d["a"], a[uid]), "L7 sums")
        elif q == "L8":
            check(len(d["all"]) == 1 and int(d["all"][0]) == 1, "L8 group")
            check(np.isclose(d["t"][0], self.ts.sum(), rtol=RTOL_FLOAT_AGG),
                  "L8 t")
            check(np.isclose(d["r"][0], self.rev.astype(np.float64).mean(),
                             rtol=RTOL_FLOAT_AGG), "L8 r")
        elif q == "L11":
            want = np.union1d(np.unique(self.u), self.power)
            got = np.sort(_uid(d["user"]))
            check(np.array_equal(got, want), "L11 distinct users")
        else:
            raise SmokeFailure(f"no oracle for {q}")


APPROX = {"L3": {"total"}, "L3F": {"avg_rev"}, "L8": {"t", "r"}}


def same_rows(q, a_res, b_res, what):
    """The rows of two arms, in order: exact except the float
    aggregates of APPROX, which must agree within RTOL_FLOAT_AGG."""
    check(sorted(a_res) == sorted(b_res), f"{q} {what}: outputs differ")
    for k in a_res:
        a, b = a_res[k].to_numpy(), b_res[k].to_numpy()
        check(sorted(a) == sorted(b), f"{q} {what}: columns differ")
        for c in a:
            check(a[c].shape == b[c].shape, f"{q} {what}: {c} shape")
            if c in APPROX.get(q, ()):
                check(np.allclose(a[c], b[c], rtol=RTOL_FLOAT_AGG,
                                  atol=1e-3), f"{q} {what}: {c} values")
            else:
                check(np.array_equal(a[c], b[c]), f"{q} {what}: {c} values")


def run_query(plan_fn, catalog, dev, keep):
    """plain -> store -> reuse, as benchmarks/common.py::measure_query."""
    from repro_torch.core.repository import Repository
    from repro_torch.core.restore import ReStore
    from repro_torch.dataflow.compiler import compile_workflow
    from repro_torch.store.artifacts import ArtifactStore

    def fresh(heuristic, rewrite):
        store = ArtifactStore(root=tempfile.mkdtemp(prefix="smoke_",
                                                    dir=keep), device=dev)
        return ReStore(catalog, store, Repository(), heuristic=heuristic,
                       rewrite_enabled=rewrite, measure_exec=True,
                       repeats=1, device=dev)

    # the catalog's sources live in the catalog; the stores hold only
    # artifacts (the engine reads a dataset from the store when it has it)
    rs0 = fresh("off", False)
    plain, rep0 = rs0.run(plan_fn())
    rs0.store.close()
    shutil.rmtree(rs0.store.root, ignore_errors=True)

    rs1 = fresh("aggressive", False)
    stored, rep1 = rs1.run(plan_fn())
    n_art = len(rs1.store.names())
    wf = compile_workflow(plan_fn())
    finals = set(wf.final_outputs.values())
    for name in finals:
        rs1.store.delete(name)
    rs1.repo._replace([e for e in rs1.repo.entries
                       if e.artifact not in finals], [], None)
    rs2 = ReStore(catalog, rs1.store, rs1.repo, heuristic="off",
                  rewrite_enabled=True, measure_exec=True, repeats=1,
                  device=dev)
    reused, rep2 = rs2.run(plan_fn())
    rs1.store.close()
    shutil.rmtree(rs1.store.root, ignore_errors=True)
    return dict(plain=plain, store=stored, reuse=reused,
                t_plain=rep0.total_wall_s, t_store=rep1.total_wall_s,
                t_reuse=rep2.total_wall_s, n_reused=rep2.n_reused,
                n_jobs=len(wf.jobs), artifacts=n_art)


def small_agreement(dev):
    """Every query's plain arm at 4096 rows on the card equals the same
    run on the CPU, where the kernels' plain versions run."""
    from repro_torch.core.restore import ReStore
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.workloads import pigmix

    out = {}
    for d in (dev, "cpu"):
        store = ArtifactStore(device=d)
        cat = Catalog(store, device=d)
        pigmix.register_all(cat, n_rows=4096)
        rs = ReStore(cat, store, heuristic="off", rewrite_enabled=False,
                     device=d)
        out[str(d)] = {q: rs.run(f())[0] for q, f in pigmix.QUERIES.items()}
    for q in pigmix.QUERIES:
        same_rows(q, out[str(dev)][q], out["cpu"][q], "card vs cpu")
    return len(pigmix.QUERIES)


def profiled(run, share_of=()):
    """Wall clock, device-busy time and the device activities (kernels
    and copies) that take most of it, for one call of ``run`` under
    torch.profiler; with ``share_of``, the activities whose names contain
    one of those strings are appended with their summed time (ms)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only: a CPU op also reports the device time of
    # the kernels it launched, which would count them twice
    kern = [e for e in prof.key_averages() if dev_us(e) > 0
            and "CUDA" in str(getattr(e, "device_type", ""))]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    top = sorted(kern, key=dev_us, reverse=True)[:8]
    top = [(e.key, dev_us(e) / 1e3, e.count) for e in top]
    if not share_of:
        return wall_ms, busy_ms, top
    share = sum(dev_us(e) for e in kern
                if any(m in e.key for m in share_of)) / 1e3
    return wall_ms, busy_ms, top, share


def profile_plain_arm(plan_fn, catalog, dev, keep):
    """Where the time goes in one query's plain arm (disk-rooted store,
    as in phase 2, after a warm run), flush to disk included."""
    import torch
    from repro_torch.core.repository import Repository
    from repro_torch.core.restore import ReStore
    from repro_torch.store.artifacts import ArtifactStore

    def once():
        store = ArtifactStore(root=tempfile.mkdtemp(prefix="prof_",
                                                    dir=keep), device=dev)
        rs = ReStore(catalog, store, Repository(), heuristic="off",
                     rewrite_enabled=False, device=dev)
        rs.run(plan_fn())
        torch.cuda.synchronize()
        store.close()
        shutil.rmtree(store.root, ignore_errors=True)

    once()
    return profiled(once)


# ------------------------------------------------ phase 4: the mesh path

A_SEED = {"total": ("sum", "estimated_revenue")}
A_PROBE = {"total": ("sum", "estimated_revenue"),
           "n": ("count", "estimated_revenue"),
           "mx": ("max", "estimated_revenue")}


def probe_plan(aggs):
    """distributed_bench.py's probe: join(project(page_views),
    project(users)) -> group by user."""
    from repro_torch.core import plan as P
    pv = P.project(P.load("page_views"), ["user", "estimated_revenue"])
    u = P.project(P.load("users"), ["name"])
    j = P.join(pv, u, ["user"], ["name"])
    g = P.groupby(j, ["user"], aggs)
    return P.PhysicalPlan([P.store(g, "dist_out")])


def probe_rows(res):
    """The probe's groups, ordered by user."""
    d = res["dist_out"].to_numpy()
    order = np.lexsort(d["user"].T[::-1])
    return {c: d[c][order] for c in d}


def same_groups(want, got, what):
    """Counts, maxima and keys exact; revenue sums within
    RTOL_FLOAT_AGG (the shards add in another order than one device)."""
    check(sorted(want) == sorted(got), f"{what}: columns differ")
    check(len(want["user"]) == len(got["user"]),
          f"{what}: {len(got['user'])} groups, want {len(want['user'])}")
    for c in want:
        if c == "total":
            check(np.allclose(got[c], want[c], rtol=RTOL_FLOAT_AGG,
                              atol=1e-3), f"{what}: {c} values")
        else:
            check(np.array_equal(got[c], want[c]), f"{what}: {c} values")


class ProbeOracle:
    """Numpy answers of the probe (sum, count and max of revenue per
    user), computed from the page_views generator's own draws —
    independent of the engine under test.

    ``colliding`` are the user ids whose name shares its seed-0 key hash
    with another name (``table.hash_column``'s string fold, ROADMAP queue
    3).  The sort-based group-by interleaves those keys' rows and
    returns each such user in more than one group; any other split, and
    any row missing or counted twice, fails."""

    def __init__(self, n_rows, seed, n_users, colliding):
        o = Oracle(n_rows, seed, n_users, None, None)
        self.n = np.bincount(o.u, minlength=n_users)
        self.users = np.nonzero(self.n)[0]
        self.total = o._per_user(o.rev.astype(np.float64))
        self.mx = np.full(n_users, -np.inf, np.float32)
        np.maximum.at(self.mx, o.u, o.rev)
        self.colliding = np.asarray(colliding)

    def check(self, got, what):
        uid = _uid(got["user"])
        users, inv, mult = np.unique(uid, return_inverse=True,
                                     return_counts=True)
        split = users[mult > 1]
        check(np.isin(split, self.colliding).all(),
              f"{what}: {int((~np.isin(split, self.colliding)).sum())} "
              f"users split into several groups whose key hash is unique")
        check(np.array_equal(users, self.users),
              f"{what}: {len(users)} users, want {len(self.users)}")
        n = np.bincount(inv, weights=got["n"].astype(np.float64))
        check(np.array_equal(n, self.n[users]), f"{what}: counts")
        total = np.bincount(inv, weights=got["total"].astype(np.float64))
        check(np.allclose(total, self.total[users], rtol=RTOL_FLOAT_AGG,
                          atol=1e-3), f"{what}: revenue sums")
        mx = np.full(len(users), -np.inf, np.float32)
        np.maximum.at(mx, inv, got["mx"].astype(np.float32))
        check(np.array_equal(mx, self.mx[users]), f"{what}: maxima")
        return len(uid) - len(users)


def mesh_arms(dev, n_rows, seed, keep, card, counters):
    """The four arms of distributed_bench.py on LocalMesh(8).  The
    sources are held in the catalog on the card, as in phase 2; the
    stores are disk-rooted with the default device cache, so artifacts
    take the write path.  Each job is warmed once off the clock and
    timed once (``measure_exec``, repeats=1).

    The launch counters are zeroed after the single-device arm and read
    right after the three mesh arms (warm runs and flushes included),
    before the profiled run."""
    import torch
    from repro_torch.core.restore import ReStore
    from repro_torch.dataflow.table import key_hash
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.workloads import pigmix

    n_users = n_rows // 8
    t0 = time.perf_counter()
    pv = pigmix.gen_page_views(n_rows, seed, n_users=n_users, device=dev)
    users = pigmix.gen_users(n_users=n_users, device=dev)
    log(f"phase 4: page_views {n_rows} rows, users {n_users}; generated "
        f"in {time.perf_counter() - t0:.1f} s")
    catalog = Catalog(ArtifactStore(device=dev), device=dev)
    catalog.register("page_views", pv)
    catalog.register("users", users)
    mesh = LocalMesh(N_SHARDS, device=dev)
    # the user names whose seed-0 key hash another name already has
    h1 = key_hash(users, ["name"]).cpu().numpy()
    _, h_inv, h_mult = np.unique(h1, return_inverse=True,
                                 return_counts=True)
    names = _uid(users.col("name").cpu().numpy())
    oracle = ProbeOracle(n_rows, seed, n_users, names[h_mult[h_inv] > 1])

    def fresh(**kw):
        store = ArtifactStore(root=tempfile.mkdtemp(prefix="mesh_",
                                                    dir=keep), device=dev)
        return ReStore(catalog, store, measure_exec=True, repeats=1,
                       device=dev, **kw)

    def close(rs):
        rs.store.close()
        shutil.rmtree(rs.store.root, ignore_errors=True)

    def stats(rep):
        return [j.stats for j in rep.jobs if j.stats]

    def snap():
        return {k: c.count for k, c in counters.items()}

    arms, info, split = {}, {}, {}
    rs = fresh(heuristic="off", rewrite_enabled=False, semantic=False)
    res, rep = rs.run(probe_plan(A_PROBE))
    single = probe_rows(res)
    split["t_single"] = oracle.check(single, "t_single vs oracle")
    arms["t_single"] = rep.total_wall_s
    close(rs)

    # ---- the mesh path's own runs: counted from here
    for c in counters.values():
        c.reset()
    rs = fresh(heuristic="off", rewrite_enabled=False, semantic=False,
               mesh=mesh, skew_factor=MESH_SKEW)
    res, rep = rs.run(probe_plan(A_PROBE))
    got = probe_rows(res)
    split["t_mesh_plain"] = oracle.check(got, "t_mesh_plain vs oracle")
    same_groups(single, got, "t_mesh_plain vs single")
    arms["t_mesh_plain"] = rep.total_wall_s
    info["t_mesh_plain"] = stats(rep)
    close(rs)

    timed_scatter = {}
    for aware, arm in ((False, "t_reuse_blind"), (True, "t_reuse_copart")):
        rs = fresh(heuristic="aggressive", mesh=mesh,
                   skew_factor=MESH_SKEW, partition_aware=aware)
        rs.run(probe_plan(A_SEED))          # warm: stores the join artifact
        before = snap()["partition_scatter"]
        res, rep = rs.run(probe_plan(A_PROBE))
        timed_scatter[arm] = snap()["partition_scatter"] - before
        got = probe_rows(res)
        split[arm] = oracle.check(got, f"{arm} vs oracle")
        same_groups(single, got, f"{arm} vs single")
        check(rep.n_reused > 0, f"{arm}: reused nothing")
        if aware:
            skipped = sum(st.shuffles_skipped for st in stats(rep))
            check(skipped > 0, f"{arm}: no exchange was skipped")
        else:
            # the blind engine records no partitioning, so the exchange
            # it runs shows only in the launch counter
            check(timed_scatter[arm] > 0,
                  f"{arm}: its timed run launched no exchange")
        arms[arm] = rep.total_wall_s
        info[arm] = stats(rep)
        close(rs)
    launches = snap()
    # (S, N, P, bucket) of each partition_scatter launch, with its count
    scatter_shapes = sorted(
        list(k) + [c] for k, c in counters["partition_scatter"].shapes.items())
    # ---- counted to here

    def mesh_plain_once():
        rs = fresh(heuristic="off", rewrite_enabled=False, semantic=False,
                   mesh=mesh, skew_factor=MESH_SKEW)
        rs.run(probe_plan(A_PROBE))
        torch.cuda.synchronize()
        close(rs)

    # where the time goes: one more t_mesh_plain run (already warm) and
    # its flush, under the profiler
    wall_ms, busy_ms, top = profiled(mesh_plain_once)
    log(f"phase 4: t_mesh_plain run + flush under torch.profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%) [{card}]")
    for name, ms, count in top:
        log(f"phase 4:   {ms:9.3f} ms  x{count:<5} {name[:90]}")
    out = dict(arms)
    out["launches"] = launches
    out["timed_partition_scatter"] = timed_scatter
    out["partition_scatter_shapes"] = scatter_shapes
    out["profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms)
    out["groups"] = len(single["user"])
    out["users_present"] = int(oracle.users.size)
    out["h1_colliding_names"] = int(oracle.colliding.size)
    out["extra_groups"] = split
    # (exchanges, skipped, rows overflowed, lossless retries) per job
    out["shuffles"] = {a: [(x.shuffles, x.shuffles_skipped,
                            x.shuffle_overflow, x.shuffle_retries)
                           for x in st] for a, st in info.items()}
    out["retries"] = sum(x.shuffle_retries for st in info.values()
                         for x in st)
    out["job_walls"] = {a: [x.wall_s for x in st] for a, st in info.items()}
    return out


def skewed_retry(dev, card):
    """One hot user at skew 1.25: the join's bucket overflows, the engine
    reruns the job losslessly once, and the groups equal one device's."""
    import torch
    from repro_torch.core.restore import ReStore
    from repro_torch.dataflow.table import encode_strings
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.workloads import pigmix

    n_rows, n_users = 1 << 16, 1 << 13
    pv = pigmix.gen_page_views(n_rows, 5, n_users=n_users, device=dev)
    hot = torch.from_numpy(np.random.default_rng(5).random(n_rows) < 0.6)
    user = pv.col("user").clone()
    user[hot.to(dev)] = torch.from_numpy(
        encode_strings(["user0007"])[0]).to(dev)
    pv.columns["user"] = user
    users = pigmix.gen_users(n_users=n_users, device=dev)

    def run(**kw):
        store = ArtifactStore(device=dev)
        cat = Catalog(store, device=dev)
        cat.register("page_views", pv)
        cat.register("users", users)
        rs = ReStore(cat, store, heuristic="off", rewrite_enabled=False,
                     semantic=False, device=dev, **kw)
        return rs.run(probe_plan(A_PROBE))

    want, _ = run()
    got, rep = run(mesh=LocalMesh(N_SHARDS, device=dev), skew_factor=1.25)
    same_groups(probe_rows(want), probe_rows(got), "skewed mesh vs single")
    st = [j.stats for j in rep.jobs if j.stats]
    retries = sum(x.shuffle_retries for x in st)
    overflow = sum(x.shuffle_overflow for x in st)
    check(overflow > 0, "skewed case: no bucket overflowed")
    check(retries == 1, f"skewed case: {retries} lossless retries, want 1")
    return dict(rows=n_rows, hot_share=0.6, shuffle_overflow=overflow,
                shuffle_retries=retries)


# ------------------------------------------------ phase 5: serving

SERVE_ARCH = "qwen3-1.7b"
# benchmarks/prefix_reuse_bench.py's defaults
PREFIX_LEN, SUFFIX_LEN, N_DECODE = 1024, 16, 2
N_REQUESTS, N_PROMPTS, ZIPF_A, EVERY_K = 48, 8, 1.1, 64
BATCH_REQUESTS, BATCH_SLOTS, BATCH_NEW = 8, 4, 16
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
FA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # the reference's tests'
# At the serving shapes, also the error over the output row's RMS: the
# worst measured on an H100 is 0.029 (the prefill's first rows, which
# see few keys); a decode that lost its last partial key tile would read
# about 0.2 there, while its absolute error stays under FA_TOL.
FA_REL_TOL = 0.06
# Logits of the bf16 model are themselves bf16 (the unembedding's output
# type), ulp 2**-6 at |logit| in [2, 4): the serve-path comparisons
# allow 8 such ulps.  A greedy token may differ only where the cold
# run's top-2 margin is within the same tolerance.
LOGIT_ATOL_BF16 = 0.125
LOGIT_ATOL_F32 = 1e-4            # card vs CPU, f32 smoke config


def _recording(model):
    """The model, recording the last row of every prefill's and decode
    step's logits (f32, on its device), counting the calls, and timing
    each call on the host clock without a sync (the time to enqueue it:
    where it nears a call's wall time, the host, not the card, sets the
    pace)."""
    from repro_torch.models.api import Model

    class Recording(Model):
        def _call(self, kind, fn, *args):
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            self.host_s[kind].append(time.perf_counter() - t0)
            self.log.append(logits[:, -1].float())
            self.calls += 1
            return logits, cache

        def prefill(self, params, batch, cache, start=None):
            return self._call("prefill", super().prefill, params, batch,
                              cache, start)

        def decode_step(self, params, batch, cache, index):
            return self._call("decode", super().decode_step, params,
                              batch, cache, index)

    m = Recording(model.cfg, model.device)
    m.log, m.calls = [], 0
    m.host_s = {"prefill": [], "decode": []}
    return m


class Agreement:
    """Teacher-forced logits of a run held against a cold run: each step
    compared while the greedy tokens so far agree; a differing token is
    a failure unless the cold step's top-2 margin is within the
    tolerance, and the request's later steps are then not compared."""

    def __init__(self, atol):
        self.atol = atol
        self.max_err = 0.0
        self.steps = self.exact_steps = 0
        self.tokens = self.equal_tokens = 0
        self.allowed_flips = 0

    def add(self, cold, warm, what):
        import torch
        for t, (c, w) in enumerate(zip(cold, warm)):
            err = float((c - w).abs().max())
            self.max_err = max(self.max_err, err)
            self.steps += 1
            self.exact_steps += int(err == 0.0)
            check(err <= self.atol, f"{what}: step {t} logits differ by "
                                    f"{err} > {self.atol}")
            self.tokens += 1
            if int(torch.argmax(c)) == int(torch.argmax(w)):
                self.equal_tokens += 1
                continue
            top2 = torch.topk(c.reshape(-1), 2).values
            margin = float(top2[0] - top2[1])
            check(margin <= self.atol, f"{what}: greedy token {t} differs "
                                       f"with a cold margin {margin}")
            self.allowed_flips += 1
            return

    def add_tokens(self, cold_logits, cold_toks, toks, what):
        """Tokens only (the batched path): equal up to a first
        difference, which the cold step's margin must allow."""
        import torch
        for t, (a, b) in enumerate(zip(cold_toks, toks)):
            self.tokens += 1
            if a == b:
                self.equal_tokens += 1
                continue
            top2 = torch.topk(cold_logits[t].reshape(-1), 2).values
            margin = float(top2[0] - top2[1])
            check(margin <= self.atol, f"{what}: token {t} differs with a "
                                       f"cold margin {margin}")
            self.allowed_flips += 1
            return

    def summary(self):
        return dict(max_abs_logit_err=self.max_err, atol=self.atol,
                    steps_compared=self.steps,
                    steps_bit_equal=self.exact_steps,
                    tokens_equal=self.equal_tokens, tokens=self.tokens,
                    flips_within_margin=self.allowed_flips)


def _flash_bound(b, hq, hkv, sq, d, kv_len, q_off, causal, elt):
    """Least time for the function on this run's data: FLOPs (4 D per
    visible (query, key) pair) at the bf16 tensor-core peak, and bytes
    (q and o once, the keys and values each row needs once)."""
    visible = 0
    for kl, qo in zip(kv_len, q_off):
        rows = np.arange(sq) + qo
        vis = np.minimum(kl, rows + 1) if causal else np.full(sq, kl)
        visible += int(np.clip(vis, 0, None).sum())
    flops = 4 * hq * visible * d
    nbytes = elt * (2 * b * hq * sq * d + 2 * hkv * d * int(sum(kv_len)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_checks(dev):
    """The kernel against its plain version on the card: check_mha's
    ragged shapes, test_flash_attention_sweep's, kv_len decode, per-row
    kv_len and q_offset, GQA, kv_len = 1; f32 and bf16.  Then batch
    invariance: a row's bits equal in a 1040-row prefill, a 16-row
    suffix and a decode step."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref

    def qkv(seed, b, hq, hkv, sq, skv, d, dt):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(s, generator=g, device=dev).to(dt)
                for s in ((b, hq, sq, d), (b, hkv, skv, d),
                          (b, hkv, skv, d))]

    i32 = dict(dtype=torch.int32, device=dev)
    cases = []
    for seed, (sq, skv) in enumerate([(64, 64), (37, 53), (64, 128),
                                      (1, 64)]):
        cases.append(((seed, 1, 2, 2, sq, skv, 16), dict(causal=True)))
    for shp in [(1, 2, 2, 64, 64, 32), (2, 4, 2, 128, 256, 64),
                (1, 8, 1, 64, 128, 128)]:
        for causal in (True, False):
            cases.append(((0,) + shp, dict(causal=causal)))
    for kv_len in (1, 100, 256):
        cases.append(((1, 2, 4, 4, 1, 256, 64),
                      dict(kv_len=kv_len, q_offset=kv_len - 1)))
    cases += [
        ((2, 4, 16, 8, 1, 1042, 128),
         dict(causal=False, q_offset=0,
              kv_len=torch.tensor([1, 1025, 600, 1042], **i32))),
        ((3, 3, 4, 2, 21, 200, 32),
         dict(kv_len=torch.tensor([21, 90, 200], **i32),
              q_offset=torch.tensor([0, 69, 179], **i32))),
        ((4, 1, 16, 8, 1040, 1042, 128), dict(kv_len=1040, q_offset=0)),
        ((5, 1, 16, 8, 16, 1042, 128),
         dict(kv_len=1040, q_offset=torch.tensor([1024], **i32))),
        ((6, 1, 16, 8, 1, 1042, 128), dict(kv_len=1041, q_offset=1040)),
    ]
    # kv_len at the 128-key split boundaries and one off: decode rows
    # (the split form) and causal prefills of 9 and 200 rows (split and
    # fused forms), whose q_offset = kv_len - Sq puts some rows before
    # every key
    bounds = torch.tensor([127, 128, 129, 255, 256, 257], **i32)
    cases.append(((8, 6, 16, 8, 1, 300, 128),
                  dict(causal=False, q_offset=0, kv_len=bounds)))
    for sq in (9, 200):
        cases.append(((9, 6, 16, 8, sq, 300, 128),
                      dict(kv_len=bounds, q_offset=bounds - sq)))
    # rows that see no key (kv_len 0; causal before every key) get the
    # mean of V over all Skv keys, as the plain version: the split form
    # (one query row) and the fused form (many rows, and one split)
    no_key = dict(kv_len=torch.tensor([0, 300], **i32),
                  q_offset=torch.tensor([5, -3], **i32))
    for sq, skv in ((1, 300), (9, 300), (1040, 300), (40, 100)):
        cases.append(((10, 2, 16, 8, sq, skv, 128),
                      dict(no_key, causal=False)))
        cases.append(((10, 2, 16, 8, sq, skv, 128), dict(no_key)))
    n, worst = 0, {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        for args, kw in cases:
            q, k, v = qkv(*args, dt)
            got = fa.mha(q, k, v, **kw)
            want = mha_ref(q, k, v, **kw)
            err = float((got.float() - want.float()).abs().max())
            check(err < FA_TOL[name], f"flash_attention differs from plain "
                                      f"({name}, {args}, {kw}): {err}")
            worst[name] = max(worst.get(name, 0.0), err)
            n += 1
        q, k, v = qkv(7, 1, 16, 8, 1040, 1042, 128, dt)
        full = fa.mha(q, k, v, 1040, q_offset=0)
        suffix = fa.mha(q[:, :, 1024:].contiguous(), k, v, 1040,
                        q_offset=1024)
        last = fa.mha(q[:, :, 1039:].contiguous(), k, v, 1040,
                      q_offset=1039)
        check(torch.equal(full[:, :, 1024:], suffix)
              and torch.equal(full[:, :, 1039:], last),
              f"flash_attention is not batch-invariant ({name})")
    torch.cuda.synchronize()
    return n, worst


def flash_measurements(dev):
    """The bf16 kernel at the serving path's shapes (``bench.SHAPES``:
    qwen3-1.7b's 16 query and 8 KV heads, head_dim 128, bf16, a 1042-slot
    cache): correctness against the plain version, absolute and relative
    to each output row's RMS, then kernel / plain / library device times
    (CUDA-graph replays), their eager times, and the bound.  The library
    call is one scaled_dot_product_attention (a yardstick the port never
    calls).  Then the wrapper's host time per decode call, with kv_len
    and q_offset as Python ints as the model passes them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.bench import (
        D, HKV, HQ, SHAPES, SLOTS, graph_ms, host_us, serving_case)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    g = torch.Generator(device=dev).manual_seed(11)
    out = []
    for label, b, sq, kv_len, q_off, causal in SHAPES:
        q, k, v, kvl, qo, mask = serving_case(dev, g, b, sq, kv_len, q_off,
                                              causal)
        kw = dict(causal=causal, q_offset=qo)
        got = fa.mha(q, k, v, kvl, **kw).float()
        want = mha_ref(q, k, v, kvl, **kw).float()
        err = float((got - want).abs().max())
        rms = want.pow(2).mean(-1).sqrt()
        rel = float(((got - want).abs().amax(-1) / rms).max())
        check(err < FA_TOL["bfloat16"] and rel < FA_REL_TOL,
              f"flash_attention differs from plain at {label}: {err} "
              f"absolute, {rel} of the row's RMS")

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = float((library().float() - want).abs().max())
        bound, by = _flash_bound(b, HQ, HKV, sq, D, kv_len, q_off, causal, 2)
        plan = fa.plan(q.dtype, "cuda", b, HQ, HKV, sq, SLOTS)

        def kernel():
            return fa.mha(q, k, v, kvl, **kw)
        out.append(dict(
            shape=f"{label}: B={b} Hq={HQ} Hkv={HKV} Sq={sq} D={D} bf16, "
                  f"cache {SLOTS}, kv_len {kv_len}, q_offset {q_off}",
            form="split" if plan.scratch else "fused",
            max_abs_err=err, max_err_of_row_rms=rel,
            library_max_abs_err=lib_err,
            ms=graph_ms(kernel),
            plain_ms=graph_ms(lambda: mha_ref(q, k, v, kvl, **kw), iters=5),
            library_ms=graph_ms(library),
            eager_ms=cuda_ms(kernel, iters=20),
            library_eager_ms=cuda_ms(library, iters=20),
            bound_ms=bound, bound_by=by))
    q, k, v, *_ = serving_case(dev, g, 1, 1, [1041], [1040], True)
    us = host_us(lambda: fa.mha(q, k, v, 1041, causal=True, q_offset=1040))
    return out, us


def _stream(cfg, rng):
    """prefix_reuse_bench.py's request stream: zipf choices over
    N_PROMPTS prefixes, each request a prefix plus a fresh suffix."""
    w = 1.0 / np.arange(1, N_PROMPTS + 1) ** ZIPF_A
    prefixes = [rng.integers(1, cfg.vocab_size, PREFIX_LEN)
                for _ in range(N_PROMPTS)]
    ranks = rng.choice(N_PROMPTS, size=N_REQUESTS, p=w / w.sum())
    prompts = [np.concatenate([prefixes[r], rng.integers(
        1, cfg.vocab_size, SUFFIX_LEN)]) for r in ranks]
    return prefixes, ranks, prompts


def serve_arm(model, params, prompts, kv, rng, cfg):
    """prefix_reuse_bench.py's ``run_arm``: two serves off the clock to
    warm both prefill shapes, then the stream, each request timed."""
    import torch
    from repro_torch.serve.session import ServeSession

    max_len = PREFIX_LEN + SUFFIX_LEN + N_DECODE
    sess = ServeSession(model, params, max_len=max_len, kv=kv,
                        every_k=EVERY_K)
    warm_prefix = rng.integers(1, cfg.vocab_size, PREFIX_LEN)
    for _ in range(2):
        sess.serve(np.concatenate(
            [warm_prefix, rng.integers(1, cfg.vocab_size, SUFFIX_LEN)]),
            N_DECODE)
    torch.cuda.synchronize()
    model.log.clear()
    for v in model.host_s.values():
        v.clear()
    stats, laps, logs = [], [], []
    t0 = time.perf_counter()
    for p in prompts:
        t1 = time.perf_counter()
        _, s = sess.serve(p, N_DECODE)
        laps.append(time.perf_counter() - t1)
        stats.append(s)
        logs.append(list(model.log))
        model.log.clear()
    wall = time.perf_counter() - t0
    in_model = sum(sum(v) for v in model.host_s.values())
    host_ms = dict(
        prefill_enqueue_ms=float(np.mean(model.host_s["prefill"]) * 1e3),
        decode_enqueue_ms=float(np.mean(model.host_s["decode"]) * 1e3),
        outside_model_ms=(wall - in_model) / len(prompts) * 1e3)
    return dict(stats=stats, laps=laps, logs=logs, wall=wall,
                host_ms=host_ms)


def serving_phase(dev, card, seed):
    """Phase 5: qwen3-1.7b at its full config (bf16, 28 layers, random
    weights from a seeded generator) through ServeSession.  Returns the
    record and the flash-attention launches of (b)-(d)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.api import build
    from repro_torch.serve.kv_repo import KVRepository
    from repro_torch.serve.kv_store import KVTierStore
    from repro_torch.serve.session import ServeSession
    from repro_torch.tree import tree_leaves

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    base = build(cfg, device=dev)
    params = base.init(seed)
    torch.cuda.synchronize()
    n_params = sum(int(t.numel()) for t in tree_leaves(params))
    log(f"phase 5: {cfg.name} full config ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}): {n_params} parameters made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    model = _recording(base)
    rng = np.random.default_rng(seed)
    prefixes, ranks, prompts = _stream(cfg, rng)
    fa.launches.reset()
    fa.merge_launches.reset()
    model.calls = 0
    rec = {}

    # (b) the prefix_reuse_bench protocol: cold arm, then the reuse arm
    cold = serve_arm(model, params, prompts, None, rng, cfg)
    kv = KVRepository(model_version=cfg.name)
    warm = serve_arm(model, params, prompts, kv, rng, cfg)
    agree = Agreement(LOGIT_ATOL_BF16)
    for i, (c, w) in enumerate(zip(cold["logs"], warm["logs"])):
        agree.add(c, w, f"phase 5 (b) request {i}")
    reused = sum(s.reused_tokens for s in warm["stats"])
    total = sum(s.reused_tokens + s.prefilled_tokens for s in warm["stats"])
    frac = reused / max(total, 1)
    check(frac > 0.5, f"phase 5 (b): reused-token fraction {frac}")
    rec["stream"] = dict(
        requests=N_REQUESTS, prompts=N_PROMPTS, prefix=PREFIX_LEN,
        suffix=SUFFIX_LEN, decode=N_DECODE, zipf=ZIPF_A, every_k=EVERY_K,
        t_noreuse_s=cold["wall"], t_reuse_s=warm["wall"],
        wall_speedup=cold["wall"] / warm["wall"], reused_token_frac=frac,
        p50_noreuse_ms=float(np.percentile(cold["laps"], 50) * 1e3),
        p95_noreuse_ms=float(np.percentile(cold["laps"], 95) * 1e3),
        p50_reuse_ms=float(np.percentile(warm["laps"], 50) * 1e3),
        p95_reuse_ms=float(np.percentile(warm["laps"], 95) * 1e3),
        host_ms_noreuse=cold["host_ms"], host_ms_reuse=warm["host_ms"],
        kv_entries=len(kv), kv_bytes=kv.total_bytes,
        exact_hits=kv.stats()["exact_hits"],
        semantic_hits=kv.stats()["semantic_hits"], **agree.summary())
    log(f"phase 5 (b): {rec['stream']} [{card}]")
    del warm

    # (c) a host-tier round trip: one snapshot per prefix the first
    # eight requests use, demoted to pinned host memory, then those
    # requests served warm from it and held against the cold arm
    store = KVTierStore(host_bytes=4 << 30)
    kv_c = KVRepository(model_version=cfg.name, store=store)
    sess = ServeSession(model, params, max_len=PREFIX_LEN + SUFFIX_LEN
                        + N_DECODE, kv=kv_c, every_k=EVERY_K)
    for r in sorted(set(ranks[:BATCH_REQUESTS].tolist())):
        sess.serve(np.concatenate([prefixes[r], rng.integers(
            1, cfg.vocab_size, SUFFIX_LEN)]), N_DECODE)
    for name in {e.artifact for e in kv_c.repository.entries}:
        check(store.demote_to_host(name), f"demote {name} failed")
        check(store.residency(name) == "host", f"{name} not on the host")
    model.log.clear()
    agree_c = Agreement(LOGIT_ATOL_BF16)
    for i in range(BATCH_REQUESTS):
        _, st = sess.serve(prompts[i], N_DECODE)
        check(st.reused_tokens >= PREFIX_LEN,
              f"phase 5 (c): request {i} reused {st.reused_tokens}")
        agree_c.add(cold["logs"][i], model.log, f"phase 5 (c) request {i}")
        model.log.clear()
    check(store.stats["host_hits"] > 0, "phase 5 (c): no host-tier hit")
    rec["host_round_trip"] = dict(host_hits=store.stats["host_hits"],
                                  **agree_c.summary())
    log(f"phase 5 (c): {rec['host_round_trip']} [{card}]")
    del sess, kv_c, store, kv

    # (d) continuous batching: submit/run with 4 slots against serve()
    max_len = PREFIX_LEN + SUFFIX_LEN + BATCH_NEW + 2
    seq = ServeSession(model, params, max_len=max_len)
    want_toks, want_logs = [], []
    for p in prompts[:BATCH_REQUESTS]:
        o, _ = seq.serve(p, BATCH_NEW)
        want_toks.append(o)
        want_logs.append(list(model.log))
        model.log.clear()
    batched = ServeSession(model, params, n_slots=BATCH_SLOTS,
                           max_len=max_len)
    t1 = time.perf_counter()
    tickets = [batched.submit(p, BATCH_NEW)
               for p in prompts[:BATCH_REQUESTS]]
    batched.run()
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t1
    model.log.clear()
    agree_d = Agreement(LOGIT_ATOL_BF16)
    for i, t in enumerate(tickets):
        got = t.result()
        check(len(got) == BATCH_NEW, f"phase 5 (d): request {i} returned "
                                     f"{len(got)} tokens")
        agree_d.add_tokens(want_logs[i], want_toks[i].tolist(),
                           got.tolist(), f"phase 5 (d) request {i}")
    rec["continuous_batching"] = dict(
        requests=BATCH_REQUESTS, slots=BATCH_SLOTS, new_tokens=BATCH_NEW,
        wall_s=t_batched, **agree_d.summary())
    log(f"phase 5 (d): {rec['continuous_batching']} [{card}]")
    del seq, batched

    # (e) launches on (b)-(d): one per layer per prefill or decode step
    launches, calls = fa.launches.count, model.calls
    merges = fa.merge_launches.count
    model.log.clear()
    rec["model_calls"] = calls
    log(f"phase 5 (e): flash_attention launches {launches} over {calls} "
        f"prefills and decode steps of {cfg.n_layers} layers (of them "
        f"{merges} in the split form, each with a merge launch)")
    check(launches > 0, "flash_attention was never launched on the "
                        "serving path")
    check(launches == cfg.n_layers * calls,
          f"flash_attention launches {launches} != {cfg.n_layers} x "
          f"{calls} model calls")

    # where the time goes: one warm request under torch.profiler
    kv_p = KVRepository(model_version=cfg.name)
    sess = ServeSession(model, params, max_len=PREFIX_LEN + SUFFIX_LEN
                        + N_DECODE, kv=kv_p, every_k=EVERY_K)
    sess.serve(prompts[0], N_DECODE)
    sess.serve(prompts[1], N_DECODE)
    wall_ms, busy_ms, top, fa_ms = profiled(lambda: sess.serve(
        np.concatenate([prompts[0][:PREFIX_LEN], rng.integers(
            1, cfg.vocab_size, SUFFIX_LEN)]), N_DECODE),
        share_of=("fa_sm90_kernel", "fa_merge_kernel",
                  "flash_attention_kernel"))
    rec["warm_request_profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                       flash_ms=fa_ms, top=top)
    log(f"phase 5: one warm request under torch.profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), flash attention {fa_ms:.3f} ms "
        f"of it [{card}]")
    for name, ms, count in top:
        log(f"phase 5:   {ms:9.3f} ms  x{count:<5} {name[:90]}")
    del sess, kv_p, model, params, base
    torch.cuda.empty_cache()
    return rec, launches, merges


def serving_card_vs_cpu(dev, seed):
    """(f) The smoke config (f32) served on the card and on the CPU from
    the same parameters: logits within LOGIT_ATOL_F32, tokens equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.serve.kv_repo import KVRepository
    from repro_torch.serve.session import ServeSession
    from repro_torch.tree import tree_map

    cfg = get_config(SERVE_ARCH, smoke=True)
    cpu = _recording(build(cfg, device="cpu"))
    card = _recording(build(cfg, device=dev))
    p_cpu = cpu.init(seed)
    p_card = tree_map(lambda t: t.to(dev), p_cpu)
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab_size, 48)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab_size, 9)])
               for _ in range(3)]
    runs = {}
    for name, m, p in (("cpu", cpu, p_cpu), ("card", card, p_card)):
        sess = ServeSession(m, p, max_len=80, kv=KVRepository(), every_k=8)
        runs[name] = []
        for x in prompts:
            toks, _ = sess.serve(x, 6)
            runs[name].append((toks, [t.cpu() for t in m.log]))
            m.log.clear()
    err = 0.0
    for (a, la), (b, lb) in zip(runs["cpu"], runs["card"]):
        check((a == b).all(), "phase 5 (f): card and cpu tokens differ")
        for x, y in zip(la, lb):
            err = max(err, float((x - y).abs().max()))
    check(err <= LOGIT_ATOL_F32, f"phase 5 (f): card vs cpu logits {err}")
    return dict(prompts=len(prompts), max_abs_logit_err=err,
                atol=LOGIT_ATOL_F32)


# ---------------------------------------------- phase 6: the service path

STREAM_EVENTS = 24
STREAM_TENANTS = 3
STREAM_APPEND_EVERY = 8
SERVICE_WORKERS = 4
STAMPEDE = 8
FAULT_LOG2_ROWS = 20
FAULT_SEEDS = 8
# tests/test_faults.py's sweep
FAULT_RATES = {"transient": 0.15, "latency": 0.05, "truncate": 0.10,
               "flip": 0.10, "manifest": 0.05}


def _sortable(a):
    if a.ndim == 2:          # a byte-string column: one bytes key a row
        return np.ascontiguousarray(a).view(f"S{a.shape[1]}").ravel()
    return a


def approx_cols(plan, table):
    """The float columns of a plan's output that an aggregate summed (in
    another order on another path): all float columns when the plan
    holds a GROUPBY or COGROUP, none otherwise (copied floats are exact)."""
    if not any(op.kind in ("GROUPBY", "COGROUP") for op in plan.topo()):
        return set()
    return {c for c in table.names if table.col(c).is_floating_point()}


def same_table(a, b, approx, what):
    """The valid rows of two Tables agree: exact, except the columns in
    ``approx`` within RTOL_FLOAT_AGG.  Compared in order on the device
    first (a refreshed value and its recompute usually agree row for
    row), else after a sort on the host.  Returns the largest absolute
    difference of an ``approx`` column."""
    import torch
    check(sorted(a.names) == sorted(b.names), f"{what}: columns differ")
    va, vb = a.valid, b.valid.to(a.device)
    na, nb = int(va.sum()), int(vb.sum())
    check(na == nb, f"{what}: {na} rows against {nb}")
    cols = sorted(a.names, key=lambda c: (c in approx, c))
    worst = 0.0
    in_order = True
    for c in cols:
        x, y = a.col(c)[va], b.col(c).to(a.device)[vb]
        check(x.dtype == y.dtype, f"{what}: {c} dtype")
        if c in approx:
            d = (x.double() - y.double()).abs()
            if na and not bool((d <= 1e-3 + RTOL_FLOAT_AGG
                                * y.double().abs()).all()):
                in_order = False
                break
            worst = max(worst, float(d.max()) if na else 0.0)
        elif not torch.equal(x, y):
            in_order = False
            break
    if in_order:
        return worst
    da, db = a.to_numpy(), b.to_numpy()
    oa = np.lexsort(tuple(_sortable(da[c]) for c in reversed(cols)))
    ob = np.lexsort(tuple(_sortable(db[c]) for c in reversed(cols)))
    worst = 0.0
    for c in cols:
        x, y = da[c][oa], db[c][ob]
        if c in approx:
            check(np.allclose(x, y, rtol=RTOL_FLOAT_AGG, atol=1e-3),
                  f"{what}: {c} values")
            if len(x):
                worst = max(worst, float(np.abs(
                    x.astype(np.float64) - y.astype(np.float64)).max()))
        else:
            check(np.array_equal(x, y), f"{what}: {c} values")
    return worst


def same_results(a_res, b_res, plan, what):
    check(sorted(a_res) == sorted(b_res), f"{what}: outputs differ")
    return max([same_table(a_res[k], b_res[k],
                           approx_cols(plan, a_res[k]), f"{what} {k}")
                for k in a_res] + [0.0])


def _cold(catalog, plan, dev):
    """The plan's results on a fresh store, reuse off."""
    from repro_torch.core.restore import ReStore
    from repro_torch.store.artifacts import ArtifactStore
    rs = ReStore(catalog, ArtifactStore(device=dev), heuristic="off",
                 rewrite_enabled=False, device=dev)
    return rs.run_plan(plan)[0]


def stream_part(dev, n_rows, seed):
    """(a) run_stream("cost") with append churn and the prefetcher, then
    every live repository entry against a cold recompute of its plan."""
    from repro_torch.workloads.stream import StreamConfig, run_stream

    cfg = StreamConfig(n_events=STREAM_EVENTS, n_tenants=STREAM_TENANTS,
                       zipf_s=1.1, n_rows=n_rows, seed=seed,
                       append_every=STREAM_APPEND_EVERY, append_frac=0.10,
                       maintain="auto",
                       prefetch=True)
    t0 = time.perf_counter()
    res = run_stream("cost", cfg, device=dev)
    wall = time.perf_counter() - t0
    rs = res.driver
    cat = rs.catalog
    checked, pending, worst = 0, 0, 0.0
    for e in list(rs.repo.entries):
        if any(cat.version(ds) != v for ds, v in e.source_versions.items()):
            # a deferred (lazy) refresh: the entry is not served until a
            # probe refreshes it
            check(e.signature in rs.repo.pending_refresh,
                  f"phase 6 (a): stale entry {e.artifact} is neither "
                  "refreshed nor pending")
            pending += 1
            continue
        cold = _cold(cat, e.plan, dev)
        (ct,) = cold.values()
        worst = max(worst, same_table(
            rs.store.get(e.artifact), ct, approx_cols(e.plan, ct),
            f"phase 6 (a) entry {e.artifact}"))
        checked += 1
    rec = dict(events=len(res.events), wall_s=wall,
               stream_wall_s=res.total_wall_s,
               page_views_rows=int(cat.get("page_views").num_valid()),
               refreshes=res.refreshes, prefetch_hits=res.prefetch_hits,
               prefetched=res.prefetched,
               refreshed_ahead=res.refreshed_ahead,
               reused=res.n_reused_total,
               executed=sum(e.n_executed for e in res.events),
               entries_checked=checked, entries_pending=pending,
               evictions=res.evictions, rejections=res.rejections,
               peak_store_bytes=res.peak_store_bytes,
               max_float_agg_err=worst)
    check(len(res.events) == STREAM_EVENTS, "phase 6 (a): events lost")
    for k in ("refreshes", "prefetch_hits", "reused", "entries_checked"):
        check(rec[k] > 0, f"phase 6 (a): {k} is {rec[k]}")
    return rec, res


def batch_part(catalog, dev):
    """(b) run_batch over 8 PigMix queries that share sub-plans, held
    against the same queries run one by one on a fresh driver."""
    from repro_torch.core.mqo import run_batch
    from repro_torch.core.plan import rebind_load_versions
    from repro_torch.core.restore import ReStore
    from repro_torch.store.artifacts import ArtifactStore
    from repro_torch.workloads.stream import DATASETS, default_templates

    templates = dict(default_templates())
    names = ["L3_sum", "L3F", "L3_mean", "L2", "L5", "L6", "L7", "hi_rev"]
    versions = {ds: catalog.version(ds) for ds in DATASETS}

    def plans():
        return [rebind_load_versions(templates[n](), versions)
                for n in names]

    def driver():
        return ReStore(catalog, ArtifactStore(device=dev), heuristic="cost",
                       device=dev)

    t0 = time.perf_counter()
    br = run_batch(driver(), plans())
    t_batch = time.perf_counter() - t0
    seq = driver()
    t0 = time.perf_counter()
    seq_res = [seq.run(p)[0] for p in plans()]
    t_seq = time.perf_counter() - t0
    worst, exact = 0.0, True
    for n, p, a, b in zip(names, plans(), br.results, seq_res):
        w = same_results(a, b, p, f"phase 6 (b) {n}")
        worst = max(worst, w)
        exact = exact and w == 0.0
    check(br.dup_executions == 0,
          f"phase 6 (b): {br.dup_executions} duplicate executions")
    check(len(br.batch.shared) > 0, "phase 6 (b): nothing shared")
    return dict(queries=names, shared=len(br.batch.shared),
                shared_kinds=sorted(s.kind for s in br.batch.shared),
                dup_executions=br.dup_executions, t_batch_s=t_batch,
                t_sequential_s=t_seq, shared_wall_s=br.shared_wall_s,
                float_aggs_bit_identical=exact, max_float_agg_err=worst)


def service_part(catalog, events, dev, root):
    """(c) ReStoreService, 4 workers, over the stream's events on a disk
    store with a journal: every ticket against a serial cold baseline, a
    stampede of one plan collapsing onto one execution, goodput and
    latency.  (d) stop, reopen the store, replay the journal, and answer
    a repeated query by reuse."""
    import threading

    from repro_torch.core.plan import rebind_load_versions
    from repro_torch.core.repository import Repository
    from repro_torch.core.restore import ReStore
    from repro_torch.service import ReStoreService, RepositoryJournal
    from repro_torch.store.artifacts import ArtifactStore
    from repro_torch.workloads.stream import DATASETS, default_templates

    templates = dict(default_templates())
    versions = {ds: catalog.version(ds) for ds in DATASETS}

    def plan(name):
        return rebind_load_versions(templates[name](), versions)

    baseline = {n: _cold(catalog, plan(n), dev)
                for n in sorted({e.template for e in events})}
    store = ArtifactStore(root=root, device=dev)
    svc = ReStoreService(catalog, store, Repository(),
                         n_workers=SERVICE_WORKERS,
                         journal=RepositoryJournal(root), device=dev)
    done = {}

    def watch(t):
        t._ev.wait()
        done[t] = time.time()

    try:
        t0 = time.perf_counter()
        hits0 = svc.stats()["singleflight_hits"]
        stampede = [svc.submit(plan("L3F"), tenant=f"burst{i}")
                    for i in range(STAMPEDE)]
        burst_hits = svc.stats()["singleflight_hits"] - hits0
        tickets = [(e.template, svc.submit(plan(e.template),
                                           tenant=f"t{e.tenant}"))
                   for e in events]
        watchers = [threading.Thread(target=watch, args=(t,), daemon=True)
                    for t in stampede + [t for _, t in tickets]]
        for w in watchers:
            w.start()
        worst = 0.0
        for t in stampede:
            res, _ = t.result(timeout=600)
            worst = max(worst, same_results(res, baseline["L3F"],
                                            plan("L3F"),
                                            "phase 6 (c) stampede"))
        for name, t in tickets:
            res, _ = t.result(timeout=600)
            worst = max(worst, same_results(res, baseline[name], plan(name),
                                            f"phase 6 (c) {name}"))
        wall = time.perf_counter() - t0
        for w in watchers:
            w.join(timeout=60)
        st = svc.stats()
    finally:
        svc.stop()
    # a ticket's latency: from its submit to its result
    lat = np.array([done[t] - t.submitted_at for t in done])
    check(len(lat) == len(tickets) + STAMPEDE, "phase 6 (c): a ticket "
          "never resolved")
    check(burst_hits == STAMPEDE - 1,
          f"phase 6 (c): stampede of {STAMPEDE} gave {burst_hits} "
          "singleflight hits")
    check(st["failed"] == 0 and st["dup_executions"] == 0,
          f"phase 6 (c): failed {st['failed']}, duplicate executions "
          f"{st['dup_executions']}")
    n_done = len(tickets) + STAMPEDE
    rec = dict(workers=SERVICE_WORKERS, tickets=n_done, wall_s=wall,
               goodput_per_s=n_done / wall,
               p50_latency_s=float(np.percentile(lat, 50)),
               p95_latency_s=float(np.percentile(lat, 95)),
               stampede=STAMPEDE, stampede_singleflight_hits=burst_hits,
               singleflight_hits=st["singleflight_hits"],
               completed=st["completed"], retries=st["retries"],
               degraded=st["degraded"], max_float_agg_err=worst)
    # (d) the journal: reopen and recover as a new process would
    store2 = ArtifactStore(root=root, device=dev)
    repo2, journal2 = RepositoryJournal.recover(store2)
    try:
        check(journal2.recovered_entries > 0 and
              journal2.reconciled_drops == 0,
              f"phase 6 (d): recovered {journal2.recovered_entries}, "
              f"dropped {journal2.reconciled_drops}")
        again = events[0].template
        res, rep = ReStore(catalog, store2, repo2, device=dev).run_plan(
            plan(again))
        check(rep.n_executed == 0 and rep.n_reused > 0,
              f"phase 6 (d): {again} executed {rep.n_executed} jobs after "
              "recovery")
        same_results(res, baseline[again], plan(again), "phase 6 (d)")
    finally:
        journal2.close()
        store2.close()
    rec["journal"] = dict(recovered_entries=journal2.recovered_entries,
                          reconciled_drops=journal2.reconciled_drops,
                          repeated=again, executed=rep.n_executed,
                          reused=rep.n_reused)
    return rec


def fault_part(dev, seed, keep):
    """(e) the seeded fault sweep of tests/test_faults.py on disk stores
    at 2**FAULT_LOG2_ROWS rows: every seed's answers equal the fault-free
    run's, and no query fails for good."""
    from repro_torch.core.repository import Repository
    from repro_torch.core.restore import ReStore
    from repro_torch.service import FaultInjector, FaultSchedule
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.workloads import pigmix

    mix = (("L3_sum", lambda: pigmix.L3("sum")), ("L2", pigmix.L2),
           ("L3_mean", lambda: pigmix.L3("mean")))
    src = Catalog(ArtifactStore(device=dev), device=dev)
    pigmix.register_all(src, n_rows=1 << FAULT_LOG2_ROWS, seed=seed)

    def run(injector):
        root = tempfile.mkdtemp(prefix="faults_", dir=keep)
        store = ArtifactStore(root=root, fault_injector=injector,
                              device=dev)
        rs = ReStore(src, store, Repository(), device=dev)
        try:
            out = {label: rs.run_plan(q())[0] for label, q in mix}
            store.flush()
            return out, store.stats["quarantined"]
        finally:
            store.close()
            shutil.rmtree(root, ignore_errors=True)

    t0 = time.perf_counter()
    base, _ = run(None)
    injected, quarantined, worst = 0, 0, 0.0
    for s in range(FAULT_SEEDS):
        inj = FaultInjector(FaultSchedule(s, rates=FAULT_RATES,
                                          max_faults=6), latency_s=0.001)
        got, q = run(inj)
        quarantined += q
        injected += inj.total_injected()
        for label, q_fn in mix:
            worst = max(worst, same_results(got[label], base[label], q_fn(),
                                            f"phase 6 (e) seed {s} {label}"))
    check(injected > 0, "phase 6 (e): no fault injected")
    return dict(rows=1 << FAULT_LOG2_ROWS, seeds=FAULT_SEEDS,
                injected=injected, quarantined=quarantined,
                wall_s=time.perf_counter() - t0, max_float_agg_err=worst)


def profile_service(catalog, events, dev, root):
    """Where the time goes on the service path: the stream's events once
    more on a fresh disk store, 4 workers, under torch.profiler (the
    store's flush at stop included)."""
    import torch
    from repro_torch.core.plan import rebind_load_versions
    from repro_torch.core.repository import Repository
    from repro_torch.service import ReStoreService
    from repro_torch.store.artifacts import ArtifactStore
    from repro_torch.workloads.stream import DATASETS, default_templates

    templates = dict(default_templates())
    versions = {ds: catalog.version(ds) for ds in DATASETS}

    def run():
        svc = ReStoreService(catalog, ArtifactStore(root=root, device=dev),
                             Repository(), n_workers=SERVICE_WORKERS,
                             device=dev)
        try:
            tickets = [svc.submit(rebind_load_versions(
                templates[e.template](), versions), tenant=f"t{e.tenant}")
                for e in events]
            for t in tickets:
                t.result(timeout=600)
        finally:
            svc.stop()
        torch.cuda.synchronize()

    wall_ms, busy_ms, top = profiled(run)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, top=top)


def service_phase(dev, n_rows, seed, keep, counters):
    """Phase 6: parts (a)-(e), the launch counters read just after (e),
    then (f) where the time goes.  Returns its record."""
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.workloads.stream import DATASETS

    t0 = time.perf_counter()
    stream, res = stream_part(dev, n_rows, seed)
    stream["part_s"] = time.perf_counter() - t0
    # (b)-(d) run over the stream's final tables in a catalog of their
    # own, so the stream's store (and its artifacts on the card) can go
    catalog = Catalog(ArtifactStore(device=dev), device=dev)
    for ds in DATASETS:
        catalog.register(ds, res.driver.catalog.sources[ds])
    events = res.events
    del res
    t1 = time.perf_counter()
    batch = batch_part(catalog, dev)
    batch["part_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    svc = service_part(catalog, events, dev,
                       tempfile.mkdtemp(prefix="service_", dir=keep))
    svc["part_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    faults = fault_part(dev, seed, keep)
    faults["part_s"] = time.perf_counter() - t1
    launches = {k: c.count for k, c in counters.items()}
    phase_s = time.perf_counter() - t0
    profile = profile_service(catalog, events, dev,
                              tempfile.mkdtemp(prefix="service_prof_",
                                               dir=keep))
    return dict(stream=stream, batch=batch, service=svc, faults=faults,
                launches=launches, phase_s=phase_s, profile=profile)


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build
    from repro_torch.kernels.filter_project import ops as fp
    from repro_torch.kernels.hash_join import ops as hj
    from repro_torch.kernels.radix_partition import ops as rp
    from repro_torch.kernels.segment_reduce import ops as sr
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.workloads import pigmix

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    build.library()
    log(f"phase 0: kernels built in "
        f"{build.build_seconds if build.build_seconds is not None else 0:.1f}"
        f" s ({'fresh build' if build.build_seconds else 'cached'})")

    # ---- phase 1
    n_cases = ragged_checks(dev)
    log(f"phase 1: {n_cases} ragged/tie-heavy cases bit-identical "
        "to the plain versions")
    log(f"phase 1: {edge_case_checks(dev)} join_probe/segment_sum edge "
        "cases equal to the plain versions")
    log(f"phase 1: {radix_checks(dev)} radix_partition/partition_scatter "
        "cases bit-identical to the plain versions")
    n_rows = 1 << args.log2_rows
    if args.log2_rows < 24:
        log(f"CUT: page_views = 2**{args.log2_rows} rows, not 2**24")
    t0 = time.perf_counter()
    pv = pigmix.gen_page_views(n_rows, args.seed, n_users=N_USERS,
                               device=dev)
    users = pigmix.gen_users(n_users=N_USERS, device=dev)
    power = pigmix.gen_power_users(device=dev)
    torch.cuda.synchronize()
    log(f"phase 1: page_views {n_rows} rows ({pv.nbytes() / 1e9:.3f} GB on "
        f"the card), users {users.capacity}, power_users "
        f"{power.capacity}; generated in {time.perf_counter() - t0:.1f} s")
    kernels = main_shape_measurements(dev, pv, users)
    for k in kernels:
        log(f"phase 1: {k['name']:<15} {k['shape']}: kernel {k['ms']:.4f} ms"
            f", plain {k['plain_ms']:.4f} ms, library {k['library_ms']:.4f}"
            f" ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
            f"max_abs_err {k['max_abs_err']} [{card}]")
    log(f"phase 1: card and cpu agree on "
        f"{small_agreement(dev)} queries at 4096 rows")

    # ---- phase 2
    catalog = Catalog(ArtifactStore(device=dev), device=dev)
    catalog.register("page_views", pv)
    catalog.register("users", users)
    catalog.register("power_users", power)
    oracle = Oracle(n_rows, args.seed, N_USERS,
                    users.col("phone").cpu().numpy(),
                    users.col("zip").cpu().numpy())
    keep = tempfile.mkdtemp(prefix="restore_smoke_")
    counters = {"join_probe": hj.launches,
                "join_probe_directory": hj.directory_launches,
                "segment_sum": sr.launches,
                "filter_compact": fp.launches,
                "partition_scatter": rp.scatter_launches,
                "radix_partition": rp.partition_launches}
    main_path = ("join_probe", "segment_sum", "filter_compact")
    for c in counters.values():
        c.reset()
    times = {}
    try:
        for q, plan_fn in pigmix.QUERIES.items():
            before = {k: c.count for k, c in counters.items()}
            r = run_query(plan_fn, catalog, dev, keep)
            per_q = {k: c.count - before[k] for k, c in counters.items()}
            oracle.check(q, r["plain"])
            same_rows(q, r["store"], r["plain"], "store vs plain")
            same_rows(q, r["reuse"], r["plain"], "reuse vs plain")
            if r["n_jobs"] > 1:
                check(r["n_reused"] > 0, f"{q}: reuse arm reused nothing")
            times[q] = {k: r[k] for k in ("t_plain", "t_store", "t_reuse",
                                          "n_reused", "artifacts")}
            times[q]["launches"] = per_q
            log(f"phase 2: {q:<4} t_plain {r['t_plain']:.4f} s  t_store "
                f"{r['t_store']:.4f} s  t_reuse {r['t_reuse']:.4f} s  "
                f"reused {r['n_reused']}  artifacts {r['artifacts']}  "
                f"launches {per_q}  (page_views {n_rows} rows) [{card}]")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    launches = {k: c.count for k, c in counters.items()}
    log(f"phase 2: kernel launches on the main path: {launches}")
    for k in main_path:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    check(launches["join_probe_directory"] == launches["join_probe"],
          "join_probe: a probe launch without its directory pre-pass")

    # ---- phase 3: where the time goes (after the counts were read)
    keep = tempfile.mkdtemp(prefix="restore_prof_")
    try:
        wall_ms, busy_ms, top = profile_plain_arm(
            pigmix.QUERIES["L3"], catalog, dev, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    log(f"phase 3: L3 plain arm + flush under torch.profiler: wall "
        f"{wall_ms:.1f} ms"
        f", device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)"
        f" [{card}]")
    for name, ms, count in top:
        log(f"phase 3:   {ms:9.3f} ms  x{count:<5} {name[:90]}")

    # ---- phase 4: the mesh path, its own counts (zeroed and read
    # around the mesh arms inside mesh_arms)
    del catalog, pv, users, power
    torch.cuda.empty_cache()
    keep = tempfile.mkdtemp(prefix="restore_mesh_")
    t4 = time.perf_counter()
    try:
        mesh = mesh_arms(dev, n_rows, args.seed, keep, card, counters)
        skew = skewed_retry(dev, card)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    mesh_launches = mesh["launches"]
    for arm in ("t_single", "t_mesh_plain", "t_reuse_blind",
                "t_reuse_copart"):
        log(f"phase 4: {arm:<15} {mesh[arm]:.4f} s  jobs "
            f"{mesh['job_walls'].get(arm)}  shuffles/skipped/overflow/"
            f"retries "
            f"{mesh['shuffles'].get(arm)}  (page_views {n_rows} rows, "
            f"{N_SHARDS} shards, skew {MESH_SKEW}) [{card}]")
    log(f"phase 4: {mesh['groups']} groups of {mesh['users_present']} "
        f"users drawn; {mesh['h1_colliding_names']} user names share their"
        f" seed-0 key hash with another; groups beyond one per user "
        f"{mesh['extra_groups']}; partition_scatter launches in the reuse "
        f"arms' timed runs {mesh['timed_partition_scatter']}; skewed case "
        f"{skew}; phase took {time.perf_counter() - t4:.1f} s")
    log(f"phase 4: kernel launches on the mesh path: {mesh_launches}")
    log(f"phase 4: partition_scatter launches by [S, N, P, bucket, count]:"
        f" {mesh['partition_scatter_shapes']}")
    check(sum(x[-1] for x in mesh["partition_scatter_shapes"])
          == mesh_launches["partition_scatter"],
          "partition_scatter: launch shapes do not add up to its launches")
    # segment_sum runs on the mesh path only in the lossless retry's
    # sort-based reduce
    mesh_path = ("partition_scatter", "join_probe", "filter_compact") + \
        (("segment_sum",) if mesh["retries"] else ())
    for k in mesh_path:
        check(mesh_launches[k] > 0,
              f"{k} was never launched on the mesh path")
    for k in kernels:
        # each kernel's count on its path: phase 2 for the slice-A
        # kernels, phase 4 for the exchange; radix_partition is on no
        # path
        k["launches"] = (launches if k["name"] in main_path
                         else mesh_launches)[k["name"]]
        k["mesh_launches"] = mesh_launches[k["name"]]
        if k["name"] == "partition_scatter":
            k["mesh_launch_shapes"] = mesh["partition_scatter_shapes"]
        if k["name"] == "join_probe":
            # the directory pre-pass, one launch before each probe launch
            k["directory_launches"] = launches["join_probe_directory"]
            k["mesh_directory_launches"] = \
                mesh_launches["join_probe_directory"]

    # ---- phase 5: the serving path, its own counts (zeroed and read
    # around (b)-(d) inside serving_phase)
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    n_fa, fa_worst = flash_checks(dev)
    log(f"phase 5 (a): flash_attention on {n_fa} cases within "
        f"{FA_TOL} of the plain version (worst {fa_worst}); batch-"
        "invariant rows in a 1040-row prefill, a 16-row suffix and a "
        "decode step")
    fa_shapes, fa_host_us = flash_measurements(dev)
    for k in fa_shapes:
        log(f"phase 5 (a): {k['shape']} ({k['form']} form): kernel "
            f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, library "
            f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}); eager: kernel {k['eager_ms']:.4f} ms, "
            f"library {k['library_eager_ms']:.4f} ms; max_abs_err "
            f"{k['max_abs_err']}, of the row's RMS "
            f"{k['max_err_of_row_rms']} [{card}]")
    log(f"phase 5 (a): wrapper host time per decode call "
        f"{fa_host_us:.2f} us [{card}]")
    serving, fa_launches, fa_merges = serving_phase(dev, card, args.seed)
    serving["card_vs_cpu"] = serving_card_vs_cpu(dev, args.seed)
    log(f"phase 5 (f): smoke config, card vs cpu: "
        f"{serving['card_vs_cpu']}; phase took "
        f"{time.perf_counter() - t5:.1f} s")
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:104",
        launches=fa_launches, merge_launches=fa_merges,
        host_us_per_decode_call=fa_host_us,
        f32_source="src/repro_torch/csrc/flash_attention.cu",
        **fa_shapes[0], at_shapes=fa_shapes[1:]))

    # ---- phase 6: the service path, its own counts (zeroed just before
    # (a) and read just after (e), inside service_phase)
    torch.cuda.empty_cache()
    log(f"CUT: phase 6 (e) sweeps its faults at page_views = "
        f"2**{FAULT_LOG2_ROWS} rows, not 2**{args.log2_rows}: every "
        "injected retry sleeps")
    keep = tempfile.mkdtemp(prefix="restore_service_")
    for c in counters.values():
        c.reset()
    try:
        service = service_phase(dev, n_rows, args.seed, keep, counters)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    svc_launches = service["launches"]
    st, bt, sv, ft = (service[k] for k in ("stream", "batch", "service",
                                           "faults"))
    log(f"phase 6 (a): run_stream('cost'): {st['events']} events, "
        f"{STREAM_TENANTS} tenants, page_views {n_rows} -> "
        f"{st['page_views_rows']} rows "
        f"({(STREAM_EVENTS - 1) // STREAM_APPEND_EVERY} appends of 10%); "
        f"refreshes "
        f"{st['refreshes']} (ahead of arrival {st['refreshed_ahead']}), "
        f"prefetch hits {st['prefetch_hits']}, reused {st['reused']}, "
        f"executed {st['executed']}; {st['entries_checked']} live entries "
        f"equal a cold recompute ({st['entries_pending']} pending lazy "
        f"refresh; float aggregates within {st['max_float_agg_err']:.3g});"
        f" stream {st['wall_s']:.1f} s, part {st['part_s']:.1f} s [{card}]")
    log(f"phase 6 (b): run_batch of {len(bt['queries'])} queries: shared "
        f"{bt['shared']} {bt['shared_kinds']}, duplicate executions "
        f"{bt['dup_executions']}; equal to sequential runs (float "
        f"aggregates bit-identical: {bt['float_aggs_bit_identical']}, "
        f"worst {bt['max_float_agg_err']:.3g}); batch {bt['t_batch_s']:.3f}"
        f" s, sequential {bt['t_sequential_s']:.3f} s [{card}]")
    log(f"phase 6 (c): ReStoreService, {sv['workers']} workers, "
        f"{sv['tickets']} tickets: every ticket equals its serial "
        f"baseline; stampede of {sv['stampede']} -> "
        f"{sv['stampede_singleflight_hits']} singleflight hits; goodput "
        f"{sv['goodput_per_s']:.3f} tickets/s, latency p50 "
        f"{sv['p50_latency_s']:.4f} s p95 {sv['p95_latency_s']:.4f} s, "
        f"wall {sv['wall_s']:.3f} s [{card}]")
    log(f"phase 6 (d): journal recovered {sv['journal']['recovered_entries']}"
        f" entries (dropped {sv['journal']['reconciled_drops']}); "
        f"{sv['journal']['repeated']} answered by reuse (executed "
        f"{sv['journal']['executed']}, reused {sv['journal']['reused']})")
    log(f"phase 6 (e): {ft['seeds']} fault schedules at {ft['rows']} rows:"
        f" {ft['injected']} faults injected, {ft['quarantined']} "
        f"quarantined, answers equal the fault-free run's; "
        f"{ft['wall_s']:.1f} s")
    log(f"phase 6: kernel launches on the service path: {svc_launches}; "
        f"(a)-(e) took {service['phase_s']:.1f} s")
    pr = service["profile"]
    log(f"phase 6 (f): the events on 4 workers once more under "
        f"torch.profiler: wall {pr['wall_ms']:.1f} ms, device busy "
        f"{pr['busy_ms']:.1f} ms ({100 * pr['busy_ms'] / pr['wall_ms']:.1f}"
        f"%) [{card}]")
    for name, ms, count in pr["top"]:
        log(f"phase 6 (f):   {ms:9.3f} ms  x{count:<5} {name[:90]}")
    for k in ("segment_sum", "join_probe", "filter_compact"):
        check(svc_launches[k] > 0,
              f"{k} was never launched on the service path")
    check(svc_launches["join_probe_directory"] == svc_launches["join_probe"],
          "join_probe: a probe launch without its directory pre-pass "
          "(service path)")
    for k in kernels:
        k["service_launches"] = svc_launches.get(k["name"], 0)
    for k in kernels:
        log(f"kernel {k['name']:<17} kernel {k['ms']:.4f} ms  plain "
            f"{k['plain_ms']:.4f} ms  library {k['library_ms']:.4f} ms  "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})  launches "
            f"{k['launches']} (service path {k['service_launches']}) "
            f"[{card}]")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels, "queries": times,
                      "mesh": mesh, "skewed_retry": skew,
                      "page_views_rows": n_rows, "serving": serving,
                      "service": service}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
