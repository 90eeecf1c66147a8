#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--log2-rows 24] [--seed 0] [--against SRC]

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
         function (a yardstick the port never calls).  The float32
         attention kernel's row statistic (``ops.mha_lse`` on its
         CUDA-core route) against ``mha_lse_ref`` on the attention parity
         generators, and its time with and without the statistic.  The
         float32 forward and backward at MLA's (D_qk, D_v) = (24, 16)
         and (96, 64) against the plain versions, the backward given
         the forward's ``lse`` bit-equal to the one that computes it, an
         f32 gradient through ``_sdpa_chunked`` against its plain route,
         and both kernels' times at F32_MLA_SHAPE.
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
         at page_views = 2**min(log2_rows, MESH_LOG2_ROWS) rows (a CUT
         line) and n_users = rows / 8, on a
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

Phase 7  the store's tiers.  (a) L3's largest job-boundary artifact at
         page_views = 2**log2_rows rows, stored by the ReStore driver on
         a store with a host tier and a remote, goes device -> pinned
         host (a pressure eviction of the device cache) -> disk ->
         remote -> promoted back; its crc after every read must equal
         the original's; each tier's io_stats and the reads waited out on
         the card.  (b) ``benchmarks/tier_bench.py``'s two arms through
         the port's store (its constants, 2**20 rows per artifact):
         demand paging against the prefetcher, identical probe crcs,
         prefetch hits, and a cold start from the remote alone.  The
         launch counters are zeroed before (a) and read after (b);
         ``filter_compact`` (the flusher's) must have launched.
Phase 8  training.  (a) The attention backward kernel
         (``csrc/flash_attention_bwd.cu``) against autograd through the
         plain attention on ``bench.backward_cases`` (f32 on its CUDA-core
         route, bf16 on its tensor-core route, each route's launch counter
         checked; bf16 also against the plain version of its own
         arithmetic from the forward's row statistics, and those against
         ``mha_lse_ref``; no-key rows included), then at
         ``bench.TRAIN_SHAPES``: the forward's output, its row statistics
         and the gradients held to the plain versions again, and the
         kernel's graph-replayed time beside SDPA's backward's, the bound
         and, with ``--against SRC``, the backward of the checkout whose
         ``src`` directory is SRC (timed in the same process), with eager
         times and the plain version's.  (b)
         qwen3-1.7b at its full config (bf16, remat, random weights),
         batch 8 x seq 64 from the ReStore pipeline
         (``train/data.py``): one step's gradients against the same step
         with plain attention (cosine per leaf), then 4 steps on the
         pipeline's batches and 8 on one repeated batch (the loss must
         fall), with step time, tokens/s, peak memory, the attention
         launches of one step counted apart (forward, remat's recompute,
         backward) and one step under torch.profiler; the launch
         counters are zeroed before those steps and read after them.
         (c) ``launch/train.py``'s "100m" preset (f32) killed at step 6
         in a subprocess (exit code 17), resumed, and held against an
         uninterrupted run.  (d) (b)'s model and optimizer at a long
         context: batch 8 x seq 1024 (4 x 1024 if 8 does not fit in the
         card's memory) from the ReStore pipeline over
         synthetic_corpus(64, 1025, vocab), a few timed steps with finite
         losses and gnorms, step time, tokens/s, peak memory, its own
         launch counts and one step under torch.profiler with the
         attention backward's share of the device time.

Phase 9  the model families, one model at a time (bf16, random weights
         from a seeded generator), each freed before the next.  (a)
         minicpm3-4b at its full config (62 layers, MLA): the attention
         kernel at (D_qk, D_v) = (96, 64) against the plain version at
         the stream's shapes (``bench.MLA_SHAPES``, with times and the
         bound), then ``ServeSession`` with and without a
         ``KVRepository`` over the same 16 requests (4 prefixes of 4096
         tokens at zipf 1.1, 16-token suffixes, 2 greedy tokens), every
         reused request's logits held to the cold arm's; the latent
         cache's bytes per token beside a decompressed K and V's.  (b)
         qwen3-moe-235b-a22b at full width, 8 of its 94 layers, all 128
         experts a layer: each attention and MoE sublayer of a 2048-token
         prefill and of a batched decode of 8 rows teacher-forced
         against its plain version fed the same input (attention through
         ``mha_ref``, slots through ``partition_scatter_ref``): slots
         bit-equal, the same drops, outputs within SUBLAYER_RTOL; a
         ``ServeSession`` stream of 8 requests over 2 prefixes of 1024
         tokens with and without reuse (the logit gap between the arms
         reported, not held: with capacity-dropping MoE a token's output
         depends on its call); the dropless smoke config on the card
         against the CPU.  (c) qwen2-vl-72b at full width, 8 of its 80
         layers: ``Model.prefill`` of 2048 embeddings with 3-axis
         positions and 4 decode steps against the port's full forward
         over the same 2052 positions with plain attention; the smoke
         config on the card against the CPU.  Per model: prefill and
         decode ms, tokens/s, peak memory, device busy over one profiled
         request, and the launches of ``flash_attention`` by route and
         (D_qk, D_v) and of ``partition_scatter``, their counters zeroed
         before and read after each model's main path.

Phase 10 the recurrent mixers, one model at a time.  (a) xlstm-350m at
         its full width and CHAT_LAYERS of its 24 blocks (7 mLSTM and 1
         sLSTM, bf16, random weights; a CUT line): a multi-turn chat of 4
         conversations x 3 turns through ``ServeSession.serve`` in
         turn-major order, a 1024-token first turn, each later turn the
         previous prompt, its 2 greedy tokens and 14 new ones, 2
         greedy tokens a turn; with and without a ``KVRepository`` (a
         stored state is
         exact-length), every reuse-arm logit within LOGIT_ATOL_BF16 of
         the no-reuse arm's; the same turns through ``submit``/``run``
         with 4 slots; one warm turn under torch.profiler; the smoke
         config on the card against the CPU.  Its path launches no
         kernel (the cells are plain loops, as the reference's are plain
         JAX).  (b) jamba-1.5-large-398b at full width: the attention
         kernel (64 / 8 heads x 128) and the partition scatter (E = 16)
         at Jamba's shapes against their plain versions, with times and
         bounds; then the period's three sublayer kinds, (mamba, mlp),
         (mamba, moe) and (attn, moe), built one at a time (one period
         does not fit the card) and each teacher-forced at a 2048-token
         prefill and at an 8-row decode step after a 256-token prefill
         against its plain version fed the same input (attention through
         ``mha_ref``, slots through ``partition_scatter_ref``, Mamba's
         scan through ``plain_mamba``, a step-by-step float32
         recurrence): slots bit-equal, the same drops, outputs within
         SUBLAYER_RTOL, Mamba's h within MAMBA_H_RTOL; launches by
         shape; the smoke config card vs CPU, and the reference's reuse
         fault on the card (a suffix prefill restarts Mamba's scan), its
         logit gap reported, not held.

Phase 11 the encoder-decoder family and MLA's training, one model at a
         time.  (a) seamless-m4t-medium at its full config (12 + 12
         layers, 16 heads x 64, bf16, random weights, nothing cut): the
         attention kernel at its shapes (``bench.ENCDEC_SHAPES``: the
         encoder's non-causal self-attention over 1024 frames, the
         cross-attention at a 16-token prompt and at a decode row)
         against the plain version, with times and bounds; then 8
         utterances of 1024 seeded frame embeddings as one batch, and one
         alone, each through ``Model.prefill`` (a 16-token prompt) and 63
         greedy ``decode_step`` calls: every step's logits within
         LOGIT_ATOL_BF16 of the teacher-forced ``encdec_forward`` over the
         same tokens, every attention call of the batch of 8 against its
         plain version fed the same input (SUBLAYER_RTOL), encode,
         prefill and decode ms, tokens/s, peak memory, one decode step
         under torch.profiler, and the launches by route, dims and
         causality.  (b) The same model trained at 8 x (1024 frames, 256
         decoder tokens): the backward kernel at the encoder, cross and
         decoder shapes (``bench.ENCDEC_TRAIN_SHAPES``) against
         ``mha_bwd_ref`` and ``mha_bwd_lse_ref``, with times and bounds;
         1 + 3 AdamW steps on one repeated batch (losses finite and
         falling), each leaf's gradient against the same step with plain
         attention (cosine), step ms, tokens/s, peak, one step profiled,
         the backward's launches by route.  (c) minicpm3-4b at its full
         config trained at 4 x 1024 tokens from the ReStore pipeline: the
         backward at (D_qk, D_v) = (96, 64) at this shape
         (``bench.MLA_TRAIN_SHAPES``) against the plain versions, then 1
         + 3 steps, 62 backward launches a step on the tensor-core route.
         A batch that does not fit is halved once (a CUT line).  (d) The
         smoke config (f32) on the card against the CPU.

Phase 12 the dry-run and the recurrent families trained, in the order
         (b), (d), then (c) beside (a)'s CPU processes.  (a) Once (b) and
         (d) are timed, ``launch/dryrun.py --all`` counts every (arch,
         shape) cell's step on the meta device in worker processes (no
         card) while (c), which times nothing, runs: every applicable
         cell ok, with FLOPs by dtype, bytes, the simulated peak and
         ``fits_one_card``; the roofline table (``roofline/analysis.py``,
         H100 constants); and the dry-run of the three training steps
         this script times, each at its measured batch (qwen3-1.7b at 8 x
         1024, phase 8 (d); seamless at 8 x (1024 frames, 256 tokens), 11
         (b); xlstm-350m, 12 (b)), each predicted peak within
         PEAK_RATIO_MAX of the measured one, and each step's ``mfu``
         (model_flops / (step s x 989 TFLOP/s)).  (b) xlstm-350m at its
         full config trained from the ReStore pipeline at 4 x 1024
         (remat: the loops over time in chunks of 64 steps, ``ssm._scan``;
         its superblocks are not recomputed whole): the first step's
         gradients at 1 x 80 (a chunk and a short one) against the
         unchunked loop (cosine a leaf); the float32 loss at 1 x 80
         moved along its gradient each way, its change within
         XLSTM_FD_RTOL of the gradient's prediction; 1 + 1 bf16 AdamW
         steps on one repeated batch (losses finite; whether the step
         lowered the loss is logged, not checked: see
         ``xlstm_training``), step ms, tokens/s, peak, device busy over a
         4 x 32 step.  (c) Jamba's three sublayer kinds at full width one
         at a time, a forward and backward over 1024 tokens against
         autograd through the plain versions on the card (cosine on every
         leaf, slots bit-equal), the backward's launches by route and
         dims.  (d) ``launch/dryrun_dataflow.py`` at page_views = 2**24
         rows over LocalMesh(8): its groups against the single-card
         group-by.
Phase 13 the model mesh on logical shards of the card (``launch/mesh.py``'s
         named ``LocalMesh``, ``models/dist.py``), bf16 at full width
         unless said otherwise, the counters zeroed just before each
         main path and read just after.  (a) ``moe_forward`` with a
         (2, 4) mesh set: ``_moe_forward_shard_map`` at
         qwen3-moe-235b-a22b's full width (one MoE sublayer, 128 experts,
         top-8) over 4 x 512 tokens (e_loc 32, t_loc 1024, cap 80), one
         partition-scatter launch a shard, held against the same function
         with slots from ``partition_scatter_ref`` (slots bit-equal, the
         same drops, the output within SUBLAYER_RTOL); its ms, drops, the
         single-device MoE's drops.  (b) qwen3-1.7b whole, a 16384-token
         prefill under ``dist.optimized()``: ``_sdpa_chunked``, 8
         ``mha_lse`` launches of 2048 keys a layer, its last logits within
         LOGIT_ATOL_BF16 of the prefill with the gate off, one layer's
         chunked call against ``mha_ref`` on two slices of its rows; ms,
         peak, launches.  (c) The same model on a (2, 4) mesh: batch 8, a
         4096-token prefill into 8192 slots (s_loc 2048), 32 decode steps
         through ``_decode_attn_seq_sharded`` teacher-forced with an
         unsharded greedy rollout's tokens, every step's logits within
         LOGIT_ATOL_BF16 of it; ms a step of both.  (d)
         ``make_compressed_sync`` over ``LocalMesh(8, "data")`` on one
         layer's gradient-shaped leaves, 10 steps of error feedback:
         codes, errors and means bit-equal to the same calls on the CPU
         (on a subset of leaves), tests/test_distributed.py's bounds; GB/s.
         (e) The smoke configs (f32) of (a)-(c) on the card against the
         CPU, which runs the float32 kernel's row statistic on a path.
         (f) ``launch/dryrun_dataflow.py --multi-pod`` at 2**24 rows over
         the 2x16x16 production mesh's 32 DP shards: its groups against
         the single-card group-by.
Phase 14 the mesh across processes (``launch/mesh.py::GroupMesh``): 4
         gloo ranks, each a process with its own CUDA context on the
         one card, every collective copied through pinned host buffers
         (the transport is printed); the ranks count their own launches.
         (a) phase 4's join -> group-by at page_views = 2**23 rows, skew
         4, the packed rows sent by ``all_to_all``: the ranks' rows in
         rank order equal ``LocalMesh(4)``'s in this process slot for
         slot (keys, counts and maxima bit-equal, float sums within
         RTOL_FLOAT_AGG: the hashed reduce adds them by atomics), and a
         skewed case that every rank retries losslessly (segment_sum);
         per rank the wall, the exchange's bytes and ms, the launches.
         (b) ReStore over the ranks: a cold workflow stores the join
         artifact partitioned, a shard file a rank; the warm one reuses
         it with every exchange skipped and no ``all_to_all``; its
         groups equal the plain arm's; the shard files' npz members
         byte-equal to ``LocalMesh(4)``'s (float sums within the
         tolerance).  (c) ``make_compressed_sync`` over the 4 ranks on
         one qwen3-1.7b layer's gradients, 10 steps: means and each
         rank's errors bit-equal to ``LocalMesh(4)``'s; GB/s.  (d)
         qwen3-1.7b at full width (GROUP_CKPT_LAYERS layers, a CUT line)
         saved from a (2, 2) mesh of the 4 ranks and restored on a
         (1, 2) mesh of 2: every block equals the source's.  (e) (a)'s
         plan over nccl at ``torch.cuda.device_count()`` ranks, one a
         card.  The model programs on the same 4 ranks, each held
         against a ``LocalMesh`` run of its shape in this process, the
         counters zeroed just before each part's main path and read just
         after: (f) qwen3-moe-235b-a22b's MoE sublayer at full width
         (bf16) on (1, 4), 4 x 512 tokens, a rank holding 32 of the 128
         experts: its slots and drops bit-equal to LocalMesh's shard,
         the output within SUBLAYER_RTOL, one partition-scatter launch.
         (g) qwen3-1.7b whole (28 layers) on (2, 2): a 4096-token
         prefill of 4 rows into 8192 slots, then GROUP_ROLL_STEPS decode
         steps teacher-forced with an unsharded greedy rollout's tokens,
         a rank holding its DP block's S-slice of the cache; every step's
         logits within LOGIT_ATOL_BF16 of the unsharded rollout's and of
         LocalMesh's.  (h) ``launch/train.py``'s sharded step of
         qwen3-1.7b at full width, GROUP_CKPT_LAYERS layers (a CUT line),
         on (2, 2) at 8 x 1024 tokens, a rank holding its blocks of the
         parameters and moments: each rank's loss and global norm within
         GROUP_STEP_LOSS_RTOL of LocalMesh's step, its gradient leaves'
         cosines at least GROUP_STEP_MIN_COS, its updated parameter, m
         and v blocks held against LocalMesh's at its coordinates
         (``_same_digests``).  (i) ``launch/sharded_serve.py``'s
         sharded prefill and decode steps of (d)'s model (qwen3-1.7b at
         full width, GROUP_CKPT_LAYERS layers) on (2, 2), baseline
         (every weight gathered, the cache gathered over "model") and
         ``--opt`` (the sequence-sharded GQA cache): a 1024-token
         prefill of 4 rows into 2048 slots and 2 decode steps
         (GROUP_SERVE_*), a rank holding its parameter and cache blocks:
         every call's logits bit-equal to ``LocalMesh((2, 2))``'s and
         within LOGIT_ATOL_BF16 of the one-device calls', attention
         launched in both modes.  Per rank: walls, collective calls,
         bytes and ms, resident bytes, peaks, launches by kernel and
         shape.
Phase 15 the dry-run per device of a mesh: a ``CountingMesh`` of each
         rank counts phase 14 (h) and (i) on the meta device at their
         own dims (``predicted_step``, ``group_serve_run``); each rank's
         predicted transport (calls and bytes by kind) must equal its
         measured one and its predicted peak lie within PEAK_RATIO_MAX
         of its ``torch.cuda.max_memory_allocated``.  Then the
         per-device reports of qwen3-1.7b's train_4k and decode_32k on
         16x16 and 2x16x16, with and without ``--opt``, counted in a
         CPU process beside phase 14 (``MeshReports``), with their
         roofline rows at the data-sheet constants.

Prints one JSON line of kernel measurements, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  Needs the repository's ``src/`` beside this file and
a CUDA card; without either it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
RTOL_FLOAT_AGG = 1e-4            # float sums/means added in another order
N_USERS = 1 << 16
N_SHARDS = 8                     # the mesh phase's LocalMesh
# the mesh phase's page_views rows at most, below the other phases'
# 2**24 so the whole script keeps within its time limit (a CUT line)
MESH_LOG2_ROWS = 23
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


def _recording(model, sync=False):
    """The model, recording the last row of every prefill's and decode
    step's logits (f32, on its device), counting the calls, and timing
    each call on the host clock without a sync (the time to enqueue it:
    where it nears a call's wall time, the host, not the card, sets the
    pace), and counting the decode steps that captured CUDA graphs of
    the step (``captures``).  With ``sync``, each call also waits for
    the card and its wall time goes to ``wall_s``."""
    import torch
    from repro_torch.models.api import Model

    class Recording(Model):
        def _call(self, kind, fn, *args):
            graph = self._graph
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            self.captures += self._graph is not graph
            self.host_s[kind].append(time.perf_counter() - t0)
            if sync:
                torch.cuda.synchronize()
                self.wall_s[kind].append(time.perf_counter() - t0)
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
    m.log, m.calls, m.captures = [], 0, 0
    m.host_s = {"prefill": [], "decode": []}
    m.wall_s = {"prefill": [], "decode": []}
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


def _flash_bound(b, hq, hkv, sq, d, kv_len, q_off, causal, elt,
                 peak=None):
    """Least time for the function on this run's data: FLOPs (4 D per
    visible (query, key) pair) at the bf16 tensor-core peak (or
    ``peak``), and bytes (q and o once, the keys and values each row
    needs once)."""
    visible = 0
    for kl, qo in zip(kv_len, q_off):
        rows = np.arange(sq) + qo
        vis = np.minimum(kl, rows + 1) if causal else np.full(sq, kl)
        visible += int(np.clip(vis, 0, None).sum())
    flops = 4 * hq * visible * d
    nbytes = elt * (2 * b * hq * sq * d + 2 * hkv * d * int(sum(kv_len)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or BF16_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_cases(dev):
    """(qkv, cases): the attention parity generators (check_mha's ragged
    shapes, test_flash_attention_sweep's, kv_len decode, per-row kv_len
    and q_offset, GQA, kv_len = 1, the split boundaries, rows that see
    no key) as (qkv arguments, mha keywords), and ``qkv(*args, dtype)``
    making their seeded inputs on the card."""
    import torch

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
    return qkv, cases


def flash_checks(dev):
    """The kernel against its plain version on the card on
    ``flash_cases``, f32 and bf16.  Then batch invariance: a row's bits
    equal in a 1040-row prefill, a 16-row suffix and a decode step."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref

    qkv, cases = flash_cases(dev)
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


# the float32 kernel's row statistic against mha_lse_ref: both are
# float32 (m + ln l against torch.logsumexp), so they differ in the last
# bits of a value of size ~10
LSE_TOL_F32 = 1e-4


def f32_lse_checks(dev):
    """The float32 kernel's row statistic (``csrc/flash_attention.cu``
    given an lse buffer, as ``ops.mha_lse`` asks on the CUDA-core route)
    against ``mha_lse_ref`` on ``flash_cases``: +inf on exactly the rows
    that see no key, the rest within LSE_TOL_F32; the output bit-equal
    to the same call without the statistic.  Then the kernel's time with
    and without the statistic at the serving cold prefill's shape in
    float32 (16/8 heads x 128, 1040 queries over a 1042-slot cache), the
    plain version's, SDPA's and the bound (f32 FLOPs at the CUDA cores'
    peak)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (mha_lse_ref,
                                                         mha_with_lse_ref)

    qkv, cases = flash_cases(dev)
    worst, n = 0.0, 0
    simt = fa.launches.shapes.copy()
    for args, kw in cases:
        q, k, v = qkv(*args, torch.float32)
        out, lse = fa.mha_lse(q, k, v, **kw)
        want = mha_lse_ref(q, k, **kw)
        check(torch.equal(torch.isinf(lse), torch.isinf(want)),
              f"phase 1: f32 lse: rows with no key differ ({args}, {kw})")
        fin = torch.isfinite(want)
        err = float((lse[fin] - want[fin]).abs().max()) \
            if bool(fin.any()) else 0.0
        check(err < LSE_TOL_F32, f"phase 1: f32 lse differs from "
                                 f"mha_lse_ref ({args}, {kw}): {err}")
        check(torch.equal(out, fa.mha(q, k, v, **kw)),
              f"phase 1: f32 output with the statistic differs ({args})")
        worst, n = max(worst, err), n + 1
    moved = {key: c - simt.get(key, 0) for key, c in
             fa.launches.shapes.items() if c != simt.get(key, 0)}
    check(moved and all(key[0] == "simt" for key in moved),
          f"phase 1: f32 lse launches {moved}, not on the simt route")
    q, k, v = qkv(7, 1, 16, 8, 1040, 1042, 128, torch.float32)
    kw = dict(q_offset=0)
    mask = (torch.arange(1042, device=dev)[None] <=
            torch.arange(1040, device=dev)[:, None])
    bound, by = _flash_bound(1, 16, 8, 1040, 128, [1040], [0], True, 4,
                             peak=FP32_OPS_PER_S)
    return dict(
        shape="B=1 Hq=16 Hkv=8 Sq=1040 Skv=1042 D=128 f32, kv_len 1040 "
              "(the cold prefill)",
        cases=n, lse_max_abs_err=worst, tol=LSE_TOL_F32,
        ms=cuda_ms(lambda: fa.mha_lse(q, k, v, 1040, **kw)),
        without_statistic_ms=cuda_ms(lambda: fa.mha(q, k, v, 1040, **kw)),
        plain_ms=cuda_ms(lambda: mha_with_lse_ref(q, k, v, 1040, **kw),
                         iters=3),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)),
        bound_ms=bound, bound_by=by)


F32_MLA_DIMS = ((24, 16), (96, 64))      # MLA's smoke config, minicpm3's
# the f32 kernels' timed shape at each pair: a training step's attention
F32_MLA_SHAPE = (2, 8, 512)              # B, heads, positions (causal)


def f32_mla_checks(dev):
    """The float32 kernels at MLA's unequal head dims: the forward
    (``csrc/flash_attention.cu``) and the CUDA-core backward
    (``csrc/flash_attention_bwd.cu``, namespace simt) at (24, 16) and
    (96, 64) on ``flash_cases``' calls of those dims, against
    ``mha_ref``, ``mha_lse_ref`` and ``mha_bwd_ref`` (FA_TOL, LSE_TOL_F32,
    BWD_TOL); the backward given the forward's ``lse`` bit-equal to the
    one that computes it; an f32 gradient through ``_sdpa_chunked`` (each
    chunk's backward kernel reading the merged statistic) against the
    plain chunk path (``ref.mha_bwd_lse_ref`` on the CPU's copy).  Then,
    at F32_MLA_SHAPE, each pair's forward and backward times beside the
    plain version's, SDPA's and the bound (f32 FLOPs at the CUDA cores'
    peak)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (
        mha_bwd_ref, mha_lse_ref, mha_ref)
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(24)

    def qkv(b, hq, hkv, sq, skv, d, dv):
        return [torch.randn(s, generator=gen, device=dev) for s in (
            (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, dv))]

    i32 = dict(dtype=torch.int32, device=dev)
    calls = [((1, 8, 4, 1, 300), dict(kv_len=300, q_offset=299)),
             ((2, 8, 4, 70, 150), dict(causal=False, q_offset=0,
                                       kv_len=100)),
             ((2, 4, 2, 70, 150), dict(
                 q_offset=torch.tensor([80, -75], **i32),
                 kv_len=torch.tensor([150, 0], **i32))),
             ((1, 16, 8, 1040, 1042), dict(kv_len=1040, q_offset=0))]
    out = {"cases": 0, "fwd_max_abs_err": 0.0, "lse_max_abs_err": 0.0,
           "bwd_max_rel_err": 0.0}
    s_fwd, s_bwd = fa.launches.shapes.copy(), \
        fa.backward_launches.shapes.copy()

    def rel(got, want):
        return max(float((g - w).abs().max()) / float(w.abs().max())
                   for g, w in zip(got, want))

    for d, dv in F32_MLA_DIMS:
        for shape, kw in calls:
            q, k, v = qkv(*shape, d, dv)
            o, lse = fa.mha_lse(q, k, v, **kw)
            want = mha_ref(q, k, v, **kw)
            err = float((o - want).abs().max())
            check(err < FA_TOL["float32"], f"phase 1: f32 forward at "
                  f"({d}, {dv}) {shape}: {err}")
            wl = mha_lse_ref(q, k, **kw)
            check(torch.equal(torch.isinf(lse), torch.isinf(wl)),
                  f"phase 1: f32 lse at ({d}, {dv}): rows with no key")
            fin = torch.isfinite(wl)
            le = float((lse[fin] - wl[fin]).abs().max())
            check(le < LSE_TOL_F32, f"phase 1: f32 lse at ({d}, {dv}): "
                                    f"{le}")
            do = torch.randn(o.shape, generator=gen, device=dev)
            own = fa.backward(q, k, v, o, do, **kw)
            given = fa.backward(q, k, v, o, do, lse=lse, **kw)
            check(all(torch.equal(a, b) for a, b in zip(own, given)),
                  f"phase 1: f32 backward given lse at ({d}, {dv}) "
                  "differs from the one that computes it")
            be = rel(own, mha_bwd_ref(q, k, v, do, **kw))
            check(be < BWD_TOL["float32"], f"phase 1: f32 backward at "
                  f"({d}, {dv}) {shape}: {be}")
            out["cases"] += 1
            out["fwd_max_abs_err"] = max(out["fwd_max_abs_err"], err)
            out["lse_max_abs_err"] = max(out["lse_max_abs_err"], le)
            out["bwd_max_rel_err"] = max(out["bwd_max_rel_err"], be)
    fwd = {key: c - s_fwd.get(key, 0) for key, c in
           fa.launches.shapes.items() if c != s_fwd.get(key, 0)}
    bwd = {key: c - s_bwd.get(key, 0) for key, c in
           fa.backward_launches.shapes.items() if c != s_bwd.get(key, 0)}
    for d, dv in F32_MLA_DIMS:
        check(fwd.get(("simt", d, dv, True), 0) > 0 and bwd.get(
            ("simt", d, dv, True), 0) > 0,
            f"phase 1: no f32 launch at ({d}, {dv}) on the simt route")

    # the chunked path's f32 gradient against its plain route on the CPU
    chunk = {}
    for d, dv in ((64, 64),) + F32_MLA_DIMS:
        q, k, v = qkv(1, 4, 2, 1024, 1024, d, dv)
        do = torch.randn((1, 4, 1024, dv), generator=gen, device=dev)
        got, want = [], []
        for side, ts in (("card", (q, k, v)),
                         ("cpu", [t.cpu() for t in (q, k, v)])):
            x = [t.detach().requires_grad_(True) for t in ts]
            o = L._sdpa_chunked(*x, causal=True, q_offset=0, chunk=256)
            g = torch.autograd.grad(o, x, do.to(ts[0].device))
            (got if side == "card" else want).extend(g)
        e = rel([g.cpu() for g in got], want)
        check(e < BWD_TOL["float32"], f"phase 1: f32 chunked gradient at "
                                      f"({d}, {dv}): {e}")
        chunk[f"{d}/{dv}"] = e
    out["chunked_grad_rel_err"] = chunk

    # times at F32_MLA_SHAPE
    b, h, s = F32_MLA_SHAPE
    out["shape"] = f"B={b} H={h} S={s} causal f32"
    out["at"] = {}
    for d, dv in F32_MLA_DIMS:
        q, k, v = qkv(b, h, h, s, s, d, dv)
        do = torch.randn((b, h, s, dv), generator=gen, device=dev)
        o = fa.mha(q, k, v)
        visible = b * h * s * (s + 1) // 2
        fb, fby = bound_ms(4 * (2 * b * h * s * (d + dv)),
                           2 * visible * (d + dv))
        # q, k, v, o and dO read once, dq, dk and dv written once
        bb, bby = bound_ms(4 * b * h * s * (4 * d + 4 * dv),
                           2 * visible * (3 * d + 2 * dv))
        x = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sd = F.scaled_dot_product_attention(*x, is_causal=True)

        def plain_bwd():
            y = [t.detach().requires_grad_(True) for t in (q, k, v)]
            torch.autograd.grad(mha_ref(*y), y, do)

        out["at"][f"{d}/{dv}"] = dict(
            ms=cuda_ms(lambda: fa.mha(q, k, v)),
            plain_ms=cuda_ms(lambda: mha_ref(q, k, v), iters=3),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)),
            bound_ms=fb, bound_by=fby,
            bwd_ms=cuda_ms(lambda: fa.backward(q, k, v, o, do)),
            bwd_plain_ms=cuda_ms(plain_bwd, iters=3),
            bwd_library_ms=cuda_ms(lambda: torch.autograd.grad(
                sd, x, do, retain_graph=True)),
            bwd_bound_ms=bb, bwd_bound_by=bby)
    return out


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


def _stream(cfg, rng, n_prompts=N_PROMPTS, n_requests=N_REQUESTS,
            prefix=PREFIX_LEN, suffix=SUFFIX_LEN):
    """prefix_reuse_bench.py's request stream: zipf choices over
    ``n_prompts`` prefixes, each request a prefix plus a fresh suffix."""
    w = 1.0 / np.arange(1, n_prompts + 1) ** ZIPF_A
    prefixes = [rng.integers(1, cfg.vocab_size, prefix)
                for _ in range(n_prompts)]
    ranks = rng.choice(n_prompts, size=n_requests, p=w / w.sum())
    prompts = [np.concatenate([prefixes[r], rng.integers(
        1, cfg.vocab_size, suffix)]) for r in ranks]
    return prefixes, ranks, prompts


def serve_arm(model, params, prompts, kv, rng, cfg, prefix=PREFIX_LEN,
              suffix=SUFFIX_LEN, n_decode=N_DECODE):
    """prefix_reuse_bench.py's ``run_arm``: two serves off the clock to
    warm both prefill shapes, then the stream, each request timed."""
    import torch
    from repro_torch.serve.session import ServeSession

    max_len = prefix + suffix + n_decode
    sess = ServeSession(model, params, max_len=max_len, kv=kv,
                        every_k=EVERY_K)
    warm_prefix = rng.integers(1, cfg.vocab_size, prefix)
    for _ in range(2):
        sess.serve(np.concatenate(
            [warm_prefix, rng.integers(1, cfg.vocab_size, suffix)]),
            n_decode)
    torch.cuda.synchronize()
    model.log.clear()
    for v in (*model.host_s.values(), *model.wall_s.values()):
        v.clear()
    stats, laps, logs = [], [], []
    t0 = time.perf_counter()
    for p in prompts:
        t1 = time.perf_counter()
        _, s = sess.serve(p, n_decode)
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


def serving_card_vs_cpu(dev, seed, arch=SERVE_ARCH, what="phase 5 (f)"):
    """(f) The smoke config (f32) served on the card and on the CPU from
    the same parameters: logits within LOGIT_ATOL_F32, tokens equal."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.serve.kv_repo import KVRepository
    from repro_torch.serve.session import ServeSession
    from repro_torch.tree import tree_map

    cfg = get_config(arch, smoke=True)
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
        check((a == b).all(), f"{what}: card and cpu tokens differ")
        for x, y in zip(la, lb):
            err = max(err, float((x - y).abs().max()))
    check(err <= LOGIT_ATOL_F32, f"{what}: card vs cpu logits {err}")
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


# ------------------------------------------------ phase 7: the store tiers

TIER_ARTS = 24                   # benchmarks/tier_bench.py's constants
TIER_PROBES = 120
TIER_FLUSH_EVERY = 12
TIER_K = 6
TIER_ZIPF = 1.1
TIER_REMOTE_LATENCY_S = 0.015
TIER_REMOTE_BW = 2e8
TIER_LOG2_ROWS = 20              # rows per tier_bench artifact


def table_crc(t) -> int:
    """crc32 over the valid rows, column by column in name order."""
    d = t.to_numpy()
    acc = 0
    for c in sorted(d):
        acc = zlib.crc32(np.ascontiguousarray(d[c]).tobytes(),
                         zlib.crc32(c.encode(), acc))
    return acc


def _rate(io, tier):
    b, s = io[f"{tier}_bytes"], io[f"{tier}_s"]
    return dict(bytes=b, s=s, gb_per_s=(b / s / 1e9) if s else None)


def tier_round_trip(dev, n_rows, seed, keep):
    """(a) L3's job-boundary output at page_views = n_rows, stored by the
    ReStore driver on a tiered store, then moved device -> pinned host
    (a pressure eviction of the device cache) -> disk -> remote ->
    promoted back to disk; its content crc after every step must equal
    the original's."""
    import torch
    from repro_torch.core.repository import Repository
    from repro_torch.core.restore import ReStore
    from repro_torch.dataflow.compiler import compile_workflow
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.store.tiers import RemoteObjectStore
    from repro_torch.workloads import pigmix

    remote = RemoteObjectStore(os.path.join(keep, "remote"))
    store = ArtifactStore(root=os.path.join(keep, "store"),
                          host_bytes=8 << 30, remote=remote, device=dev,
                          cache_bytes=8 << 30)
    catalog = Catalog(store, device=dev)
    catalog.register("page_views", pigmix.gen_page_views(
        n_rows, seed, n_users=N_USERS, device=dev))
    catalog.register("users", pigmix.gen_users(n_users=N_USERS, device=dev))
    catalog.register("power_users", pigmix.gen_power_users(device=dev))
    rs = ReStore(catalog, store, Repository(), heuristic="aggressive",
                 device=dev)
    rs.run(pigmix.L3())
    store.flush()
    finals = set(compile_workflow(pigmix.L3()).final_outputs.values())
    inner = [n for n in store.names() if n not in finals] or store.names()
    name = max(inner, key=store.nbytes)
    art = store.get(name)
    nb = art.nbytes()
    crc0 = table_crc(art)
    out = dict(artifact=name, rows=store.meta[name]["rows"],
               nbytes=store.nbytes(name), device_nbytes=nb)
    crcs = {}

    synced = {}

    def reread(tier):
        store.cache.drop(name)
        t0 = time.perf_counter()
        t = store.get(name)
        torch.cuda.synchronize()
        synced[tier] = time.perf_counter() - t0
        crcs[tier] = table_crc(t)
        check(crcs[tier] == crc0, f"phase 7 (a): crc after {tier} differs")

    # device -> pinned host: the device cache squeezed to this artifact,
    # then another entry's put evicts it through the demotion hook
    store.drop_caches()
    store.cache.max_bytes = nb
    store.cache.put(name, art, nb)
    other = art.gather(torch.arange(art.capacity, device=dev), art.valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.cache.put("phase7/pressure", other, nb)
    out["host_demotion_s"] = time.perf_counter() - t0
    check(store.residency(name) == "host",
          f"phase 7 (a): residency {store.residency(name)} after eviction")
    check(store.stats["host_demotions"] == 1, "phase 7 (a): no demotion")
    pinned = all(a.is_pinned() for a in store.host.get(name).values())
    check(pinned, "phase 7 (a): host payload is not pinned")
    store.cache.drop("phase7/pressure")
    del other
    store.cache.max_bytes = 8 << 30
    reread("host")                            # pinned host -> device
    store.drop_caches()
    reread("disk")
    t0 = time.perf_counter()
    store.demote_to_remote(name)
    out["demote_to_remote_s"] = time.perf_counter() - t0
    check(store.authoritative_tier(name) == "remote",
          "phase 7 (a): remote is not the owner after demotion")
    out["blob_bytes"] = os.path.getsize(remote.path(store._remote_key(name)))
    store.drop_caches()
    reread("remote")
    t0 = time.perf_counter()
    store.promote_from_remote(name)
    out["promote_s"] = time.perf_counter() - t0
    check(store.authoritative_tier(name) == "disk",
          "phase 7 (a): disk is not the owner after promotion")
    store.drop_caches()
    reread("promoted")
    io = store.io_stats()
    # io_stats samples stop where get() returns: the host tier's copy to
    # the card is queued without blocking, so its sample is the enqueue;
    # the synced times wait for the data on the card
    out.update(crc=crc0, crcs_equal=sorted(crcs),
               hostload=_rate(io, "hostload"), load=_rate(io, "load"),
               remoteload=_rate(io, "remoteload"),
               synced_read_s=synced,
               synced_gb_per_s={k: nb / v / 1e9 for k, v in synced.items()})
    store.close()
    return out


def _tier_art(i):
    return f"tier_art_{i:03d}"


def _tier_table(i, n_rows, dev):
    from repro_torch.dataflow.table import Table
    rng = np.random.default_rng(1000 + i)
    return Table.from_numpy({
        "k": rng.integers(0, 1 << 40, n_rows).astype(np.int64),
        "v": rng.standard_normal(n_rows).astype(np.float32)}, device=dev)


def _tier_probes():
    rng = np.random.default_rng(7)
    p = 1.0 / np.arange(1, TIER_ARTS + 1) ** TIER_ZIPF
    p /= p.sum()
    perm = np.random.default_rng(8).permutation(TIER_ARTS)
    return [int(perm[rng.choice(TIER_ARTS, p=p)])
            for _ in range(TIER_PROBES)]


def tier_bench_arms(dev, n_rows, keep):
    """(b) benchmarks/tier_bench.py's two arms through the port's store:
    24 remote-authoritative artifacts behind a 15 ms, 200 MB/s remote,
    device and host budgets of 4 artifacts, 120 zipf-1.1 probes with
    ``drop_caches`` every 12; demand paging against the prefetcher
    (k = 6) re-warming between probes off the clock.  The probes' crcs
    must be identical between the arms, the prefetcher must hit, and a
    cold start from the remote tier alone must rehydrate everything."""
    import torch
    from repro_torch.core.cost_model import CostModel
    from repro_torch.store.artifacts import ArtifactStore
    from repro_torch.store.prefetch import SpeculativePrefetcher
    from repro_torch.store.tiers import RemoteObjectStore

    os.makedirs(keep, exist_ok=True)
    art_bytes = _tier_table(0, n_rows, dev).nbytes()
    seq = _tier_probes()

    def arm(prefetch):
        disk = tempfile.mkdtemp(prefix="tier_disk_", dir=keep)
        rroot = tempfile.mkdtemp(prefix="tier_remote_", dir=keep)
        setup = ArtifactStore(root=disk, cache_bytes=4 * art_bytes,
                              host_bytes=4 * art_bytes, device=dev,
                              remote=RemoteObjectStore(rroot))
        for i in range(TIER_ARTS):
            setup.put(_tier_art(i), _tier_table(i, n_rows, dev))
        setup.flush()
        for i in range(TIER_ARTS):
            setup.demote_to_remote(_tier_art(i))
        setup.drop_caches()
        setup.close()
        store = ArtifactStore(
            root=disk, cache_bytes=4 * art_bytes, host_bytes=4 * art_bytes,
            device=dev, remote=RemoteObjectStore(
                rroot, latency_s=TIER_REMOTE_LATENCY_S,
                bandwidth_bytes_s=TIER_REMOTE_BW))
        pf = SpeculativePrefetcher(store, k=TIER_K) if prefetch else None
        total, crcs = 0.0, []
        for i, a in enumerate(seq):
            if i and i % TIER_FLUSH_EVERY == 0:
                store.drop_caches()
                if pf is not None:
                    pf.prefetch()
            t0 = time.perf_counter()
            t = store.get(_tier_art(a))
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
            crcs.append(table_crc(t))
            if pf is not None:
                pf.prefetch()
        cm = CostModel()
        cm.calibrate_io(store)
        res = dict(wall_s=total, crcs=crcs,
                   prefetch=pf.stats() if pf is not None else {},
                   host_demotions=store.stats["host_demotions"],
                   bw={"disk": cm.load_bw, **cm.tier_bw}, remote=rroot)
        store.close()
        return res

    off, on = arm(False), arm(True)
    check(off["crcs"] == on["crcs"], "phase 7 (b): probe crcs differ "
                                     "between the arms")
    hits = on["prefetch"].get("hits", 0)
    check(hits > 0, "phase 7 (b): the prefetcher never hit")
    fresh = tempfile.mkdtemp(prefix="tier_cold_", dir=keep)
    t0 = time.perf_counter()
    cold = ArtifactStore(root=fresh, cache_bytes=1 << 32, host_bytes=1 << 32,
                         device=dev, remote=RemoteObjectStore(
                             on["remote"], latency_s=TIER_REMOTE_LATENCY_S,
                             bandwidth_bytes_s=TIER_REMOTE_BW))
    names = [_tier_art(i) for i in range(TIER_ARTS)]
    check(all(cold.exists(n) for n in names),
          "phase 7 (b): cold start's remote index is incomplete")
    warmed = cold.prewarm(names)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    check(len(warmed) == TIER_ARTS, f"phase 7 (b): cold start rehydrated "
                                    f"{len(warmed)}/{TIER_ARTS}")
    cold.close()
    return dict(n_rows=n_rows, artifact_bytes=art_bytes,
                t_off_s=off["wall_s"], t_on_s=on["wall_s"],
                speedup_prefetch=off["wall_s"] / max(on["wall_s"], 1e-9),
                prefetch_hits=hits,
                prefetch_hit_rate=on["prefetch"].get("hit_rate", 0.0),
                prefetched=on["prefetch"].get("prefetched", 0),
                host_demotions=[off["host_demotions"], on["host_demotions"]],
                identical=True, cold_start_s=cold_s,
                bw={t: v for t, v in on["bw"].items()})


def tier_phase(dev, n_rows, seed, counters):
    """Phase 7: (a) and (b), the launch counters zeroed just before and
    read just after."""
    keep = tempfile.mkdtemp(prefix="restore_tiers_")
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    try:
        trip = tier_round_trip(dev, n_rows, seed, os.path.join(keep, "a"))
        trip["part_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        bench = tier_bench_arms(dev, 1 << TIER_LOG2_ROWS,
                                os.path.join(keep, "b"))
        bench["part_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    launches = {k: c.count for k, c in counters.items()}
    return dict(round_trip=trip, tier_bench=bench, launches=launches,
                phase_s=time.perf_counter() - t0)


# ------------------------------------------------- phase 8: training

TRAIN_BATCH, TRAIN_SEQ = 8, 64   # launch/train.py's defaults
GRAD_COSINE_MIN = 0.999
RESUME_ATOL = 1e-5
# the backward's error relative to each gradient's largest plain entry
# (the cuda tests' tolerances)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the bf16 backward against the plain version of its own arithmetic
# (mha_bwd_lse_ref), relative likewise, and the forward's row statistics
# (absolute): the cuda tests' tolerances
BWD_OWN_TOL = 1e-2
LSE_TOL = 1e-3
LONG_BATCH, LONG_SEQ = 8, 1024   # phase 8 (d); 4 x 1024 if 8 does not fit
LONG_DOCS, LONG_STEPS = 64, 3


def backward_checks(dev):
    """(a) The backward kernel against its plain version (autograd
    through mha_ref) on the cuda tests' grid, f32 and bf16, each call on
    the route bwd_plan names (its counter, and only its, moves); bf16
    also against the plain version of its own arithmetic from the
    forward's row statistics, and those against mha_lse_ref.  Returns the
    count, the worst error relative to each case's largest plain
    gradient, the route launches and the worst lse and own-arithmetic
    errors."""
    import torch
    from repro_torch.kernels.flash_attention import bench
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (mha_bwd_lse_ref,
                                                         mha_bwd_ref,
                                                         mha_lse_ref)

    def rel(got, want):
        return max(float((g.float() - w.float()).abs().max())
                   / max(float(w.float().abs().max()), 1e-30)
                   for g, w in zip(got, want))

    routes = {"sm90": fa.backward_sm90_launches,
              "simt": fa.backward_simt_launches}
    n, worst, lse_worst, own_worst = 0, {}, 0.0, 0.0
    launched = {k: 0 for k in routes}
    for dt in (torch.float32, torch.bfloat16):
        for args, kw in bench.backward_cases():
            q, k, v, do, kw2 = bench.backward_inputs(dev, dt, *args, kw)
            route = fa.bwd_plan(dt, args[-1])
            before = {r: c.count for r, c in routes.items()}
            name = str(dt).replace("torch.", "")
            if route == "sm90":
                out, lse = fa.mha_lse(q, k, v, **kw2)
                want_lse = mha_lse_ref(q, k, **kw2)
                check(torch.equal(torch.isinf(lse), torch.isinf(want_lse)),
                      f"flash_attention lse: rows with no key differ "
                      f"({args}, {kw})")
                fin = torch.isfinite(want_lse)
                lse_err = float((lse[fin] - want_lse[fin]).abs().max()) \
                    if bool(fin.any()) else 0.0
                check(lse_err < LSE_TOL, f"flash_attention lse differs from "
                                         f"plain ({args}, {kw}): {lse_err}")
                lse_worst = max(lse_worst, lse_err)
                got = fa.backward(q, k, v, out, do, lse=lse, **kw2)
                own = rel(got, mha_bwd_lse_ref(q, k, v, out, do, lse, **kw2))
                check(own < BWD_OWN_TOL, f"flash_attention_bwd differs from "
                                         f"its own arithmetic ({args}, "
                                         f"{kw}): {own}")
                own_worst = max(own_worst, own)
            else:
                got = fa.backward(q, k, v, fa.mha(q, k, v, **kw2), do, **kw2)
            moved = {r: c.count - before[r] for r, c in routes.items()}
            check(moved == {r: int(r == route) for r in routes},
                  f"flash_attention_bwd ({name}, D {args[-1]}) took "
                  f"{moved}, not the {route} route")
            for r in routes:
                launched[r] += moved[r]
            err = rel(got, mha_bwd_ref(q, k, v, do, **kw2))
            check(err < BWD_TOL[name], f"flash_attention_bwd differs from "
                                       f"plain ({name}, {args}, {kw}): {err}")
            worst[name] = max(worst.get(name, 0.0), err)
            n += 1
    torch.cuda.synchronize()
    return dict(cases=n, worst=worst, route_launches=launched,
                lse_max_abs_err=lse_worst, own_worst=own_worst)


def _grads(params):
    from repro_torch.tree import tree_leaves
    return [p.grad.detach().clone() for p in tree_leaves(params)]


def _leaf_paths(tree, prefix=""):
    """Leaf paths in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree)
                for q in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def qwen_training(dev, card, counters):
    """(b) qwen3-1.7b at its full config (bf16, remat on, random weights),
    batch 8 x seq 64 from the ReStore pipeline over
    synthetic_corpus(256, 65, vocab).  One step's gradient leaves against
    the same step with attention through the plain version; 4 steps on
    the pipeline's batches; 8 steps on one repeated batch; times, memory
    and one step under torch.profiler.  The launch counters are zeroed
    just before the 4 + 8 steps and read just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.restore import ReStore
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.train import train_step
    from repro_torch.models.api import build
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.train.data import (batches_from_table, run_pipeline,
                                        synthetic_corpus)
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_leaves

    cfg = get_config("qwen3-1.7b")
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.n_layers == 28,
          "phase 8 (b): qwen3-1.7b is not its full config")
    model = build(cfg, device=dev)
    store = ArtifactStore(device=dev)
    catalog = Catalog(store, device=dev)
    rs = ReStore(catalog, store, heuristic="aggressive", device=dev)
    corpus = synthetic_corpus(256, TRAIN_SEQ + 1, cfg.vocab_size, device=dev)
    table, rep = run_pipeline(rs, corpus)
    batches = batches_from_table(table, TRAIN_BATCH, TRAIN_SEQ)
    params = model.init(seed=0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    opt = AdamW()
    opt_state = opt.init(params)
    out = dict(n_params=n_params, pipeline_rows=int(table.num_valid()),
               pipeline_executed=rep.n_executed)

    def to_dev(b):
        return tuple(torch.from_numpy(x).to(dev) for x in b)

    # one step's gradients: the kernels against the plain attention
    tokens, labels = to_dev(next(batches))
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=dev)
    cos, worst, n = _grad_cosines(model, params, {
        "tokens": tokens, "labels": labels, "positions": pos})
    check(cos >= GRAD_COSINE_MIN, f"phase 8 (b): gradient cosine {cos} < "
                                  f"{GRAD_COSINE_MIN} ({worst})")
    out.update(grad_cosine_min=cos, grad_cosine_min_leaf=worst,
               grad_leaves=n)

    for c in counters.values():
        c.reset()
    # one step, the forward and backward launches counted apart
    step_launches = {}
    tokens, labels = to_dev(next(batches))
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    total, _ = model.loss_fn(params, {"tokens": tokens, "labels": labels,
                                      "positions": pos})
    step_launches["forward"] = fa.launches.count
    total.backward()
    step_launches["recomputed_by_remat"] = \
        fa.launches.count - step_launches["forward"]
    step_launches["backward"] = fa.backward_launches.count
    check(step_launches["forward"] == cfg.n_layers
          and step_launches["recomputed_by_remat"] == cfg.n_layers
          and step_launches["backward"] == cfg.n_layers,
          f"phase 8 (b): attention launches in one step {step_launches}")
    from repro_torch.tree import tree_map
    grads = tree_map(lambda p: p.grad, params)
    params, opt_state, gnorm = opt.update(grads, opt_state, params)
    del grads
    for p in tree_leaves(params):
        p.grad = None
    losses, gnorms, step_s = [float(total.detach())], [float(gnorm)], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        tokens, labels = to_dev(next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss, gnorm = train_step(
            model, opt, params, opt_state, tokens, labels)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        step_s.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"phase 8 (b): a loss or gnorm is not finite: {losses} {gnorms}")
    out.update(pipeline_losses=losses, pipeline_gnorms=gnorms)
    tokens, labels = to_dev(next(batches))
    rep_losses = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss, gnorm = train_step(
            model, opt, params, opt_state, tokens, labels)
        rep_losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        check(np.isfinite(rep_losses[-1]) and np.isfinite(float(gnorm)),
              "phase 8 (b): a loss on the repeated batch is not finite")
    check(rep_losses[-1] < rep_losses[0], f"phase 8 (b): the repeated "
                                          f"batch's loss did not fall: "
                                          f"{rep_losses}")
    launches = {k: c.count for k, c in counters.items()}
    med = float(np.median(step_s))
    out.update(repeated_batch_losses=rep_losses, step_s=step_s,
               step_s_median=med,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               one_step_attention_launches=step_launches,
               launches=launches)

    def one():
        nonlocal params, opt_state
        params, opt_state, _, _ = train_step(model, opt, params, opt_state,
                                             tokens, labels)
        torch.cuda.synchronize()
    wall_ms, busy_ms, top = profiled(one)
    out["profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms, top=top)
    out["long"] = long_context(dev, cfg, model, opt, params, opt_state,
                               counters)
    del params, opt_state
    return out


def long_context(dev, cfg, model, opt, params, opt_state, counters):
    """(d) (b)'s model and optimizer at LONG_BATCH x LONG_SEQ tokens from
    the ReStore pipeline over synthetic_corpus(LONG_DOCS, LONG_SEQ + 1,
    vocab), in a catalog of its own: one untimed step, LONG_STEPS timed
    ones (finite losses and gnorms), the launch counters zeroed just
    before those and read just after, then one step under
    torch.profiler.  A batch that does not fit in the card's memory is
    halved once, and the cut is recorded."""
    import torch
    from repro_torch.core.restore import ReStore
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.train import train_step
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.train.data import (batches_from_table, run_pipeline,
                                        synthetic_corpus)

    store = ArtifactStore(device=dev)
    catalog = Catalog(store, device=dev)
    rs = ReStore(catalog, store, heuristic="aggressive", device=dev)
    corpus = synthetic_corpus(LONG_DOCS, LONG_SEQ + 1, cfg.vocab_size,
                              device=dev)
    table, _ = run_pipeline(rs, corpus)
    rows = int(table.num_valid())

    def to_dev(b):
        return tuple(torch.from_numpy(x).to(dev) for x in b)

    batch, cut = LONG_BATCH, None
    try:
        batches = batches_from_table(table, batch, LONG_SEQ)
        params, opt_state, loss, gnorm = train_step(
            model, opt, params, opt_state, *to_dev(next(batches)))
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        batch, cut = LONG_BATCH // 2, f"batch {LONG_BATCH // 2} x " \
            f"{LONG_SEQ}: {LONG_BATCH} x {LONG_SEQ} did not fit"
        batches = batches_from_table(table, batch, LONG_SEQ)
        params, opt_state, loss, gnorm = train_step(
            model, opt, params, opt_state, *to_dev(next(batches)))
    losses, gnorms, step_s = [float(loss)], [float(gnorm)], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.reset()
    for _ in range(LONG_STEPS):
        tokens, labels = to_dev(next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss, gnorm = train_step(
            model, opt, params, opt_state, tokens, labels)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        step_s.append(time.perf_counter() - t0)
    launches = {k: c.count for k, c in counters.items()}
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"phase 8 (d): a loss or gnorm is not finite: {losses} {gnorms}")
    check(launches["flash_attention_bwd_sm90"] == LONG_STEPS * cfg.n_layers
          and launches["flash_attention_bwd_simt"] == 0,
          f"phase 8 (d): backward launches {launches}")
    med = float(np.median(step_s))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens, labels = to_dev(next(batches))

    def one():
        nonlocal params, opt_state
        params, opt_state, _, _ = train_step(model, opt, params, opt_state,
                                             tokens, labels)
        torch.cuda.synchronize()
    wall_ms, busy_ms, top, bwd_ms = profiled(
        one, share_of=("bwd_dq_kernel", "bwd_dkv_kernel"))
    return dict(batch=batch, seq=LONG_SEQ, cut=cut, pipeline_rows=rows,
                losses=losses, gnorms=gnorms, step_s=step_s,
                step_s_median=med, tokens_per_s=batch * LONG_SEQ / med,
                peak_memory_gb=peak, launches=launches,
                profile=dict(wall_ms=wall_ms, busy_ms=busy_ms, top=top,
                             attention_bwd_ms=bwd_ms,
                             attention_bwd_share=bwd_ms / max(busy_ms, 1e-9)))


def train_resume(dev, keep):
    """(c) launch/train.py at its "100m" preset (f32): killed at step 6
    in a subprocess (exit code 17, checkpoints every 3 steps), resumed,
    and held against an uninterrupted run."""
    from repro_torch.launch.train import train

    kw = dict(scale=100.0, steps=10, ckpt_every=3, quiet=True, device=dev)
    full = train(ckpt_dir=os.path.join(keep, "full"), **kw)
    killed = os.path.join(keep, "killed")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--scale", "100",
         "--steps", "10", "--ckpt-every", "3", "--simulate-failure", "6",
         "--ckpt-dir", killed, "--device", str(dev)], env=env,
        capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 17, f"phase 8 (c): the killed run exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
    resumed = train(ckpt_dir=killed, **kw)
    check(len(resumed) == 4, f"phase 8 (c): resumed {len(resumed)} steps")
    gap = max(abs(a - b) for a, b in zip(full[6:], resumed))
    check(gap <= RESUME_ATOL, f"phase 8 (c): resumed losses differ by {gap}")
    return dict(losses_full=full, losses_resumed=resumed, max_gap=gap,
                bitwise_equal=full[6:] == resumed, child_exit=proc.returncode,
                child_s=child_s)


def training_phase(dev, card, counters, against=None):
    """Phase 8: (a) the backward kernel (and, with ``against``, another
    checkout's timed beside it); (b) qwen3-1.7b training at full width,
    its own launch counts, and (d) at a long context; (c) the resume
    after a kill."""
    from repro_torch.kernels.flash_attention import bench

    t0 = time.perf_counter()
    checks = backward_checks(dev)
    other = None
    if against:
        from repro_torch.kernels.abtiming import load_other
        other = load_other(against, "kernels.flash_attention.ops")
    bwd_shapes = bench.backward_measurements(dev, other=other)
    for k in bwd_shapes:
        _check_backward_shape("phase 8 (a)", k)
    qwen = qwen_training(dev, card, counters)
    keep = tempfile.mkdtemp(prefix="restore_train_")
    try:
        resume = train_resume(dev, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    return dict(backward_cases=checks["cases"],
                backward_worst=checks["worst"], backward_checks=checks,
                backward_shapes=bwd_shapes, qwen=qwen, resume=resume,
                phase_s=time.perf_counter() - t0)


def report_training(training, card):
    """Phase 8's log lines and its launch checks; returns (b)'s record."""
    qw, rz = training["qwen"], training["resume"]
    bc = training["backward_checks"]
    log(f"phase 8 (a): flash_attention_bwd on {training['backward_cases']} "
        f"cases within {BWD_TOL} of the plain version (worst, of the "
        f"largest plain gradient: {training['backward_worst']}); route "
        f"launches {bc['route_launches']} (bf16 on sm90, f32 on simt); "
        f"bf16 within {BWD_OWN_TOL} of its own arithmetic (worst "
        f"{bc['own_worst']:.3g}); the forward's lse within {LSE_TOL} of "
        f"the plain version (worst {bc['lse_max_abs_err']:.3g})")
    for k in training["backward_shapes"]:
        log(f"phase 8 (a): {k['shape']}: graph-replayed kernel "
            f"{k['ms']:.4f} ms, library {k['library_ms']:.4f} ms (SDPA "
            f"backward), bound {k['bound_ms']:.4f} ms ({k['bound_by']}); "
            f"eager: kernel {k['eager_ms']:.4f} ms, library "
            f"{k['library_eager_ms']:.4f} ms, plain {k['plain_ms']:.4f} "
            f"ms; other checkout's backward "
            f"{'not timed' if k['other_ms'] is None else '%.4f ms' % k['other_ms']}"
            f"; gradients' max_abs_err {k['max_abs_err']} (worst "
            f"{k['max_err_of_max']:.3g} of the largest, within "
            f"{BWD_TOL['bfloat16']}), forward's {k['o_max_abs_err']} "
            f"(within {FA_TOL['bfloat16']}), lse {k['lse_max_abs_err']:.3g}"
            f" [{card}]")
    log(f"phase 8 (b): qwen3-1.7b full config ({qw['n_params']} parameters,"
        f" bf16, remat), batch {TRAIN_BATCH} x seq {TRAIN_SEQ} from the "
        f"pipeline ({qw['pipeline_rows']} rows): gradient cosine against "
        f"plain attention >= {qw['grad_cosine_min']:.6f} over "
        f"{qw['grad_leaves']} leaves (least: {qw['grad_cosine_min_leaf']});"
        f" losses "
        f"{qw['pipeline_losses']}, gnorms {qw['pipeline_gnorms']}; "
        f"repeated batch {qw['repeated_batch_losses'][0]:.4f} -> "
        f"{qw['repeated_batch_losses'][-1]:.4f} [{card}]")
    log(f"phase 8 (b): step {qw['step_s_median'] * 1e3:.1f} ms (median of "
        f"{len(qw['step_s'])}), {qw['tokens_per_s']:.1f} tokens/s, peak "
        f"memory {qw['peak_memory_gb']:.2f} GB; attention launches in one "
        f"step {qw['one_step_attention_launches']} [{card}]")
    pr = qw["profile"]
    log(f"phase 8 (b): one step under torch.profiler: wall "
        f"{pr['wall_ms']:.1f} ms, device busy {pr['busy_ms']:.1f} ms "
        f"({100 * pr['busy_ms'] / pr['wall_ms']:.1f}%) [{card}]")
    for name, ms, count in pr["top"]:
        log(f"phase 8 (b):   {ms:9.3f} ms  x{count:<5} {name[:90]}")
    log(f"phase 8 (b): kernel launches on the training path: "
        f"{qw['launches']}")
    log(f"phase 8 (c): 100m preset killed at step 6 (exit "
        f"{rz['child_exit']}, {rz['child_s']:.1f} s) and resumed: losses "
        f"{rz['losses_resumed']} against {rz['losses_full'][6:]}, max gap "
        f"{rz['max_gap']:.3g}, bitwise equal {rz['bitwise_equal']} [{card}]")
    lc = qw["long"]
    if lc["cut"]:
        log(f"CUT: phase 8 (d) at {lc['cut']}")
    log(f"phase 8 (d): qwen3-1.7b full config, batch {lc['batch']} x seq "
        f"{lc['seq']} from the pipeline ({lc['pipeline_rows']} rows): step "
        f"{lc['step_s_median'] * 1e3:.1f} ms (median of "
        f"{len(lc['step_s'])}), {lc['tokens_per_s']:.1f} tokens/s, peak "
        f"memory {lc['peak_memory_gb']:.2f} GB; losses {lc['losses']}, "
        f"gnorms {lc['gnorms']}; launches {lc['launches']} [{card}]")
    lp = lc["profile"]
    log(f"phase 8 (d): one step under torch.profiler: wall "
        f"{lp['wall_ms']:.1f} ms, device busy {lp['busy_ms']:.1f} ms "
        f"({100 * lp['busy_ms'] / lp['wall_ms']:.1f}%), attention backward "
        f"{lp['attention_bwd_ms']:.1f} ms "
        f"({100 * lp['attention_bwd_share']:.1f}% of the device time) "
        f"[{card}]")
    for name, ms, count in lp["top"]:
        log(f"phase 8 (d):   {ms:9.3f} ms  x{count:<5} {name[:90]}")
    log(f"phase 8: took {training['phase_s']:.1f} s")
    check(qw["launches"]["flash_attention_bwd"] > 0,
          "flash_attention_bwd was never launched on the training path")
    check(qw["launches"]["flash_attention"] > 0,
          "flash_attention was never launched on the training path")
    check(qw["launches"]["flash_attention_bwd_sm90"]
          == qw["launches"]["flash_attention_bwd"]
          and qw["launches"]["flash_attention_bwd_simt"] == 0,
          f"phase 8 (b): a bf16 backward off the tensor-core route: "
          f"{qw['launches']}")
    return qw


# ------------------------------------------ phase 9: the model families

FAMILY_SEED = 9
# (a) minicpm3-4b, whole: MLA's usual traffic (model-configs guide,
# workloads.md): long prompts asked a few times, with short answers
MLA_ARCH = "minicpm3-4b"
MLA_PREFIX, MLA_SUFFIX, MLA_DECODE = 4096, 16, 2
MLA_REQUESTS, MLA_PROMPTS = 16, 4
# (b) qwen3-moe-235b-a22b at full width, its depth cut to MOE_LAYERS of 94
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8
MOE_PREFILL, MOE_BATCH, MOE_CONTEXT = 2048, 8, 32
MOE_PREFIX, MOE_REQUESTS, MOE_PROMPTS = 1024, 8, 2
# (c) qwen2-vl-72b at full width, its depth cut to VL_LAYERS of 80: a
# 32 x 32-patch image, then text
VL_ARCH, VL_LAYERS = "qwen2-vl-72b", 8
VL_PREFILL, VL_DECODE, VL_PATCHES = 2048, 4, 32
# A sublayer's output on the kernel path against its plain version fed
# the same input, over the plain output's largest magnitude: bf16 keeps
# 8 bits (2**-8 = 0.0039 relative), the kernel rounds P to bf16 before
# P V and the plain version does not, so the attention output may differ
# in its last bits before the output projection sums them; 2e-2 allows
# five bf16 steps of the largest entry.
SUBLAYER_RTOL = 2e-2


@contextlib.contextmanager
def plain_kernels():
    """Inside the block, the model's attention and MoE slots run through
    their plain versions on the card: the wrappers ``ops.mha`` and
    ``ops.scatter_slots`` are swapped for ``mha_ref`` and
    ``partition_scatter_ref`` (same signatures), the oracle of the
    teacher-forced checks."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.radix_partition import ops as rp
    from repro_torch.kernels.radix_partition.ref import (
        partition_scatter_ref)
    saved = fa.mha, rp.scatter_slots
    fa.mha, rp.scatter_slots = mha_ref, partition_scatter_ref
    try:
        yield
    finally:
        fa.mha, rp.scatter_slots = saved


@contextlib.contextmanager
def recorded_sublayers(rec):
    """Inside the block, every attention, Mamba and MoE sublayer the
    model runs appends (kind, its inputs, its output, its (slots,
    dropped) for the MoE or its new state for Mamba) to ``rec``; Mamba's
    incoming state is copied, since the model writes the new one over
    it."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    saved = LM.attn_forward, LM.moe_forward, L.moe_slots, LM.mamba_forward
    slots = []

    def attn(cfg, p, x, positions, cache=None, cache_index=None):
        o, nc = saved[0](cfg, p, x, positions, cache, cache_index)
        rec.append(("attn", (p, x, positions, cache, cache_index), o, None))
        return o, nc

    def moe(cfg, p, x):
        o, aux = saved[1](cfg, p, x)
        rec.append(("moe", (p, x), o, slots[-1]))
        return o, aux

    def moe_slots(expert_ids, n_experts, cap):
        slots.append(saved[2](expert_ids, n_experts, cap))
        return slots[-1]

    def mamba(cfg, p, x, state=None):
        kept = None if state is None else tuple(t.clone() for t in state)
        o, nc = saved[3](cfg, p, x, state)
        rec.append(("mamba", (p, x, kept), o, nc))
        return o, nc
    LM.attn_forward, LM.moe_forward, L.moe_slots, LM.mamba_forward = \
        attn, moe, moe_slots, mamba
    try:
        yield
    finally:
        LM.attn_forward, LM.moe_forward, L.moe_slots, LM.mamba_forward = \
            saved


@contextlib.contextmanager
def counted_drops():
    """Inside the block, each MoE dispatch's count of dropped entries
    (a 0-d tensor on the device, read after the block) is appended to
    the list it yields."""
    from repro_torch.models import layers as L
    saved, drops = L.moe_slots, []

    def moe_slots(expert_ids, n_experts, cap):
        slot, dropped = saved(expert_ids, n_experts, cap)
        drops.append(dropped)
        return slot, dropped
    L.moe_slots = moe_slots
    try:
        yield drops
    finally:
        L.moe_slots = saved


def replay_plain(cfg, rec, what):
    """Each recorded sublayer again through its plain version, fed the
    kernel path's own input (so the MoE's routing is the same by
    construction): MoE slots bit-equal and the same drops, every output
    within SUBLAYER_RTOL of the plain one, Mamba's new h within
    MAMBA_H_RTOL of ``plain_mamba``'s.  Returns the worst relative errors
    and how many MoE outputs were bit-equal."""
    import torch
    from repro_torch.models import layers as L
    worst = {kind: 0.0 for kind, *_ in rec}
    exact = dropped = 0
    with plain_kernels():
        for i, (kind, args, out, slots) in enumerate(rec):
            if kind == "mamba":
                want, (_, want_h) = plain_mamba(cfg, *args)
                h = slots[1]
                h_rel = float((h - want_h).abs().max()) / max(
                    float(want_h.abs().max()), 1e-30)
                check(h_rel <= MAMBA_H_RTOL, f"{what}: Mamba sublayer {i}:"
                                             f" h differs by {h_rel} of its "
                                             "largest entry")
                worst["mamba h"] = max(worst.get("mamba h", 0.0), h_rel)
            elif kind == "attn":
                p, x, positions, cache, index = args
                cache = None if cache is None else tuple(
                    c.clone() for c in cache)
                want, _ = L.attn_forward(cfg, p, x, positions, cache, index)
            else:
                got_slots = []
                saved = L.moe_slots

                def moe_slots(*a):
                    got_slots.append(saved(*a))
                    return got_slots[-1]
                L.moe_slots = moe_slots
                try:
                    want, _ = L.moe_forward(cfg, *args)
                finally:
                    L.moe_slots = saved
                check(torch.equal(got_slots[0][0], slots[0])
                      and int(got_slots[0][1]) == int(slots[1]),
                      f"{what}: MoE sublayer {i}: slots differ from the "
                      "plain version's")
                dropped += int(slots[1])
                exact += int(torch.equal(out, want))
            rel = float((out.float() - want.float()).abs().max()) / max(
                float(want.float().abs().max()), 1e-30)
            worst[kind] = max(worst[kind], rel)
            check(rel <= SUBLAYER_RTOL, f"{what}: {kind} sublayer {i} "
                                        f"differs by {rel} of its largest "
                                        "entry")
    return dict(sublayers=len(rec), worst_rel_err=worst,
                moe_bit_equal=exact, dropped=dropped, rtol=SUBLAYER_RTOL)


def _peak_gb():
    import torch
    return torch.cuda.max_memory_allocated() / 1e9


def _launches(counters):
    """(counts, flash_attention's launches by (route, D_qk, D_v))."""
    from repro_torch.kernels.flash_attention import ops as fa
    return ({k: c.count for k, c in counters.items()},
            _by_dims(fa.launches))


def _by_dims(counter, causal=False):
    """A flash-attention launch counter's tally as {"route D_qk/D_v": n},
    with " causal" or " not causal" after the dims if ``causal``."""
    out = {}
    for (r, d, dv, c), n in counter.shapes.items():
        key = f"{r} {d}/{dv}" + (
            (" causal" if c else " not causal") if causal else "")
        out[key] = out.get(key, 0) + n
    return out


def _reset(counters):
    for c in counters.values():
        c.reset()


def _family_model(arch, dev, seed, n_layers=None, what="phase 9"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = build(cfg, device=dev)
    params = base.init(seed)
    torch.cuda.synchronize()
    n = sum(int(t.numel()) for t in tree_leaves(params))
    nbytes = sum(int(t.numel()) * t.element_size()
                 for t in tree_leaves(params))
    log(f"{what}: {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}): {n} parameters"
        f", {nbytes / 1e9:.2f} GB, made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, base, params, dict(params=n, param_gb=nbytes / 1e9)


def _arm_numbers(model, arm, n_decode):
    """Synced ms per prefill and decode call, and tokens/s over the
    arm's wall."""
    tokens = sum(s.prefilled_tokens + n_decode for s in arm["stats"])
    return dict(wall_s=arm["wall"],
                prefill_ms=float(np.mean(model.wall_s["prefill"]) * 1e3),
                decode_ms=float(np.mean(model.wall_s["decode"]) * 1e3),
                tokens_per_s=tokens / arm["wall"],
                p50_ms=float(np.percentile(arm["laps"], 50) * 1e3))


def mla_family(dev, card, seed, counters):
    """(a) minicpm3-4b at its full config, nothing cut: the attention
    kernel at (D_qk, D_v) = (96, 64) against the plain version at the
    stream's shapes, then ServeSession with and without a KVRepository
    over the same 16 requests, every reused request's logits held to
    the cold arm's."""
    import torch
    from repro_torch.kernels.flash_attention.bench import mla_measurements
    from repro_torch.serve.kv_repo import KVRepository
    from repro_torch.serve.session import ServeSession
    from repro_torch.tree import tree_leaves

    shapes = mla_measurements(dev)
    for k in shapes:
        check(k["max_abs_err"] < FA_TOL["bfloat16"]
              and k["err_of_row_rms"] < FA_REL_TOL,
              f"phase 9 (a): flash_attention at {k['shape']}: "
              f"{k['max_abs_err']} absolute, {k['err_of_row_rms']} of the "
              "row's RMS")
        log(f"phase 9 (a): {k['shape']} ({k['form']} form): kernel "
            f"{k['ms']:.4f} ms (eager {k['eager_ms']:.4f}), plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}); max_abs_err "
            f"{k['max_abs_err']}, of the row's RMS {k['err_of_row_rms']} "
            f"[{card}]")
    torch.cuda.empty_cache()
    cfg, base, params, rec = _family_model(MLA_ARCH, dev, seed)
    model = _recording(base, sync=True)
    rng = np.random.default_rng(seed)
    prefixes, ranks, prompts = _stream(cfg, rng, MLA_PROMPTS, MLA_REQUESTS,
                                       MLA_PREFIX, MLA_SUFFIX)
    lens = dict(prefix=MLA_PREFIX, suffix=MLA_SUFFIX, n_decode=MLA_DECODE)
    _reset(counters)
    model.calls = model.captures = 0
    # gradients off, as a server runs: the decode step replays its graphs
    with torch.no_grad():
        cold = serve_arm(model, params, prompts, None, rng, cfg, **lens)
        cold_n = _arm_numbers(model, cold, MLA_DECODE)
        kv = KVRepository(model_version=cfg.name)
        warm = serve_arm(model, params, prompts, kv, rng, cfg, **lens)
        warm_n = _arm_numbers(model, warm, MLA_DECODE)
    launches, by_dims = _launches(counters)
    calls, captures = model.calls, model.captures
    # each arm's session captured the decode step once
    check(captures == 2, f"phase 9 (a): {captures} decode graph captures "
          "over two sessions")
    agree = Agreement(LOGIT_ATOL_BF16)
    for i, (c, w) in enumerate(zip(cold["logs"], warm["logs"])):
        agree.add(c, w, f"phase 9 (a) request {i}")
    reused = sum(s.reused_tokens for s in warm["stats"])
    frac = reused / sum(s.reused_tokens + s.prefilled_tokens
                        for s in warm["stats"])
    check(frac > 0.5, f"phase 9 (a): reused-token fraction {frac}")
    check(launches["flash_attention"] == cfg.n_layers * calls
          and by_dims == {"sm90 96/64": cfg.n_layers * calls},
          f"phase 9 (a): flash_attention launches {by_dims} over {calls} "
          f"calls of {cfg.n_layers} layers")
    max_len = MLA_PREFIX + MLA_SUFFIX + MLA_DECODE
    latent = sum(t.numel() * t.element_size() for t in tree_leaves(
        base.init_cache(1, max_len))) / max_len
    m = cfg.mla
    dense = cfg.n_layers * cfg.n_heads * (
        m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) * 2
    snap = kv.store.nbytes(kv.repository.entries[0].artifact)
    # one warm request under the profiler, its session's decode graph
    # captured by a request before it
    sess = ServeSession(model, params, max_len=max_len, kv=kv,
                        every_k=EVERY_K)

    def ask():
        with torch.no_grad():
            sess.serve(np.concatenate(
                [prefixes[0], rng.integers(1, cfg.vocab_size, MLA_SUFFIX)]),
                MLA_DECODE)
    ask()
    check(model.captures == 3, f"phase 9 (a): {model.captures - 2} "
          "captures before the profiled request")
    wall_ms, busy_ms, top, fa_ms = profiled(
        ask, share_of=("fa_sm90_kernel", "fa_merge_kernel"))
    check(model.captures == 3, "phase 9 (a): the profiled request captured")
    rec.update(
        requests=MLA_REQUESTS, prompts=MLA_PROMPTS, prefix=MLA_PREFIX,
        suffix=MLA_SUFFIX, decode=MLA_DECODE, zipf=ZIPF_A,
        noreuse=cold_n, reuse=warm_n, reused_token_frac=frac,
        model_calls=calls, decode_graph_captures=captures,
        launches=launches, flash_by_dims=by_dims,
        latent_bytes_per_token=latent, decompressed_kv_bytes_per_token=dense,
        snapshot_bytes=snap, snapshot_bytes_per_token=snap / max_len,
        peak_gb=_peak_gb(), attention=shapes,
        warm_request_profile=dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                  flash_ms=fa_ms, top=top),
        **agree.summary())
    log(f"phase 9 (a): {cfg.name} stream of {MLA_REQUESTS} requests over "
        f"{MLA_PROMPTS} prefixes of {MLA_PREFIX} tokens: no reuse {cold_n},"
        f" reuse {warm_n}; reused-token fraction {frac:.3f}; logits "
        f"{agree.summary()}; peak {rec['peak_gb']:.2f} GB [{card}]")
    log(f"phase 9 (a): latent cache {latent:.0f} B per token against "
        f"{dense} B for a decompressed K and V ({dense / latent:.1f}x); "
        f"a stored snapshot {snap} B for {max_len} slots "
        f"({snap / max_len:.0f} B per slot, logits included)")
    log(f"phase 9 (a): flash_attention launches {by_dims} over {calls} "
        f"prefills and decode steps of {cfg.n_layers} layers; one warm "
        f"request under torch.profiler: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), attention "
        f"{fa_ms:.3f} ms [{card}]")
    del sess, kv, model, params, base, cold, warm
    torch.cuda.empty_cache()
    return rec


def moe_family(dev, card, seed, counters):
    """(b) qwen3-moe-235b-a22b at full width, 8 of its 94 layers, all
    128 experts a layer: each sublayer of a 2048-token prefill and of a
    batched decode of 8 rows teacher-forced against its plain version;
    a ServeSession stream with and without reuse; the dropless smoke
    config on the card against the CPU."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.serve.kv_repo import KVRepository

    cfg, base, params, rec = _family_model(MOE_ARCH, dev, seed, MOE_LAYERS)
    model = _recording(base, sync=True)
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size

    def toks(*shape):
        return torch.from_numpy(rng.integers(1, V, shape)).to(dev)
    _reset(counters)
    model.calls = 0
    # check 1: teacher-forced sublayers, at the prefill (cap 160) and at
    # a batched decode step (cap 8) after an 8 x 32 prefill
    forced = {}
    for label, b, run in (
            (f"prefill 1 x {MOE_PREFILL}", 1, lambda c: model.prefill(
                params, {"tokens": toks(1, MOE_PREFILL), "positions":
                         torch.arange(MOE_PREFILL, device=dev)}, c)),
            ("decode B=8", MOE_BATCH, None)):
        cache = base.init_cache(b, MOE_PREFILL if run else MOE_CONTEXT + 1)
        if run is None:
            model.prefill(params, {"tokens": toks(b, MOE_CONTEXT),
                                   "positions": torch.arange(
                                       MOE_CONTEXT, device=dev)}, cache)

            def run(c):
                return model.decode_step(params, {
                    "tokens": toks(b, 1), "positions": torch.arange(
                        MOE_CONTEXT, MOE_CONTEXT + 1, device=dev)},
                    c, MOE_CONTEXT)
        sub = []
        with recorded_sublayers(sub):
            run(cache)
        forced[label] = replay_plain(cfg, sub, f"phase 9 (b) {label}")
        forced[label]["cap"] = L.moe_capacity(
            cfg, b * (MOE_PREFILL if label.startswith("prefill") else 1))
        del sub, cache
    # check 2: the serving stream, reuse off and on
    prefixes, ranks, prompts = _stream(cfg, rng, MOE_PROMPTS, MOE_REQUESTS,
                                       MOE_PREFIX, SUFFIX_LEN)
    lens = dict(prefix=MOE_PREFIX, suffix=SUFFIX_LEN, n_decode=N_DECODE)
    with counted_drops() as drops:
        cold = serve_arm(model, params, prompts, None, rng, cfg, **lens)
    cold_n = _arm_numbers(model, cold, N_DECODE)
    cold_n["dropped"] = int(sum(drops))
    kv = KVRepository(model_version=cfg.name)
    with counted_drops() as drops:
        warm = serve_arm(model, params, prompts, kv, rng, cfg, **lens)
    warm_n = _arm_numbers(model, warm, N_DECODE)
    warm_n["dropped"] = int(sum(drops))
    launches, by_dims = _launches(counters)
    scatter_shapes = [list(s) + [n] for s, n in sorted(
        counters["partition_scatter"].shapes.items())]
    calls = model.calls
    check(launches["partition_scatter"] == cfg.n_layers * calls > 0,
          f"phase 9 (b): partition_scatter launches "
          f"{launches['partition_scatter']} over {calls} model calls")
    gap, flips = 0.0, 0
    for c, w in zip(cold["logs"], warm["logs"]):
        for a, b in zip(c, w):
            gap = max(gap, float((a - b).abs().max()))
            if int(torch.argmax(a)) != int(torch.argmax(b)):
                flips += 1
                break
    reused = sum(s.reused_tokens for s in warm["stats"])
    frac = reused / sum(s.reused_tokens + s.prefilled_tokens
                        for s in warm["stats"])
    check(frac > 0.5, f"phase 9 (b): reused-token fraction {frac}")
    sess_kv = kv
    from repro_torch.serve.session import ServeSession
    sess = ServeSession(model, params, max_len=MOE_PREFIX + SUFFIX_LEN
                        + N_DECODE, kv=sess_kv, every_k=EVERY_K)
    wall_ms, busy_ms, top = profiled(lambda: sess.serve(np.concatenate(
        [prefixes[0], rng.integers(1, V, SUFFIX_LEN)]), N_DECODE))
    rec.update(layers_cut=f"{cfg.n_layers} of 94", forced=forced,
               requests=MOE_REQUESTS, prompts=MOE_PROMPTS, prefix=MOE_PREFIX,
               noreuse=cold_n, reuse=warm_n, reused_token_frac=frac,
               max_logit_gap_between_arms=gap, token_flips=flips,
               model_calls=calls, launches=launches, flash_by_dims=by_dims,
               partition_scatter_shapes=scatter_shapes, peak_gb=_peak_gb(),
               warm_request_profile=dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                         top=top))
    for label, f in forced.items():
        log(f"phase 9 (b): {label} teacher-forced, cap {f['cap']}: "
            f"{f['sublayers']} sublayers, MoE slots bit-equal to "
            f"partition_scatter_ref's, {f['dropped']} entries dropped, the "
            f"same in both; worst relative errors {f['worst_rel_err']} "
            f"(rtol {SUBLAYER_RTOL}), MoE outputs bit-equal "
            f"{f['moe_bit_equal']} [{card}]")
    log(f"phase 9 (b): stream of {MOE_REQUESTS} requests over "
        f"{MOE_PROMPTS} prefixes of {MOE_PREFIX} tokens ({cfg.n_layers} of "
        f"94 layers, so the host's share of a call is larger than at full "
        f"depth): no reuse {cold_n}, reuse {warm_n}; reused-token fraction "
        f"{frac:.3f}; largest logit gap between the arms {gap} ({flips} "
        f"requests with a differing token; not held: at capacity factor "
        f"1.25 a token's output depends on the other tokens of its call); "
        f"peak {rec['peak_gb']:.2f} GB [{card}]")
    log(f"phase 9 (b): launches {launches}; flash_attention by route and "
        f"dims {by_dims}; partition_scatter by [S, N, P, bucket, count] "
        f"{scatter_shapes}; one warm request under torch.profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%) [{card}]")
    del sess, sess_kv, kv, model, params, base, cold, warm
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = serving_card_vs_cpu(dev, seed, MOE_ARCH,
                                             "phase 9 (b) smoke")
    log(f"phase 9 (b): dropless smoke config, card vs cpu: "
        f"{rec['card_vs_cpu']}")
    return rec


def _vl_positions(n, dev):
    """(3, 1, n) M-RoPE positions: a VL_PATCHES x VL_PATCHES-patch image
    (temporal 0, height = row, width = column), then text whose three
    axes all count on from VL_PATCHES."""
    import torch
    i = torch.arange(n, device=dev)
    img = i < VL_PATCHES ** 2
    text = VL_PATCHES + i - VL_PATCHES ** 2
    pos = torch.stack([torch.where(img, 0, text),
                       torch.where(img, i // VL_PATCHES, text),
                       torch.where(img, i % VL_PATCHES, text)])
    return pos[:, None].to(torch.int32)


def vl_family(dev, card, seed, counters):
    """(c) qwen2-vl-72b at full width, 8 of its 80 layers: a prefill of
    2048 embeddings with 3-axis positions and 4 decode steps through
    ``Model.prefill`` / ``Model.decode_step``, held to the port's own full
    forward over the same 2052 positions with plain attention; the smoke
    config on the card against the CPU."""
    import torch
    from repro_torch.models import lm as LM

    cfg, model, params, rec = _family_model(VL_ARCH, dev, seed, VL_LAYERS)
    n = VL_PREFILL + VL_DECODE
    g = torch.Generator(device=dev).manual_seed(seed)
    embeds = torch.randn((1, n, cfg.d_model), generator=g,
                         device=dev).to(torch.bfloat16)
    pos = _vl_positions(n, dev)

    def request():
        cache = model.init_cache(1, n)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {
            "embeds": embeds[:, :VL_PREFILL],
            "positions": pos[..., :VL_PREFILL]}, cache)
        out = [logits[:, -1].float()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(VL_PREFILL, n):
            logits, cache = model.decode_step(params, {
                "embeds": embeds[:, t:t + 1],
                "positions": pos[..., t:t + 1]}, cache, t)
            out.append(logits[:, -1].float())
        torch.cuda.synchronize()
        return out, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
    request()                            # warm
    _reset(counters)
    got, prefill_ms, decode_ms = request()
    launches, by_dims = _launches(counters)
    check(by_dims == {"sm90 128/128": cfg.n_layers * (1 + VL_DECODE)},
          f"phase 9 (c): flash_attention launches {by_dims}")
    with plain_kernels(), torch.no_grad():
        full, _ = LM.lm_forward(cfg, params, embeds, pos)
    err = max(float((g_ - full[:, VL_PREFILL - 1 + i].float()).abs().max())
              for i, g_ in enumerate(got))
    check(err <= LOGIT_ATOL_BF16, f"phase 9 (c): prefill and decode logits "
                                  f"differ from the full forward by {err}")
    del full
    wall_ms, busy_ms, top = profiled(request)
    rec.update(layers_cut=f"{cfg.n_layers} of 80", prefill=VL_PREFILL,
               decode_steps=VL_DECODE, prefill_ms=prefill_ms,
               decode_ms=decode_ms / VL_DECODE,
               tokens_per_s=n / ((prefill_ms + decode_ms) / 1e3),
               max_abs_logit_err_vs_full_forward=err, atol=LOGIT_ATOL_BF16,
               launches=launches, flash_by_dims=by_dims, peak_gb=_peak_gb(),
               request_profile=dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                    top=top))
    log(f"phase 9 (c): {cfg.name}, {cfg.n_layers} of 80 layers: prefill of "
        f"{VL_PREFILL} embeddings (3-axis positions) {prefill_ms:.1f} ms, "
        f"decode {rec['decode_ms']:.1f} ms a step, {rec['tokens_per_s']:.1f}"
        f" tokens/s; logits against the full forward with plain attention "
        f"within {err} (atol {LOGIT_ATOL_BF16}); flash_attention {by_dims}; "
        f"peak {rec['peak_gb']:.2f} GB; one request under torch.profiler: "
        f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%) [{card}]")
    del model, params, embeds
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = embeds_card_vs_cpu(dev, seed)
    log(f"phase 9 (c): smoke config, card vs cpu: {rec['card_vs_cpu']}")
    return rec


def embeds_card_vs_cpu(dev, seed):
    """qwen2-vl's smoke config (f32) on the card and on the CPU from the
    same parameters and embeddings: a prefill and 3 decode steps, logits
    within LOGIT_ATOL_F32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.tree import tree_map
    cfg = get_config(VL_ARCH, smoke=True)
    cpu, card = build(cfg, device="cpu"), build(cfg, device=dev)
    p_cpu = cpu.init(seed)
    p_card = tree_map(lambda t: t.to(dev), p_cpu)
    rng = np.random.default_rng(seed)
    e = torch.from_numpy(rng.standard_normal((2, 27, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(27, dtype=torch.int32)[None, None].expand(3, 2, 27)
    logs = []
    for m, p, d in ((cpu, p_cpu, "cpu"), (card, p_card, dev)):
        cache = m.init_cache(2, 27)
        lg, cache = m.prefill(p, {"embeds": e[:, :24].to(d),
                                  "positions": pos[..., :24].to(d)}, cache)
        out = [lg[:, -1]]
        for t in range(24, 27):
            lg, cache = m.decode_step(p, {"embeds": e[:, t:t + 1].to(d),
                                          "positions": pos[..., t:t + 1]
                                          .to(d)}, cache, t)
            out.append(lg[:, -1])
        logs.append(torch.stack(out).float().cpu())
    err = float((logs[0] - logs[1]).abs().max())
    check(err <= LOGIT_ATOL_F32, f"phase 9 (c) smoke: card vs cpu logits "
                                 f"{err}")
    return dict(steps=4, max_abs_logit_err=err, atol=LOGIT_ATOL_F32)


def families_phase(dev, card, seed, counters):
    """Phase 9: one model at a time, each freed before the next; the
    launch counters zeroed before each model's main path and read after
    it (the kernel-against-plain checks fall outside those windows)."""
    t0 = time.perf_counter()
    out = {"mla": mla_family(dev, card, seed, counters)}
    out["moe"] = moe_family(dev, card, seed, counters)
    out["vl"] = vl_family(dev, card, seed, counters)
    out["launches"] = {k: sum(out[f]["launches"][k] for f in ("mla", "moe",
                                                               "vl"))
                       for k in counters}
    out["phase_s"] = time.perf_counter() - t0
    return out


def scatter_measurement(dev, n, cap, experts):
    """The partition-scatter kernel at a MoE dispatch's shape: ``n``
    expert ids drawn at zipf 1.2 over ``experts`` experts
    (radix_partition/bench.py's ``moe_case``), capacity ``cap``, against
    its plain version, with torch.sort(stable=True) as the library call
    and the bound of 9 bytes an id (the int64 lane and the mask read
    once)."""
    import torch
    from repro_torch.kernels.radix_partition import ops as rp
    from repro_torch.kernels.radix_partition.bench import moe_case
    from repro_torch.kernels.radix_partition.ref import (
        partition_scatter_ref)
    h, v = moe_case(dev, n, experts=experts)
    slot, ovf = rp.scatter_slots(h, v, n_parts=experts, bucket=cap)
    s_r, o_r = partition_scatter_ref(h, v, n_parts=experts, bucket=cap)
    err = int((slot.long() - s_r.long()).abs().max())
    check(err == 0 and torch.equal(ovf, o_r),
          f"partition_scatter differs from plain at N={n} P={experts} "
          f"cap {cap} ({err})")
    b, by = bound_ms(9 * n, 0)
    return dict(shape=f"N={n} expert ids, P={experts}, bucket={cap}, "
                      f"overflow {int(ovf)}",
                max_abs_err=float(err),
                ms=cuda_ms(lambda: rp.scatter_slots(
                    h, v, n_parts=experts, bucket=cap)),
                plain_ms=cuda_ms(lambda: partition_scatter_ref(
                    h, v, n_parts=experts, bucket=cap), iters=3),
                library_ms=cuda_ms(lambda: torch.sort(h, stable=True)),
                bound_ms=b, bound_by=by)


def moe_scatter_measurement(dev):
    """The partition-scatter kernel at qwen3-moe's dispatch shapes
    (radix_partition/bench.py's MOE_SHAPES): 16384 expert ids over 128
    experts at capacity 160, and (``decode``) 64 ids at capacity 8."""
    from repro_torch.kernels.radix_partition.bench import (MOE_EXPERTS,
                                                           MOE_SHAPES)
    out = scatter_measurement(dev, *MOE_SHAPES["moe prefill T=2048"],
                              MOE_EXPERTS)
    out["decode"] = scatter_measurement(dev, *MOE_SHAPES["moe decode B=8"],
                                        MOE_EXPERTS)
    return out


# --------------------------------------- phase 10: the recurrent mixers

# (a) xlstm-350m whole: multi-turn chat, the reuse a recurrent state
# admits (a stored state is exact-length): each later turn is the
# previous prompt, its greedy tokens and CHAT_NEW new ones
XLSTM_ARCH = "xlstm-350m"
CHAT_CONVERSATIONS, CHAT_TURNS = 4, 3
# the chat's model at one superblock (7 mLSTM and 1 sLSTM layers) of the
# 24 layers, so the whole script keeps within its limit (a CUT line);
# phase 12 (b) trains all 24
CHAT_LAYERS = 8
CHAT_FIRST, CHAT_NEW, CHAT_DECODE = 1024, 14, 2
# (b) jamba-1.5-large-398b at full width: one 8-layer period holds four
# MoE layers of 16 x 3 x 8192 x 24576 bf16 weights (~77 GB), so the
# period's three sublayer kinds are built one at a time
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_PREFILL, JAMBA_BATCH, JAMBA_CONTEXT = 2048, 8, 256
JAMBA_SMOKE_PREFIX, JAMBA_SMOKE_SUFFIX = 32, 8
# Mamba's final h on the port's path (chunks of 256, a doubling scan
# inside each) against a step-by-step float32 recurrence from the same
# inputs, over the largest |h|: both are float32 and differ only in how
# the products of exp(dt A) associate (~1e-6 relative a step; the decay
# keeps the error from adding up over 2048 steps)
MAMBA_H_RTOL = 1e-4
# the TPU kernels on Jamba's path: attention at 64 query / 8 KV heads x
# 128 (label, B, Sq, kv_len, q_offset, causal), fused at the prefill and
# split at the decode; the MoE dispatch's partition scatter over 16
# experts, top-2: (N = T k ids, capacity) at the prefill and the decode
JAMBA_HEADS = (64, 8, 128)
JAMBA_ATTN_SHAPES = [
    ("Jamba prefill", 1, JAMBA_PREFILL, [JAMBA_PREFILL], [0], True),
    ("Jamba decode B=8", JAMBA_BATCH, 1, [JAMBA_CONTEXT + 1] * JAMBA_BATCH,
     [JAMBA_CONTEXT] * JAMBA_BATCH, True)]
JAMBA_EXPERTS = 16
JAMBA_SCATTER_SHAPES = [(2 * JAMBA_PREFILL, 320), (2 * JAMBA_BATCH, 8)]


def jamba_attention_measurements(dev):
    """The bf16 attention kernel at Jamba's shapes (``JAMBA_ATTN_SHAPES``:
    64 query and 8 KV heads x 128) against its plain version, with
    device times from CUDA-graph replays (``ms``) and eager, the plain
    version's, scaled_dot_product_attention's (a yardstick) and the
    bound, as ``flash_measurements``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.bench import (
        eager_ms, graph_ms, serving_case)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    hq, hkv, d = JAMBA_HEADS
    g = torch.Generator(device=dev).manual_seed(12)
    out = []
    for label, b, sq, kv_len, q_off, causal in JAMBA_ATTN_SHAPES:
        slots = max(kv_len)
        q, k, v, kvl, qo, mask = serving_case(
            dev, g, b, sq, kv_len, q_off, causal, hq, hkv, d, slots)
        kw = dict(causal=causal, q_offset=qo)
        got = fa.mha(q, k, v, kvl, **kw).float()
        want = mha_ref(q, k, v, kvl, **kw).float()
        err = float((got - want).abs().max())
        rms = want.pow(2).mean(-1).sqrt()
        rel = float(((got - want).abs().amax(-1) / rms).max())
        del got, want, rms

        def kernel():
            return fa.mha(q, k, v, kvl, **kw)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        bound, by = _flash_bound(b, hq, hkv, sq, d, kv_len, q_off, causal, 2)
        plan = fa.plan(q.dtype, "cuda", b, hq, hkv, sq, slots)
        out.append(dict(
            shape=f"{label}: B={b} Hq={hq} Hkv={hkv} Sq={sq} D={d} bf16, "
                  f"cache {slots}, kv_len {kv_len[0]}, q_offset {q_off[0]}",
            form="split" if plan.scratch else "fused",
            max_abs_err=err, err_of_row_rms=rel,
            ms=graph_ms(kernel), eager_ms=eager_ms(kernel),
            plain_ms=eager_ms(lambda: mha_ref(q, k, v, kvl, **kw), 2),
            library_ms=graph_ms(library), bound_ms=bound, bound_by=by))
        del q, k, v, mask
    return out


def plain_mamba(cfg, p, x, state=None):
    """Mamba-1 (``models/ssm.py::mamba_forward``'s function, the
    reference's prefill restart at h = 0 included) with its scan as a
    step-by-step float32 recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t
    x_t, y_t = C_t . h_t, and the depthwise conv as K shifted products:
    the oracle of phase 10 (b)."""
    import torch
    import torch.nn.functional as F
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_in, n = s_cfg.expand * d, s_cfg.d_state
    r = s_cfg.dt_rank or -(-d // 16)
    k = s_cfg.d_conv
    xz = x @ p["in_proj"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    pad = xi.new_zeros((b, k - 1, d_in)) if state is None else \
        state[0].to(xi.dtype)
    xp = torch.cat([pad, xi], 1)
    xc = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(k)) + p["conv_b"]
    xc = F.silu(xc)
    dbc = xc @ p["x_proj"]
    bm, cm = dbc[..., r:r + n].float(), dbc[..., r + n:].float()
    dt = F.softplus((dbc[..., :r] @ p["dt_proj"]).float()
                    + p["dt_bias"].float())
    a = -torch.exp(p["A_log"])
    xf = xc.float()
    h = state[1] if s == 1 and state is not None else \
        xf.new_zeros((b, d_in, n))
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h + \
            dt[:, t, :, None] * bm[:, t, None, :] * xf[:, t, :, None]
        ys.append((h * cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + p["D"] * xf
    out = (y * F.silu(z.float())).to(x.dtype)
    return out @ p["out_proj"], (xp[:, -(k - 1):], h)


def _chat_arm(model, params, firsts, news, kv, turns=None, warm=None):
    """The chat through ``ServeSession.serve`` in turn-major order, one
    short serve off the clock first.  Without ``turns`` each later turn
    is built from this arm's own greedy tokens; with them (the no-reuse
    arm's prompts) the arm is teacher-forced on the same prompts."""
    import torch
    from repro_torch.serve.session import ServeSession
    max_len = CHAT_FIRST + (CHAT_TURNS - 1) * (CHAT_DECODE + CHAT_NEW) \
        + 2 * (CHAT_DECODE + CHAT_NEW)
    sess = ServeSession(model, params, max_len=max_len, kv=kv)
    sess.serve(warm, CHAT_DECODE)
    torch.cuda.synchronize()
    model.log.clear()
    for v in (*model.host_s.values(), *model.wall_s.values()):
        v.clear()
    prompts = [np.asarray(f, np.int32) for f in firsts]
    built, toks, stats, logs = [], [], [], []
    t0 = time.perf_counter()
    for turn in range(CHAT_TURNS):
        if turns is not None:
            prompts = turns[turn]
        built.append(list(prompts))
        outs = []
        for c, p in enumerate(prompts):
            out, st = sess.serve(p, CHAT_DECODE)
            outs.append(out)
            toks.append(out.tolist())
            stats.append(st)
            logs.append(list(model.log))
            model.log.clear()
        if turns is None and turn < CHAT_TURNS - 1:
            prompts = [np.concatenate([p, o, news[c][turn]]).astype(np.int32)
                       for c, (p, o) in enumerate(zip(prompts, outs))]
    wall = time.perf_counter() - t0
    prefill_tokens = [s.prefilled_tokens for s in stats]
    return dict(sess=sess, turns=built, toks=toks, stats=stats, logs=logs,
                wall=wall, prefill_ms=list(model.wall_s["prefill"]),
                prefill_tokens=prefill_tokens,
                decode_ms=float(np.mean(model.wall_s["decode"]) * 1e3))


def xlstm_family(dev, card, seed, counters):
    """(a) xlstm-350m at its full width, CHAT_LAYERS deep: the chat with
    reuse off and on
    (every reuse-arm logit within LOGIT_ATOL_BF16 of the no-reuse
    arm's), the same turns through submit/run with 4 slots, one warm
    turn under torch.profiler, the smoke config card vs CPU."""
    import torch
    from repro_torch.serve.kv_repo import KVRepository
    from repro_torch.serve.session import ServeSession

    log(f"CUT: phase 10 (a) chats with {XLSTM_ARCH} at {CHAT_LAYERS} of "
        "its 24 layers (one superblock), so the script keeps within its "
        "time limit; phase 12 (b) trains all 24")
    cfg, base, params, rec = _family_model(XLSTM_ARCH, dev, seed,
                                           n_layers=CHAT_LAYERS,
                                           what="phase 10")
    model = _recording(base, sync=True)
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    firsts = [rng.integers(1, V, CHAT_FIRST) for _ in range(
        CHAT_CONVERSATIONS)]
    news = [[rng.integers(1, V, CHAT_NEW) for _ in range(CHAT_TURNS)]
            for _ in range(CHAT_CONVERSATIONS)]
    warm = rng.integers(1, V, 64)
    _reset(counters)
    model.calls = 0
    cold = _chat_arm(model, params, firsts, news, None, warm=warm)
    kv = KVRepository(model_version=cfg.name)
    reuse = _chat_arm(model, params, firsts, news, kv, turns=cold["turns"],
                      warm=warm)
    calls = model.calls
    agree = Agreement(LOGIT_ATOL_BF16)
    for i, (c, w) in enumerate(zip(cold["logs"], reuse["logs"])):
        agree.add(c, w, f"phase 10 (a) request {i}")
    changed = sum(a != b for a, b in zip(cold["toks"], reuse["toks"]))
    reused = sum(s.reused_tokens for s in reuse["stats"])
    frac = reused / sum(s.reused_tokens + s.prefilled_tokens
                        for s in reuse["stats"])
    check(frac > 0.6, f"phase 10 (a): reused-token fraction {frac}")
    check(all(s.reused_tokens == 0 for s in cold["stats"]),
          "phase 10 (a): the no-reuse arm reused")
    # the same turns through submit/run, 4 slots, a fresh repository
    batch = ServeSession(model, params, n_slots=CHAT_CONVERSATIONS,
                         max_len=reuse["sess"].max_len,
                         kv=KVRepository(model_version=cfg.name))
    agree_b = Agreement(LOGIT_ATOL_BF16)
    i = 0
    for turn in cold["turns"]:
        tickets = [batch.submit(p, CHAT_DECODE) for p in turn]
        batch.run()
        for tk in tickets:
            agree_b.add_tokens(cold["logs"][i], cold["toks"][i],
                               tk.result().tolist(),
                               f"phase 10 (a) submit/run request {i}")
            i += 1
    check(batch.stats["reused_tokens"] == reused,
          f"phase 10 (a): submit/run reused {batch.stats['reused_tokens']}"
          f" tokens, serve {reused}")
    launches, by_dims = _launches(counters)
    check(sum(launches.values()) == 0, f"phase 10 (a): xlstm-350m launched "
                                       f"kernels {launches}")
    # a warm fourth turn of conversation 1 timed, and one of
    # conversation 0 under the profiler (whose own cost per launch
    # stretches the wall)
    nxt = [np.concatenate([cold["turns"][-1][c], cold["toks"][
        c - CHAT_CONVERSATIONS], news[c][CHAT_TURNS - 1]]).astype(np.int32)
        for c in (0, 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reuse["sess"].serve(nxt[1], CHAT_DECODE)
    torch.cuda.synchronize()
    turn_ms = (time.perf_counter() - t0) * 1e3
    wall_ms, busy_ms, top = profiled(
        lambda: reuse["sess"].serve(nxt[0], CHAT_DECODE))
    state_bytes = kv.store.nbytes(kv.repository.entries[0].artifact)

    def per_token(arm, sel):
        ms = [m * 1e3 / n for m, n in zip(arm["prefill_ms"],
                                          arm["prefill_tokens"]) if sel(n)]
        return float(np.mean(ms)) if ms else None
    rec.update(
        conversations=CHAT_CONVERSATIONS, turns=CHAT_TURNS,
        first=CHAT_FIRST, new=CHAT_NEW, decode=CHAT_DECODE,
        noreuse=dict(wall_s=cold["wall"], decode_ms=cold["decode_ms"],
                     prefill_ms_per_token=per_token(cold, lambda n: n > 0)),
        reuse=dict(wall_s=reuse["wall"], decode_ms=reuse["decode_ms"],
                   cold_prefill_ms_per_token=per_token(
                       reuse, lambda n: n >= CHAT_FIRST),
                   suffix_prefill_ms_per_token=per_token(
                       reuse, lambda n: 0 < n < CHAT_FIRST)),
        reused_token_frac=frac, greedy_requests_changed=changed,
        submit_run=agree_b.summary(), model_calls=calls,
        launches=launches, flash_by_dims=by_dims, peak_gb=_peak_gb(),
        state_bytes=state_bytes,
        warm_turn_ms=turn_ms,
        warm_turn_profile=dict(wall_ms=wall_ms, busy_ms=busy_ms, top=top),
        **agree.summary())
    log(f"phase 10 (a): {cfg.name} chat, {CHAT_CONVERSATIONS} "
        f"conversations x {CHAT_TURNS} turns ({CHAT_FIRST}-token first "
        f"turn, + {CHAT_DECODE} greedy + {CHAT_NEW} new a turn): no reuse "
        f"{rec['noreuse']}, reuse {rec['reuse']}; reused-token fraction "
        f"{frac:.3f}; logits {agree.summary()}; requests whose greedy "
        f"tokens changed {changed}; submit/run (4 slots) "
        f"{agree_b.summary()}; a stored state {state_bytes} B; peak "
        f"{rec['peak_gb']:.2f} GB [{card}]")
    log(f"phase 10 (a): a warm fourth turn (reuses {len(nxt[0]) - 16} "
        f"tokens, prefills 16, decodes {CHAT_DECODE}) {turn_ms:.1f} ms; "
        f"another under torch.profiler: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / turn_ms:.1f}% of the unprofiled"
        f" turn, {100 * busy_ms / wall_ms:.1f}% of the profiled) [{card}]")
    for name, ms, count in top:
        log(f"phase 10 (a):   {ms:9.3f} ms  x{count:<5} {name[:90]}")
    del batch, kv, model, params, base, cold, reuse
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = serving_card_vs_cpu(dev, seed, XLSTM_ARCH,
                                             "phase 10 (a) smoke")
    log(f"phase 10 (a): smoke config, card vs cpu: {rec['card_vs_cpu']}")
    return rec


def jamba_sublayers(dev, card, seed, counters):
    """(b) Jamba's three sublayer kinds at full width, one at a time,
    each teacher-forced against its plain version at a 2048-token
    prefill and at an 8-row decode step after a 256-token prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models.api import build
    from repro_torch.tree import tree_leaves

    cfg = get_config(JAMBA_ARCH)
    kinds = LM.slot_kinds(cfg)
    model = build(cfg, device=dev)     # for its caches; no weights
    g = torch.Generator(device=dev).manual_seed(seed)
    log(f"CUT: phase 10 (b) {cfg.name} runs its period's sublayer kinds "
        f"{sorted(set(kinds))} at full width one at a time, not its "
        f"{cfg.n_layers} layers: one 8-layer period's four MoE layers "
        "alone hold ~77 GB of bf16 weights")
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    merges0 = counters["flash_attention_merge"].count
    out, sublayer_calls = {}, {"attn": 0, "moe": 0}
    for kind in sorted(set(kinds), key=kinds.index):
        j = kinds.index(kind)
        p = LM._init_sublayer(cfg, g, *kind)
        nbytes = sum(int(t.numel()) * t.element_size()
                     for t in tree_leaves(p))
        res = {"param_gb": nbytes / 1e9}
        for label, b, s in ((f"prefill 1 x {JAMBA_PREFILL}", 1,
                             JAMBA_PREFILL), ("decode B=8", JAMBA_BATCH,
                                              JAMBA_CONTEXT)):
            x = (torch.randn((b, s + 1, cfg.d_model), generator=g,
                             device=dev) * 0.5).to(getattr(torch, cfg.dtype))
            cache = tuple(c[0] for c in model.init_cache(
                b, s + 1)[f"slot{j}"])
            pos = torch.arange(s + 1, device=dev)
            decode = label.startswith("decode")
            steps = [(x[:, :s], pos[:s], 0)] + (
                [(x[:, s:], pos[s:], s)] if decode else [])
            sub = []
            with torch.no_grad():
                for k, (xs, ps, index) in enumerate(steps):
                    # the decode's prefill fills the cache unrecorded
                    with recorded_sublayers(sub if k == len(steps) - 1
                                            else []):
                        _o, _a, nc = LM._apply_sublayer(cfg, p, kind, xs, ps,
                                                        cache, index)
                    if kind[0] in LM.RECURRENT:
                        for dst, src in zip(cache, nc):
                            dst.copy_(src)
                    sublayer_calls["attn"] += kind[0] == "attn"
                    sublayer_calls["moe"] += kind[1] == "moe"
                res[label] = replay_plain(cfg, sub, f"phase 10 (b) {kind} "
                                                    f"{label}")
                res[label]["cap"] = L.moe_capacity(cfg, b * (
                    1 if decode else s)) if kind[1] == "moe" else None
            del x, cache, sub
        out[f"{kind[0]}+{kind[1]}"] = res
        log(f"phase 10 (b): {kind} at full width ({nbytes / 1e9:.2f} GB): "
            f"{res} [{card}]")
        del p
        torch.cuda.empty_cache()
    launches, by_dims = _launches(counters)
    merges = counters["flash_attention_merge"].count - merges0
    scatter_shapes = [list(s) + [n] for s, n in sorted(
        counters["partition_scatter"].shapes.items())]
    check(launches["flash_attention"] == sublayer_calls["attn"]
          and by_dims == {"sm90 128/128": sublayer_calls["attn"]},
          f"phase 10 (b): flash_attention launches {by_dims} over "
          f"{sublayer_calls['attn']} attention calls")
    check(launches["partition_scatter"] == sublayer_calls["moe"] > 0,
          f"phase 10 (b): partition_scatter launches "
          f"{launches['partition_scatter']} over {sublayer_calls['moe']} "
          "MoE calls")
    return dict(sublayers=out, launches=launches, flash_by_dims=by_dims,
                flash_merge_launches=merges,
                partition_scatter_shapes=scatter_shapes,
                peak_gb=_peak_gb(), cut=f"sublayer kinds of the period, "
                                        f"not {cfg.n_layers} layers")


def jamba_reuse_fault(dev, seed):
    """Jamba's smoke config (f32) on the card: a prompt served cold, and
    the same prompt after its 32-token prefix was stored, so that its
    8-token suffix prefill starts Mamba's scan at h = 0 (the reference's
    fault, ``repro/models/ssm.py:124``).  Reports the gap between the
    two requests' logits; not held equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    from repro_torch.serve.kv_repo import KVRepository
    from repro_torch.serve.session import ServeSession

    cfg = get_config(JAMBA_ARCH, smoke=True)
    model = _recording(build(cfg, device=dev))
    params = model.init(seed)
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, JAMBA_SMOKE_PREFIX)
    prompt = np.concatenate([prefix, rng.integers(1, cfg.vocab_size,
                                                  JAMBA_SMOKE_SUFFIX)])
    max_len = len(prompt) + 4
    cold = ServeSession(model, params, max_len=max_len)
    cold_toks, _ = cold.serve(prompt, 4)
    cold_logs = list(model.log)
    warm = ServeSession(model, params, max_len=max_len, kv=KVRepository())
    warm.serve(prefix, 4)
    model.log.clear()
    warm_toks, st = warm.serve(prompt, 4)
    check(st.reused_tokens == JAMBA_SMOKE_PREFIX,
          f"phase 10 (b) smoke: the suffix reused {st.reused_tokens}")
    # the suffix prefill's logits (later steps decode from the tokens
    # each run chose)
    gap = float((cold_logs[0] - model.log[0]).abs().max())
    largest = float(cold_logs[0].abs().max())
    del model, params
    torch.cuda.empty_cache()
    return dict(prefix=JAMBA_SMOKE_PREFIX, suffix=JAMBA_SMOKE_SUFFIX,
                prefill_logit_gap=gap, largest_logit=largest,
                tokens_equal=cold_toks.tolist() == warm_toks.tolist())


def jamba_family(dev, card, seed, counters):
    """(b) Jamba: the kernels at its shapes against their plain versions,
    the sublayers at full width, the smoke config card vs CPU and its
    reuse fault on the card."""
    rec = dict(attention=jamba_attention_measurements(dev),
               scatter=[scatter_measurement(dev, n, cap, JAMBA_EXPERTS)
                        for n, cap in JAMBA_SCATTER_SHAPES])
    for k in rec["attention"]:
        check(k["max_abs_err"] < FA_TOL["bfloat16"]
              and k["err_of_row_rms"] < FA_REL_TOL,
              f"phase 10 (b): flash_attention at {k['shape']}: "
              f"{k['max_abs_err']} absolute, {k['err_of_row_rms']} of the "
              "row's RMS")
        log(f"phase 10 (b): {k['shape']} ({k['form']} form): kernel "
            f"{k['ms']:.4f} ms (eager {k['eager_ms']:.4f}), plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}); max_abs_err "
            f"{k['max_abs_err']}, of the row's RMS {k['err_of_row_rms']} "
            f"[{card}]")
    for m in rec["scatter"]:
        log(f"phase 10 (b): partition_scatter at {m['shape']}: kernel "
            f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, library "
            f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.6f} ms "
            f"({m['bound_by']}) [{card}]")
    rec.update(jamba_sublayers(dev, card, seed, counters))
    log(f"phase 10 (b): launches {rec['launches']}; flash_attention by "
        f"route and dims {rec['flash_by_dims']} ({rec['flash_merge_launches']}"
        f" split-form merges); partition_scatter by [S, N, P, bucket, "
        f"count] {rec['partition_scatter_shapes']}; peak "
        f"{rec['peak_gb']:.2f} GB [{card}]")
    rec["card_vs_cpu"] = serving_card_vs_cpu(dev, seed, JAMBA_ARCH,
                                             "phase 10 (b) smoke")
    rec["reuse_fault"] = jamba_reuse_fault(dev, seed)
    log(f"phase 10 (b): smoke config, card vs cpu: {rec['card_vs_cpu']}; "
        f"the reuse fault on the card (a {JAMBA_SMOKE_SUFFIX}-token suffix "
        f"after a reused {JAMBA_SMOKE_PREFIX}-token prefix restarts "
        f"Mamba's scan): {rec['reuse_fault']} (reported, not held)")
    return rec


def recurrent_phase(dev, card, seed, counters):
    """Phase 10: xlstm-350m, then Jamba, one model at a time; the launch
    counters zeroed before each main path and read after it."""
    t0 = time.perf_counter()
    out = {"xlstm": xlstm_family(dev, card, seed, counters)}
    out["jamba"] = jamba_family(dev, card, seed, counters)
    out["launches"] = {k: out["xlstm"]["launches"][k]
                       + out["jamba"]["launches"][k] for k in counters}
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------ phase 11: the encoder-decoder family

ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_SEED = 11
# (a) 8 utterances served as one batch, then one alone: 1024 encoder
# frames of seeded embeddings each (the speech frontend is a stub in the
# reference), a 16-token decoder prompt and 64 greedy tokens
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 8, 1024, 16, 64
# (b) seamless trained at 8 x (1024 frames, 256 decoder tokens); (c)
# minicpm3-4b's MLA trained at 4 x 1024 tokens from the ReStore pipeline;
# each 1 + TRAIN11_STEPS steps of AdamW on one repeated batch (the loss
# must fall), the batch halved once if it does not fit
ENCDEC_TRAIN_TOKENS = 256
MLA_TRAIN_BATCH, MLA_TRAIN_SEQ = 4, 1024
TRAIN11_STEPS = 3


@contextlib.contextmanager
def recorded_encdec_attention(rec):
    """Inside the block, every attention call of ``models/encdec.py``
    appends (kind, its inputs, its output) to ``rec``; kind is "encoder
    self", "decoder self" or "cross"."""
    from repro_torch.models import encdec as ED
    saved = ED.attn_forward

    def attn(cfg, p, x, positions, cache=None, cache_index=None,
             causal=True, kv_override=None):
        o, nc = saved(cfg, p, x, positions, cache, cache_index, causal,
                      kv_override)
        kind = "cross" if kv_override is not None else \
            "decoder self" if causal else "encoder self"
        rec.append((kind, (p, x, positions, cache, cache_index, causal,
                           kv_override), o))
        return o, nc
    ED.attn_forward = attn
    try:
        yield
    finally:
        ED.attn_forward = saved


def replay_encdec_attention(cfg, rec, what):
    """Each recorded attention sublayer again with attention through
    ``mha_ref``, fed the kernel path's own input (a decoder
    self-attention's cache as it stood after the call: the keys the call
    wrote are rewritten with the same values, and keys written by later
    steps lie past its kv_len): outputs within SUBLAYER_RTOL of the plain
    one's largest entry.  Returns the count and the worst error by
    kind."""
    from repro_torch.models import layers as L
    worst = {}
    with plain_kernels():
        for i, (kind, args, out) in enumerate(rec):
            p, x, positions, cache, index, causal, kv = args
            cache = None if cache is None else tuple(
                c.clone() for c in cache)
            want, _ = L.attn_forward(cfg, p, x, positions, cache, index,
                                     causal, kv)
            rel = float((out.float() - want.float()).abs().max()) / max(
                float(want.float().abs().max()), 1e-30)
            worst[kind] = max(worst.get(kind, 0.0), rel)
            check(rel <= SUBLAYER_RTOL, f"{what}: {kind} attention call "
                                        f"{i} differs by {rel} of its "
                                        "largest entry")
    return dict(calls=len(rec), worst_rel_err=worst, rtol=SUBLAYER_RTOL)


def encdec_greedy(model, params, emb, prompt, n_new):
    """Encode ``emb`` and prefill ``prompt``, then ``n_new - 1`` decode
    steps of greedy tokens, each call synced and timed: (tokens (B,
    n_new), each step's logits (B, n_new, V) float32, prefill s, decode
    s per step, the cache)."""
    import torch
    dev = emb.device
    b, t, _ = emb.shape
    s = prompt.shape[1]
    cache = model.init_cache(b, s + n_new, t)
    batch = {"enc_embeds": emb,
             "enc_positions": torch.arange(t, dtype=torch.int32, device=dev),
             "tokens": prompt,
             "positions": torch.arange(s, dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    steps, decode_s = [logits[:, -1]], []
    for i in range(n_new - 1):
        pos = s + i
        tok = steps[-1].argmax(-1)[:, None]
        t0 = time.perf_counter()
        logits, cache = model.decode_step(
            params, {"tokens": tok, "positions": torch.full(
                (1,), pos, dtype=torch.int32, device=dev)}, cache, pos)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        steps.append(logits[:, -1])
    logits = torch.stack(steps, 1)
    return logits.argmax(-1), logits, prefill_s, decode_s, cache


def encdec_serving(dev, card, seed, counters):
    """(a) seamless-m4t-medium whole (bf16, random weights): 8 utterances
    as one batch, then one alone, each encoded, prefilled and decoded
    greedily; every step's logits against the teacher-forced
    ``encdec_forward`` over the same tokens, and every attention call of
    the batch of 8 against its plain version.  The launch counters are
    zeroed just before the two runs and read just after them."""
    import torch
    from repro_torch.kernels.flash_attention import bench
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import encdec as ED

    shapes = bench.encdec_measurements(dev)
    for k in shapes:
        check(k["max_abs_err"] < FA_TOL["bfloat16"]
              and k["err_of_row_rms"] < FA_REL_TOL,
              f"phase 11 (a): flash_attention at {k['shape']}: "
              f"{k['max_abs_err']} absolute, {k['err_of_row_rms']} of the "
              "row's RMS")
        log(f"phase 11 (a): {k['shape']} ({k['form']} form): kernel "
            f"{k['ms']:.4f} ms (eager {k['eager_ms']:.4f}), plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}); max_abs_err "
            f"{k['max_abs_err']}, of the row's RMS {k['err_of_row_rms']} "
            f"[{card}]")
    torch.cuda.empty_cache()
    cfg, model, params, rec = _family_model(ENCDEC_ARCH, dev, seed,
                                            what="phase 11 (a)")
    # the config's count leaves out the decoder's cross-attention norms
    # and the two final norms: 12 + 2 vectors of d_model
    rec["config_total_params"] = cfg.total_params()
    check(rec["params"] == cfg.total_params() + (cfg.n_layers + 2)
          * cfg.d_model,
          f"phase 11 (a): {rec['params']} parameters, the config counts "
          f"{cfg.total_params()}")
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model),
                      generator=g, device=dev).to(torch.bfloat16)
    prompt = torch.randint(1, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_PROMPT),
                           generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()
    calls, runs = [], {}
    with torch.no_grad():
        for b in (ENCDEC_BATCH, 1):    # off the clock: first calls' setup
            encdec_greedy(model, params, emb[:b], prompt[:b], 2)
        _reset(counters)
        with recorded_encdec_attention(calls):
            runs[ENCDEC_BATCH] = encdec_greedy(model, params, emb, prompt,
                                               ENCDEC_NEW)
        runs[1] = encdec_greedy(model, params, emb[:1], prompt[:1],
                                ENCDEC_NEW)
        torch.cuda.synchronize()
        launches, by_dims = _launches(counters)
        by_causal = _by_dims(fa.launches, causal=True)
        merges = fa.merge_launches.count
        peak = _peak_gb()
        out = dict(rec, frames=ENCDEC_FRAMES, prompt=ENCDEC_PROMPT,
                   new_tokens=ENCDEC_NEW, launches=launches,
                   flash_by_dims=by_dims, flash_by_dims_causal=by_causal,
                   flash_merge_launches=merges, peak_gb=peak,
                   attention=shapes)
        per_run = cfg.n_encoder_layers + 2 * cfg.n_layers * ENCDEC_NEW
        dims = f"sm90 {cfg.head_dim}/{cfg.head_dim}"
        check(by_causal == {
            f"{dims} not causal": 2 * (cfg.n_encoder_layers + cfg.n_layers
                                       * ENCDEC_NEW),
            f"{dims} causal": 2 * cfg.n_layers * ENCDEC_NEW}
            and launches["flash_attention"] == 2 * per_run,
            f"phase 11 (a): flash_attention launches {by_causal}")
        for b, (toks, logits, pre_s, dec_s, cache) in runs.items():
            seq = torch.cat([prompt[:b], toks[:, :-1]], 1)
            n = seq.shape[1]
            full, _ = ED.encdec_forward(
                cfg, params, emb[:b], seq,
                torch.arange(ENCDEC_FRAMES, dtype=torch.int32, device=dev),
                torch.arange(n, dtype=torch.int32, device=dev))
            err = float((logits - full[:, ENCDEC_PROMPT - 1:]).abs().max())
            del full
            check(err <= LOGIT_ATOL_BF16, f"phase 11 (a): batch {b}: step "
                                          f"logits {err} from the "
                                          "teacher-forced forward")
            check(tuple(cache["cross"][0].shape) == (
                cfg.n_layers, b, cfg.n_kv_heads, ENCDEC_FRAMES,
                cfg.head_dim), f"phase 11 (a): cross cache "
                               f"{tuple(cache['cross'][0].shape)}")
            enc_pos = torch.arange(ENCDEC_FRAMES, dtype=torch.int32,
                                   device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ED.encode(cfg, params, emb[:b], enc_pos)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
            dec = float(np.median(dec_s))
            wall = pre_s + sum(dec_s)
            out[f"batch_{b}"] = dict(
                encode_ms=enc_s * 1e3, prefill_ms=pre_s * 1e3,
                decode_ms_median=dec * 1e3, decode_ms_mean=float(
                    np.mean(dec_s)) * 1e3, wall_s=wall,
                tokens_per_s=b * ENCDEC_NEW / wall,
                decode_tokens_per_s=b / dec, max_abs_logit_err=err,
                atol=LOGIT_ATOL_BF16)
            log(f"phase 11 (a): {cfg.name} batch {b} x {ENCDEC_FRAMES} "
                f"frames, {ENCDEC_PROMPT}-token prompt, {ENCDEC_NEW} greedy"
                f" tokens: encode {enc_s * 1e3:.1f} ms, prefill (encode "
                f"included) {pre_s * 1e3:.1f} ms, decode {dec * 1e3:.2f} ms"
                f" a step (median of {len(dec_s)}), "
                f"{b * ENCDEC_NEW / wall:.1f} tokens/s; every step's logits "
                f"within {err} of the teacher-forced forward (atol "
                f"{LOGIT_ATOL_BF16}) [{card}]")
        out["replay"] = replay_encdec_attention(cfg, calls, "phase 11 (a)")
        del calls
        toks, logits, _, _, cache = runs[ENCDEC_BATCH]
        last = ENCDEC_PROMPT + ENCDEC_NEW - 2
        tok = toks[:, -2:-1]
        pos = torch.full((1,), last, dtype=torch.int32, device=dev)

        def one():
            model.decode_step(params, {"tokens": tok, "positions": pos},
                              cache, last)
            torch.cuda.synchronize()
        profiled(one)      # the profiler's own first-use setup
        wall_ms, busy_ms, top, fa_ms = profiled(
            one, share_of=("fa_sm90_kernel", "fa_merge_kernel"))
    out["decode_profile"] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                 flash_ms=fa_ms, top=top)
    log(f"phase 11 (a): every attention call of the batch of "
        f"{ENCDEC_BATCH} against its plain version: {out['replay']}")
    log(f"phase 11 (a): flash_attention launches {by_causal} "
        f"({merges} split-form merges) over both runs; peak "
        f"{peak:.2f} GB; one decode step of the batch of {ENCDEC_BATCH} "
        f"under torch.profiler: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), attention "
        f"{fa_ms:.3f} ms [{card}]")
    del runs, emb
    torch.cuda.empty_cache()
    return out, model, params


def _zero_grads(params, on=True):
    from repro_torch.tree import tree_leaves
    for p in tree_leaves(params):
        p.requires_grad_(on)
        p.grad = None


def _leaf_cosines(a, b, paths, block=1 << 26):
    """Per leaf, the cosine between two gradient lists, summed in float64
    over blocks of ``block`` elements (a float copy of a whole MoE expert
    stack would not fit beside two sets of its gradients): (worst, its
    leaf, how many leaves are bit-equal)."""
    import torch
    cos, equal = {}, 0
    for path, g, w in zip(paths, a, b):
        g, w = g.reshape(-1), w.reshape(-1)
        dot = gg = ww = 0.0
        same = True
        for i in range(0, g.numel(), block):
            x, y = g[i:i + block], w[i:i + block]
            same = same and torch.equal(x, y)
            x, y = x.double(), y.double()
            dot += float(x @ y)
            gg += float(x @ x)
            ww += float(y @ y)
        equal += same
        den = (gg * ww) ** 0.5
        cos[path] = 1.0 if gg == ww == 0 else dot / max(den, 1e-300)
    worst = min(cos, key=cos.get)
    return cos[worst], worst, equal


def _grad_cosines(model, params, batch):
    """Per leaf, the cosine between the gradient with the attention
    kernels and with attention through ``mha_ref`` (autograd of the
    plain version), the same step: (worst, its leaf, leaves)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref
    kernel_mha = fa.mha

    def plain_mha(q, k, v, kv_len=None, *, causal=True, q_offset=None):
        return mha_ref(q, k, v, kv_len, causal=causal, q_offset=q_offset)
    grads = []
    for plain in (False, True):
        _zero_grads(params)
        fa.mha = plain_mha if plain else kernel_mha
        try:
            model.loss_fn(params, batch)[0].backward()
        finally:
            fa.mha = kernel_mha
        grads.append(_grads(params))
    _zero_grads(params)
    paths = _leaf_paths(params)
    cos, worst, _ = _leaf_cosines(*grads, paths)
    return cos, worst, len(paths)


def _train11(what, model, params, make_batch, batch_size, counters):
    """1 + TRAIN11_STEPS AdamW steps on one repeated batch of
    ``make_batch(batch_size)`` (halved once if it does not fit, with a
    CUT line), the counters zeroed just before the timed steps and read
    just after them; then one more step under torch.profiler.  Losses
    finite and falling."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.train import batch_step
    from repro_torch.train.optimizer import AdamW
    opt = AdamW()
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    cut = None
    try:
        batch = make_batch(batch_size)
        params, state, loss, gnorm = batch_step(model, opt, params, state,
                                                batch)
    except torch.cuda.OutOfMemoryError:
        _zero_grads(params)
        batch = None
        torch.cuda.empty_cache()
        cut = f"batch {batch_size // 2}: {batch_size} did not fit"
        log(f"CUT: {what} at {cut}")
        batch_size //= 2
        batch = make_batch(batch_size)
        params, state, loss, gnorm = batch_step(model, opt, params, state,
                                                batch)
    losses, gnorms, step_s = [float(loss)], [float(gnorm)], []
    _reset(counters)
    for _ in range(TRAIN11_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, gnorm = batch_step(model, opt, params, state,
                                                batch)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        step_s.append(time.perf_counter() - t0)
    launches = {k: c.count for k, c in counters.items()}
    fwd = _by_dims(fa.launches, causal=True)
    bwd = _by_dims(fa.backward_launches, causal=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{what}: a loss or gnorm is not finite: {losses} {gnorms}")
    check(losses[-1] < losses[0], f"{what}: the repeated batch's loss did "
                                  f"not fall: {losses}")
    peak = _peak_gb()

    def one():
        nonlocal params, state
        params, state, _, _ = batch_step(model, opt, params, state, batch)
        torch.cuda.synchronize()
    wall_ms, busy_ms, top, bwd_ms = profiled(
        one, share_of=("bwd_dq_kernel", "bwd_dkv_kernel"))
    med = float(np.median(step_s))
    del state
    return params, batch, dict(
        batch=batch_size, cut=cut, losses=losses, gnorms=gnorms,
        step_s=step_s, step_ms_median=med * 1e3, peak_gb=peak,
        launches=launches, forward_by_dims=fwd, backward_by_dims=bwd,
        profile=dict(wall_ms=wall_ms, busy_ms=busy_ms, top=top,
                     attention_bwd_ms=bwd_ms))


def _check_backward_shape(what, k):
    """One ``bench.backward_measurements`` record held to the plain
    versions: the forward within FA_TOL, its lse within LSE_TOL, the
    gradients within BWD_TOL of autograd through ``mha_ref`` and of
    ``mha_bwd_lse_ref``."""
    check(k["o_max_abs_err"] < FA_TOL["bfloat16"]
          and k["lse_max_abs_err"] < LSE_TOL
          and k["max_err_of_max"] < BWD_TOL["bfloat16"]
          and k["own_err_of_max"] < BWD_TOL["bfloat16"],
          f"{what}: attention backward at {k['shape']}: output "
          f"{k['o_max_abs_err']}, lse {k['lse_max_abs_err']}, gradients "
          f"{k['max_err_of_max']} of the largest plain entry, "
          f"{k['own_err_of_max']} of its own arithmetic's")


def _check_backward_shapes(what, shapes, card):
    for k in shapes:
        _check_backward_shape(what, k)
        lib = "n/a (this PyTorch refuses the call)" \
            if k["library_ms"] is None else "%.4f ms" % k["library_ms"]
        log(f"{what}: backward at {k['shape']}: graph-replayed kernel "
            f"{k['ms']:.4f} ms, library {lib} (SDPA backward), bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}); eager kernel "
            f"{k['eager_ms']:.4f} ms, plain {k['plain_ms']:.4f} ms; "
            f"gradients within {k['max_err_of_max']:.3g} of the largest "
            f"plain entry, {k['own_err_of_max']:.3g} of mha_bwd_lse_ref's;"
            f" forward {k['o_max_abs_err']}, lse "
            f"{k['lse_max_abs_err']:.3g} [{card}]")


def encdec_training(dev, card, seed, model, params, counters):
    """(b) seamless-m4t-medium trained at 8 x (1024 frames, 256 decoder
    tokens): the backward kernel at the encoder, cross and decoder
    self-attention shapes against the plain versions; each leaf's
    gradient of the first step against the same step with plain
    attention (cosine); 1 + 3 AdamW steps."""
    import torch
    from repro_torch.kernels.flash_attention import bench

    shapes = bench.backward_measurements(dev,
                                         shapes=bench.ENCDEC_TRAIN_SHAPES)
    _check_backward_shapes("phase 11 (b)", shapes, card)
    torch.cuda.empty_cache()
    cfg = model.cfg
    t, s = ENCDEC_FRAMES, ENCDEC_TRAIN_TOKENS

    def make_batch(b):
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        toks = torch.randint(1, cfg.vocab_size, (b, s + 1), generator=g,
                             device=dev)
        return {"enc_embeds": torch.randn((b, t, cfg.d_model), generator=g,
                                          device=dev).to(torch.bfloat16),
                "enc_positions": torch.arange(t, dtype=torch.int32,
                                              device=dev),
                "tokens": toks[:, :-1], "labels": toks[:, 1:],
                "positions": torch.arange(s, dtype=torch.int32, device=dev)}
    # the first step's gradients, as phase 8 (b) holds qwen3-1.7b's
    cos, leaf, n = _grad_cosines(model, params, make_batch(ENCDEC_BATCH))
    check(cos >= GRAD_COSINE_MIN, f"phase 11 (b): gradient cosine {cos} < "
                                  f"{GRAD_COSINE_MIN} ({leaf})")
    torch.cuda.empty_cache()
    params, batch, out = _train11("phase 11 (b)", model, params, make_batch,
                                  ENCDEC_BATCH, counters)
    steps = TRAIN11_STEPS
    layers = cfg.n_encoder_layers + 2 * cfg.n_layers
    dims = f"sm90 {cfg.head_dim}/{cfg.head_dim}"
    check(out["backward_by_dims"] == {
        f"{dims} not causal": steps * (cfg.n_encoder_layers + cfg.n_layers),
        f"{dims} causal": steps * cfg.n_layers}
        and out["launches"]["flash_attention_bwd_sm90"] == steps * layers
        and out["launches"]["flash_attention_bwd_simt"] == 0,
        f"phase 11 (b): backward launches {out['backward_by_dims']}")
    out.update(grad_cosine_min=cos, grad_cosine_min_leaf=leaf,
               grad_leaves=n, backward=shapes, frames=t, tokens=s,
               tokens_per_s=out["batch"] * s / out["step_ms_median"] * 1e3,
               frames_per_s=out["batch"] * t / out["step_ms_median"] * 1e3)
    _report_train11("phase 11 (b)", cfg, out, card,
                    f"{out['batch']} x ({t} frames, {s} tokens)")
    del batch
    return out


def _report_train11(what, cfg, out, card, shape):
    pr = out["profile"]
    log(f"{what}: {cfg.name} at {shape}: losses {out['losses']}, gnorms "
        f"{out['gnorms']}; step {out['step_ms_median']:.1f} ms (median of "
        f"{len(out['step_s'])}), {out['tokens_per_s']:.1f} tokens/s, peak "
        f"{out['peak_gb']:.2f} GB; one step under torch.profiler: wall "
        f"{pr['wall_ms']:.1f} ms, device busy {pr['busy_ms']:.1f} ms "
        f"({100 * pr['busy_ms'] / pr['wall_ms']:.1f}%), attention backward "
        f"{pr['attention_bwd_ms']:.2f} ms [{card}]")
    if "grad_cosine_min" in out:
        log(f"{what}: gradient cosine against plain attention >= "
            f"{out['grad_cosine_min']:.6f} over {out['grad_leaves']} leaves"
            f" (least: {out['grad_cosine_min_leaf']})")
    log(f"{what}: launches over {TRAIN11_STEPS} steps {out['launches']}; "
        f"forward by route and dims {out['forward_by_dims']}, backward "
        f"{out['backward_by_dims']}")


def mla_training(dev, card, seed, counters):
    """(c) minicpm3-4b at its full config trained at 4 x 1024 tokens from
    the ReStore pipeline (as phase 8 (d) draws them): the (96, 64)
    backward at this shape against the plain versions, then 1 + 3 AdamW
    steps on one repeated batch, every backward on the tensor-core route
    at (96, 64)."""
    import torch
    from repro_torch.core.restore import ReStore
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import bench
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.train.data import (batches_from_table, run_pipeline,
                                        synthetic_corpus)

    shapes = bench.backward_measurements(dev, shapes=bench.MLA_TRAIN_SHAPES)
    _check_backward_shapes("phase 11 (c)", shapes, card)
    regs = build.ptxas_registers("flash_attention_bwd.cu")
    regs = dict({k: n for k, n in regs.items() if k.startswith("sm90")},
                serialized=regs["serialized"])
    log(f"phase 11 (c): ptxas -v, registers per thread of the bf16 "
        f"backward's kernels: {regs}")
    torch.cuda.empty_cache()
    cfg, model, params, rec = _family_model(MLA_ARCH, dev, seed,
                                            what="phase 11 (c)")
    store = ArtifactStore(device=dev)
    rs = ReStore(Catalog(store, device=dev), store, heuristic="aggressive",
                 device=dev)
    corpus = synthetic_corpus(LONG_DOCS, MLA_TRAIN_SEQ + 1, cfg.vocab_size,
                              device=dev)
    table, _ = run_pipeline(rs, corpus)

    def make_batch(b):
        toks, labels = next(batches_from_table(table, b, MLA_TRAIN_SEQ))
        toks, labels = (torch.from_numpy(x).to(dev) for x in (toks, labels))
        return {"tokens": toks, "labels": labels,
                "positions": torch.arange(MLA_TRAIN_SEQ, dtype=torch.int32,
                                          device=dev)}
    params, batch, out = _train11("phase 11 (c)", model, params, make_batch,
                                  MLA_TRAIN_BATCH, counters)
    steps, m = TRAIN11_STEPS, cfg.mla
    dims = f"sm90 {m.qk_nope_head_dim + m.qk_rope_head_dim}/{m.v_head_dim}"
    check(out["backward_by_dims"] == {f"{dims} causal": steps * cfg.n_layers}
          and out["launches"]["flash_attention_bwd_simt"] == 0,
          f"phase 11 (c): backward launches {out['backward_by_dims']}")
    out.update(rec, backward=shapes, seq=MLA_TRAIN_SEQ, bwd_registers=regs,
               pipeline_rows=int(table.num_valid()),
               tokens_per_s=out["batch"] * MLA_TRAIN_SEQ
               / out["step_ms_median"] * 1e3)
    _report_train11("phase 11 (c)", cfg, out, card,
                    f"{out['batch']} x {MLA_TRAIN_SEQ} tokens from the "
                    f"pipeline ({out['pipeline_rows']} rows)")
    del params, model, batch, store, rs, table
    torch.cuda.empty_cache()
    return out


def encdec_card_vs_cpu(dev, seed):
    """(d) seamless's smoke config (f32, 4 heads x 16: the CUDA-core
    kernel of csrc/flash_attention.cu) on the card against the CPU from
    the same parameters: a prefill and 3 decode steps, logits within
    LOGIT_ATOL_F32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.api import build
    from repro_torch.tree import tree_map

    cfg = get_config(ENCDEC_ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, (2, 12))
    cpu = build(cfg, device="cpu")
    p_cpu = cpu.init(seed)
    before = fa.launches.count
    out = []
    with torch.no_grad():
        for m, dv in ((cpu, "cpu"), (build(cfg, device=dev), dev)):
            p = p_cpu if dv == "cpu" else tree_map(lambda t: t.to(dv),
                                                   p_cpu)
            t = torch.from_numpy(toks).to(dv)
            cache = m.init_cache(2, 12, 40)
            first, cache = m.prefill(p, {
                "enc_embeds": torch.from_numpy(emb).to(dv),
                "enc_positions": torch.arange(40, dtype=torch.int32,
                                              device=dv),
                "tokens": t[:, :9],
                "positions": torch.arange(9, dtype=torch.int32, device=dv)},
                cache)
            steps = [first]
            for i in range(9, 12):
                nxt, cache = m.decode_step(p, {
                    "tokens": t[:, i:i + 1],
                    "positions": torch.full((1,), i, dtype=torch.int32,
                                            device=dv)}, cache, i)
                steps.append(nxt)
            out.append(torch.cat(steps, 1).float().cpu())
    torch.cuda.synchronize()
    err = float((out[0] - out[1]).abs().max())
    check(err <= LOGIT_ATOL_F32, f"phase 11 (d): card vs cpu logits {err}")
    check(fa.launches.count > before, "phase 11 (d): no attention launch")
    return dict(max_abs_logit_err=err, atol=LOGIT_ATOL_F32,
                launches=fa.launches.count - before)


def encdec_phase(dev, card, seed, counters):
    """Phase 11: (a) seamless served, (b) trained, (c) minicpm3-4b
    trained, (d) seamless's smoke config card vs CPU; one model at a
    time, the counters zeroed before each main path and read after it.
    Returns the record, with launches summed by counter over (a)-(c)."""
    import torch
    t0 = time.perf_counter()
    serving, model, params = encdec_serving(dev, card, seed, counters)
    out = {"serving": serving}
    out["training"] = encdec_training(dev, card, seed, model, params,
                                      counters)
    del model, params
    torch.cuda.empty_cache()
    out["mla_training"] = mla_training(dev, card, seed, counters)
    out["card_vs_cpu"] = encdec_card_vs_cpu(dev, seed)
    log(f"phase 11 (d): smoke config, card vs cpu: {out['card_vs_cpu']}")
    parts = ("serving", "training", "mla_training")
    out["launches"] = {k: sum(out[p]["launches"][k] for p in parts)
                       for k in counters}
    # forward launches by route and dims over (a)-(c), causal or not
    dims = {}
    for p in parts:
        rec = out[p]
        for key, n in rec.get("forward_by_dims",
                              rec.get("flash_by_dims", {})).items():
            key = " ".join(key.split()[:2])
            dims[key] = dims.get(key, 0) + n
    out["flash_by_dims"] = dims
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------- phase 12: the dry-run, the recurrent families trained


# (a) the dry-run (``launch/dryrun.py``) of every (arch, shape) cell on the
# meta device, and of the three training steps this script times at
# their (batch, seq, frames): phase 8 (d)'s, 11 (b)'s and 12 (b)'s; in
# CPU processes (no card) started after every timed part, beside (c),
# which times nothing: DRYRUN_JOBS workers for the cells' step counts,
# and for each training step a process with DRYRUN_STEP_JOBS
DRYRUN_JOBS, DRYRUN_STEP_JOBS = 4, 4
DRYRUN_WAIT_S = 300
# XLSTM_STEPS timed steps after the first: 1 since phase 14 (2 until
# then), so the script keeps within its time limit (a CUT line)
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, XLSTM_STEPS = 4, 1024, 1
DRYRUN_TRAIN = {"qwen3-1.7b": (LONG_SEQ, None),
                ENCDEC_ARCH: (ENCDEC_TRAIN_TOKENS, ENCDEC_FRAMES),
                XLSTM_ARCH: (XLSTM_TRAIN_SEQ, None)}
# a predicted peak within this factor of the measured one, either way
PEAK_RATIO_MAX = 2.0
# (b) the first step's gradients, chunked remat against the unchunked
# loop, at 1 x XLSTM_GRAD_SEQ tokens: a chunk of 64 steps and a short one
# of 16 (the unchunked loop keeps ~12 MB a token a layer); device busy
# over a step of XLSTM_TRAIN_BATCH x XLSTM_BUSY_SEQ under torch.profiler
# (the full step launches ~2e6 kernels, too many to trace)
XLSTM_GRAD_SEQ, XLSTM_BUSY_SEQ = 80, 32
# (b) the descent check: the float32 loss moved along its gradient by a
# first-order change of XLSTM_FD_DROP each way; the change within
# XLSTM_FD_RTOL of the prediction (0.09-0.23% at 8 layers on the CPU;
# at 24 on the card 4.4% at a drop of 3e-3, the third-order term, which
# falls as the drop squared)
XLSTM_FD_DROP, XLSTM_FD_RTOL = 1e-3, 0.05
# (c) Jamba's sublayer kinds at full width, a forward and backward over
# JAMBA_TRAIN_TOKENS tokens: Mamba's doubling scan keeps ~5.5 GB of
# float32 (Q, d_in, N) states a chunk of 256 for its backward
JAMBA_TRAIN_TOKENS = 1024
class DryRunJobs:
    """The dry-run's processes on the CPU (the card hidden from them):
    ``launch/dryrun.py --all`` over DRYRUN_JOBS workers, and one
    ``launch/dryrun.py`` cell a training step of ``measured`` (arch ->
    its batch) at that step's batch and DRYRUN_TRAIN's (seq, frames).
    ``stop`` (also at exit) ends any still running and removes their
    files."""

    def __init__(self, measured):
        import atexit
        self.dir = tempfile.mkdtemp(prefix="restore_dryrun_")
        self.cells = os.path.join(self.dir, "cells")
        self.train = os.path.join(self.dir, "train")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=SRC + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        run = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        cmds = [run + ["--all", "--jobs", str(DRYRUN_JOBS),
                       "--out-dir", self.cells]]
        for arch, m in measured.items():
            seq, frames = DRYRUN_TRAIN[arch]
            cmds.append(run + ["--arch", arch, "--shape", "train_4k",
                               "--batch", str(m["batch"]), "--seq", str(seq),
                               "--jobs", str(DRYRUN_STEP_JOBS),
                               "--out-dir", self.train]
                        + (["--enc-seq", str(frames)] if frames else []))
        self.logs = [os.path.join(self.dir, f"{n}.log")
                     for n in range(len(cmds))]
        self.procs = []
        for cmd, path in zip(cmds, self.logs):
            with open(path, "w") as f:
                self.procs.append(subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT, env=env))
        self.t0 = time.perf_counter()
        atexit.register(self.stop)

    def wait(self):
        """(seconds from the jobs' start to their reading here, seconds of
        it this call waited for them); fails on a job that failed or did
        not end within DRYRUN_WAIT_S of this call."""
        t_call = time.perf_counter()
        for p, path in zip(self.procs, self.logs):
            try:
                rc = p.wait(DRYRUN_WAIT_S)
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                with open(path) as f:
                    tail = f.read()[-3000:]
                check(False, f"phase 12 (a): dry-run job {p.args[3:9]} "
                             f"ended with {rc}: {tail}")
        t_end = time.perf_counter()
        return t_end - self.t0, t_end - t_call

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def dryrun_part(jobs, card, measured):
    """(a) Every applicable (arch, shape) cell's report: status ok, its
    FLOPs, bytes, peak and ``fits_one_card``; the roofline table; and for
    each training step this script timed (``measured``: arch -> batch,
    step s, peak GB), the dry-run's peak within PEAK_RATIO_MAX of the
    measured one, and its ``mfu``: ``model_flops`` / (step s x 989
    TFLOP/s)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.api import SHAPES, shape_applicable
    from repro_torch.roofline import analysis as RA

    jobs_s, waited_s = jobs.wait()
    reps = {(r["arch"], r["shape"]): r for r in RA.load_reports(jobs.cells)}
    rows, skipped = [], []
    for a in ARCH_IDS:
        for s in SHAPES:
            r = reps.get((a, s))
            check(r is not None, f"phase 12 (a): no dry-run report of "
                                 f"{a} x {s}")
            if not shape_applicable(get_config(a), s)[0]:
                check(r["status"] == "skipped", f"phase 12 (a): {a} x {s}")
                skipped.append(r)
                continue
            c = r.get("cost_extrapolated", {})
            check(r["status"] == "ok" and c.get("flops", 0) > 0
                  and c.get("bytes", 0) > 0
                  and r["memory"]["peak_bytes"] > 0
                  and isinstance(r.get("fits_one_card"), bool),
                  f"phase 12 (a): {a} x {s}: {r.get('status')} "
                  f"{r.get('error', '')}")
            rows.append(RA.analyze_cell(r))
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    for line in RA.to_markdown(rows, skipped).splitlines():
        if line:
            log(f"phase 12 (a): {line}")
    fits = sorted(f"{a} x {s}" for (a, s), r in reps.items()
                  if r.get("fits_one_card"))
    log(f"phase 12 (a): {len(rows)} cells ok, {len(skipped)} skipped; fit "
        f"one card (80 GB): {fits}; the jobs read {jobs_s:.1f} s after "
        f"their start beside (c), {waited_s:.1f} s of it after (c)")
    train = {r["arch"]: r for r in RA.load_reports(jobs.train)}
    steps = {}
    for arch, m in measured.items():
        s, e = DRYRUN_TRAIN[arch]
        rep = train[arch]
        row = RA.analyze_cell(rep)
        pred_gb = rep["memory"]["peak_bytes"] / 1e9
        ratio = pred_gb / m["peak_gb"]
        mf = RA.model_flops(rep)
        rec = dict(batch=m["batch"], seq=s, frames=e, step_s=m["step_s"],
                   peak_gb=m["peak_gb"], predicted_peak_gb=pred_gb,
                   predicted_over_measured=ratio, model_flops=mf,
                   mfu=mf / (m["step_s"] * RA.PEAK_FLOPS),
                   counted_flops=rep["cost_extrapolated"]["flops"],
                   counted_bytes=rep["cost_extrapolated"]["bytes"],
                   roofline_s=max(row["t_compute_s"], row["t_memory_s"]),
                   dominant=row["dominant"], source=m["source"])
        steps[arch] = rec
        log(f"phase 12 (a): {arch} trained at {m['batch']} x {s}"
            + (f" ({e} frames)" if e else "") + f" ({m['source']}): step "
            f"{m['step_s'] * 1e3:.1f} ms measured, roofline of the counted "
            f"step {rec['roofline_s'] * 1e3:.1f} ms ({row['dominant']}); "
            f"peak {m['peak_gb']:.2f} GB measured, {pred_gb:.2f} GB "
            f"predicted (x{ratio:.3f}); mfu {rec['mfu']:.4g} (model_flops "
            f"{mf:.4g}) [{card}]")
        check(1 / PEAK_RATIO_MAX <= ratio <= PEAK_RATIO_MAX,
              f"phase 12 (a): {arch}'s predicted peak {pred_gb:.2f} GB is "
              f"not within x{PEAK_RATIO_MAX} of the measured "
              f"{m['peak_gb']:.2f} GB")
    return dict(cells_ok=len(rows), cells_skipped=len(skipped),
                fit_one_card=fits, jobs_s=jobs_s, waited_s=waited_s,
                roofline=rows,
                training_steps=steps)


def xlstm_training(dev, card, seed, counters):
    """(b) xlstm-350m at its full config (remat on: the loops over time
    in chunks, the superblocks not recomputed whole) trained from the ReStore pipeline: the
    first step's gradients against the unchunked loop at 1 x
    XLSTM_GRAD_SEQ (cosine a leaf); on that batch in float32, the loss
    along its gradient each way against the gradient's prediction (the
    descent check) and the bf16 gradient's cosine with it; then 1 +
    XLSTM_STEPS bf16 AdamW steps on one repeated batch of
    XLSTM_TRAIN_BATCH x XLSTM_TRAIN_SEQ (halved once, with a CUT line, if
    it does not fit), the counters zeroed just before the timed steps and
    read just after; device busy over one profiled step at
    XLSTM_TRAIN_BATCH x XLSTM_BUSY_SEQ."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.restore import ReStore
    from repro_torch.launch.step_probe import (central_difference, cosine,
                                               grads_of)
    from repro_torch.launch.train import batch_step
    from repro_torch.models.api import build
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    from repro_torch.train.data import (batches_from_table, run_pipeline,
                                        synthetic_corpus)
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_map

    cfg = get_config(XLSTM_ARCH)
    check(cfg.remat and cfg.n_layers == 24, "phase 12 (b): xlstm-350m is "
                                            "not its full config")
    model = build(cfg, device=dev)
    params = model.init(seed)
    store = ArtifactStore(device=dev)
    catalog = Catalog(store, device=dev)
    rs = ReStore(catalog, store, heuristic="aggressive", device=dev)
    corpus = synthetic_corpus(LONG_DOCS, XLSTM_TRAIN_SEQ + 1, cfg.vocab_size,
                              device=dev)
    table, _ = run_pipeline(rs, corpus)

    def batch_of(b, s):
        tokens, labels = (torch.from_numpy(x).to(dev) for x in
                          next(batches_from_table(table, b, s)))
        return {"tokens": tokens, "labels": labels,
                "positions": torch.arange(s, dtype=torch.int32, device=dev)}

    t0 = time.perf_counter()
    small = batch_of(1, XLSTM_GRAD_SEQ)
    grads = []
    for remat in (True, False):
        _zero_grads(params)
        build(cfg.with_(remat=remat), device=dev).loss_fn(
            params, small)[0].backward()
        grads.append(_grads(params))
    _zero_grads(params)
    cos, leaf, equal = _leaf_cosines(*grads, _leaf_paths(params))
    out = dict(grad_cosine_min=cos, grad_cosine_min_leaf=leaf,
               grad_leaves_bit_equal=equal,
               grad_leaves=len(_leaf_paths(params)),
               grad_check_s=time.perf_counter() - t0)
    # the descent check (see below), in float32 on the same batch: the
    # loss of a float32 copy of the weights moved along its gradient each
    # way (``central_difference``) against the gradient's prediction; and
    # the bf16 gradient's cosine with the float32 one
    t0 = time.perf_counter()
    model32 = build(cfg.with_(dtype="float32"), device=dev)
    p32 = tree_map(lambda t: t.detach().to(torch.float32, copy=True),
                   params)
    loss32, g32 = grads_of(model32, p32, small)
    f32_cos = cosine(grads[0], g32)
    f32_leaf_cos = _leaf_cosines(grads[0], g32, _leaf_paths(params))
    del grads
    up, down, want = central_difference(model32, p32, g32, small,
                                        XLSTM_FD_DROP)
    moved = [up, down]
    del model32, p32, g32
    torch.cuda.empty_cache()
    got = moved[0] - moved[1]
    out.update(f32_loss=loss32, f32_moved_losses=moved,
               f32_central_change=got, f32_predicted_change=want,
               bf16_f32_grad_cosine=f32_cos,
               bf16_f32_grad_cosine_min=f32_leaf_cos[0],
               bf16_f32_grad_cosine_min_leaf=f32_leaf_cos[1],
               descent_check_s=time.perf_counter() - t0)
    log(f"phase 12 (b): float32 loss {loss32:.6f} at 1 x "
        f"{XLSTM_GRAD_SEQ}, moved along its gradient each way: "
        f"{moved[0]:.6f} and {moved[1]:.6f}, a change of {got:.6g} against "
        f"the gradient's {want:.6g} (rtol {XLSTM_FD_RTOL}); the bf16 "
        f"gradient's cosine with the float32 one {f32_cos:.6f} (least leaf "
        f"{f32_leaf_cos[0]:.6f}, {f32_leaf_cos[1]}); "
        f"{out['descent_check_s']:.1f} s")
    check(moved[1] < loss32 < moved[0]
          and abs(got - want) <= XLSTM_FD_RTOL * abs(want),
          f"phase 12 (b): the float32 loss along its gradient moved by "
          f"{got} ({moved}), not by the gradient's {want}")
    opt = AdamW()
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    batch_size, cut = XLSTM_TRAIN_BATCH, None
    try:
        batch = batch_of(batch_size, XLSTM_TRAIN_SEQ)
        params, state, loss, gnorm = batch_step(model, opt, params, state,
                                                batch)
    except torch.cuda.OutOfMemoryError:
        _zero_grads(params)
        batch = None
        torch.cuda.empty_cache()
        batch_size //= 2
        cut = f"batch {batch_size}: {XLSTM_TRAIN_BATCH} did not fit"
        log(f"CUT: phase 12 (b) {cfg.name} trained at {batch_size} x "
            f"{XLSTM_TRAIN_SEQ}: {XLSTM_TRAIN_BATCH} x {XLSTM_TRAIN_SEQ} "
            "did not fit")
        batch = batch_of(batch_size, XLSTM_TRAIN_SEQ)
        params, state, loss, gnorm = batch_step(model, opt, params, state,
                                                batch)
    losses, gnorms, step_s = [float(loss)], [float(gnorm)], []
    log(f"phase 12 (b): first step {time.perf_counter() - t1:.1f} s, loss "
        f"{losses[0]:.4f}, gnorm {gnorms[0]:.2f}")
    _reset(counters)
    log(f"CUT: phase 12 (b) times {XLSTM_STEPS} AdamW step(s) after the "
        "first, not 2, so the script keeps within its time limit with "
        "phase 14")
    for _ in range(XLSTM_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, loss, gnorm = batch_step(model, opt, params, state,
                                                batch)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        step_s.append(time.perf_counter() - t1)
        log(f"phase 12 (b): step {step_s[-1]:.1f} s, loss {losses[-1]:.4f},"
            f" gnorm {gnorms[-1]:.2f}")
    launches = {k: c.count for k, c in counters.items()}
    peak = _peak_gb()
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"phase 12 (b): a loss or gnorm is not finite: {losses} {gnorms}")
    # whether one AdamW step at lr 3e-4 (its first is a step of ~lr on
    # every weight, whatever the gradient's size) lowers the loss at full
    # width turns on the batch, in the reference as in the port: run as a
    # script, tests/test_torch_ssm_train.py takes one step on each of 4
    # batches at 8 layers, 1 x 80 tokens, and both packages' steps raise
    # the loss of the same one of them, in bf16 and in float32.  So the
    # check is the float32 descent check above, and this step's outcome
    # is logged; at the smoke config the port's bf16 losses are the
    # reference's within GRAD_TOL and fall at every step
    # (test_adamw_steps_on_a_repeated_batch_match_jax)
    out["bf16_step_lowered"] = min(losses[1:]) < losses[0]
    log(f"phase 12 (b): the bf16 AdamW step "
        f"{'lowered' if out['bf16_step_lowered'] else 'did not lower'} the "
        f"repeated batch's loss: {losses} (logged, not checked)")
    short = batch_of(batch_size, XLSTM_BUSY_SEQ)

    def one():
        nonlocal params, state
        params, state, _, _ = batch_step(model, opt, params, state, short)
        torch.cuda.synchronize()
    one()
    wall_ms, busy_ms, top = profiled(one)
    med = float(np.median(step_s))
    out.update(batch=batch_size, seq=XLSTM_TRAIN_SEQ, cut=cut,
               losses=losses, gnorms=gnorms, step_s=step_s,
               step_s_median=med,
               tokens_per_s=batch_size * XLSTM_TRAIN_SEQ / med,
               peak_gb=peak, launches=launches,
               profile=dict(batch=batch_size, seq=XLSTM_BUSY_SEQ,
                            wall_ms=wall_ms, busy_ms=busy_ms, top=top))
    log(f"phase 12 (b): {cfg.name} full config at {batch_size} x "
        f"{XLSTM_TRAIN_SEQ} from the ReStore pipeline: losses {losses}, "
        f"gnorms {gnorms}; step {med * 1e3:.1f} ms (median of "
        f"{len(step_s)}), {out['tokens_per_s']:.1f} tokens/s, peak "
        f"{peak:.2f} GB; a {batch_size} x {XLSTM_BUSY_SEQ} step under "
        f"torch.profiler: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f}"
        f" ms ({100 * busy_ms / wall_ms:.1f}%); launches {launches} "
        f"[{card}]")
    for name, ms, count in top:
        log(f"phase 12 (b):   {ms:9.3f} ms  x{count:<5} {name[:90]}")
    del model, params, state, batch, short
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_sublayers():
    """``plain_kernels`` and Mamba's scan as ``plain_mamba``'s sequential
    recurrence: autograd through them is the oracle of (c)."""
    from repro_torch.models import lm as LM
    saved = LM.mamba_forward
    LM.mamba_forward = plain_mamba
    try:
        with plain_kernels():
            yield
    finally:
        LM.mamba_forward = saved


def jamba_training(dev, card, seed, counters):
    """(c) Jamba's three sublayer kinds at full width, one at a time, a
    forward and backward over JAMBA_TRAIN_TOKENS tokens against autograd
    through the plain versions on the card (``plain_sublayers``), each
    half teacher-forced as phase 10 (b) forces them: the mixer (with
    ``ln1``) fed x, the FFN (with ``ln2``) fed the kernel path's x + mixer
    output, so the MoE's routing is the same by construction (a bf16
    attention output can flip a near-tied top-2 choice).  A cosine on
    every parameter leaf and both inputs, the MoE's slots bit-equal; the
    kernel path's launches by route and dims, counted from just before
    the first sublayer to just after the last (the plain versions launch
    nothing)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.tree import tree_leaves

    cfg = get_config(JAMBA_ARCH)
    kinds = LM.slot_kinds(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    s = JAMBA_TRAIN_TOKENS
    pos = torch.arange(s, device=dev)
    eps = cfg.norm_eps

    def mixer(p, x):
        h = L.rmsnorm(x, p["ln1"], eps)
        if kind[0] == "mamba":
            return LM.mamba_forward(cfg, p["mixer"], h)[0], None
        return LM.attn_forward(cfg, p["mixer"], h, pos)[0], None

    def ffn(p, x):
        h = L.rmsnorm(x, p["ln2"], eps)
        if kind[1] == "moe":
            return LM.moe_forward(cfg, p["ffn"], h)
        return LM.mlp_forward(p["ffn"], h), None

    def run(half, leaves, x, w, plain):
        """Gradients of sum(out * w) (+ aux) of one half over ``leaves``
        and ``x``, and the MoE's slots."""
        slots, saved = [], L.moe_slots

        def moe_slots(*a):
            res = saved(*a)
            slots.append(res[0])
            return res
        for t in leaves + [x]:
            t.requires_grad_(True)
            t.grad = None
        L.moe_slots = moe_slots
        try:
            with plain_sublayers() if plain else contextlib.nullcontext():
                o, aux = half(p, x)
                loss = (o.float() * w).sum()
                (loss if aux is None else loss + aux).backward()
        finally:
            L.moe_slots = saved
        return [t.grad for t in leaves + [x]], slots, o.detach()

    torch.cuda.reset_peak_memory_stats(dev)
    _reset(counters)
    out, calls = {}, {"attn": 0, "moe": 0}
    for kind in sorted(set(kinds), key=kinds.index):
        t0 = time.perf_counter()
        p = LM._init_sublayer(cfg, g, *kind)
        x = (torch.randn((1, s, cfg.d_model), generator=g, device=dev)
             * 0.5).to(getattr(torch, cfg.dtype))
        res = dict(param_gb=sum(t.numel() * t.element_size()
                                for t in tree_leaves(p)) / 1e9)
        for name, half, keys in (("mixer", mixer, ("ln1", "mixer")),
                                 ("ffn", ffn, ("ln2", "ffn"))):
            leaves = tree_leaves({k: p[k] for k in keys})
            paths = _leaf_paths({k: p[k] for k in keys}) + ["input"]
            w = torch.randn((1, s, cfg.d_model), generator=g, device=dev)
            got, got_slots, o = run(half, leaves, x, w, False)
            want, want_slots, _ = run(half, leaves, x, w, True)
            cos, leaf, equal = _leaf_cosines(got, want, paths)
            check(cos >= GRAD_COSINE_MIN, f"phase 12 (c) {kind} {name}: "
                                          f"gradient cosine {cos} < "
                                          f"{GRAD_COSINE_MIN} ({leaf})")
            check(len(got_slots) == len(want_slots)
                  and all(torch.equal(a, b)
                          for a, b in zip(got_slots, want_slots)),
                  f"phase 12 (c) {kind}: the MoE's slots differ from the "
                  "plain version's")
            res[name] = dict(grad_cosine_min=cos, grad_cosine_min_leaf=leaf,
                             grad_leaves=len(paths),
                             grad_leaves_bit_equal=equal,
                             slots_bit_equal=len(got_slots))
            if name == "mixer":
                # the FFN half is fed the kernel path's residual stream
                x = (x + o).detach()
            for t in leaves:
                t.grad = None
            del got, want, got_slots, want_slots
        calls["attn"] += kind[0] == "attn"
        calls["moe"] += kind[1] == "moe"
        res["part_s"] = time.perf_counter() - t0
        out[f"{kind[0]}+{kind[1]}"] = res
        log(f"phase 12 (c): {kind} at full width, forward and backward "
            f"over {s} tokens against autograd through the plain versions:"
            f" {res} [{card}]")
        del p, x
        torch.cuda.empty_cache()
    launches, fwd = _launches(counters)
    bwd = _by_dims(fa.backward_launches, causal=True)
    log(f"phase 12 (c): launches {launches}; forward by route and dims "
        f"{fwd}, backward {bwd}; peak {_peak_gb():.2f} GB [{card}]")
    check(fwd == {"sm90 128/128": calls["attn"]}
          and bwd == {"sm90 128/128 causal": calls["attn"]},
          f"phase 12 (c): attention launches forward {fwd}, backward {bwd}"
          f" over {calls['attn']} attention sublayers")
    check(launches["partition_scatter"] == calls["moe"] > 0,
          f"phase 12 (c): partition_scatter launches "
          f"{launches['partition_scatter']} over {calls['moe']} MoE calls")
    return dict(sublayers=out, tokens=s, launches=launches,
                forward_by_dims=fwd, backward_by_dims=bwd, peak_gb=_peak_gb())


def _groups_by_user(t):
    """A grouped table's (user ids, counts, revenue sums), split groups
    of one user merged (the sort-based reduce splits users whose key
    hashes collide, ROADMAP queue 3)."""
    d = t.to_numpy()
    users, inv = np.unique(_uid(d["key"]), return_inverse=True)
    return (users, np.bincount(inv, weights=d["cnt"].astype(np.float64)),
            np.bincount(inv, weights=d["total"].astype(np.float64)),
            len(inv) - len(users))


def dataflow_part(dev, card, seed, n_rows, counters, multi_pod=None,
                  what="phase 12 (d)"):
    """(d) ``launch/dryrun_dataflow.py`` on the card at ``n_rows`` rows
    over LocalMesh(8) (or, with ``multi_pod`` True or False, over the
    production mesh's DP shards, as ``--multi-pod`` or ``--production``
    run it), its counters zeroed just before and read just after; its
    groups against the single-card sort-based group-by of the same table
    (``op_groupby``, phase 4's reduce): users and counts exact, revenue
    sums within RTOL_FLOAT_AGG."""
    import torch
    from repro_torch.dataflow.physical import op_groupby
    from repro_torch.launch import dryrun_dataflow as DD

    t0 = time.perf_counter()
    table = DD.groupby_table(n_rows, seed, dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    mesh = () if multi_pod is None else DD.production_shards(multi_pod)
    _reset(counters)
    grouped, rep = DD.run(table, *mesh)
    launches = {k: c.count for k, c in counters.items()}
    got = _groups_by_user(grouped)
    want = _groups_by_user(op_groupby(table, DD.KEYS, DD.AGGS))
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                             want[1]),
          f"{what}: {len(got[0])} users / counts against the "
          f"single-card group-by's {len(want[0])}")
    check(np.allclose(got[2], want[2], rtol=RTOL_FLOAT_AGG, atol=1e-3),
          f"{what}: revenue sums differ from the single-card "
          "group-by's")
    check(launches["partition_scatter"] > 0,
          f"{what}: partition_scatter was never launched")
    rep.update(users=len(got[0]), split_groups=got[3],
               single_card_split_groups=want[3], generate_s=gen_s,
               launches_counted=launches)
    log(f"{what}: dryrun_dataflow at {n_rows} rows on "
        f"{rep['mesh']}: {rep['groups']} groups of "
        f"{len(got[0])} users (split by colliding hashes: {got[3]}, "
        f"single-card {want[3]}), overflow {rep['overflow']} (retried "
        f"lossless: {rep['retried_lossless']}); wall {rep['wall_s']:.3f} s,"
        f" peak {rep['memory']['peak_bytes'] / 1e9:.2f} GB, all-to-all "
        f"buffer {rep['collective_bytes']['all-to-all'] / 1e9:.3f} GB; "
        f"launches {launches}; equal to the single-card group-by [{card}]")
    del table, grouped
    torch.cuda.empty_cache()
    return rep


def dryrun_phase(dev, card, seed, n_rows, counters, measured):
    """Phase 12: (b) xlstm-350m trained, (d) the dataflow dry-run, then
    the dry-run's CPU processes (``DryRunJobs``) started beside (c)
    Jamba's sublayers trained, which times nothing, and (a) their reports
    with (b)'s step beside ``measured``'s.  Returns the record, with
    launches summed by counter over (b)-(d)."""
    t0 = time.perf_counter()
    out = {"xlstm": xlstm_training(dev, card, seed, counters)}
    x = out["xlstm"]
    measured[XLSTM_ARCH] = dict(batch=x["batch"], step_s=x["step_s_median"],
                                peak_gb=x["peak_gb"], source="phase 12 (b)")
    out["dataflow"] = dataflow_part(dev, card, seed, n_rows, counters)
    jobs = DryRunJobs(measured)
    try:
        out["jamba"] = jamba_training(dev, card, seed, counters)
        out["dryrun"] = dryrun_part(jobs, card, measured)
    finally:
        jobs.stop()
    parts = ("xlstm", "jamba")
    out["launches"] = {k: sum(out[p]["launches"][k] for p in parts)
                       + out["dataflow"]["launches_counted"][k]
                       for k in counters}
    out["phase_s"] = time.perf_counter() - t0
    return out



# ------------------------------------------------ phase 13: the model mesh

# (a) one MoE sublayer of qwen3-moe at full width on a logical (2, 4)
# mesh: 4 x 512 tokens, so t_loc = 1024 a DP block, e_loc = 32, cap = 80
MESH_MOE_BATCH, MESH_MOE_SEQ = 4, 512
# (b) qwen3-1.7b whole, one prefill under dist.optimized(): 8 chunks of
# 2048 keys a layer; the chunked call's rows checked against mha_ref in
# two slices of CHUNK_CHECK_ROWS (the whole call's scores would take
# 17 GB)
CHUNK_PREFILL, CHUNK_CHECK_ROWS = 16384, 1024
# (c) qwen3-1.7b whole on a logical (2, 4) mesh: s_loc = 2048
SHARD_BATCH, SHARD_PREFILL, SHARD_SMAX, SHARD_STEPS = 8, 4096, 8192, 32
# (d) the int8 sync over LocalMesh(8, "data"), one layer's gradients
SYNC_SHARDS, SYNC_STEPS = 8, 10
SYNC_CPU_LEAVES = ("ln1", "ln2", "mixer/k_norm", "mixer/q_norm",
                   "mixer/wk")


@contextlib.contextmanager
def _dist(mesh, optimized=False):
    """Inside the block ``mesh`` is the ambient mesh and
    ``dist.optimized()`` is ``optimized``; both reset after it."""
    from repro_torch.models import dist
    dist.set_mesh(mesh)
    dist.set_optimized(optimized)
    try:
        yield
    finally:
        dist.set_mesh(None)
        dist.set_optimized(False)


@contextlib.contextmanager
def _slot_calls(rec):
    """Inside the block each ``moe_slots`` call appends (its arguments,
    (slot, dropped)) to ``rec``."""
    from repro_torch.models import layers as L
    inner = L.moe_slots

    def moe_slots(*a, **kw):
        out = inner(*a, **kw)
        rec.append(((a, kw), out))
        return out
    L.moe_slots = moe_slots
    try:
        yield
    finally:
        L.moe_slots = inner


@contextlib.contextmanager
def _first_call(module, name, rec):
    """Inside the block the first call of ``module.name`` appends its
    (args, kwargs, output) to ``rec``."""
    inner = getattr(module, name)

    def fn(*a, **kw):
        out = inner(*a, **kw)
        if not rec:
            rec.append((a, kw, out))
        return out
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, inner)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def mesh_moe_part(dev, card, seed, counters):
    """(a) ``_moe_forward_shard_map`` through ``moe_forward`` with a
    logical (2, 4) mesh set, at qwen3-moe-235b-a22b's full width (one MoE
    sublayer: 128 experts, top-8, d 4096, d_expert 1536, bf16 random
    weights) over 4 x 512 tokens.  Counters zeroed just before, read just
    after: one partition-scatter launch a shard.  Held against the same
    function with slots from ``partition_scatter_ref``: each shard's
    slots bit-equal and its drops equal, the output within
    SUBLAYER_RTOL.  Then its time, the scatter kernel at a shard's
    inputs, and the single-device ``moe_forward``'s drops on the same
    input."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.radix_partition import ops as rp
    from repro_torch.kernels.radix_partition.ref import (
        partition_scatter_ref)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = L.init_moe(cfg, gen)
    x = torch.randn((MESH_MOE_BATCH, MESH_MOE_SEQ, cfg.d_model),
                    generator=gen, device=dev).to(torch.bfloat16)
    mesh = make_host_mesh(2, 4, device=dev)
    got = []
    _reset(counters)
    with _dist(mesh), _slot_calls(got):
        out, aux = L.moe_forward(cfg, p, x)
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    shapes = sorted([list(k) + [n] for k, n in
                     counters["partition_scatter"].shapes.items()])
    check(launches["partition_scatter"] == mesh.n_shards == len(got),
          f"phase 13 (a): partition_scatter launched "
          f"{launches['partition_scatter']} times for {mesh.n_shards} "
          "shards")
    want = []
    with plain_kernels(), _slot_calls(want):
        plain, plain_aux = L._moe_forward_shard_map(cfg, p, x, mesh)
    for i, ((_, (s1, d1)), (_, (s2, d2))) in enumerate(zip(got, want)):
        check(torch.equal(s1, s2) and int(d1) == int(d2),
              f"phase 13 (a): shard {i}: slots or drops differ from "
              "partition_scatter_ref's")
    rel = _rel(out, plain)
    check(rel <= SUBLAYER_RTOL and float(aux) == float(plain_aux),
          f"phase 13 (a): output differs by {rel} of its largest entry")
    ms = cuda_ms(lambda: L._moe_forward_shard_map(cfg, p, x, mesh),
                 iters=3, warmup=1)
    (args, kw), _ = got[0]
    lanes = args[0].reshape(-1).to(torch.int64)
    valid = kw["valid"].reshape(-1).contiguous()
    e_loc, cap = args[1], args[2]
    n = lanes.numel()
    b_ms, b_by = bound_ms(9 * n, 0)
    scatter = dict(
        shape=f"N={n} entries of a DP block, P={e_loc} local experts, "
              f"bucket={cap}, valid = local",
        ms=cuda_ms(lambda: rp.scatter_slots(lanes, valid, n_parts=e_loc,
                                            bucket=cap)),
        plain_ms=cuda_ms(lambda: partition_scatter_ref(
            lanes, valid, n_parts=e_loc, bucket=cap), iters=3),
        library_ms=cuda_ms(lambda: torch.sort(
            torch.where(valid, lanes, e_loc), stable=True)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
    single = []
    with _slot_calls(single):
        L.moe_forward(cfg, p, x)
    drops = [int(d) for _, (_, d) in got]
    rec = dict(mesh="(2, 4) data x model", tokens=[MESH_MOE_BATCH,
                                                   MESH_MOE_SEQ],
               e_loc=e_loc, t_loc=MESH_MOE_BATCH // 2 * MESH_MOE_SEQ,
               cap=cap, drops_per_shard=drops,
               single_device_drops=int(single[0][1][1]),
               single_device_cap=single[0][0][0][2], ms=ms,
               max_rel_err_vs_plain_slots=rel, rtol=SUBLAYER_RTOL,
               aux=float(aux), peak_gb=_peak_gb(), launches=launches,
               partition_scatter_shapes=shapes, scatter=scatter,
               part_s=time.perf_counter() - t0)
    log(f"phase 13 (a): {MOE_ARCH} MoE sublayer at full width on a "
        f"logical (2, 4) mesh, {MESH_MOE_BATCH} x {MESH_MOE_SEQ} tokens "
        f"(e_loc {e_loc}, t_loc {rec['t_loc']}, cap {cap}): {ms:.3f} ms, "
        f"peak {rec['peak_gb']:.2f} GB; slots bit-equal to "
        f"partition_scatter_ref's on every shard, output within {rel:.3g} "
        f"of its largest entry; drops per shard {drops} (single-device "
        f"moe_forward at cap {rec['single_device_cap']}: "
        f"{rec['single_device_drops']}); partition_scatter launches "
        f"{shapes}; the scatter at a shard's inputs ({scatter['shape']}): "
        f"kernel {scatter['ms']:.4f} ms, plain {scatter['plain_ms']:.4f} "
        f"ms, library {scatter['library_ms']:.4f} ms, bound "
        f"{b_ms:.6f} ms [{card}]")
    del p, x, out, plain, got, want, single
    torch.cuda.empty_cache()
    return rec


def _attention_measurement(dev, q, k, v, kv_len, q_offset, causal, label):
    """``ops.mha_lse`` at one call of a mesh path: its time, the plain
    version's (``mha_with_lse_ref``), SDPA's (the output only) and the
    bound on this call's visible pairs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import mha_with_lse_ref
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kpos = torch.arange(skv, device=dev)
    mask = kpos[None] < kv_len
    if causal:
        mask = mask & (kpos[None] <= torch.arange(sq, device=dev)[:, None]
                       + q_offset)
    out, lse = fa.mha_lse(q, k, v, kv_len, causal=causal, q_offset=q_offset)
    want, want_lse = mha_with_lse_ref(q, k, v, kv_len, causal=causal,
                                      q_offset=q_offset)
    err = float((out.float() - want.float()).abs().max())
    check(err < FA_TOL["bfloat16"], f"phase 13: mha_lse at {label} differs "
                                    f"from plain by {err}")
    fin = torch.isfinite(want_lse)
    lse_err = float((lse[fin] - want_lse[fin]).abs().max())
    check(lse_err < LSE_TOL, f"phase 13: lse at {label} differs by {lse_err}")
    bound, by = _flash_bound(b, hq, hkv, sq, d, [kv_len] * b,
                             [q_offset] * b, causal, 2)
    return dict(
        shape=f"{label}: B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
              f"bf16, kv_len {kv_len}, q_offset {q_offset}, "
              f"{'causal' if causal else 'not causal'}",
        max_abs_err=err, lse_max_abs_err=lse_err,
        ms=cuda_ms(lambda: fa.mha_lse(q, k, v, kv_len, causal=causal,
                                      q_offset=q_offset)),
        plain_ms=cuda_ms(lambda: mha_with_lse_ref(
            q, k, v, kv_len, causal=causal, q_offset=q_offset), iters=2,
            warmup=1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)),
        bound_ms=bound, bound_by=by)


def chunked_part(dev, card, base, cfg, params, counters):
    """(b) qwen3-1.7b whole: a CHUNK_PREFILL-token ``Model.prefill`` under
    ``dist.optimized()`` (every layer's attention through
    ``_sdpa_chunked``: 8 ``mha_lse`` launches of 2048 keys), counters
    zeroed just before and read just after; its last logits within
    LOGIT_ATOL_BF16 of the same prefill with the gate off (one ``mha``
    launch a layer); the first layer's chunked call against ``mha_ref``
    fed the same input on its first and last CHUNK_CHECK_ROWS rows
    (SUBLAYER_RTOL); the kernel at the first chunk's call."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    s = CHUNK_PREFILL
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                                     generator=gen),
             "positions": torch.arange(s, dtype=torch.int32, device=dev)}
    first, chunk_calls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    fa.launches.reset()
    with _dist(None, optimized=True), _first_call(L, "_sdpa_chunked", first), \
            _first_call(fa, "mha_lse", chunk_calls):
        t1 = time.perf_counter()
        got, _ = base.prefill(params, batch, base.init_cache(1, s))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
    launches = {k: c.count for k, c in counters.items()}
    by_dims = _by_dims(fa.launches, causal=True)
    peak = _peak_gb()
    n_chunks = s // 2048
    check(by_dims == {"sm90 128/128 causal": cfg.n_layers * n_chunks},
          f"phase 13 (b): flash_attention launches {by_dims}, not "
          f"{n_chunks} chunks in each of {cfg.n_layers} layers")
    t1 = time.perf_counter()
    want, _ = base.prefill(params, batch, base.init_cache(1, s))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    err = float((got - want).abs().max())
    check(err <= LOGIT_ATOL_BF16, f"phase 13 (b): chunked prefill's logits "
                                  f"differ from the unchunked by {err}")
    (q, k, v), kw, out = first[0]
    worst = 0.0
    for r0 in (0, s - CHUNK_CHECK_ROWS):
        r = slice(r0, r0 + CHUNK_CHECK_ROWS)
        ref = mha_ref(q[:, :, r], k, v, kw["kv_len"], causal=kw["causal"],
                      q_offset=kw["q_offset"] + r0)
        worst = max(worst, _rel(out[:, :, r], ref))
    check(worst <= SUBLAYER_RTOL, f"phase 13 (b): the chunked call differs "
                                  f"from mha_ref by {worst}")
    (cq, ck, cv, ckvl), ckw, _ = chunk_calls[0]
    meas = _attention_measurement(dev, cq, ck, cv, ckvl, ckw["q_offset"],
                                  ckw["causal"], "(b) chunk 0 of a layer")
    rec = dict(arch=cfg.name, layers=cfg.n_layers, tokens=s,
               chunks_per_layer=n_chunks, prefill_ms=ms,
               unchunked_prefill_ms=plain_ms, peak_gb=peak,
               max_abs_logit_err=err, atol=LOGIT_ATOL_BF16,
               chunked_call_rel_err=worst, rtol=SUBLAYER_RTOL,
               launches=launches, flash_by_dims=by_dims, attention=meas,
               part_s=time.perf_counter() - t0)
    log(f"phase 13 (b): {cfg.name} whole ({cfg.n_layers} layers), one "
        f"{s}-token prefill under dist.optimized(): {ms:.1f} ms (the gate "
        f"off: {plain_ms:.1f} ms), peak {peak:.2f} GB; last logits within "
        f"{err:.4f} of the unchunked prefill's (atol {LOGIT_ATOL_BF16}); "
        f"layer 0's chunked call within {worst:.3g} of mha_ref's largest "
        f"entry; flash_attention launches {by_dims}; mha_lse at "
        f"{meas['shape']}: kernel {meas['ms']:.4f} ms, plain "
        f"{meas['plain_ms']:.4f} ms, library {meas['library_ms']:.4f} ms, "
        f"bound {meas['bound_ms']:.4f} ms ({meas['bound_by']}) [{card}]")
    del q, k, v, out, first, chunk_calls, got, want
    torch.cuda.empty_cache()
    return rec


def sharded_part(dev, card, base, cfg, params, counters):
    """(c) qwen3-1.7b whole on a logical (2, 4) mesh: SHARD_BATCH rows, a
    SHARD_PREFILL-token prefill into a cache of SHARD_SMAX (s_loc 2048),
    then SHARD_STEPS greedy decode steps unsharded, and the same steps
    teacher-forced (the same tokens) with the mesh set under
    ``dist.optimized()``: every decode step's attention through
    ``_decode_attn_seq_sharded`` (one ``mha_lse`` launch per DP block and
    visible S-slice), counters zeroed just before the sharded steps and
    read just after.  Every step's logits within LOGIT_ATOL_BF16 of the
    unsharded step's; layer 0's cache bit-equal to the unsharded one's at
    the end; each arm's synced ms a step.""" 
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(17)
    b, s, smax = SHARD_BATCH, SHARD_PREFILL, SHARD_SMAX
    toks = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                         generator=gen)
    pos = torch.arange(smax, dtype=torch.int32, device=dev)
    mesh = make_host_mesh(2, 4, device=dev)
    runs = {}
    for arm in ("plain", "sharded"):
        cache = base.init_cache(b, smax)
        lg, cache = base.prefill(params, {"tokens": toks,
                                          "positions": pos[:s]}, cache)
        logs, step_ms, feed = [], [], []
        if arm == "sharded":
            _reset(counters)
            fa.launches.reset()
        with _dist(mesh if arm == "sharded" else None,
                   optimized=arm == "sharded"):
            for t in range(SHARD_STEPS):
                nxt = lg[:, -1].argmax(-1) if arm == "plain" \
                    else runs["plain"]["feed"][t]
                feed.append(nxt)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                lg, cache = base.decode_step(
                    params, {"tokens": nxt[:, None],
                             "positions": pos[s + t:s + t + 1]}, cache,
                    s + t)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                logs.append(lg[:, -1].float())
        if arm == "sharded":
            launches = {k: c.count for k, c in counters.items()}
            by_dims = _by_dims(fa.launches, causal=True)
        runs[arm] = dict(logs=logs, step_ms=step_ms, feed=feed, cache=cache)
    err = max(float((a - w).abs().max()) for a, w in
              zip(runs["sharded"]["logs"], runs["plain"]["logs"]))
    check(err <= LOGIT_ATOL_BF16, f"phase 13 (c): sharded decode logits "
                                  f"differ from the unsharded by {err}")
    # layer 0's keys and values come from the embeddings alone; later
    # layers' inputs carry the merge's rounding
    check(all(torch.equal(x[0], y[0]) for x, y in zip(
        runs["sharded"]["cache"]["slot0"], runs["plain"]["cache"]["slot0"])),
        "phase 13 (c): the sharded decode wrote layer 0's cache otherwise")
    s_loc = smax // 4
    visible = sum(-(-(s + t + 1) // s_loc) for t in range(SHARD_STEPS))
    want_launches = visible * 2 * cfg.n_layers
    check(by_dims == {"sm90 128/128 not causal": want_launches},
          f"phase 13 (c): flash_attention launches {by_dims}, not "
          f"{want_launches} (2 DP blocks x the visible S-slices a layer)")
    ck, cv = (c[0] for c in runs["sharded"]["cache"]["slot0"])
    idx = s + SHARD_STEPS - 1
    q = torch.randn((b // 2, cfg.n_heads, 1, cfg.head_dim), device=dev,
                    generator=gen).to(torch.bfloat16)
    meas = _attention_measurement(dev, q, ck[:b // 2, :, :s_loc],
                                  cv[:b // 2, :, :s_loc],
                                  min(idx + 1, s_loc), 0, False,
                                  "(c) S-slice 0 of a DP block")
    med = {a: float(np.median(runs[a]["step_ms"])) for a in runs}
    rec = dict(arch=cfg.name, mesh="(2, 4) data x model", batch=b,
               prefill=s, smax=smax, s_loc=s_loc, steps=SHARD_STEPS,
               decode_ms_sharded=med["sharded"],
               decode_ms_unsharded=med["plain"], max_abs_logit_err=err,
               atol=LOGIT_ATOL_BF16, launches=launches,
               flash_by_dims=by_dims, attention=meas,
               part_s=time.perf_counter() - t0)
    log(f"phase 13 (c): {cfg.name} whole on a logical (2, 4) mesh, batch "
        f"{b}, a {s}-token prefill into {smax} slots (s_loc {s_loc}), "
        f"{SHARD_STEPS} decode steps: sharded {med['sharded']:.2f} ms a "
        f"step, unsharded {med['plain']:.2f} ms (medians, synced); every "
        f"step's logits within {err:.4f} of the unsharded (atol "
        f"{LOGIT_ATOL_BF16}), layer 0's cache equal; flash_attention "
        f"launches "
        f"{by_dims}; mha_lse at {meas['shape']}: kernel {meas['ms']:.4f} "
        f"ms, plain {meas['plain_ms']:.4f} ms, library "
        f"{meas['library_ms']:.4f} ms, bound {meas['bound_ms']:.4f} ms "
        f"({meas['bound_by']}) [{card}]")
    del runs
    torch.cuda.empty_cache()
    return rec


def _leaf_dict(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_dict(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def sync_part(dev, card, cfg, params):
    """(d) ``make_compressed_sync`` over ``LocalMesh(8, "data")`` on one
    qwen3-1.7b layer's gradient-shaped leaves (bf16, seeded, one slice a
    shard), SYNC_STEPS steps of error feedback on the card; the same
    calls on the CPU over SYNC_CPU_LEAVES: every step's int8 codes,
    errors and means bit-equal; and tests/test_distributed.py's bounds
    on every leaf (each step within two quantization steps of the true
    mean, the accumulated mean within 2%).  GB/s: the gradients' bytes
    over the sync's synced time."""
    import torch
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.train.compression import (make_compressed_sync,
                                               quantize_int8)

    t0 = time.perf_counter()
    layer = {k: v[0] for k, v in _leaf_dict(
        params["blocks"]["slot0"]).items()}
    meshes = {"card": LocalMesh(SYNC_SHARDS, "data", device=dev),
              "cpu": LocalMesh(SYNC_SHARDS, "data", device="cpu")}
    syncs = {k: make_compressed_sync(m, ("data",)) for k, m in
             meshes.items()}
    errs = {"card": {k: torch.zeros(v.shape, device=dev)
                     for k, v in layer.items()},
            "cpu": {k: torch.zeros(layer[k].shape)
                    for k in SYNC_CPU_LEAVES}}
    gen = torch.Generator(device=dev).manual_seed(19)
    acc_c = {k: 0.0 for k in layer}
    acc_t = dict(acc_c)
    worst_step, ms, nbytes = 0.0, [], 0
    for step in range(SYNC_STEPS):
        grads = {k: (torch.randn((SYNC_SHARDS,) + tuple(v.shape),
                                 generator=gen, device=dev)
                     * (1 + step % 3)).to(torch.bfloat16)
                 for k, v in layer.items()}
        nbytes = sum(g.numel() * g.element_size() for g in grads.values())
        codes = {}
        for side in ("card", "cpu"):
            g = {k: grads[k] if side == "card" else grads[k].cpu()
                 for k in errs[side]}
            m = meshes[side]
            codes[side] = {}
            for k in SYNC_CPU_LEAVES:
                gf = g[k].float() + errs[side][k]
                amax = m.pmax(gf.abs().reshape(SYNC_SHARDS, -1).amax(1),
                              "data")
                scale = (amax.clamp_min(1e-12) * float(
                    np.float32(1 / 127))).reshape((-1,) + (1,) * (gf.ndim - 1))
                codes[side][k] = quantize_int8(gf, scale).cpu()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mean, errs[side] = syncs[side](g, errs[side])
            torch.cuda.synchronize()
            if side == "card":
                ms.append((time.perf_counter() - t1) * 1e3)
                card_mean = mean
            else:
                cpu_mean = mean
        for k in SYNC_CPU_LEAVES:
            check(torch.equal(codes["card"][k], codes["cpu"][k])
                  and torch.equal(errs["card"][k].cpu(), errs["cpu"][k])
                  and torch.equal(card_mean[k].cpu(), cpu_mean[k]),
                  f"phase 13 (d): step {step}: {k}'s codes, errors or "
                  "mean differ between the card and the CPU")
        for k, g in grads.items():
            true = g.float().mean(0)
            gmax = float(g.float().abs().max())
            e = float((card_mean[k] - true).abs().max())
            check(e < gmax / 127 * 2 + 1e-6, f"phase 13 (d): step {step}: "
                                             f"{k} off by {e}")
            worst_step = max(worst_step, e / gmax)
            acc_c[k] = acc_c[k] + card_mean[k]
            acc_t[k] = acc_t[k] + true
    rel = max(float((acc_c[k] - acc_t[k]).abs().max())
              / float(acc_t[k].abs().max()) for k in layer)
    check(rel < 0.02, f"phase 13 (d): accumulated relative error {rel}")
    med = float(np.median(ms))
    rec = dict(leaves=len(layer), elements_per_shard=sum(
        v.numel() for v in layer.values()), shards=SYNC_SHARDS,
        steps=SYNC_STEPS, cpu_leaves=list(SYNC_CPU_LEAVES),
        sync_ms=med, gb_per_s=nbytes / med / 1e6,
        worst_step_err_of_gmax=worst_step, accumulated_rel_err=rel,
        part_s=time.perf_counter() - t0)
    log(f"phase 13 (d): make_compressed_sync over LocalMesh("
        f"{SYNC_SHARDS}, 'data'), one {cfg.name} layer's {len(layer)} "
        f"gradient leaves ({rec['elements_per_shard']} elements a shard, "
        f"bf16), {SYNC_STEPS} steps: {med:.2f} ms a step, "
        f"{rec['gb_per_s']:.1f} GB/s of gradients; codes, errors and means"
        f" bit-equal to the CPU's on {len(SYNC_CPU_LEAVES)} leaves; worst "
        f"step error {worst_step:.3g} of max|g|, accumulated {rel:.3g} "
        f"[{card}]")
    del layer, errs, grads
    torch.cuda.empty_cache()
    return rec


def smoke_mesh_part(dev, card, seed, counters):
    """(e) The smoke configs (float32) on the card against the CPU from
    the same parameters: (a)'s expert-parallel MoE (qwen3-moe, (2, 2),
    4 x 64 tokens), (b)'s chunked prefill at its gate (qwen3-1.7b, 8192
    tokens, 4 chunks), (c)'s sharded rollout (llama4-maverick, (2, 4), a
    12-token prefill and 4 decode steps); within LOGIT_ATOL_F32.  The
    float32 kernel's row statistic (the simt route of ``mha_lse``) runs
    on (b)'s and (c)'s paths, counters zeroed just before the card's
    runs and read just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.api import build
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    out = {}

    def both(run):
        res = {}
        for side in ("cpu", "card"):
            d = "cpu" if side == "cpu" else dev
            res[side] = run(d)
        return res

    def moe(d):
        cfg = get_config(MOE_ARCH, smoke=True)
        p = L.init_moe(cfg, torch.Generator().manual_seed(seed))
        x = torch.randn((4, 64, cfg.d_model),
                        generator=torch.Generator().manual_seed(seed + 1))
        with _dist(make_host_mesh(2, 2, device=d)):
            o, _ = L.moe_forward(cfg, tree_map(lambda t: t.to(d), p),
                                 x.to(d))
        return [o.cpu()]

    def chunked(d):
        cfg = get_config(SERVE_ARCH, smoke=True)
        m = build(cfg, device=d)
        p = tree_map(lambda t: t.to(d), build(cfg, device="cpu").init(seed))
        s = 8192
        tok = torch.arange(s).view(1, s) * 7 % cfg.vocab_size
        with _dist(None, optimized=True):
            lg, _ = m.prefill(p, {"tokens": tok.to(d), "positions":
                                  torch.arange(s, dtype=torch.int32).to(d)},
                              m.init_cache(1, s))
        return [lg.cpu()]

    def rollout(d):
        cfg = get_config("llama4-maverick-400b-a17b", smoke=True)
        m = build(cfg, device=d)
        p = tree_map(lambda t: t.to(d), build(cfg, device="cpu").init(seed))
        toks = (torch.arange(64).view(4, 16) * 5 % cfg.vocab_size).to(d)
        pos = torch.arange(16, dtype=torch.int32).to(d)
        with _dist(make_host_mesh(2, 4, device=d), optimized=True):
            cache = m.init_cache(4, 16)
            lg, cache = m.prefill(p, {"tokens": toks[:, :12],
                                      "positions": pos[:12]}, cache)
            logs = [lg.cpu()]
            for t in range(12, 16):
                lg, cache = m.decode_step(p, {"tokens": toks[:, t:t + 1],
                                              "positions": pos[t:t + 1]},
                                          cache, t)
                logs.append(lg.cpu())
        return logs

    _reset(counters)
    fa.launches.reset()
    for name, run in (("moe_shard_map", moe), ("chunked_prefill", chunked),
                      ("sharded_rollout", rollout)):
        res = both(run)
        err = max(float((a - b).abs().max())
                  for a, b in zip(res["cpu"], res["card"]))
        check(err <= LOGIT_ATOL_F32, f"phase 13 (e): {name}: card vs cpu "
                                     f"{err}")
        out[name] = err
    launches = {k: c.count for k, c in counters.items()}
    by_dims = _by_dims(fa.launches, causal=True)
    check(by_dims.get("simt 16/16 causal", 0) > 0
          and by_dims.get("simt 16/16 not causal", 0) > 0
          and launches["partition_scatter"] > 0,
          f"phase 13 (e): launches {launches} {by_dims}: the f32 statistic "
          "or the MoE shards' scatter did not run")
    rec = dict(max_abs_err=out, atol=LOGIT_ATOL_F32, launches=launches,
               flash_by_dims=by_dims, part_s=time.perf_counter() - t0)
    log(f"phase 13 (e): smoke configs (f32) card vs cpu: {out} (atol "
        f"{LOGIT_ATOL_F32}); flash_attention launches {by_dims}; "
        f"partition_scatter {launches['partition_scatter']} [{card}]")
    return rec


def mesh_phase(dev, card, seed, n_rows, counters):
    """Phase 13: the model mesh on logical shards of the card, (a)-(f).
    Each part zeroes the counters just before its main path and reads
    them just after."""
    import torch
    t0 = time.perf_counter()
    out = {"moe": mesh_moe_part(dev, card, seed, counters)}
    cfg, base, params, info = _family_model(SERVE_ARCH, dev, seed,
                                            what="phase 13 (b)-(d)")
    out["model"] = info
    out["chunked"] = chunked_part(dev, card, base, cfg, params, counters)
    out["sharded"] = sharded_part(dev, card, base, cfg, params, counters)
    out["sync"] = sync_part(dev, card, cfg, params)
    del base, params
    torch.cuda.empty_cache()
    out["smoke"] = smoke_mesh_part(dev, card, seed, counters)
    out["dataflow"] = dataflow_part(dev, card, seed, n_rows, counters,
                                    multi_pod=True, what="phase 13 (f)")
    parts = ("moe", "chunked", "sharded", "smoke")
    out["launches"] = {k: sum(out[p]["launches"][k] for p in parts)
                       + out["dataflow"]["launches_counted"][k]
                       for k in counters}
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------ phase 14: the mesh across processes

GROUP_RANKS = 4                  # gloo ranks, one process each, one card
GROUP_TIMEOUT_S = 420            # spawn's limit for one part
GROUP_SYNC_STEPS = 10            # (c): steps of error feedback
# (d): qwen3-1.7b at full width, its depth cut to this many of 28 layers
# so that the checkpoint (float32 on disk) stays near 2 GB (a CUT line)
GROUP_CKPT_LAYERS = 4
GROUP_RETRY_ROWS, GROUP_RETRY_USERS = 1 << 16, 1 << 13   # (a)'s skew
# (f) qwen3-moe's MoE sublayer at full width on (1, 4): 4 x 512 tokens,
# 32 of the 128 experts a rank
GROUP_MOE_BATCH, GROUP_MOE_SEQ = 4, 512
# (g) qwen3-1.7b whole on (2, 2): a GROUP_ROLL_PREFILL-token prefill into
# GROUP_ROLL_SMAX slots (s_loc 4096), then GROUP_ROLL_STEPS decode steps
GROUP_ROLL_BATCH, GROUP_ROLL_PREFILL, GROUP_ROLL_SMAX = 4, 4096, 8192
GROUP_ROLL_STEPS = 8
# (h) the sharded step of qwen3-1.7b at full width, GROUP_CKPT_LAYERS of
# its layers (a CUT line), on (2, 2) at 8 x 1024 tokens
GROUP_STEP_BATCH, GROUP_STEP_SEQ = 8, 1024
GROUP_STEP_LOSS_RTOL, GROUP_STEP_MIN_COS = 1e-3, 0.999
# (h) after the update: each rank's global norm, and the norm of each of
# its parameter, m and v blocks, within GROUP_STEP_LOSS_RTOL of
# LocalMesh's at its coordinates; GROUP_DIGEST_SAMPLE elements of each
# block (of a parameter block, the update: after less before) at a fixed
# stride with cosine at least GROUP_STEP_MIN_COS with LocalMesh's
GROUP_DIGEST_SAMPLE = 4096
# (i) launch/sharded_serve.py's steps of qwen3-1.7b at full width,
# GROUP_CKPT_LAYERS of its layers, on (2, 2), baseline and --opt: a
# GROUP_SERVE_PREFILL-token prefill of GROUP_SERVE_BATCH rows into
# GROUP_SERVE_SMAX slots, then GROUP_SERVE_STEPS decode steps
GROUP_SERVE_BATCH, GROUP_SERVE_PREFILL, GROUP_SERVE_SMAX = 4, 1024, 2048
GROUP_SERVE_STEPS = 2


def _group_counters():
    """A rank's launch counters, under the names ``main`` counts."""
    from repro_torch.kernels.filter_project import ops as fp
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.hash_join import ops as hj
    from repro_torch.kernels.radix_partition import ops as rp
    from repro_torch.kernels.segment_reduce import ops as sr
    return {"join_probe": hj.launches,
            "join_probe_directory": hj.directory_launches,
            "segment_sum": sr.launches, "filter_compact": fp.launches,
            "partition_scatter": rp.scatter_launches,
            "radix_partition": rp.partition_launches,
            "flash_attention": fa.launches,
            "flash_attention_merge": fa.merge_launches,
            "flash_attention_bwd": fa.backward_launches,
            "flash_attention_bwd_sm90": fa.backward_sm90_launches,
            "flash_attention_bwd_simt": fa.backward_simt_launches}


def _owned(table, dev=None):
    """A Table on ``dev`` (default: its own) that holds its own columns
    (a block cut from a whole table keeps the whole alive through its
    views)."""
    from repro_torch.dataflow.table import Table
    dev = table.device if dev is None else dev
    return Table({n: c.to(dev, copy=True) for n, c in
                  table.columns.items()}, table.valid.to(dev, copy=True))


def _group_sources(mesh, n_rows, seed, dev, path=None):
    """Phase 4's page_views and users, cut to ``mesh``'s blocks of this
    process: made whole from the seed, and written to ``path`` when it
    is given; or, when ``path`` exists, read from it (the ranks read the
    tables the parent made, instead of making them four times over)."""
    from repro_torch.dataflow.table import Table
    from repro_torch.workloads import pigmix
    if path is not None and os.path.exists(path):
        z = np.load(path)
        tabs = []
        for name in ("pv", "users"):
            cols = {k.split("__", 1)[1]: z[k] for k in z.files
                    if k.startswith(name + "__") and k != name + "____v"}
            whole = Table.from_numpy(cols, device="cpu",
                                     valid=z[name + "____v"])
            tabs.append(_owned(mesh.local_table(whole), dev))
        return tuple(tabs)
    pv = pigmix.gen_page_views(n_rows, seed, n_users=n_rows // 8,
                               device=dev)
    users = pigmix.gen_users(n_users=n_rows // 8, device=dev)
    if path is not None:
        out = {}
        for name, t in (("pv", pv), ("users", users)):
            for k, a in t.to_numpy(only_valid=False).items():
                out[f"{name}__{k}"] = a
            out[f"{name}____v"] = t.valid.cpu().numpy()
        np.savez(path, **out)
    return _owned(mesh.local_table(pv)), _owned(mesh.local_table(users))


def _skewed_sources(dev):
    """skewed_retry's inputs: 60% of the page views on one user."""
    import torch
    from repro_torch.dataflow.table import encode_strings
    from repro_torch.workloads import pigmix
    pv = pigmix.gen_page_views(GROUP_RETRY_ROWS, 5,
                               n_users=GROUP_RETRY_USERS, device=dev)
    hot = torch.from_numpy(
        np.random.default_rng(5).random(GROUP_RETRY_ROWS) < 0.6)
    user = pv.col("user").clone()
    user[hot.to(dev)] = torch.from_numpy(
        encode_strings(["user0007"])[0]).to(dev)
    pv.columns["user"] = user
    return pv, pigmix.gen_users(n_users=GROUP_RETRY_USERS, device=dev)


def _restore_over(mesh, dev, sources, root=None, **kw):
    """A ReStore of ``mesh`` whose catalog holds ``sources`` (this
    process's blocks) and whose store is rooted at ``root``."""
    from repro_torch.core.restore import ReStore
    from repro_torch.store.artifacts import ArtifactStore, Catalog
    store = ArtifactStore(root=root, device=dev, mesh=mesh)
    cat = Catalog(store, device=dev)
    cat.register("page_views", sources[0])
    cat.register("users", sources[1])
    return ReStore(cat, store, mesh=mesh, device=dev, **kw)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _plain_arm(mesh, dev, sources, skew=MESH_SKEW):
    rs = _restore_over(mesh, dev, sources, heuristic="off",
                       rewrite_enabled=False, semantic=False,
                       skew_factor=skew)
    t0 = time.perf_counter()
    res, rep = rs.run(probe_plan(A_PROBE))
    _sync(dev)
    return res["dist_out"].to_numpy(), rep, time.perf_counter() - t0


def _workflows(mesh, dev, sources, root):
    """(b): the cold workflow (A_SEED) stores the join artifact
    partitioned on the user; the warm one (A_PROBE) reuses it.  Returns
    the warm rows and facts about the two runs."""
    a2a = getattr(mesh, "transport", None)
    rs = _restore_over(mesh, dev, sources, root=root,
                       heuristic="aggressive", skew_factor=MESH_SKEW)
    t0 = time.perf_counter()
    rs.run(probe_plan(A_SEED))
    cold_s = time.perf_counter() - t0
    calls0 = a2a["all_to_all"]["calls"] if a2a is not None else None
    t0 = time.perf_counter()
    res, rep = rs.run(probe_plan(A_PROBE))
    warm_s = time.perf_counter() - t0
    calls1 = a2a["all_to_all"]["calls"] if a2a is not None else None
    rows = res["dist_out"].to_numpy()
    rs.store.flush()
    st = [j.stats for j in rep.jobs if j.stats]
    facts = dict(cold_s=cold_s, warm_s=warm_s, reused=rep.n_reused,
                 sites=[(x.shuffles, x.shuffles_skipped) for x in st],
                 warm_all_to_all=None if calls0 is None
                 else calls1 - calls0,
                 artifacts=sorted(n for n in rs.store.names()
                                  if rs.store.partitioning(n)))
    rs.store.close()
    return rows, facts


def _sync_leaves(dev, smoke=False):
    """One qwen3-1.7b layer's parameter shapes (the gradients' shapes;
    ``smoke``: its smoke config's, for a rehearsal on the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    cfg = get_config(SERVE_ARCH, smoke=smoke)
    shapes = build(cfg, device=dev).init_shapes(0)
    return {k: tuple(v.shape[1:]) for k, v in _leaf_dict(
        shapes["blocks"]["slot0"]).items()}


def _sync_run(mesh, dev, rank, smoke=False):
    """(c): GROUP_SYNC_STEPS error-fed steps of ``make_compressed_sync``
    over "data" on seeded bf16 gradients (every shard's made alike on
    every process; ``rank`` None: all of them).  Returns, to hold two
    runs bit for bit: each step's means as an int64 sum of their bits
    and of their bits weighted by position (on the card), sha256 digests
    of the last step's means and of each shard's last errors (which
    carry every step's); the bytes of one shard's gradients and the
    synced ms of each step."""
    import hashlib
    import torch
    from repro_torch.train.compression import make_compressed_sync
    leaves = _sync_leaves(dev, smoke)
    n = mesh.n_shards
    sync = make_compressed_sync(mesh, ("data",))
    errs = {k: torch.zeros(s, device=dev) for k, s in leaves.items()}
    gen = torch.Generator(device=dev).manual_seed(19)
    sums, ms = [], []
    for step in range(GROUP_SYNC_STEPS):
        grads = {}
        for k, s in leaves.items():
            g = (torch.randn((n,) + s, generator=gen, device=dev)
                 * (1 + step % 3)).to(torch.bfloat16)
            grads[k] = g if rank is None else g[rank:rank + 1].clone()
        _sync(dev)
        t0 = time.perf_counter()
        mean, errs = sync(grads, errs)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        bits = [mean[k].reshape(-1).view(torch.int32).long()
                for k in sorted(leaves)]
        sums.append([int(sum(b.sum() for b in bits)), int(sum(
            (b * torch.arange(1, b.numel() + 1, device=dev)).sum()
            for b in bits))])
    mean_h = hashlib.sha256()
    err_h = [hashlib.sha256() for _ in range(n)]
    for k in sorted(leaves):
        mean_h.update(mean[k].cpu().numpy().tobytes())
        e = errs[k].cpu().numpy()
        for i in range(e.shape[0]):
            err_h[i if rank is None else rank].update(e[i].tobytes())
    nbytes = sum(int(np.prod(s)) * 2 for s in leaves.values())
    return dict(means=mean_h.hexdigest(), step_sums=sums,
                errors=[h.hexdigest() for h in err_h], bytes=nbytes,
                ms=ms, elements=nbytes // 2, leaves=len(leaves))


def _ckpt_model(dev, seed, smoke=False):
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    cfg = get_config(SERVE_ARCH, smoke=smoke)
    if not smoke:
        cfg = cfg.with_(n_layers=GROUP_CKPT_LAYERS)
    return cfg, build(cfg, device=dev).init(seed)


def _ckpt_shardings(cfg, params, mesh):
    from repro_torch.launch.sharding import param_specs, to_named
    return to_named(param_specs(cfg, params, mesh), mesh)


def _rank_device(device):
    """The device a rank runs on: the card, with the kernels the parent
    built loaded (not compiled again), or the CPU for a rehearsal."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.library()
    return dev


def group_rank(rank, world, n_rows, seed, root, ckpt, device, smoke,
               sources_path, model_dir):
    """Phase 14 (a)-(d) and (f)-(i) on one rank of a GroupMesh of
    ``world`` gloo ranks that share ``device`` (the card); ``model_dir``
    holds the parent's (g) feed and (h) gradients."""
    import torch
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.tree import tree_leaves, tree_map
    dev = _rank_device(device)
    mesh = GroupMesh(world, "data", backend="gloo", device=dev)
    counters = _group_counters()
    t_rank = time.perf_counter()
    out = {"rank": rank, "staged": mesh.staged, "part_s": None}
    sources = _group_sources(mesh, n_rows, seed, dev, sources_path)
    skewed = _skewed_sources(dev)
    part_s = {"sources": time.perf_counter() - t_rank}
    # (a) counted from here
    _reset(counters)
    a2a0 = dict(mesh.transport["all_to_all"])
    rows, rep, wall = _plain_arm(mesh, dev, sources)
    a2a1 = dict(mesh.transport["all_to_all"])
    st = [j.stats for j in rep.jobs if j.stats]
    out["a"] = dict(rows=rows, wall_s=wall,
                    exchange_bytes=a2a1["bytes"] - a2a0["bytes"],
                    exchange_ms=(a2a1["seconds"] - a2a0["seconds"]) * 1e3,
                    exchanges=a2a1["calls"] - a2a0["calls"],
                    sites=[(x.shuffles, x.shuffles_skipped,
                            x.shuffle_overflow, x.shuffle_retries)
                           for x in st])
    # the skewed case: the overflow is the mesh's, so every rank reruns
    # the job losslessly (the sort-based reduce: segment_sum)
    mine = [_owned(mesh.local_table(t)) for t in skewed]
    srows, srep, _ = _plain_arm(mesh, dev, mine, skew=1.25)
    sst = [j.stats for j in srep.jobs if j.stats]
    out["skewed"] = dict(rows=srows, overflow=sum(
        x.shuffle_overflow for x in sst), retries=sum(
        x.shuffle_retries for x in sst))
    out["launches_a"] = {k: c.count for k, c in counters.items()}
    part_s["a"] = time.perf_counter() - t_rank - sum(part_s.values())
    # (b) counted from here
    _reset(counters)
    out["b_rows"], out["b"] = _workflows(mesh, dev, sources, root)
    out["launches_b"] = {k: c.count for k, c in counters.items()}
    part_s["b"] = time.perf_counter() - t_rank - sum(part_s.values())
    del sources, skewed, mine
    torch.cuda.empty_cache()
    # (c)
    out["c"] = _sync_run(mesh, dev, rank, smoke)
    torch.cuda.empty_cache()
    part_s["c"] = time.perf_counter() - t_rank - sum(part_s.values())
    # (d): the parameters saved from a (2, 2) mesh of the 4 ranks
    mesh2 = GroupMesh((2, 2), ("data", "model"), backend="gloo",
                      device=dev)
    cfg, params = _ckpt_model(dev, seed, smoke)
    sh = _ckpt_shardings(cfg, params, mesh2)
    blocks = tree_map(lambda x, s: mesh2.localize(x, s.spec), params, sh)
    n_params = sum(int(t.numel()) for t in tree_leaves(params))
    del params
    _sync(dev)
    t0 = time.perf_counter()
    save_checkpoint(ckpt, 1, blocks, extra={"ranks": world}, shardings=sh)
    out["d_save_s"] = time.perf_counter() - t0
    out["d_params"] = n_params
    del blocks
    part_s["d"] = time.perf_counter() - t_rank - sum(part_s.values())
    # (f)-(h): the model programs, each counted just around its main path
    mesh14 = GroupMesh((1, world), ("data", "model"), backend="gloo",
                       device=dev)
    out["f"] = group_moe_run(mesh14, dev, seed, smoke, counters)
    part_s["f"] = time.perf_counter() - t_rank - sum(part_s.values())
    feed = np.load(os.path.join(model_dir, "feed.npy"))
    out["g"] = group_roll_run(mesh2, dev, seed, smoke, feed, counters)
    part_s["g"] = time.perf_counter() - t_rank - sum(part_s.values())
    out["h"] = group_step_run(mesh2, dev, seed, smoke,
                              os.path.join(model_dir, "grads.pt"),
                              counters)
    part_s["h"] = time.perf_counter() - t_rank - sum(part_s.values())
    out["i"] = group_serve_run(mesh2, dev, seed, smoke, counters)
    part_s["i"] = time.perf_counter() - t_rank - sum(part_s.values())
    out["coords"] = mesh2.my_coords
    out["staged_bytes"] = mesh.staged_bytes + mesh2.staged_bytes + \
        mesh14.staged_bytes
    out["part_s"] = part_s
    return out


def group_restore_rank(rank, world, ckpt, seed, device, smoke):
    """(d): the 4 ranks' checkpoint restored on a (1, 2) mesh of 2 ranks;
    every block against the same block of the source parameters (made
    again from the seed)."""
    import torch
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.tree import tree_leaves_with_path, tree_map
    dev = _rank_device(device)
    mesh = GroupMesh((1, world), ("data", "model"), backend="gloo",
                     device=dev)
    cfg, params = _ckpt_model(dev, seed, smoke)
    sh = _ckpt_shardings(cfg, params, mesh)
    target = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                            device="meta"), params)
    t0 = time.perf_counter()
    got, manifest = restore_checkpoint(ckpt, 1, target, sh)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    n, split, bad = 0, 0, []
    for (p, g), (_, x), (_, s) in zip(tree_leaves_with_path(got),
                                      tree_leaves_with_path(params),
                                      tree_leaves_with_path(sh)):
        want = mesh.block(x, s.spec, mesh.my_coords)
        n += 1
        split += tuple(want.shape) != tuple(x.shape)
        if g.dtype != x.dtype or not torch.equal(g, want):
            bad.append("/".join(map(str, p)))
    return dict(coords=mesh.my_coords, leaves=n, split=split, bad=bad,
                restore_s=restore_s, extra=manifest["extra"])


def group_nccl_rank(rank, world, n_rows, seed, sources_path):
    """(e): (a)'s plan on a GroupMesh over nccl, one rank a card."""
    from repro_torch.launch.mesh import GroupMesh
    dev = _rank_device(f"cuda:{rank}")
    mesh = GroupMesh(world, "data", backend="nccl")
    rows, rep, wall = _plain_arm(mesh, dev, _group_sources(
        mesh, n_rows, seed, dev, sources_path))
    return dict(rows=rows, wall_s=wall, device=str(mesh.device),
                transport={k: dict(v) for k, v in mesh.transport.items()})


# ----------------------- phase 14 (f)-(h): the model programs over ranks


def _transport(mesh):
    return {k: dict(v) for k, v in mesh.transport.items()}


def _transport_delta(before, mesh):
    """Each collective's calls, payload bytes and ms since ``before``."""
    out = {}
    for k, v in mesh.transport.items():
        b = before.get(k, {"calls": 0, "bytes": 0, "seconds": 0.0})
        if v["calls"] > b["calls"]:
            out[k] = dict(calls=v["calls"] - b["calls"],
                          bytes=v["bytes"] - b["bytes"],
                          ms=(v["seconds"] - b["seconds"]) * 1e3)
    return out


def _launch_shapes(counters):
    """Each launched kernel's count and its launches by shape."""
    return {k: dict(n=c.count, by_shape=sorted(
        [list(map(str, sh)), n] for sh, n in c.shapes.items()))
        for k, c in counters.items() if c.count}


def _nbytes(tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _group_moe_setup(dev, seed, lo, hi, smoke):
    """(f)'s inputs: the router, the experts [lo, hi) (each from a
    generator of its own, so a rank makes only its block and the parent
    the whole, the same numbers) and the tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config(MOE_ARCH, smoke=smoke)
    m, d = cfg.moe, cfg.d_model
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {"router": L._init(gen, (d, m.n_experts), torch.float32,
                           scale=0.02)}
    shape = (GROUP_MOE_BATCH, GROUP_MOE_SEQ) if not smoke else (4, 8)
    x = torch.randn(shape + (d,), generator=gen, device=dev).to(dt)
    scale = 1.0 / m.n_experts ** 0.5        # init_moe's (E, d, f) scale
    for name, shp in (("wg", (d, m.d_expert)), ("wu", (d, m.d_expert)),
                      ("wd", (m.d_expert, d))):
        p[name] = torch.empty((hi - lo,) + shp, dtype=dt, device=dev)
    for e in range(lo, hi):
        g = torch.Generator(device=dev).manual_seed(seed * 1000 + 7 + e)
        for name in ("wg", "wu", "wd"):
            p[name][e - lo] = L._init(g, p[name].shape[1:], dt, scale=scale)
    return cfg, p, x


def group_moe_run(mesh, dev, seed, smoke, counters=None):
    """(f) on ``mesh`` ((1, 4)): the process's experts (all on a
    LocalMesh, its 32 on a rank), ``moe_forward`` with the mesh set, its
    slots recorded.  Returns the output, aux, the slots of each shard
    this process ran (numpy: a rank's result crosses to the parent after
    the rank has exited), and, with ``counters``, the launches by shape,
    the transport and the resident bytes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    e = get_config(MOE_ARCH, smoke=smoke).moe.n_experts
    held = e // mesh.shape["model"] * mesh.local_shards("model")
    lo = held * (mesh.my_coords["model"] if mesh.spans_processes else 0)
    cfg, p, x = _group_moe_setup(dev, seed, lo, lo + held, smoke)
    rec, before = [], _transport(mesh) if mesh.spans_processes else {}
    if counters is not None:
        _reset(counters)
    _sync(dev)
    t0 = time.perf_counter()
    with _dist(mesh), _slot_calls(rec):
        out, aux = L.moe_forward(cfg, p, x)
    _sync(dev)
    wall = time.perf_counter() - t0
    res = dict(out=out.float().cpu().numpy(), aux=float(aux), wall_s=wall,
               slots=[sl.cpu().numpy() for _, (sl, _) in rec],
               drops=[int(dr) for _, (_, dr) in rec],
               experts_held=held, experts=e,
               resident_bytes=_nbytes(p[k] for k in ("wg", "wu", "wd")))
    if counters is not None:
        res["launches"] = _launch_shapes(counters)
        res["transport"] = _transport_delta(before, mesh)
    del p, x, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _group_roll_setup(dev, seed, smoke):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    cfg = get_config(SERVE_ARCH, smoke=smoke)
    b, s, smax, steps = (GROUP_ROLL_BATCH, GROUP_ROLL_PREFILL,
                         GROUP_ROLL_SMAX, GROUP_ROLL_STEPS) if not smoke \
        else (4, 60, 128, 8)
    model = build(cfg, device=dev)
    params = model.init(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev)
    return model, params, toks, (b, s, smax, steps)


def group_roll_run(mesh, dev, seed, smoke, feed=None, counters=None):
    """(g): qwen3-1.7b whole, a prefill and decode steps; ``mesh`` None:
    unsharded, greedy (the feed); else on ``mesh`` under
    ``dist.optimized()``, teacher-forced with ``feed``, the process
    holding its DP block of the rows and its block of the cache.
    Returns every step's last logits, the feed, ms and, with
    ``counters``, the launches by shape, the transport, the cache bytes
    held against the whole cache's."""
    import torch
    from repro_torch.launch.mesh import PartitionSpec as P
    from repro_torch.tree import tree_leaves
    model, params, toks, (b, s, smax, steps) = _group_roll_setup(
        dev, seed, smoke)
    pos = torch.arange(smax, dtype=torch.int32, device=dev)
    rows = slice(0, b)
    if mesh is not None and mesh.spans_processes:
        d = mesh.my_coords["data"]
        n = b // mesh.shape["data"]
        rows = slice(d * n, d * n + n)
    toks = toks[rows]
    before = _transport(mesh) if mesh is not None and \
        mesh.spans_processes else {}
    if counters is not None:
        _reset(counters)
    logs, nxt_all, ms = [], [], []
    with _dist(mesh, optimized=mesh is not None):
        cache = model.init_cache(toks.shape[0], smax)
        cache_bytes = _nbytes(tree_leaves(cache))
        _sync(dev)
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, {"tokens": toks,
                                           "positions": pos[:s]}, cache)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        logs.append(lg[:, -1].float().cpu().numpy())
        for t in range(steps):
            nxt = lg[:, -1].argmax(-1) if feed is None \
                else torch.from_numpy(feed[t][rows]).to(dev)
            nxt_all.append(nxt.cpu().numpy())
            t1 = time.perf_counter()
            lg, cache = model.decode_step(params, {
                "tokens": nxt[:, None], "positions": pos[s + t:s + t + 1]},
                cache, s + t)
            _sync(dev)
            ms.append((time.perf_counter() - t1) * 1e3)
            logs.append(lg[:, -1].float().cpu().numpy())
    res = dict(logits=np.stack(logs), feed=np.stack(nxt_all),
               prefill_s=prefill_s, decode_ms=ms, rows=[rows.start,
                                                        rows.stop],
               cache_bytes=cache_bytes,
               whole_cache_bytes=_nbytes(tree_leaves(model.init_cache(
                   b, smax))) if counters is not None else None)
    if counters is not None:
        res["launches"] = _launch_shapes(counters)
        res["transport"] = _transport_delta(before, mesh)
    del params, cache, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _group_step_setup(dev, seed, smoke):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build
    cfg = get_config(SERVE_ARCH, smoke=smoke)
    b, s = GROUP_STEP_BATCH, GROUP_STEP_SEQ
    if smoke:
        b, s = 4, 16
    else:
        cfg = cfg.with_(n_layers=GROUP_CKPT_LAYERS)
    model = build(cfg, device=dev)
    if dev.type == "meta":
        toks = torch.empty((b, s + 1), dtype=torch.int64, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed + 29)
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                             device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "positions": torch.arange(s, dtype=torch.int32, device=dev)}
    return model, batch


def group_step_run(mesh, dev, seed, smoke, grads_path, counters=None):
    """(h): the sharded step of qwen3-1.7b over ``mesh`` ((2, 2)) from the
    process's blocks (``param_specs``, ``opt_specs``): the loss and
    gradients (``sharded_loss_and_grads``), then the update
    (``sharded_update``).  A ``LocalMesh`` run saves its gradients to
    ``grads_path``; each rank of a ``GroupMesh`` holds its own against
    them (cosine a leaf).  Returns loss, gnorm, ms of both halves, the
    updated blocks' digests (``_step_digests``) by coordinates (every
    shard's on a LocalMesh, the rank's own on a GroupMesh) and, with
    ``counters``, the launches by shape, the transport, the bytes held
    against the whole parameters' and moments'."""
    import torch
    from repro_torch.launch.sharding import opt_specs, param_specs, \
        to_named
    from repro_torch.launch.train import sharded_loss_and_grads, \
        sharded_update
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_leaves, tree_leaves_with_path, \
        tree_map
    model, batch = _group_step_setup(dev, seed, smoke)
    params = model.init(seed)
    opt = AdamW()
    state = opt.init(params)
    whole_bytes = _nbytes(tree_leaves((params, state)))
    paths = ["/".join(map(str, p)) for p, _ in tree_leaves_with_path(params)]
    p_named = to_named(param_specs(model.cfg, params, mesh), mesh)
    o_named = to_named(opt_specs(model.cfg, params, mesh), mesh)
    pb = tree_map(lambda x, sh: mesh.localize(x, sh.spec), params, p_named)
    ob = tree_map(lambda x, sh: mesh.localize(x, sh.spec), state, o_named)
    specs = ([sh.spec for sh in tree_leaves(p_named)],
             [sh.spec for sh in tree_leaves(o_named["m"])])
    del params, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    held_bytes = _nbytes(tree_leaves((pb, ob)))
    before = _transport(mesh) if mesh.spans_processes else {}
    if counters is not None:
        _reset(counters)
    _sync(dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    loss, grads = sharded_loss_and_grads(model, pb, batch, mesh)
    _sync(dev)
    grad_s = time.perf_counter() - t0
    peak = _peak_bytes(dev)
    cos = None
    g_leaves = tree_leaves(grads)
    if not mesh.spans_processes:
        torch.save([g.detach().cpu() for g in g_leaves], grads_path)
    else:
        want = [w.to(dev) for w in torch.load(grads_path)]
        cos = _leaf_cosines(g_leaves, want, paths)
        del want
    digests = _step_digests(mesh, pb, ob, specs)
    _reset_peak(dev)
    t1 = time.perf_counter()
    pb, ob, gnorm = sharded_update(model, opt, pb, ob, grads, mesh)
    _sync(dev)
    update_s = time.perf_counter() - t1
    res = dict(loss=float(loss), gnorm=float(gnorm), grad_s=grad_s,
               update_s=update_s, cos=cos, held_bytes=held_bytes,
               whole_bytes=whole_bytes, step=int(ob["step"]),
               leaves=len(paths), peak_bytes=None if peak is None else
               max(peak, _peak_bytes(dev)),
               digests=_step_digests(mesh, pb, ob, specs, digests))
    if counters is not None:
        res["launches"] = _launch_shapes(counters)
        res["transport"] = _transport_delta(before, mesh)
    del pb, ob, grads, g_leaves
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _reset_peak(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _allocated(dev):
    """The process's allocated card memory now (None off the card)."""
    import torch
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


def _peak_bytes(dev):
    """The process's peak of allocated card memory since
    ``_reset_peak`` (None off the card)."""
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _group_serve_dims(smoke):
    if smoke:
        return 4, 60, 128, 2
    return (GROUP_SERVE_BATCH, GROUP_SERVE_PREFILL, GROUP_SERVE_SMAX,
            GROUP_SERVE_STEPS)


def group_serve_run(mesh, dev, seed, smoke, counters=None):
    """(i): ``launch/sharded_serve.py``'s prefill and GROUP_SERVE_STEPS
    decode steps of (d)'s model over ``mesh`` ((2, 2)), baseline and
    ``--opt``, from the process's blocks (``param_specs``,
    ``cache_shardings``), the batch whole and the decode teacher-forced
    with seeded tokens; ``mesh`` None: the one-device calls on the whole
    batch and cache.  A ``CountingMesh`` on ``meta`` counts the same
    calls under ``CostMode`` (phase 15's prediction).  Returns by mode
    ("base", "opt"): every call's whole last-token logits (numpy, off
    ``meta``), the walls, the resident bytes (the parameter and cache
    blocks and the batch), the peak (measured on the card after
    ``reset_peak_memory_stats``, or predicted: the resident bytes plus
    ``CostMode``'s peak of new storages), the transport and, with
    ``counters``, the launches by shape."""
    import contextlib
    import torch
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.launch.sharded_serve import (cache_shardings,
                                                  sharded_decode_step,
                                                  sharded_prefill)
    from repro_torch.launch.sharding import param_specs, to_named
    from repro_torch.models.api import build
    from repro_torch.tree import tree_leaves, tree_map
    meta = dev.type == "meta"
    held_before = _allocated(dev)
    cfg, params = _ckpt_model(dev, seed, smoke)
    b, s, smax, steps = _group_serve_dims(smoke)
    model = build(cfg, device=dev)
    if meta:
        toks = torch.empty((b, s + steps), dtype=torch.int64, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed + 31)
        toks = torch.randint(0, cfg.vocab_size, (b, s + steps),
                             generator=gen, device=dev)
    pos = torch.arange(smax, dtype=torch.int32, device=dev)
    if mesh is not None:
        params = tree_map(lambda x, sh: mesh.localize(x, sh.spec), params,
                          to_named(param_specs(cfg, params, mesh), mesh))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {}
    for mode in ("base", "opt"):
        named = None if mesh is None else \
            cache_shardings(model, mesh, b, smax)
        cache = model.init_cache(b, smax)
        if mesh is not None:
            cache = tree_map(lambda x, sh: mesh.localize(x, sh.spec),
                             cache, named)
        kw = dict(cache_shardings=named, optimized=mode == "opt")
        resident = _nbytes(tree_leaves((params, cache, toks, pos)))
        ranks = mesh is not None and mesh.spans_processes
        before = _transport(mesh) if ranks else {}
        if counters is not None:
            _reset(counters)
        cost = CostMode(tree_leaves((params, cache, toks, pos))) if meta \
            else contextlib.nullcontext()
        _sync(dev)
        _reset_peak(dev)
        at_reset = _allocated(dev)
        logits, ms = [], []
        with cost, torch.no_grad():
            for t in range(-1, steps):
                t0 = time.perf_counter()
                if t < 0:
                    batch = {"tokens": toks[:, :s], "positions": pos[:s]}
                    if mesh is None:
                        lg, cache = model.prefill(params, batch, cache)
                    else:
                        lg, cache = sharded_prefill(model, params, batch,
                                                    cache, mesh, **kw)
                else:
                    batch = {"tokens": toks[:, s + t:s + t + 1],
                             "positions": pos[s + t:s + t + 1]}
                    if mesh is None:
                        lg, cache = model.decode_step(params, batch, cache,
                                                      s + t)
                    else:
                        lg, cache = sharded_decode_step(
                            model, params, batch, cache, s + t, mesh, **kw)
                _sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                if not meta:
                    logits.append(lg[:, -1].float().cpu().numpy())
        peak = resident + cost.peak_new if meta else _peak_bytes(dev)
        out[mode] = dict(prefill_ms=ms[0], decode_ms=ms[1:],
                         resident_bytes=resident, peak_bytes=peak,
                         held_before_bytes=held_before,
                         allocated_at_reset_bytes=at_reset,
                         transport=_transport_delta(before, mesh)
                         if ranks else {})
        if not meta:
            out[mode]["logits"] = np.stack(logits)
        if counters is not None:
            out[mode]["launches"] = _launch_shapes(counters)
        del cache
    del params, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def predicted_step(rank, seed, smoke):
    """Phase 15: (h)'s step counted on the ``meta`` device by a
    ``CountingMesh`` of ``rank`` on (2, 2): ``sharded_loss_and_grads``
    then ``sharded_update`` (the rank's calls) under ``CostMode``.
    Returns the transport and the peak (the resident parameter and
    moment blocks and the batch, plus the storages the step makes)."""
    import torch
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.launch.sharding import opt_specs, param_specs, \
        to_named
    from repro_torch.launch.train import sharded_loss_and_grads, \
        sharded_update
    from repro_torch.train.optimizer import AdamW
    from repro_torch.tree import tree_leaves, tree_map
    meta = torch.device("meta")
    mesh = CountingMesh((2, 2), ("data", "model"), rank=rank, device=meta)
    model, batch = _group_step_setup(meta, seed, smoke)
    params = model.init_shapes()
    opt = AdamW()
    pb = tree_map(lambda x, sh: mesh.localize(x, sh.spec), params,
                  to_named(param_specs(model.cfg, params, mesh), mesh))
    ob = tree_map(lambda x, sh: mesh.localize(x, sh.spec), opt.init(params),
                  to_named(opt_specs(model.cfg, params, mesh), mesh))
    held = tree_leaves((pb, ob, batch))
    cost = CostMode(held)
    with cost:
        _, grads = sharded_loss_and_grads(model, pb, batch, mesh)
        sharded_update(model, opt, pb, ob, grads, mesh)
    return dict(transport=_transport_delta({}, mesh),
                peak_bytes=_nbytes(held) + cost.peak_new)


def _step_digests(mesh, pb, ob, specs, before=None):
    """{coordinates: {"p", "m", "v": [(shape, float64 norm, sample)] a
    leaf}} of the parameter and moment blocks each shard of this process
    holds (``specs``: the parameter and moment specs, leaf by leaf), the
    sample GROUP_DIGEST_SAMPLE elements at a fixed stride (numpy
    float32).  With ``before`` (this function's result before the
    update) a parameter block's sample is the update: after less
    before."""
    import torch
    from repro_torch.tree import tree_leaves
    leaves = {"p": tree_leaves(pb), "m": tree_leaves(ob["m"]),
              "v": tree_leaves(ob["v"])}
    spec_of = {"p": specs[0], "m": specs[1], "v": specs[1]}
    out = {}
    for c in mesh.local_coords():
        key = tuple(int(c[a]) for a in mesh.axis_names)
        dig = {}
        for k, xs in leaves.items():
            dig[k] = []
            for i, (x, sp) in enumerate(zip(xs, spec_of[k])):
                blk = x if mesh.spans_processes else mesh.block(x, sp, c)
                flat = blk.detach().reshape(-1)
                step = max(1, flat.numel() // GROUP_DIGEST_SAMPLE)
                # a copy: on the CPU .numpy() would share the storage
                # that the update writes into
                sample = flat[::step][:GROUP_DIGEST_SAMPLE].float().cpu() \
                    .numpy().copy()
                if before is not None and k == "p":
                    sample = sample - before[key]["p"][i][2]
                dig[k].append((tuple(blk.shape), float(
                    torch.linalg.vector_norm(flat, dtype=torch.float64)),
                    sample))
        out[key] = dig
    return out


def _same_digests(got, want, what):
    """``_step_digests`` of one shard against LocalMesh's at its
    coordinates: shapes equal, norms within GROUP_STEP_LOSS_RTOL, samples
    with cosine at least GROUP_STEP_MIN_COS (bit-equal ones pass).
    Returns the least cosine."""
    least = 1.0
    for k in ("p", "m", "v"):
        check(len(got[k]) == len(want[k]), f"{what}: {len(got[k])} {k} "
                                           f"blocks, not {len(want[k])}")
        for i, ((gs, gn, ga), (ws, wn, wa)) in enumerate(zip(got[k],
                                                             want[k])):
            check(gs == ws and abs(gn - wn) <= GROUP_STEP_LOSS_RTOL * abs(wn),
                  f"{what}: {k} block {i}: shape {gs}, norm {gn} against "
                  f"LocalMesh's {ws}, {wn}")
            if np.array_equal(ga, wa):
                continue
            ga, wa = ga.astype(np.float64), wa.astype(np.float64)
            den = np.linalg.norm(ga) * np.linalg.norm(wa)
            cos = float(ga @ wa / den) if den > 0 else 0.0
            least = min(least, cos)
            check(cos >= GROUP_STEP_MIN_COS, f"{what}: {k} block {i}: "
                  f"sample cosine {cos} with LocalMesh's")
    return least


def _npz_members(root):
    """{artifact: (manifest less its time and crc32s, {file: {member:
    bytes}})} of the partitioned artifacts under ``root``."""
    import io
    import zipfile
    out = {}
    for d in sorted(os.listdir(root)):
        mpath = os.path.join(root, d, "manifest.json")
        if d.startswith(".") or not os.path.exists(mpath):
            continue
        with open(mpath) as f:
            m = json.load(f)
        if m.get("partitioning") is None:
            continue
        files = {}
        for fn in sorted(os.listdir(os.path.join(root, d))):
            if fn.endswith(".npz"):
                with open(os.path.join(root, d, fn), "rb") as f:
                    z = zipfile.ZipFile(io.BytesIO(f.read()))
                files[fn] = {i.filename: z.read(i) for i in z.infolist()}
        m.pop("created")
        m.pop("checksums")
        out[d] = (m, files)
    return out


def _same_shard_files(group_root, local_root):
    """The GroupMesh's artifacts against LocalMesh(4)'s: the same names,
    manifests and files; every npz member byte-equal, except the float
    sums of a group-by ("total"), whose adds the hashed reduce's atomics
    order on the card: those within RTOL_FLOAT_AGG."""
    import io
    g, l = _npz_members(group_root), _npz_members(local_root)
    check(g and sorted(g) == sorted(l),
          f"phase 14 (b): artifacts {sorted(g)} against {sorted(l)}")
    same, close = 0, 0
    for name, (m, files) in g.items():
        lm, lfiles = l[name]
        check(m == lm, f"phase 14 (b): {name}: manifests differ")
        check(sorted(files) == sorted(lfiles),
              f"phase 14 (b): {name}: files differ")
        for fn, members in files.items():
            for mem, data in members.items():
                want = lfiles[fn][mem]
                if data == want:
                    same += 1
                    continue
                check(mem == "total.npy", f"phase 14 (b): {name}/{fn}/"
                      f"{mem} differs from LocalMesh(4)'s")
                a = np.load(io.BytesIO(data))
                b = np.load(io.BytesIO(want))
                check(np.allclose(a, b, rtol=RTOL_FLOAT_AGG, atol=1e-3),
                      f"phase 14 (b): {name}/{fn}: sums differ")
                close += 1
    return dict(artifacts=len(g), members_byte_equal=same,
                float_sum_members_within_tol=close)


def _same_layout(want, got, what):
    """Slot for slot: the keys, counts and maxima bit-equal; the float
    sums within RTOL_FLOAT_AGG (atomics order their adds on the card)."""
    check(sorted(want) == sorted(got), f"{what}: columns differ")
    for c in want:
        check(want[c].shape == got[c].shape, f"{what}: {c} shapes")
        if c == "total":
            check(np.allclose(got[c], want[c], rtol=RTOL_FLOAT_AGG,
                              atol=1e-3), f"{what}: {c} values")
        else:
            check(np.array_equal(got[c], want[c]), f"{what}: {c} values")
    return int(np.array_equal(got.get("total"), want.get("total")))


def _cat_rows(parts):
    return {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}


def group_phase(dev, card, seed, n_rows, counters, smoke=False):
    """Phase 14: the mesh across processes, (a)-(i).  The ranks count
    their own launches, zeroed just before each of (a), (b), (f), (g) and
    (h) and read just after; the parent's own runs (LocalMesh and one
    device, the yardsticks) are not counted.  ``smoke`` (a rehearsal on
    the CPU, ``dev`` the CPU): (c), (d) and (f)-(h) at their smoke
    configs and sizes, no (e)."""
    import torch
    from repro_torch.launch.mesh import LocalMesh, spawn
    t0 = time.perf_counter()
    rows = min(n_rows, 1 << MESH_LOG2_ROWS)
    log(f"CUT: phase 14 runs at page_views = 2**{MESH_LOG2_ROWS} rows "
        f"(phase 4's size); (d) saves and (h) trains qwen3-1.7b at full "
        f"width with {GROUP_CKPT_LAYERS} of its 28 layers")
    keep = tempfile.mkdtemp(prefix="restore_group_")
    try:
        # the yardsticks, in this process
        local = LocalMesh(GROUP_RANKS, device=dev)
        yard = {}
        sources_path = os.path.join(keep, "sources.npz")
        whole = _group_sources(local, rows, seed, dev, sources_path)
        yard["sources"] = time.perf_counter() - t0
        want_a, _, local_a_s = _plain_arm(local, dev, whole)
        skewed = _skewed_sources(dev)
        want_skew, _, _ = _plain_arm(local, dev, skewed, skew=1.25)
        yard["a"] = time.perf_counter() - t0 - sum(yard.values())
        want_b, local_b = _workflows(local, dev, whole,
                                     os.path.join(keep, "local"))
        yard["b"] = time.perf_counter() - t0 - sum(yard.values())
        del whole, skewed
        torch.cuda.empty_cache()
        want_c = _sync_run(LocalMesh(GROUP_RANKS, device=dev), dev, None,
                           smoke)
        torch.cuda.empty_cache()
        yard["c"] = time.perf_counter() - t0 - sum(yard.values())
        # (f)-(h)'s yardsticks: LocalMesh runs of the ranks' shapes, and
        # (g)'s unsharded greedy rollout, whose tokens every arm is fed
        model_dir = os.path.join(keep, "model")
        os.makedirs(model_dir)
        want_f = group_moe_run(LocalMesh((1, GROUP_RANKS), ("data", "model"),
                                         device=dev), dev, seed, smoke)
        plain_g = group_roll_run(None, dev, seed, smoke)
        np.save(os.path.join(model_dir, "feed.npy"), plain_g["feed"])
        mesh22 = LocalMesh((2, 2), ("data", "model"), device=dev)
        want_g = group_roll_run(mesh22, dev, seed, smoke, plain_g["feed"])
        want_h = group_step_run(mesh22, dev, seed, smoke,
                                os.path.join(model_dir, "grads.pt"))
        yard["fgh"] = time.perf_counter() - t0 - sum(yard.values())
        want_i = group_serve_run(mesh22, dev, seed, smoke)
        plain_i = group_serve_run(None, dev, seed, smoke)
        yard["i"] = time.perf_counter() - t0 - sum(yard.values())
        log(f"phase 14: the yardsticks in this process (LocalMesh("
            f"{GROUP_RANKS}) on the card) took "
            f"{time.perf_counter() - t0:.1f} s: "
            f"{ {k: round(v, 1) for k, v in yard.items()} }")
        # (a)-(d) on 4 gloo ranks sharing the card
        t1 = time.perf_counter()
        ranks = spawn(group_rank, GROUP_RANKS, backend="gloo",
                      init_file=os.path.join(keep, "rdv"),
                      timeout=GROUP_TIMEOUT_S,
                      args=(rows, seed, os.path.join(keep, "group"),
                            os.path.join(keep, "ckpt"), str(dev), smoke,
                            sources_path, model_dir))
        spawn_s = time.perf_counter() - t1
        # (d)'s restore on 2 gloo ranks and (e) over nccl, one rank a
        # card, side by side: two process groups of their own
        n_cards = torch.cuda.device_count()
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            fb = ex.submit(spawn, group_restore_rank, 2, backend="gloo",
                           init_file=os.path.join(keep, "rdv2"),
                           timeout=GROUP_TIMEOUT_S,
                           args=(os.path.join(keep, "ckpt"), seed,
                                 str(dev), smoke))
            fe = None if smoke else ex.submit(
                spawn, group_nccl_rank, n_cards, backend="nccl",
                init_file=os.path.join(keep, "rdv3"),
                timeout=GROUP_TIMEOUT_S,
                args=(rows, seed, sources_path))
            back = fb.result()
            nccl = [] if fe is None else fe.result()
        back_s = nccl_s = time.perf_counter() - t1
        files = _same_shard_files(os.path.join(keep, "group"),
                                  os.path.join(keep, "local"))
        want_e = None
        if n_cards != GROUP_RANKS and not smoke:
            nccl_mesh = LocalMesh(n_cards, device=dev)
            want_e = _plain_arm(nccl_mesh, dev, _group_sources(
                nccl_mesh, rows, seed, dev, sources_path))[0]
    finally:
        shutil.rmtree(keep, ignore_errors=True)

    # (a): the ranks' rows, in rank order, are LocalMesh(4)'s
    got_a = _cat_rows([r["a"]["rows"] for r in ranks])
    sums_bit_equal = _same_layout(want_a, got_a, "phase 14 (a)")
    same_groups(probe_rows({"dist_out": _Rows(want_a)}),
                probe_rows({"dist_out": _Rows(got_a)}), "phase 14 (a)")
    _same_layout(want_skew, _cat_rows([r["skewed"]["rows"]
                                       for r in ranks]),
                 "phase 14 (a), skewed")
    for r in ranks:
        check(r["skewed"]["retries"] == 1 and r["skewed"]["overflow"] > 0,
              f"phase 14 (a): rank {r['rank']}: the skewed case took "
              f"{r['skewed']['retries']} lossless retries")
        for k in ("partition_scatter", "join_probe", "segment_sum"):
            # (a CPU rehearsal launches no kernel)
            check(r["launches_a"][k] > 0 or dev.type != "cuda",
                  f"phase 14 (a): rank {r['rank']} never launched {k}")
        check(r["a"]["exchange_bytes"] > 0,
              f"phase 14 (a): rank {r['rank']} sent no rows")
        check(r["launches_a"]["join_probe_directory"]
              == r["launches_a"]["join_probe"], f"phase 14 (a): rank "
              f"{r['rank']}: a probe launch without its directory pre-pass")
    # (b): the warm workflow reused the join artifact and sent nothing;
    # its groups are the plain arm's
    got_b = _cat_rows([r["b_rows"] for r in ranks])
    _same_layout(want_b, got_b, "phase 14 (b)")
    same_groups(probe_rows({"dist_out": _Rows(want_a)}),
                probe_rows({"dist_out": _Rows(got_b)}), "phase 14 (b)")
    for r in ranks:
        b = r["b"]
        check(b["reused"] > 0 and b["warm_all_to_all"] == 0 and all(
            n == k for n, k in b["sites"]), f"phase 14 (b): rank "
            f"{r['rank']}: reused {b['reused']}, exchange sites "
            f"{b['sites']}, all_to_all calls {b['warm_all_to_all']}")
        check(b["artifacts"] == local_b["artifacts"],
              "phase 14 (b): the ranks' artifacts are not LocalMesh's")
    # (c): bit-equal to LocalMesh(4)'s
    for r in ranks:
        c = r["c"]
        check(c["means"] == want_c["means"]
              and c["step_sums"] == want_c["step_sums"]
              and c["errors"][r["rank"]] == want_c["errors"][r["rank"]],
              f"phase 14 (c): rank {r['rank']}: means or errors differ "
              "from LocalMesh(4)'s")
    # (d): every block equals the source
    for r in back:
        check(not r["bad"] and r["split"] > 0, f"phase 14 (d): rank "
              f"{r['coords']}: blocks {r['bad'][:4]} differ from the "
              f"source ({r['split']} of {r['leaves']} leaves split)")
    # (e)
    if nccl:
        got_e = _cat_rows([r["rows"] for r in nccl])
        _same_layout(want_a if want_e is None else want_e, got_e,
                     "phase 14 (e)")

    fgh = group_model_checks(ranks, want_f, plain_g, want_g, want_h, dev,
                             card, smoke)
    fgh["i"] = group_serve_checks(ranks, want_i, plain_i, dev, card)

    def per_rank(key):
        return [r[key] for r in ranks]

    for r in ranks:
        r["launches_fgh"] = {k: sum(r[x]["launches"].get(k, {}).get("n", 0)
                                    for x in "fgh")
                             + sum(r["i"][m]["launches"].get(k, {}).get(
                                 "n", 0) for m in ("base", "opt"))
                             for k in counters}
    launches = {k: sum(r["launches_a"].get(k, 0) + r["launches_b"].get(k, 0)
                       + r["launches_fgh"][k] for r in ranks)
                for k in counters}
    sync_ms = [float(np.median(r["c"]["ms"])) for r in ranks]
    out = dict(
        ranks=GROUP_RANKS, rows=rows,
        transport="gloo, 4 processes on one card: each collective's "
                  "tensors copied through pinned host buffers"
        if ranks[0]["staged"] else "gloo",
        a=dict(wall_s=[r["a"]["wall_s"] for r in ranks],
               exchange_bytes=[r["a"]["exchange_bytes"] for r in ranks],
               exchange_ms=[r["a"]["exchange_ms"] for r in ranks],
               exchanges=[r["a"]["exchanges"] for r in ranks],
               sites=ranks[0]["a"]["sites"], local_mesh_s=local_a_s,
               float_sums_bit_equal=bool(sums_bit_equal),
               launches_by_rank=per_rank("launches_a"),
               skewed_retries=[r["skewed"]["retries"] for r in ranks]),
        b=dict(cold_s=[r["b"]["cold_s"] for r in ranks],
               warm_s=[r["b"]["warm_s"] for r in ranks],
               local_mesh=local_b, files=files,
               launches_by_rank=per_rank("launches_b")),
        c=dict(leaves=want_c["leaves"], elements=want_c["elements"],
               steps=GROUP_SYNC_STEPS, sync_ms=sync_ms,
               gb_per_s=[ranks[i]["c"]["bytes"] / sync_ms[i] / 1e6
                         for i in range(len(ranks))],
               local_mesh_ms=float(np.median(want_c["ms"]))),
        d=dict(params=ranks[0]["d_params"], layers=GROUP_CKPT_LAYERS,
               save_s=[r["d_save_s"] for r in ranks],
               restore_s=[r["restore_s"] for r in back],
               leaves=back[0]["leaves"],
               split_leaves=back[0]["split"]),
        e=dict(ranks=n_cards, wall_s=[r["wall_s"] for r in nccl],
               devices=[r["device"] for r in nccl],
               all_to_all=[r["transport"].get("all_to_all") for r in nccl],
               spawn_s=nccl_s),
        f=fgh["f"], g=fgh["g"], h=fgh["h"], i=fgh["i"],
        launches_fgh_by_rank=per_rank("launches_fgh"),
        staged_bytes=per_rank("staged_bytes"),
        part_s=per_rank("part_s"), yardstick_s=yard,
        spawn_s=spawn_s, restore_spawn_s=back_s, launches=launches,
        phase_s=time.perf_counter() - t0)
    a = out["a"]
    log(f"phase 14: transport: {out['transport']}")
    for i in range(GROUP_RANKS):
        log(f"phase 14 (a): rank {i}: join -> group-by at {rows} rows, "
            f"skew {MESH_SKEW}: wall {a['wall_s'][i]:.3f} s, exchange "
            f"{a['exchanges'][i]} all_to_all {a['exchange_bytes'][i]} "
            f"bytes in {a['exchange_ms'][i]:.1f} ms, launches "
            f"{a['launches_by_rank'][i]} [{card}]")
    log(f"phase 14 (a): the ranks' rows, in rank order, equal LocalMesh("
        f"{GROUP_RANKS})'s slot for slot (float sums bit-equal: "
        f"{a['float_sums_bit_equal']}); LocalMesh({GROUP_RANKS}) in one "
        f"process {local_a_s:.3f} s; the skewed case retried losslessly "
        f"on every rank {a['skewed_retries']} [{card}]")
    b = out["b"]
    log(f"phase 14 (b): ReStore over the ranks: cold {b['cold_s']} s, "
        f"warm {b['warm_s']} s (no exchange: every site skipped, no "
        f"all_to_all); LocalMesh: cold {local_b['cold_s']:.3f} s, warm "
        f"{local_b['warm_s']:.3f} s; {files['artifacts']} partitioned "
        f"artifacts, manifests equal, {files['members_byte_equal']} npz "
        f"members byte-equal to LocalMesh's, "
        f"{files['float_sum_members_within_tol']} float-sum members within"
        f" {RTOL_FLOAT_AGG} [{card}]")
    c = out["c"]
    log(f"phase 14 (c): make_compressed_sync over {GROUP_RANKS} ranks, "
        f"one {SERVE_ARCH} layer ({c['leaves']} leaves, {c['elements']} "
        f"elements a rank, bf16), {GROUP_SYNC_STEPS} steps: means and "
        f"errors bit-equal to LocalMesh({GROUP_RANKS})'s; ms a step by "
        f"rank {[round(x, 2) for x in sync_ms]} = "
        f"{[round(x, 2) for x in c['gb_per_s']]} GB/s of gradients "
        f"(LocalMesh {c['local_mesh_ms']:.2f} ms) [{card}]")
    d = out["d"]
    log(f"phase 14 (d): {SERVE_ARCH} at full width, {GROUP_CKPT_LAYERS} "
        f"layers ({d['params']} parameters, bf16) saved from a (2, 2) mesh"
        f" of 4 ranks in {max(d['save_s']):.2f} s, restored on (1, 2) in "
        f"{max(d['restore_s']):.2f} s (beside (e)): every block of "
        f"{d['leaves']} leaves"
        f" ({d['split_leaves']} split) equals the source [{card}]")
    e = out["e"]
    log(f"phase 14 (e): nccl, {n_cards} rank(s), one a card "
        f"({e['devices']}): (a)'s plan in {e['wall_s']} s, rows equal "
        f"LocalMesh({n_cards})'s"
        + ("; this machine has one card, so no row crossed a card: a run "
           "across cards waits for a four-chip cell" if n_cards == 1
           else "") + f" [{card}]")
    log(f"phase 14: a rank's parts, s: "
        f"{[{k: round(v, 1) for k, v in r['part_s'].items()} for r in ranks]}")
    log(f"phase 14: spawn of {GROUP_RANKS} ranks (a)-(d) {spawn_s:.1f} s, "
        f"of 2 ranks (d) beside the nccl one (e) {back_s:.1f} s; staged "
        f"bytes by rank {out['staged_bytes']}")
    return out


def group_model_checks(ranks, want_f, plain_g, want_g, want_h, dev, card,
                       smoke):
    """Phase 14 (f)-(h): each rank against the LocalMesh run of its shape
    in this process (and (g) against the unsharded rollout); logs each
    part's walls, transport, resident bytes and launches by shape a
    rank.  Returns their summaries."""
    on_card = dev.type == "cuda"
    out = {}
    # (f): slots bit-equal, the output within SUBLAYER_RTOL of LocalMesh's
    f_eq, f_rel = [], []
    for r in ranks:
        f = r["f"]
        i = r["rank"]
        check(len(f["slots"]) == 1 and np.array_equal(
            f["slots"][0], want_f["slots"][i])
            and f["drops"] == [want_f["drops"][i]],
            f"phase 14 (f): rank {i}: slots or drops differ from "
            f"LocalMesh((1, {GROUP_RANKS}))'s shard {i}")
        rel = float(np.abs(f["out"] - want_f["out"]).max()) / max(
            float(np.abs(want_f["out"]).max()), 1e-30)
        check(rel <= SUBLAYER_RTOL and f["aux"] == want_f["aux"],
              f"phase 14 (f): rank {i}: output {rel} off LocalMesh's")
        f_eq.append(bool(np.array_equal(f["out"], want_f["out"])))
        f_rel.append(rel)
        check(not on_card or f["launches"]["partition_scatter"]["n"] == 1,
              f"phase 14 (f): rank {i}: partition_scatter launches "
              f"{f['launches'].get('partition_scatter')}, not 1")
    out["f"] = dict(
        mesh=f"(1, {GROUP_RANKS})", tokens=[GROUP_MOE_BATCH, GROUP_MOE_SEQ],
        experts_a_rank=ranks[0]["f"]["experts_held"],
        resident_bytes=[r["f"]["resident_bytes"] for r in ranks],
        whole_bytes=want_f["resident_bytes"],
        wall_s=[r["f"]["wall_s"] for r in ranks],
        local_mesh_s=want_f["wall_s"], bit_equal=f_eq, max_rel=f_rel,
        drops=[r["f"]["drops"][0] for r in ranks],
        transport=[r["f"]["transport"] for r in ranks],
        launches=[r["f"]["launches"] for r in ranks])
    # (g): every step's logits within LOGIT_ATOL_BF16 of the unsharded
    # rollout's and of LocalMesh's
    g_err, g_local = [], []
    for r in ranks:
        g = r["g"]
        lo, hi = g["rows"]
        err = float(np.abs(g["logits"] - plain_g["logits"][:, lo:hi]).max())
        loc = float(np.abs(g["logits"] - want_g["logits"][:, lo:hi]).max())
        check(err <= LOGIT_ATOL_BF16 and loc <= LOGIT_ATOL_BF16,
              f"phase 14 (g): rank {r['rank']}: logits {err} off the "
              f"unsharded rollout, {loc} off LocalMesh's")
        check(g["cache_bytes"] * GROUP_RANKS == g["whole_cache_bytes"],
              f"phase 14 (g): rank {r['rank']} holds {g['cache_bytes']} "
              f"cache bytes of {g['whole_cache_bytes']}")
        check(not on_card or g["launches"]["flash_attention"]["n"] > 0,
              f"phase 14 (g): rank {r['rank']} launched no attention")
        g_err.append(err)
        g_local.append(loc)
    med = [float(np.median(r["g"]["decode_ms"])) for r in ranks]
    out["g"] = dict(
        mesh="(2, 2)", batch=plain_g["logits"].shape[1],
        steps=len(plain_g["decode_ms"]), max_abs_err=g_err,
        max_abs_err_vs_local=g_local, atol=LOGIT_ATOL_BF16,
        prefill_s=[r["g"]["prefill_s"] for r in ranks],
        decode_ms_median=med,
        local_mesh=dict(prefill_s=want_g["prefill_s"], decode_ms_median=float(
            np.median(want_g["decode_ms"]))),
        unsharded=dict(prefill_s=plain_g["prefill_s"], decode_ms_median=float(
            np.median(plain_g["decode_ms"]))),
        cache_bytes=[r["g"]["cache_bytes"] for r in ranks],
        whole_cache_bytes=ranks[0]["g"]["whole_cache_bytes"],
        transport=[r["g"]["transport"] for r in ranks],
        launches=[r["g"]["launches"] for r in ranks])
    # (h): the loss and the global norm within GROUP_STEP_LOSS_RTOL of
    # LocalMesh's step, every rank's gradient leaves' cosines at least
    # GROUP_STEP_MIN_COS, its updated blocks LocalMesh's at its
    # coordinates (``_same_digests``)
    h_cos = []
    for r in ranks:
        h = r["h"]
        rel = abs(h["loss"] - want_h["loss"]) / abs(want_h["loss"])
        check(rel <= GROUP_STEP_LOSS_RTOL and h["step"] == 1,
              f"phase 14 (h): rank {r['rank']}: loss {h['loss']} against "
              f"LocalMesh's {want_h['loss']}")
        rel = abs(h["gnorm"] - want_h["gnorm"]) / abs(want_h["gnorm"])
        check(rel <= GROUP_STEP_LOSS_RTOL, f"phase 14 (h): rank "
              f"{r['rank']}: global norm {h['gnorm']} against LocalMesh's "
              f"{want_h['gnorm']}")
        check(h["cos"][0] >= GROUP_STEP_MIN_COS, f"phase 14 (h): rank "
              f"{r['rank']}: gradient cosine {h['cos'][0]} at {h['cos'][1]}")
        (key, got), = h["digests"].items()
        h_cos.append(_same_digests(got, want_h["digests"][key],
                                   f"phase 14 (h): rank {r['rank']} at "
                                   f"{key}"))
        check(h["held_bytes"] < h["whole_bytes"],
              f"phase 14 (h): rank {r['rank']} holds every byte")
        check(not on_card or (h["launches"]["flash_attention"]["n"] > 0
                              and h["launches"]["flash_attention_bwd"]["n"]
                              > 0),
              f"phase 14 (h): rank {r['rank']}: attention launches "
              f"{h['launches']}")
    cos = min((r["h"]["cos"] for r in ranks), key=lambda c: c[0])
    out["h"] = dict(
        mesh="(2, 2)", tokens=[GROUP_STEP_BATCH, GROUP_STEP_SEQ],
        layers=GROUP_CKPT_LAYERS, loss=[r["h"]["loss"] for r in ranks],
        local_mesh_loss=want_h["loss"], gnorm=[r["h"]["gnorm"] for r in ranks],
        local_mesh_gnorm=want_h["gnorm"], min_cos=cos[0], min_cos_leaf=cos[1],
        leaves_bit_equal=cos[2], leaves=ranks[0]["h"]["leaves"],
        block_min_cos=min(h_cos),
        grad_s=[r["h"]["grad_s"] for r in ranks],
        update_s=[r["h"]["update_s"] for r in ranks],
        local_mesh_s=[want_h["grad_s"], want_h["update_s"]],
        held_bytes=[r["h"]["held_bytes"] for r in ranks],
        peak_bytes=[r["h"]["peak_bytes"] for r in ranks],
        whole_bytes=ranks[0]["h"]["whole_bytes"],
        transport=[r["h"]["transport"] for r in ranks],
        launches=[r["h"]["launches"] for r in ranks])
    f, g, h = out["f"], out["g"], out["h"]
    for i, r in enumerate(ranks):
        log(f"phase 14 (f): rank {i}: {MOE_ARCH} MoE sublayer at full width"
            f" on (1, {GROUP_RANKS}), {f['experts_a_rank']} experts held "
            f"({f['resident_bytes'][i]} bytes, whole "
            f"{f['whole_bytes']}), wall {f['wall_s'][i]:.3f} s, transport "
            f"{f['transport'][i]}, launches {f['launches'][i]} [{card}]")
    log(f"phase 14 (f): slots and drops bit-equal to LocalMesh((1, "
        f"{GROUP_RANKS}))'s shard by shard, outputs bit-equal {f_eq} (max "
        f"rel {max(f_rel):.3g}); LocalMesh in one process "
        f"{want_f['wall_s']:.3f} s [{card}]")
    for i, r in enumerate(ranks):
        log(f"phase 14 (g): rank {i}: {SERVE_ARCH} whole on (2, 2), rows "
            f"{r['g']['rows']}: prefill {g['prefill_s'][i]:.3f} s, decode "
            f"{g['decode_ms_median'][i]:.2f} ms a step (median of "
            f"{g['steps']}), cache held {g['cache_bytes'][i]} of "
            f"{g['whole_cache_bytes']} bytes, transport "
            f"{g['transport'][i]}, launches {g['launches'][i]} [{card}]")
    log(f"phase 14 (g): every step's logits within {max(g_err):.4f} of the "
        f"unsharded rollout's and {max(g_local):.4f} of LocalMesh((2, 2))'s "
        f"(atol {LOGIT_ATOL_BF16}); unsharded {g['unsharded']}, LocalMesh "
        f"{g['local_mesh']} [{card}]")
    for i, r in enumerate(ranks):
        log(f"phase 14 (h): rank {i}: the sharded step of {SERVE_ARCH} "
            f"({GROUP_CKPT_LAYERS} layers) at {GROUP_STEP_BATCH} x "
            f"{GROUP_STEP_SEQ}: loss {h['loss'][i]:.6f}, gnorm "
            f"{h['gnorm'][i]:.4f}, gradients {h['grad_s'][i]:.3f} s, update"
            f" {h['update_s'][i]:.3f} s, held {h['held_bytes'][i]} of "
            f"{h['whole_bytes']} bytes, transport {h['transport'][i]}, "
            f"launches {h['launches'][i]} [{card}]")
    log(f"phase 14 (h): LocalMesh((2, 2)) loss {want_h['loss']:.6f}, gnorm "
        f"{want_h['gnorm']:.4f}, {want_h['grad_s']:.3f} + "
        f"{want_h['update_s']:.3f} s; every rank's global norm within "
        f"{GROUP_STEP_LOSS_RTOL} of it; least gradient cosine over the "
        f"ranks {cos[0]:.6f} ({cos[1]}), {cos[2]} of {h['leaves']} leaves "
        f"bit-equal; each rank's updated parameter, m and v blocks against "
        f"LocalMesh's at its coordinates: norms within "
        f"{GROUP_STEP_LOSS_RTOL}, least sample cosine {min(h_cos):.6f} "
        f"[{card}]")
    return out


def group_serve_checks(ranks, want_i, plain_i, dev, card):
    """Phase 14 (i): each rank's logits of every call, in each mode,
    bit-equal to ``LocalMesh((2, 2))``'s and within LOGIT_ATOL_BF16 of
    the one-device calls'; on the card every rank launched the attention
    kernel in both modes.  Logs walls, transport, peaks and the launches
    by route and shape; returns the summary."""
    on_card = dev.type == "cuda"
    out = {}
    for mode in ("base", "opt"):
        err = []
        for r in ranks:
            got = r["i"][mode]
            check(np.array_equal(got["logits"], want_i[mode]["logits"]),
                  f"phase 14 (i) {mode}: rank {r['rank']}: logits differ "
                  f"from LocalMesh((2, 2))'s")
            e = float(np.abs(got["logits"] - plain_i[mode]["logits"]).max())
            check(e <= LOGIT_ATOL_BF16, f"phase 14 (i) {mode}: rank "
                  f"{r['rank']}: logits {e} off the one-device calls'")
            check(not on_card or got["launches"].get(
                "flash_attention", {}).get("n", 0) > 0,
                f"phase 14 (i) {mode}: rank {r['rank']} launched no "
                f"attention kernel: {got['launches']}")
            err.append(e)
        out[mode] = dict(
            max_abs_err=err, atol=LOGIT_ATOL_BF16,
            prefill_ms=[r["i"][mode]["prefill_ms"] for r in ranks],
            decode_ms=[r["i"][mode]["decode_ms"] for r in ranks],
            peak_bytes=[r["i"][mode]["peak_bytes"] for r in ranks],
            held_before_bytes=[r["i"][mode]["held_before_bytes"]
                               for r in ranks],
            allocated_at_reset_bytes=[r["i"][mode]["allocated_at_reset_bytes"]
                                      for r in ranks],
            resident_bytes=[r["i"][mode]["resident_bytes"] for r in ranks],
            transport=[r["i"][mode]["transport"] for r in ranks],
            launches=[r["i"][mode]["launches"] for r in ranks],
            local_mesh=dict(prefill_ms=want_i[mode]["prefill_ms"],
                            decode_ms=want_i[mode]["decode_ms"]),
            one_device=dict(prefill_ms=plain_i[mode]["prefill_ms"],
                            decode_ms=plain_i[mode]["decode_ms"]))
        o = out[mode]
        for i, r in enumerate(ranks):
            log(f"phase 14 (i) {mode}: rank {i}: {SERVE_ARCH} "
                f"({GROUP_CKPT_LAYERS} layers) on (2, 2), "
                f"{GROUP_SERVE_BATCH} rows: prefill {o['prefill_ms'][i]:.1f}"
                f" ms, decode {[round(x, 1) for x in o['decode_ms'][i]]} "
                f"ms, resident {o['resident_bytes'][i]} bytes (allocated "
                f"before (i) {o['held_before_bytes'][i]}, at the peak's "
                f"reset {o['allocated_at_reset_bytes'][i]}), peak "
                f"{o['peak_bytes'][i]} bytes, transport "
                f"{o['transport'][i]}, launches by route and shape "
                f"{o['launches'][i]} [{card}]")
        log(f"phase 14 (i) {mode}: every call's logits on every rank "
            f"bit-equal to LocalMesh((2, 2))'s, within {max(err):.4f} of "
            f"the one-device calls' (atol {LOGIT_ATOL_BF16}); LocalMesh "
            f"{o['local_mesh']}, one device {o['one_device']} [{card}]")
    return out


# ------------------------- phase 15: the dry-run per device of a mesh

# the per-device reports printed: these cells on both production meshes,
# with and without --opt
MESH_DRYRUN_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "decode_32k"))
MESH_DRYRUN_WAIT_S = 300
MESH_DRYRUN_CODE = """
import json, os, sys
os.nice(19)          # behind phase 14's ranks and yardsticks for the cores
from repro_torch.launch.dryrun import MESHES, lower_cell
out, cells = sys.argv[1], json.loads(sys.argv[2])
for arch, shape in cells:
    for tag, mesh in MESHES.items():
        for opt in (False, True):
            rep = lower_cell(arch, shape, mesh=mesh, optimized=opt)
            name = f"{arch}_{shape}_{tag}" + ("_opt" if opt else "")
            with open(os.path.join(out, name + ".json"), "w") as f:
                json.dump(rep, f)
"""


class MeshReports:
    """``launch/dryrun.py``'s per-device reports of MESH_DRYRUN_CELLS on
    16x16 and 2x16x16, with and without --opt, counted in one CPU
    process (the card hidden from it, at the lowest priority) started
    before phase 14 and read in phase 15.  ``stop`` (also at exit) ends it and removes its
    files."""

    def __init__(self):
        import atexit
        self.dir = tempfile.mkdtemp(prefix="restore_meshdry_")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=SRC + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        self.log = os.path.join(self.dir, "log")
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", MESH_DRYRUN_CODE, self.dir,
                 json.dumps(MESH_DRYRUN_CELLS)], stdout=f,
                stderr=subprocess.STDOUT, env=env)
        self.t0 = time.perf_counter()
        atexit.register(self.stop)

    def read(self):
        """(the reports, seconds from the start to their reading)."""
        from repro_torch.roofline import analysis as RA
        try:
            rc = self.proc.wait(MESH_DRYRUN_WAIT_S)
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            with open(self.log) as f:
                tail = f.read()[-3000:]
            check(False, f"phase 15: the mesh dry-run ended with {rc}: "
                         f"{tail}")
        return RA.load_reports(self.dir), time.perf_counter() - self.t0

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def _calls_bytes(transport):
    return {k: (v["calls"], v["bytes"]) for k, v in transport.items()
            if v["calls"]}


def mesh_count_phase(group, dev, card, seed, reports, smoke=False):
    """Phase 15: the counting mesh (``launch/mesh.py::CountingMesh``) of
    each rank counts phase 14 (h) and (i) on the ``meta`` device at their
    own dims: each rank's predicted transport (calls and bytes by kind)
    equal to its measured one, and its predicted peak within
    PEAK_RATIO_MAX of its ``torch.cuda.max_memory_allocated``; then the
    per-device reports of MESH_DRYRUN_CELLS with their roofline rows."""
    import torch
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.roofline import analysis as RA
    t0 = time.perf_counter()
    meta = torch.device("meta")
    on_card = dev.type == "cuda"
    parts = {}
    for r in range(GROUP_RANKS):
        mesh = CountingMesh((2, 2), ("data", "model"), rank=r, device=meta)
        pred_i = group_serve_run(mesh, meta, seed, smoke)
        pred = {"h": predicted_step(r, seed, smoke),
                "i base": pred_i["base"], "i opt": pred_i["opt"]}
        got = {"h": (group["h"]["transport"][r], group["h"]["peak_bytes"][r]),
               "i base": (group["i"]["base"]["transport"][r],
                          group["i"]["base"]["peak_bytes"][r]),
               "i opt": (group["i"]["opt"]["transport"][r],
                         group["i"]["opt"]["peak_bytes"][r])}
        for part, p in pred.items():
            want, peak = _calls_bytes(p["transport"]), p["peak_bytes"]
            have, measured = _calls_bytes(got[part][0]), got[part][1]
            check(want == have, f"phase 15: rank {r} ({part}): predicted "
                  f"transport {want}, measured {have}")
            ratio = peak / measured if measured else None
            check(not on_card or 1 / PEAK_RATIO_MAX <= ratio
                  <= PEAK_RATIO_MAX, f"phase 15: rank {r} ({part}): "
                  f"predicted peak {peak} bytes against the measured "
                  f"{measured}")
            parts.setdefault(part, []).append(dict(
                transport=want, predicted_peak_bytes=peak,
                measured_peak_bytes=measured,
                predicted_over_measured=ratio))
    for part, rows in parts.items():
        log(f"phase 15 ({part}): each rank's transport counted on the meta "
            f"device equals its measured one: {rows[0]['transport']}; "
            f"peak predicted / measured by rank "
            f"{[r['predicted_peak_bytes'] for r in rows]} / "
            f"{[r['measured_peak_bytes'] for r in rows]} bytes (x"
            f"{[None if r['predicted_over_measured'] is None else round(r['predicted_over_measured'], 3) for r in rows]}) [{card}]")
    count_s = time.perf_counter() - t0
    reps, reports_s = reports.read()
    rows = []
    for rep in sorted(reps, key=lambda x: (x["shape"], x["mesh"],
                                           x["_optimized"])):
        check(rep["status"] == "ok", f"phase 15: {rep['arch']} x "
              f"{rep['shape']} on {rep['mesh']}: {rep.get('error')}")
        c, m = rep["cost_extrapolated"], rep["memory"]
        row = RA.analyze_cell(rep)
        tag = rep["mesh"] + (" --opt" if rep["_optimized"] else "")
        rows.append(dict(arch=rep["arch"], shape=rep["shape"], mesh=tag,
                         flops=c["flops"], bytes=c["bytes"],
                         collective_bytes=c["collective_bytes"],
                         by_link=c["collective_bytes_by_link"],
                         peak_bytes=m["peak_bytes"],
                         fits_one_card=rep["fits_one_card"],
                         t_compute_s=row["t_compute_s"],
                         t_memory_s=row["t_memory_s"],
                         t_collective_s=row["t_collective_s"],
                         dominant=row["dominant"]))
        log(f"phase 15: {rep['arch']} x {rep['shape']} on {tag}, rank 0 "
            f"(meta device, predicted at the data-sheet constants): flops "
            f"{c['flops']:.4g}, bytes {c['bytes']:.4g}, collectives "
            f"{ {k: v for k, v in c['collective_bytes'].items() if v} } "
            f"by link {c['collective_bytes_by_link']}, peak "
            f"{m['peak_bytes'] / 1e9:.2f} GB, fits one card "
            f"{rep['fits_one_card']}; roofline compute "
            f"{RA.fmt_s(row['t_compute_s'])}, memory "
            f"{RA.fmt_s(row['t_memory_s'])}, collective "
            f"{RA.fmt_s(row['t_collective_s'])} ({row['dominant']}) "
            f"[{card}]")
    check(len(rows) == 4 * len(MESH_DRYRUN_CELLS),
          f"phase 15: {len(rows)} mesh reports")
    return dict(parts=parts, reports=rows, count_s=count_s,
                reports_s=reports_s, phase_s=time.perf_counter() - t0)


class _Rows:
    """``probe_rows`` reads ``.to_numpy()``: rows already on the host."""

    def __init__(self, rows):
        self.rows = rows

    def to_numpy(self):
        return self.rows


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", metavar="SRC",
                    help="another checkout's src directory: phase 8 (a) "
                         "times its attention backward beside this one's")
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
    from repro_torch.kernels.flash_attention import ops as fa
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
    f32_lse = f32_lse_checks(dev)
    log(f"phase 1: flash_attention f32 row statistic on {f32_lse['cases']} "
        f"cases within {f32_lse['tol']} of mha_lse_ref (worst "
        f"{f32_lse['lse_max_abs_err']:.3g}); at {f32_lse['shape']}: with "
        f"the statistic {f32_lse['ms']:.4f} ms, without "
        f"{f32_lse['without_statistic_ms']:.4f} ms, plain "
        f"{f32_lse['plain_ms']:.4f} ms, library {f32_lse['library_ms']:.4f}"
        f" ms, bound {f32_lse['bound_ms']:.4f} ms ({f32_lse['bound_by']}) "
        f"[{card}]")

    f32_mla = f32_mla_checks(dev)
    log(f"phase 1: flash_attention f32 at (D_qk, D_v) {F32_MLA_DIMS}: "
        f"{f32_mla['cases']} calls, forward within {FA_TOL['float32']} "
        f"(worst {f32_mla['fwd_max_abs_err']:.3g}), statistic within "
        f"{LSE_TOL_F32} (worst {f32_mla['lse_max_abs_err']:.3g}), backward"
        f" within {BWD_TOL['float32']} of the largest plain entry (worst "
        f"{f32_mla['bwd_max_rel_err']:.3g}), given lse bit-equal; "
        f"_sdpa_chunked's f32 gradient against its plain route "
        f"{f32_mla['chunked_grad_rel_err']}")
    for dims, t in f32_mla["at"].items():
        log(f"phase 1: flash_attention f32 {dims} at {f32_mla['shape']}: "
            f"forward {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
            f"ms ({t['bound_by']}); backward {t['bwd_ms']:.4f} ms, plain "
            f"{t['bwd_plain_ms']:.4f} ms, library {t['bwd_library_ms']:.4f}"
            f" ms, bound {t['bwd_bound_ms']:.4f} ms ({t['bwd_bound_by']}) "
            f"[{card}]")

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
    mesh_rows = min(n_rows, 1 << MESH_LOG2_ROWS)
    if mesh_rows < n_rows:
        log(f"CUT: phase 4 runs the mesh arms at page_views = "
            f"2**{MESH_LOG2_ROWS} rows, not 2**{args.log2_rows}, so the "
            "script keeps within its time limit")
    try:
        mesh = mesh_arms(dev, mesh_rows, args.seed, keep, card, counters)
        skew = skewed_retry(dev, card)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    mesh_launches = mesh["launches"]
    for arm in ("t_single", "t_mesh_plain", "t_reuse_blind",
                "t_reuse_copart"):
        log(f"phase 4: {arm:<15} {mesh[arm]:.4f} s  jobs "
            f"{mesh['job_walls'].get(arm)}  shuffles/skipped/overflow/"
            f"retries "
            f"{mesh['shuffles'].get(arm)}  (page_views {mesh_rows} rows, "
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
        f32_lse=f32_lse, f32_mla=f32_mla, **fa_shapes[0],
        at_shapes=fa_shapes[1:]))

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

    # ---- phase 7: the store's tiers, their own counts (zeroed just
    # before (a) and read just after (b), inside tier_phase)
    torch.cuda.empty_cache()
    counters.update(flash_attention=fa.launches,
                    flash_attention_merge=fa.merge_launches,
                    flash_attention_bwd=fa.backward_launches,
                    flash_attention_bwd_sm90=fa.backward_sm90_launches,
                    flash_attention_bwd_simt=fa.backward_simt_launches)
    tiers = tier_phase(dev, n_rows, args.seed, counters)
    tr, tb = tiers["round_trip"], tiers["tier_bench"]
    log(f"phase 7 (a): {tr['artifact']} ({tr['rows']} rows, "
        f"{tr['nbytes'] / 1e6:.1f} MB stored, {tr['device_nbytes'] / 1e6:.1f}"
        f" MB on the card; page_views {n_rows} rows): device -> pinned host "
        f"-> disk -> remote -> promoted back, crc equal after "
        f"{tr['crcs_equal']}; host demotion {tr['host_demotion_s']:.4f} s, "
        f"demote to remote {tr['demote_to_remote_s']:.3f} s (blob "
        f"{tr['blob_bytes'] / 1e6:.1f} MB), promote {tr['promote_s']:.3f} s"
        f" [{card}]")
    for tier in ("hostload", "load", "remoteload"):
        r = tr[tier]
        log(f"phase 7 (a): io_stats {tier:<10} {r['bytes']} bytes in "
            f"{r['s']:.4f} s = {r['gb_per_s']:.3f} GB/s [{card}]")
    log(f"phase 7 (a): reads waited out on the card, s: "
        f"{tr['synced_read_s']}, GB/s: {tr['synced_gb_per_s']}; part "
        f"{tr['part_s']:.1f} s [{card}]")
    log(f"phase 7 (b): tier_bench at {tb['n_rows']} rows x {TIER_ARTS} "
        f"artifacts, {TIER_PROBES} zipf-{TIER_ZIPF} probes, drop_caches "
        f"every {TIER_FLUSH_EVERY}, k = {TIER_K}, remote "
        f"{TIER_REMOTE_LATENCY_S * 1e3:.0f} ms / {TIER_REMOTE_BW / 1e6:.0f} "
        f"MB/s: demand {tb['t_off_s']:.4f} s, prefetch {tb['t_on_s']:.4f} s "
        f"(x{tb['speedup_prefetch']:.3f}), hits {tb['prefetch_hits']} "
        f"(rate {tb['prefetch_hit_rate']:.3f}), host demotions "
        f"{tb['host_demotions']}, crcs identical; cold start "
        f"{tb['cold_start_s']:.3f} s; bandwidths {tb['bw']}; part "
        f"{tb['part_s']:.1f} s [{card}]")
    log(f"phase 7: kernel launches on the tier path: {tiers['launches']}; "
        f"took {tiers['phase_s']:.1f} s")
    check(tiers["launches"]["filter_compact"] > 0,
          "filter_compact was never launched on the tier path")

    # ---- phase 8: training, its own counts (zeroed and read around the
    # 12 steps of (b), inside qwen_training)
    torch.cuda.empty_cache()
    training = training_phase(dev, card, counters, args.against)
    qw = report_training(training, card)
    bwd = training["backward_shapes"]
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="none: no TPU counterpart (the reference differentiates "
                 "src/repro/models/layers.py:141 _sdpa by JAX autodiff)",
        launches=qw["launches"]["flash_attention_bwd"], service_launches=0,
        route_launches={r: qw["launches"][f"flash_attention_bwd_{r}"]
                        for r in ("sm90", "simt")},
        long_context_launches=qw["long"]["launches"]["flash_attention_bwd"],
        **{k: v for k, v in bwd[0].items()}, at_shapes=bwd[1:]))

    # ---- phase 9: the model families, their own counts (zeroed just
    # before and read just after each model's main path, inside
    # families_phase)
    torch.cuda.empty_cache()
    families = families_phase(dev, card, args.seed, counters)
    log(f"phase 9: kernel launches on the families' paths: "
        f"{families['launches']}; took {families['phase_s']:.1f} s")
    mla = families["mla"]
    kernels.append(dict(
        name="flash_attention_mla", route="cuda",
        source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:104",
        launches=mla["flash_by_dims"].get("sm90 96/64", 0),
        service_launches=0, dims="D_qk 96, D_v 64 (minicpm3-4b's MLA)",
        **{k: v for k, v in mla["attention"][0].items()},
        at_shapes=mla["attention"][1:]))
    for k in kernels:
        if k["name"] == "partition_scatter":
            k["moe"] = moe_scatter_measurement(dev)
            k["moe"]["launches"] = families["moe"]["launches"][k["name"]]
            k["moe"]["launch_shapes"] = \
                families["moe"]["partition_scatter_shapes"]
        k["families_launches"] = families["launches"].get(
            k["name"], k["launches"] if k["name"] == "flash_attention_mla"
            else 0)

    # ---- phase 10: the recurrent mixers, their own counts (zeroed just
    # before and read just after each model's main path, inside
    # recurrent_phase)
    torch.cuda.empty_cache()
    recurrent = recurrent_phase(dev, card, args.seed, counters)
    log(f"phase 10: kernel launches on the recurrent families' paths: "
        f"{recurrent['launches']}; took {recurrent['phase_s']:.1f} s")
    jamba = recurrent["jamba"]
    for k in kernels:
        k["recurrent_launches"] = recurrent["launches"].get(k["name"], 0)
        if k["name"] == "partition_scatter":
            k["jamba"] = dict(at_shapes=jamba["scatter"],
                              launch_shapes=jamba["partition_scatter_shapes"])
        if k["name"] == "flash_attention":
            k["jamba"] = dict(at_shapes=jamba["attention"],
                              launches_by_dims=jamba["flash_by_dims"],
                              merge_launches=jamba["flash_merge_launches"])

    # ---- phase 11: the encoder-decoder family and MLA's training, their
    # own counts (zeroed just before and read just after each main path,
    # inside encdec_phase)
    torch.cuda.empty_cache()
    encdec = encdec_phase(dev, card, args.seed, counters)
    log(f"phase 11: kernel launches on the encoder-decoder and MLA "
        f"training paths: {encdec['launches']}; flash_attention by route "
        f"and dims {encdec['flash_by_dims']}; took "
        f"{encdec['phase_s']:.1f} s")
    mla11 = encdec["flash_by_dims"].get("sm90 96/64", 0)
    for k in kernels:
        k["encdec_launches"] = encdec["launches"].get(k["name"], 0)
        if k["name"] == "flash_attention":
            k["encdec_launches"] -= mla11
            k["encdec"] = dict(
                at_shapes=encdec["serving"]["attention"],
                launches_by_dims=encdec["serving"]["flash_by_dims_causal"],
                merge_launches=encdec["serving"]["flash_merge_launches"],
                training_launches_by_dims=encdec["training"][
                    "forward_by_dims"])
        if k["name"] == "flash_attention_mla":
            k["encdec_launches"] = mla11
        if k["name"] == "flash_attention_bwd":
            tr, mt = encdec["training"], encdec["mla_training"]
            k["encdec_launches"] = tr["launches"][k["name"]]
            k["mla_backward_launches"] = mt["backward_by_dims"].get(
                "sm90 96/64 causal", 0)
            k["encdec"] = dict(at_shapes=tr["backward"],
                               launches_by_dims=tr["backward_by_dims"])
            k["mla"] = dict(at_shapes=mt["backward"],
                            launches_by_dims=mt["backward_by_dims"])

    # ---- phase 12: the dry-run and the recurrent families trained, their
    # own counts (zeroed just before and read just after each main path,
    # inside dryrun_phase)
    torch.cuda.empty_cache()
    long, et = qw["long"], encdec["training"]
    measured = {
        "qwen3-1.7b": dict(batch=long["batch"], step_s=long["step_s_median"],
                           peak_gb=long["peak_memory_gb"],
                           source="phase 8 (d)"),
        ENCDEC_ARCH: dict(batch=et["batch"], step_s=et["step_ms_median"] / 1e3,
                          peak_gb=et["peak_gb"], source="phase 11 (b)")}
    dry = dryrun_phase(dev, card, args.seed, n_rows, counters, measured)
    log(f"phase 12: kernel launches on the recurrent training and dataflow "
        f"paths: {dry['launches']}; took {dry['phase_s']:.1f} s")
    for k in kernels:
        k["dryrun_launches"] = dry["launches"].get(k["name"], 0)

    # ---- phase 13: the model mesh on logical shards, its own counts
    # (zeroed just before and read just after each main path, inside
    # mesh_phase)
    torch.cuda.empty_cache()
    model_mesh = mesh_phase(dev, card, args.seed, n_rows, counters)
    log(f"phase 13: kernel launches on the model mesh's paths: "
        f"{model_mesh['launches']}; took {model_mesh['phase_s']:.1f} s")
    for k in kernels:
        k["model_mesh_launches"] = model_mesh["launches"].get(k["name"], 0)
        if k["name"] == "flash_attention":
            k["model_mesh"] = dict(
                chunked_by_dims=model_mesh["chunked"]["flash_by_dims"],
                sharded_by_dims=model_mesh["sharded"]["flash_by_dims"],
                f32_smoke_by_dims=model_mesh["smoke"]["flash_by_dims"],
                at_shapes=[model_mesh["chunked"]["attention"],
                           model_mesh["sharded"]["attention"]])
        if k["name"] == "partition_scatter":
            k["model_mesh"] = dict(
                moe_shard_launches=model_mesh["moe"]["launches"][k["name"]],
                launch_shapes=model_mesh["moe"]["partition_scatter_shapes"],
                at_shape=model_mesh["moe"]["scatter"])

    # ---- phase 14: the mesh across processes, the ranks' own counts
    # (zeroed just before and read just after each of (a) and (b), inside
    # each rank)
    torch.cuda.empty_cache()
    mesh_reports = MeshReports()
    group = group_phase(dev, card, args.seed, n_rows, counters)
    log(f"phase 14: kernel launches on the ranks' paths, summed: "
        f"{group['launches']}; took {group['phase_s']:.1f} s")
    for k in kernels:
        k["group_mesh_launches"] = group["launches"].get(k["name"], 0)
        if k["name"] in group["a"]["launches_by_rank"][0]:
            k["group_mesh_launches_by_rank"] = [
                a[k["name"]] + b[k["name"]] + m[k["name"]] for a, b, m in zip(
                    group["a"]["launches_by_rank"],
                    group["b"]["launches_by_rank"],
                    group["launches_fgh_by_rank"])]
    # ---- phase 15: the dry-run per device of a mesh, on the meta device
    # (no launch: the counting mesh's predictions against phase 14's
    # measurements, and the production meshes' reports)
    mesh_dry = mesh_count_phase(group, dev, card, args.seed, mesh_reports)
    mesh_reports.stop()
    log(f"phase 15: took {mesh_dry['phase_s']:.1f} s (the counts "
        f"{mesh_dry['count_s']:.1f} s; the reports read "
        f"{mesh_dry['reports_s']:.1f} s after their start beside phase 14)")
    for k in kernels:
        k["tier_launches"] = tiers["launches"].get(k["name"], 0)
        k["train_launches"] = qw["launches"].get(k["name"], 0)
    for k in kernels:
        log(f"kernel {k['name']:<19} kernel {k['ms']:.4f} ms  plain "
            f"{k['plain_ms']:.4f} ms  library {k['library_ms']:.4f} ms  "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})  launches "
            f"{k['launches']} (service path {k['service_launches']}, tier "
            f"path {k['tier_launches']}, training path "
            f"{k['train_launches']}, families {k['families_launches']}, "
            f"recurrent {k['recurrent_launches']}, encdec "
            f"{k['encdec_launches']}, phase 12 {k['dryrun_launches']}, "
            f"model mesh {k['model_mesh_launches']}, group mesh "
            f"{k['group_mesh_launches']}) [{card}]")
    m = next(k["moe"] for k in kernels if k["name"] == "partition_scatter")
    for label, x in (("the MoE dispatch", m), ("the MoE decode", m["decode"])):
        log(f"kernel partition_scatter at {label} ({x['shape']}): kernel "
            f"{x['ms']:.4f} ms  plain {x['plain_ms']:.4f} ms  library "
            f"{x['library_ms']:.4f} ms  bound {x['bound_ms']:.6f} ms "
            f"({x['bound_by']}) [{card}]")
    log(f"kernel partition_scatter at the MoE dispatch: launches "
        f"{m['launches']} [{card}]")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels, "queries": times,
                      "mesh": mesh, "skewed_retry": skew,
                      "page_views_rows": n_rows, "serving": serving,
                      "service": service, "tiers": tiers,
                      "training": training, "families": families,
                      "recurrent": recurrent, "encdec": encdec,
                      "dryrun": dry, "model_mesh": model_mesh,
                      "group_mesh": group, "mesh_dryrun": mesh_dry}))
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
