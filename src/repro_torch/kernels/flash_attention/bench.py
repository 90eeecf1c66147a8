"""Time the flash-attention wrapper at qwen3-1.7b's serving and training
shapes, MLA's and seamless-m4t's, on one CUDA card.

    PYTHONPATH=src python3 src/repro_torch/kernels/flash_attention/bench.py

Prints one JSON line.  For each of the four shapes of a serving step
(``SHAPES``: 16 query and 8 KV heads x 128, bf16, a 1042-slot cache) it
holds the device time per call from CUDA-graph replays and the eager time
(events around back-to-back calls), each beside
``scaled_dot_product_attention``'s; then the wrapper's host time per
decode call (kv_len and q_offset as Python ints, as the model passes
them), the median of ``--runs`` runs.  Then the backward kernel
(``ops.backward``, given the forward's row statistics) at the training
shapes (``TRAIN_SHAPES``, qwen3-1.7b's, causal; ``MLA_TRAIN_SHAPES``,
minicpm3-4b's at D_qk 96 / D_v 64; ``ENCDEC_TRAIN_SHAPES``,
seamless-m4t's encoder, cross and decoder self-attention; all bf16):
its device time from CUDA-graph
replays beside that of ``scaled_dot_product_attention``'s backward and,
with ``--against SRC``, of the backward of the checkout whose ``src``
directory is SRC (loaded beside this one by ``abtiming.load_other``;
its own wrapper and kernels, timed the same way in the same process),
eager times for the kernel, SDPA and the plain version (autograd
through ``mha_ref``), and its bound (``backward_bound_ms``); with
``--split``, the kernel's time by launch (torch.profiler).
``backward_cases`` is the grid the cuda tests and ``chip_smoke.py``
hold the backward kernel to its plain version on.  Then MLA's shapes
(``MLA_SHAPES``: minicpm3-4b's 40 heads at a query/key head dim of 96
and a value head dim of 64, a 4114-slot cache): the kernel against the
plain version, its graph-replayed and eager device times beside the
plain version's and ``scaled_dot_product_attention``'s, and the bound
(``forward_bound_ms``).  Then seamless-m4t-medium's forward shapes
(``ENCDEC_SHAPES``: 16 heads x 64, the encoder's non-causal
self-attention over 1024 frames and the decoder's cross-attention,
Sq != Skv) the same way.

Everything timed comes from the ``repro_torch`` on the import path, so
two checkouts (or copies with one kernel source changed) compare on one
card by running this file with each one's ``src`` on ``PYTHONPATH``, in
turns (ABBA).
"""
import argparse
import json
import statistics
import time

HQ, HKV, D, SLOTS = 16, 8, 128, 1042

# (label, B, Sq, kv_len per row, q_offset per row, causal): the calls a
# model makes in a cold prefill, a warm suffix after a reused 1024-token
# prefix, a decode step and a batched decode with per-row positions
SHAPES = [
    ("cold prefill", 1, 1040, [1040], [0], True),
    ("warm suffix", 1, 16, [1040], [1024], True),
    ("decode B=1", 1, 1, [1041], [1040], True),
    ("batched decode B=4", 4, 1, [1041, 700, 1, 1030], [0, 0, 0, 0], False),
]


# MLA (minicpm3-4b): 40 query heads, each with its own decompressed key
# and value, query/key head dim 96 (64 + 32 rotary), value head dim 64;
# the calls of a 4096-token prefix + 16-token suffix request with 2
# decode steps, as chip_smoke.py's phase 9 (a) serves it
MLA_H, MLA_D, MLA_DV, MLA_SLOTS = 40, 96, 64, 4114
MLA_SHAPES = [
    ("MLA cold prefill", 1, 4112, [4112], [0], True),
    ("MLA warm suffix", 1, 16, [4112], [4096], True),
    ("MLA decode", 1, 1, [4113], [4112], True),
]

# seamless-m4t-medium: 16 query and 16 KV heads x 64; 8 utterances of
# 1024 encoder frames, as chip_smoke.py's phase 11 (a) serves them: the
# encoder's self-attention (not causal), the decoder's cross-attention
# over the 1024 frames at its 16-token prompt and at a decode step
ENCDEC_H, ENCDEC_D, ENCDEC_FRAMES, ENCDEC_B = 16, 64, 1024, 8
ENCDEC_SHAPES = [
    ("encoder self", ENCDEC_B, ENCDEC_FRAMES, [ENCDEC_FRAMES] * ENCDEC_B,
     [0] * ENCDEC_B, False),
    ("cross prefill", ENCDEC_B, 16, [ENCDEC_FRAMES] * ENCDEC_B,
     [0] * ENCDEC_B, False),
    ("cross decode", ENCDEC_B, 1, [ENCDEC_FRAMES] * ENCDEC_B,
     [0] * ENCDEC_B, False),
]

# (label, B, Hq, Hkv, Sq, Skv, D_qk, D_v, causal): a training step's
# attention calls, with no cache.  qwen3-1.7b's (launch/train.py's batch
# 8 x seq 64, and the same batch at a 1024-token context); minicpm3-4b's
# MLA at 4 x 1024 (chip_smoke.py's phase 11 (c)); seamless-m4t's at 8 x
# (1024 encoder frames, 256 decoder tokens) (phase 11 (b))
TRAIN_SHAPES = [
    ("train seq 64", 8, HQ, HKV, 64, 64, D, D, True),
    ("train seq 1024", 8, HQ, HKV, 1024, 1024, D, D, True),
]
MLA_TRAIN_SHAPES = [
    ("MLA train seq 1024", 4, MLA_H, MLA_H, 1024, 1024, MLA_D, MLA_DV, True),
]
ENCDEC_TRAIN_SHAPES = [
    ("encoder self", 8, ENCDEC_H, ENCDEC_H, 1024, 1024, 64, 64, False),
    ("cross", 8, ENCDEC_H, ENCDEC_H, 256, 1024, 64, 64, False),
    ("decoder self", 8, ENCDEC_H, ENCDEC_H, 256, 256, 64, 64, True),
]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor cores


def backward_bound_ms(b, hq, hkv, sq, skv, d, kv_len=None, q_offset=None,
                      causal=True, elt=2, dv=None):
    """(least time, what bounds it) for the backward on this data at a
    query/key head dim ``d`` and a value head dim ``dv`` (default ``d``):
    6 D + 4 Dv operations per visible (query, key) pair (S, dQ and dK at
    2 D each, dP and dV at 2 Dv; 10 D at equal dims) at the bf16
    tensor-core peak, against the bytes of q, k, v, O, dO, dQ, dK and dV,
    each read or written once."""
    dv = d if dv is None else dv
    import numpy as np
    kl = np.broadcast_to(np.asarray(skv if kv_len is None else kv_len), b)
    qo = np.broadcast_to(np.asarray(skv - sq if q_offset is None
                                    else q_offset), b)
    visible = 0
    for kvl, off in zip(np.minimum(kl, skv), qo):
        rows = np.arange(sq) + off
        vis = np.minimum(kvl, rows + 1) if causal else np.full(sq, kvl)
        visible += int(np.clip(vis, 0, None).sum())
    ops = (6 * d + 4 * dv) * hq * visible
    nbytes = elt * 2 * (d + dv) * (b * hq * sq + b * hkv * skv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def forward_bound_ms(b, h, sq, kv_len, q_off, causal, d=MLA_D, dv=MLA_DV,
                     elt=2):
    """(least time, what bounds it) for the forward at a query/key head
    dim ``d`` and a value head dim ``dv`` on this data: 2 (d + dv)
    operations per visible (query, key) pair at the bf16 tensor-core
    peak, against the bytes of q and o once and of the keys and values
    each row's kv_len covers once (one KV head per query head)."""
    import numpy as np
    visible = 0
    for kl, qo in zip(kv_len, q_off):
        rows = np.arange(sq) + qo
        vis = np.minimum(kl, rows + 1) if causal else np.full(sq, kl)
        visible += int(np.clip(vis, 0, None).sum())
    ops = 2 * (d + dv) * h * visible
    nbytes = elt * (b * h * sq * (d + dv) + h * (d + dv) * int(sum(kv_len)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def forward_case(dev, g, b, sq, kv_len, q_off, causal, h=MLA_H, d=MLA_D,
                 dv=MLA_DV, slots=MLA_SLOTS):
    """Random bf16 q (B, h, Sq, d), k (B, h, slots, d) and v (B, h,
    slots, dv) (MLA's by default), the (B,) int32 kv_len and q_offset,
    and the boolean mask that gives ``scaled_dot_product_attention`` the
    same function."""
    import torch

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    q = rnd(b, h, sq, d)
    k, v = rnd(b, h, slots, d), rnd(b, h, slots, dv)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    k_pos = torch.arange(slots, device=dev)[None, None, None, :]
    mask = k_pos < kvl.view(b, 1, 1, 1)
    if causal:
        q_pos = torch.arange(sq, device=dev)[None, None, :, None] + \
            qo.view(b, 1, 1, 1)
        mask = mask & (k_pos <= q_pos)
    return q, k, v, kvl, qo, mask


def mla_measurements(dev, iters=10):
    """``forward_measurements`` at ``MLA_SHAPES``."""
    return forward_measurements(dev, MLA_SHAPES, iters)


def encdec_measurements(dev, iters=10):
    """``forward_measurements`` at ``ENCDEC_SHAPES``."""
    return forward_measurements(dev, ENCDEC_SHAPES, iters, h=ENCDEC_H,
                                d=ENCDEC_D, dv=ENCDEC_D,
                                slots=ENCDEC_FRAMES)


def forward_measurements(dev, shapes, iters=10, h=MLA_H, d=MLA_D,
                         dv=MLA_DV, slots=MLA_SLOTS):
    """The bf16 kernel at ``shapes`` ((label, B, Sq, kv_len per row,
    q_offset per row, causal), h heads over ``slots`` keys, head dims d
    and dv): its output against the plain version (absolute error;
    ``err_of_row_rms``, the worst error over its output row's RMS), the
    device time per call from CUDA-graph replays (``ms``) and eager
    (``eager_ms``), the plain version's and
    ``scaled_dot_product_attention``'s (a yardstick the port never
    calls; None where this PyTorch refuses the call), the bound, and
    which form (fused or split) the call takes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref

    g = torch.Generator(device=dev).manual_seed(13)
    out = []
    for label, b, sq, kv_len, q_off, causal in shapes:
        q, k, v, kvl, qo, mask = forward_case(dev, g, b, sq, kv_len, q_off,
                                              causal, h, d, dv, slots)
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
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        try:
            library_ms = graph_ms(library, iters)
            library_eager = eager_ms(library, iters)
        except RuntimeError:
            library_ms = library_eager = None
        bound, by = forward_bound_ms(b, h, sq, kv_len, q_off, causal, d, dv)
        plan = fa.plan(q.dtype, "cuda", b, h, h, sq, slots)
        out.append(dict(
            shape=f"{label}: B={b} Hq=Hkv={h} Sq={sq} D_qk={d} D_v={dv} "
                  f"bf16, {'causal' if causal else 'not causal'}, keys "
                  f"{slots}, kv_len {_runs(kv_len)}, q_offset "
                  f"{_runs(q_off)}",
            form="split" if plan.scratch else "fused",
            max_abs_err=err, err_of_row_rms=rel,
            ms=graph_ms(kernel, iters), eager_ms=eager_ms(kernel, iters),
            plain_ms=eager_ms(lambda: mha_ref(q, k, v, kvl, **kw), 2),
            library_ms=library_ms, library_eager_ms=library_eager,
            bound_ms=bound, bound_by=by))
        del q, k, v, mask
    return out


def _runs(xs):
    """A per-row list, shortened where every row holds one value."""
    return xs[0] if len(set(xs)) == 1 else xs


def backward_cases():
    """The backward kernel's check grid: (seed, B, Hq, Hkv, Sq, Skv, D)
    and the call's keyword arguments (int32 lists stand for per-row
    tensors): every head dim, GQA groups of 1, 2 and 8, ragged and
    multi-tile lengths, causal and not, per-row kv_len and q_offset, a
    decode row, and rows that see no key (kv_len 0, causal before every
    key), whose dV is dO / Skv over every key."""
    cases = []
    for seed, d in enumerate((16, 32, 64, 128)):
        for causal in (True, False):
            cases.append(((seed, 2, 4, 2, 37, 53, d), dict(causal=causal)))
    cases += [
        ((4, 1, 8, 1, 64, 128, 64), dict(causal=True)),
        ((5, 2, 4, 4, 64, 64, 32), dict(causal=True)),
        ((6, 1, 16, 8, 130, 130, 128), dict(causal=True)),
        ((7, 2, 16, 8, 64, 64, 128), dict(causal=True)),
        ((8, 3, 4, 2, 21, 200, 32),
         dict(kv_len=[21, 90, 200], q_offset=[0, 69, 179])),
        ((9, 1, 4, 2, 1, 64, 64), dict(kv_len=64, q_offset=63)),
        ((10, 2, 16, 8, 40, 100, 128),
         dict(kv_len=[0, 100], q_offset=[5, -3])),
        ((10, 2, 16, 8, 40, 100, 128),
         dict(kv_len=[0, 100], q_offset=[5, -3], causal=False)),
        ((11, 2, 4, 2, 70, 70, 64), dict(q_offset=-30)),
    ]
    return cases


def backward_inputs(dev, dtype, seed, b, hq, hkv, sq, skv, d, kw):
    """Seeded q, k, v, dout on ``dev`` in ``dtype``, and ``kw`` with its
    lists made (B,) int32 tensors there."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                   for s in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d), (b, hq, sq, d)))
    kw = {n: torch.tensor(x, dtype=torch.int32, device=dev)
          if isinstance(x, list) else x for n, x in kw.items()}
    return q, k, v, do, kw


def backward_measurements(dev, iters=10, other=None, split=False,
                          shapes=TRAIN_SHAPES):
    """The backward kernel at ``shapes`` (``TRAIN_SHAPES`` by default;
    see ``MLA_TRAIN_SHAPES`` and ``ENCDEC_TRAIN_SHAPES``) in bf16: the
    forward's output, its row statistics and the three gradients against the plain
    versions (each gradient's error relative to its largest plain entry,
    the worst of the three, as ``backward_cases`` are checked:
    ``max_err_of_max`` against autograd through ``mha_ref``,
    ``own_err_of_max`` against ``mha_bwd_lse_ref``, the plain version of
    the kernel's own arithmetic from the forward's lse); the
    device time per call (``graph_ms``) of the kernel, given the
    forward's lse as the trainer gives it, of the backward of one
    ``scaled_dot_product_attention`` call (a yardstick the port never
    calls) and, if ``other`` (another checkout's ``ops`` module) is
    given, of its ``backward`` (``other_ms``; None where that checkout
    refuses the shape), beside the bound; eager
    times (``eager_ms``) for the kernel and SDPA and the plain
    version's.  With ``split``, also each of the kernel's launches'
    device time per call (``kernel_ms``, by name), summed by
    torch.profiler over ``iters`` eager calls."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (mha_bwd_lse_ref,
                                                         mha_bwd_ref,
                                                         mha_lse_ref,
                                                         mha_ref)

    def rel_err(got, want):
        return max(float((a.float() - w.float()).abs().max())
                   / max(float(w.float().abs().max()), 1e-30)
                   for a, w in zip(got, want))

    out = []
    g = torch.Generator(device=dev).manual_seed(12)
    for label, b, hq, hkv, sq, skv, d, dv, causal in shapes:
        q, k, v, do = (torch.randn(sh, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for sh in ((b, hq, sq, d), (b, hkv, skv, d),
                                  (b, hkv, skv, dv), (b, hq, sq, dv)))
        kw = dict(causal=causal)
        o, lse = fa.mha_lse(q, k, v, **kw)
        o_err = float((o.float() - mha_ref(q, k, v, **kw).float())
                      .abs().max())
        lse_err = float((lse - mha_lse_ref(q, k, **kw)).abs().max())
        got = fa.backward(q, k, v, o, do, lse=lse, **kw)
        want = mha_bwd_ref(q, k, v, do, **kw)
        err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want))
        rel = rel_err(got, want)
        own = rel_err(got, mha_bwd_lse_ref(q, k, v, o, do, lse, **kw))
        del want
        # SDPA's forward runs on the stream its backward is captured on:
        # autograd runs each backward op on its forward op's stream
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ql, kl, vl = (t.detach().requires_grad_(True)
                          for t in (q, k, v))
            lo = F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=causal, enable_gqa=True)
        torch.cuda.current_stream().wait_stream(side)

        def kernel():
            return fa.backward(q, k, v, o, do, lse=lse, **kw)

        def library():
            return torch.autograd.grad(lo, (ql, kl, vl), do,
                                       retain_graph=True)
        try:
            library_ms = graph_ms(library, iters, stream=side)
            library_eager = eager_ms(library, iters)
        except RuntimeError:        # this PyTorch refuses the call
            torch.cuda.synchronize()
            library_ms = library_eager = None
        bound, by = backward_bound_ms(b, hq, hkv, sq, skv, d, causal=causal,
                                      dv=dv)
        other_ms = None
        if other is not None:
            try:
                other_ms = graph_ms(
                    lambda: other.backward(q, k, v, o, do, **kw), iters)
            except ValueError:      # an older backward refuses the dims
                torch.cuda.synchronize()
        out.append(dict(
            shape=f"{label}: B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} "
                  f"D_qk={d} D_v={dv} bf16, "
                  f"{'causal' if causal else 'not causal'}",
            o_max_abs_err=o_err, lse_max_abs_err=lse_err, max_abs_err=err,
            max_err_of_max=rel, own_err_of_max=own,
            ms=graph_ms(kernel, iters),
            other_ms=other_ms,
            plain_ms=eager_ms(lambda: mha_bwd_ref(q, k, v, do, **kw),
                              max(2, iters // 5)),
            library_ms=library_ms, eager_ms=eager_ms(kernel, iters),
            library_eager_ms=library_eager,
            bound_ms=bound, bound_by=by))
        if split:
            out[-1]["kernel_ms"] = kernel_split_ms(kernel, iters)
    return out


def kernel_split_ms(fn, iters):
    """Device time per call of ``fn`` by kernel name: torch.profiler's
    device-time sums over ``iters`` calls, divided by ``iters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / iters / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def graph_ms(fn, iters=20, replays=3, stream=None):
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed between two events, so the host's dispatch is not timed.
    The capture runs on ``stream`` if given (an autograd backward must
    be captured on the stream its forward ran on), else on a new one."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, iters=20):
    """Time per call between two events around ``iters`` eager calls: the
    larger of the device time and the host's dispatch time."""
    import torch
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


def host_us(fn, calls=400):
    """Host time per call to enqueue ``fn`` (no sync inside the loop)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def serving_case(dev, g, b, sq, kv_len, q_off, causal, hq=HQ, hkv=HKV,
                 d=D, slots=SLOTS):
    """Random bf16 q (B, hq, Sq, d), k and v (B, hkv, slots, d) for one
    shape, its (B,) int32 kv_len and q_offset, and the boolean mask that
    gives ``scaled_dot_product_attention`` the same function."""
    import torch

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, slots, d), rnd(b, hkv, slots, d)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    k_pos = torch.arange(slots, device=dev)[None, None, None, :]
    mask = k_pos < kvl.view(b, 1, 1, 1)
    if causal:
        q_pos = torch.arange(sq, device=dev)[None, None, :, None] + \
            qo.view(b, 1, 1, 1)
        mask = mask & (k_pos <= q_pos)
    return q, k, v, kvl, qo, mask


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5,
                    help="host-time runs of 400 decode calls each")
    ap.add_argument("--against", metavar="SRC",
                    help="another checkout's src directory: time its "
                         "attention backward beside this one's")
    ap.add_argument("--split", action="store_true",
                    help="also time the backward by kernel (profiled)")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(11)
    shapes = []
    for label, b, sq, kv_len, q_off, causal in SHAPES:
        q, k, v, kvl, qo, mask = serving_case(dev, g, b, sq, kv_len, q_off,
                                              causal)

        def kernel():
            return fa.mha(q, k, v, kvl, causal=causal, q_offset=qo)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        shapes.append(dict(shape=label, ms=graph_ms(kernel),
                           library_ms=graph_ms(library),
                           eager_ms=eager_ms(kernel),
                           library_eager_ms=eager_ms(library)))
    q, k, v, *_ = serving_case(dev, g, 1, 1, [1041], [1040], True)
    runs = [host_us(lambda: fa.mha(q, k, v, 1041, causal=True,
                                   q_offset=1040))
            for _ in range(args.runs)]
    other = None
    if args.against:
        from repro_torch.kernels.abtiming import load_other
        other = load_other(args.against, "kernels.flash_attention.ops")
    print(json.dumps({"module": fa.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "shapes": shapes,
                      "host_us_per_decode_call": statistics.median(runs),
                      "host_us_runs": runs,
                      "backward": backward_measurements(
                          dev, other=other, split=args.split,
                          shapes=TRAIN_SHAPES + MLA_TRAIN_SHAPES
                          + ENCDEC_TRAIN_SHAPES),
                      "mla": mla_measurements(dev),
                      "encdec": encdec_measurements(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
