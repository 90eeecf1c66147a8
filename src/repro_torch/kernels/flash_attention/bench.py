"""Time the flash-attention wrapper at qwen3-1.7b's serving and training
shapes on one CUDA card.

    PYTHONPATH=src python3 src/repro_torch/kernels/flash_attention/bench.py

Prints one JSON line.  For each of the four shapes of a serving step
(``SHAPES``: 16 query and 8 KV heads x 128, bf16, a 1042-slot cache) it
holds the device time per call from CUDA-graph replays and the eager time
(events around back-to-back calls), each beside
``scaled_dot_product_attention``'s; then the wrapper's host time per
decode call (kv_len and q_offset as Python ints, as the model passes
them), the median of ``--runs`` runs.  Then the backward kernel
(``ops.backward``, given the forward's row statistics) at the training
shapes (``TRAIN_SHAPES``, causal, bf16): its device time from CUDA-graph
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
(``mla_bound_ms``).

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

# (label, B, S): a training step's attention calls, causal over the
# sequence and no cache (launch/train.py's batch 8 x seq 64, and the same
# batch at a 1024-token context)
TRAIN_SHAPES = [("train seq 64", 8, 64), ("train seq 1024", 8, 1024)]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor cores


def backward_bound_ms(b, hq, hkv, sq, skv, d, kv_len=None, q_offset=None,
                      causal=True, elt=2):
    """(least time, what bounds it) for the backward on this data: 10 D
    operations per visible (query, key) pair at the bf16 tensor-core
    peak, against the bytes of q, k, v, O, dO, dQ, dK and dV, each read
    or written once."""
    import numpy as np
    kl = np.broadcast_to(np.asarray(skv if kv_len is None else kv_len), b)
    qo = np.broadcast_to(np.asarray(skv - sq if q_offset is None
                                    else q_offset), b)
    visible = 0
    for kvl, off in zip(np.minimum(kl, skv), qo):
        rows = np.arange(sq) + off
        vis = np.minimum(kvl, rows + 1) if causal else np.full(sq, kvl)
        visible += int(np.clip(vis, 0, None).sum())
    ops = 10 * d * hq * visible
    nbytes = elt * d * (4 * b * hq * sq + 4 * b * hkv * skv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def mla_bound_ms(b, h, sq, kv_len, q_off, causal, d=MLA_D, dv=MLA_DV,
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


def mla_case(dev, g, b, sq, kv_len, q_off, causal):
    """Random bf16 q (B, 40, Sq, 96), k (B, 40, 4114, 96) and v (B, 40,
    4114, 64), the (B,) int32 kv_len and q_offset, and the boolean mask
    that gives ``scaled_dot_product_attention`` the same function."""
    import torch

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    q = rnd(b, MLA_H, sq, MLA_D)
    k, v = rnd(b, MLA_H, MLA_SLOTS, MLA_D), rnd(b, MLA_H, MLA_SLOTS, MLA_DV)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    k_pos = torch.arange(MLA_SLOTS, device=dev)[None, None, None, :]
    mask = k_pos < kvl.view(b, 1, 1, 1)
    if causal:
        q_pos = torch.arange(sq, device=dev)[None, None, :, None] + \
            qo.view(b, 1, 1, 1)
        mask = mask & (k_pos <= q_pos)
    return q, k, v, kvl, qo, mask


def mla_measurements(dev, iters=10):
    """The bf16 kernel at ``MLA_SHAPES``: its output against the plain
    version (absolute error; ``err_of_row_rms``, the worst error over
    its output row's RMS), the device time per call from CUDA-graph
    replays (``ms``) and eager (``eager_ms``), the plain version's and
    ``scaled_dot_product_attention``'s (a yardstick the port never
    calls; None where this PyTorch refuses the call), the bound, and
    which form (fused or split) the call takes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref

    g = torch.Generator(device=dev).manual_seed(13)
    out = []
    for label, b, sq, kv_len, q_off, causal in MLA_SHAPES:
        q, k, v, kvl, qo, mask = mla_case(dev, g, b, sq, kv_len, q_off,
                                          causal)
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
        bound, by = mla_bound_ms(b, MLA_H, sq, kv_len, q_off, causal)
        plan = fa.plan(q.dtype, "cuda", b, MLA_H, MLA_H, sq, MLA_SLOTS)
        out.append(dict(
            shape=f"{label}: B={b} Hq=Hkv={MLA_H} Sq={sq} D_qk={MLA_D} "
                  f"D_v={MLA_DV} bf16, cache {MLA_SLOTS}, kv_len {kv_len}, "
                  f"q_offset {q_off}",
            form="split" if plan.scratch else "fused",
            max_abs_err=err, err_of_row_rms=rel,
            ms=graph_ms(kernel, iters), eager_ms=eager_ms(kernel, iters),
            plain_ms=eager_ms(lambda: mha_ref(q, k, v, kvl, **kw), 2),
            library_ms=library_ms, library_eager_ms=library_eager,
            bound_ms=bound, bound_by=by))
        del q, k, v, mask
    return out


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


def backward_measurements(dev, iters=10, other=None, split=False):
    """The backward kernel at ``TRAIN_SHAPES`` in bf16: the forward's
    output, its row statistics and the three gradients against the plain
    versions (each gradient's error relative to its largest plain entry,
    the worst of the three, as ``backward_cases`` are checked); the
    device time per call (``graph_ms``) of the kernel, given the
    forward's lse as the trainer gives it, of the backward of one
    ``scaled_dot_product_attention`` call (a yardstick the port never
    calls) and, if ``other`` (another checkout's ``ops`` module) is
    given, of its ``backward`` (``other_ms``), beside the bound; eager
    times (``eager_ms``) for the kernel and SDPA and the plain
    version's.  With ``split``, also each of the kernel's launches'
    device time per call (``kernel_ms``, by name), summed by
    torch.profiler over ``iters`` eager calls."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (mha_bwd_ref,
                                                         mha_lse_ref,
                                                         mha_ref)

    out = []
    g = torch.Generator(device=dev).manual_seed(12)
    for label, b, s in TRAIN_SHAPES:
        q, k, v, do = (torch.randn(sh, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for sh in ((b, HQ, s, D), (b, HKV, s, D),
                                  (b, HKV, s, D), (b, HQ, s, D)))
        o, lse = fa.mha_lse(q, k, v, causal=True)
        o_err = float((o.float() - mha_ref(q, k, v, causal=True).float())
                      .abs().max())
        lse_err = float((lse - mha_lse_ref(q, k, causal=True)).abs().max())
        got = fa.backward(q, k, v, o, do, causal=True, lse=lse)
        want = mha_bwd_ref(q, k, v, do, causal=True)
        err = max(float((a.float() - w.float()).abs().max())
                  for a, w in zip(got, want))
        rel = max(float((a.float() - w.float()).abs().max())
                  / max(float(w.float().abs().max()), 1e-30)
                  for a, w in zip(got, want))
        # SDPA's forward runs on the stream its backward is captured on:
        # autograd runs each backward op on its forward op's stream
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ql, kl, vl = (t.detach().requires_grad_(True)
                          for t in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                enable_gqa=True)
        torch.cuda.current_stream().wait_stream(side)

        def kernel():
            return fa.backward(q, k, v, o, do, causal=True, lse=lse)

        def library():
            return torch.autograd.grad(lo, (ql, kl, vl), do,
                                       retain_graph=True)
        bound, by = backward_bound_ms(b, HQ, HKV, s, s, D)
        other_ms = None if other is None else graph_ms(
            lambda: other.backward(q, k, v, o, do, causal=True), iters)
        out.append(dict(
            shape=f"{label}: B={b} Hq={HQ} Hkv={HKV} S={s} D={D} bf16, "
                  "causal",
            o_max_abs_err=o_err, lse_max_abs_err=lse_err, max_abs_err=err,
            max_err_of_max=rel, ms=graph_ms(kernel, iters),
            other_ms=other_ms,
            plain_ms=eager_ms(lambda: mha_bwd_ref(q, k, v, do, causal=True),
                              max(2, iters // 5)),
            library_ms=graph_ms(library, iters, stream=side),
            eager_ms=eager_ms(kernel, iters),
            library_eager_ms=eager_ms(library, iters),
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
                          dev, other=other, split=args.split),
                      "mla": mla_measurements(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
