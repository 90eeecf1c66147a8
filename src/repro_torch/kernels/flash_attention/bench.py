"""Time the flash-attention wrapper at qwen3-1.7b's serving shapes on one
CUDA card.

    PYTHONPATH=src python3 src/repro_torch/kernels/flash_attention/bench.py

Prints one JSON line.  For each of the four shapes of a serving step
(``SHAPES``: 16 query and 8 KV heads x 128, bf16, a 1042-slot cache) it
holds the device time per call from CUDA-graph replays and the eager time
(events around back-to-back calls), each beside
``scaled_dot_product_attention``'s; then the wrapper's host time per
decode call (kv_len and q_offset as Python ints, as the model passes
them), the median of ``--runs`` runs.

It calls nothing of the ``repro_torch`` on the import path but
``ops.mha``, so two checkouts compare in one session by running this file
with each checkout's ``src`` on ``PYTHONPATH``, in turns.
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


def graph_ms(fn, iters=20, replays=3):
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed between two events, so the host's dispatch is not timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def serving_case(dev, g, b, sq, kv_len, q_off, causal):
    """Random bf16 q, k, v for one shape, its (B,) int32 kv_len and
    q_offset, and the boolean mask that gives
    ``scaled_dot_product_attention`` the same function."""
    import torch

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    q, k, v = rnd(b, HQ, sq, D), rnd(b, HKV, SLOTS, D), rnd(b, HKV, SLOTS, D)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    k_pos = torch.arange(SLOTS, device=dev)[None, None, None, :]
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
    print(json.dumps({"module": fa.__file__,
                      "device": torch.cuda.get_device_name(0),
                      "shapes": shapes,
                      "host_us_per_decode_call": statistics.median(runs),
                      "host_us_runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
