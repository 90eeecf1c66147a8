"""The served model's weights, made by the benchmark from the run seed
on the card in the dtype they are served in, in a few large calls, and
handed alike to the program (as its parameter tree) and to the
reference (which reads the same tensors).

The tree is the port's layout for a dense MLA decoder
(``models/lm.py::init_lm`` with one sublayer a superblock): every leaf
of ``blocks.slot0`` carries a leading layer axis.  Matrices are N(0, 1)
scaled by 1 / sqrt(fan-in) (the embedding by 0.02); norm weights are
ones, as the port initialises them."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30        # elements a randn call fills


def layout(c: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], object]]:
    """(path, shape, scale) of every leaf; scale None marks a norm
    weight (ones)."""
    d, h, L, v, ff = (c["hidden_size"], c["num_attention_heads"],
                      c["num_hidden_layers"], c["vocab_size"],
                      c["intermediate_size"])
    qr, kvr = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    blk = ("blocks", "slot0")
    mix = blk + ("mixer",)
    ffn = blk + ("ffn",)
    inv = lambda n: n ** -0.5  # noqa: E731
    return [
        (("embed",), (v, d), 0.02),
        (mix + ("wdq",), (L, d, qr), inv(d)),
        (mix + ("wuq",), (L, qr, h * (nope + rope)), inv(qr)),
        (mix + ("wdkv",), (L, d, kvr + rope), inv(d)),
        (mix + ("wuk",), (L, kvr, h * nope), inv(kvr)),
        (mix + ("wuv",), (L, kvr, h * vd), inv(kvr)),
        (mix + ("wo",), (L, h * vd, d), inv(h * vd)),
        (ffn + ("wg",), (L, d, ff), inv(d)),
        (ffn + ("wu",), (L, d, ff), inv(d)),
        (ffn + ("wd",), (L, ff, d), inv(ff)),
        (("lm_head",), (d, v), inv(d)),
        (blk + ("ln1",), (L, d), None),
        (mix + ("q_norm",), (L, qr), None),
        (mix + ("kv_norm",), (L, kvr), None),
        (blk + ("ln2",), (L, d), None),
        (("ln_f",), (d,), None),
    ]


def n_params(c: Dict) -> int:
    n = 0
    for _, shape, _ in layout(c):
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def make(c: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The parameter tree (nested dicts of views into one buffer)."""
    leaves = layout(c)
    sizes = []
    for _, shape, _ in leaves:
        k = 1
        for s in shape:
            k *= s
        sizes.append(k)
    n_rand = sum(k for k, (_, _, sc) in zip(sizes, leaves) if sc is not None)
    buf = torch.empty(sum(sizes), dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for lo in range(0, n_rand, CHUNK):
        hi = min(lo + CHUNK, n_rand)
        torch.randn(hi - lo, generator=gen, dtype=dtype, device=device,
                    out=buf[lo:hi])
    buf[n_rand:].fill_(1.0)
    tree: Dict = {}
    off = 0
    for (path, shape, scale), k in zip(leaves, sizes):
        leaf = buf[off:off + k].view(shape)
        if scale is not None:
            leaf.mul_(scale)
        off += k
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
