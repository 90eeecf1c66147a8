"""Three-term roofline analysis of the port's dry-run reports
(``src/repro/roofline/analysis.py``), for one NVIDIA H100 or per device
of a mesh of them.

    compute term    = sum over dtypes of FLOPs / the dtype's peak rate
    memory term     = bytes / HBM bandwidth
    collective term = NVLink bytes / NVLINK_BW + network bytes / NET_BW
                      (0 on one card)

The numbers come from ``launch/dryrun.py``: the step's aten ops on the
meta device, extrapolated over depth (and over time for the xLSTM
loops); on a mesh ("16x16", "2x16x16") rank 0's step over a counting
mesh, whose collectives' result bytes are split by link
(``collective_bytes_by_link``: a call whose group spans two nodes of 8
cards crosses the network).  A report without that split prices all its
collective bytes at ``NVLINK_BW``.  FLOPs are kept by dtype, so float32 products (the xLSTM cells'
recurrences, the MoE router, the attention's plain version) are priced at
the float32 rate, not the bf16 tensor cores'.  A report without
``flops_by_dtype`` prices all its FLOPs at ``PEAK_FLOPS``.

Hardware constants: NVIDIA's data sheet for the H100 SXM at its 700 W
limit, dense rates: 989 TFLOP/s bf16 and fp16, 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s HBM3, 450 GB/s each way per card over
NVLink; and for the network between nodes one 400 Gb/s NDR InfiniBand
port a card on an HGX H100 board, 50 GB/s each way (NVIDIA's data sheets
for the HGX H100 and the ConnectX-7 adapter).  These are data-sheet
constants: the mesh rows are predictions, not measurements.

    PYTHONPATH=src python -m repro_torch.roofline.analysis \\
        --dryrun-dir experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

PEAK_FLOPS = 989e12          # bf16 / fp16, one card
PEAK_FLOPS_BY_DTYPE = {"bfloat16": 989e12, "float16": 989e12,
                       "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s, one card
NVLINK_BW = 450e9            # bytes/s each way, one card
NET_BW = 50e9                # bytes/s each way, one 400 Gb/s NDR port a card

N_CHIPS = {"1xH100": 1, "16x16": 256, "2x16x16": 512}


def predict_tile_time_s(bytes_accessed: float, flops: float = 0.0,
                        collective_bytes: float = 0.0,
                        dispatch_overhead_s: float = 0.0) -> float:
    """Price one candidate kernel/exchange configuration by the same
    three-term roofline that scores whole dry-run cells: the dominant of
    compute (at the bf16 peak), HBM and NVLink time, plus a
    caller-modeled fixed dispatch cost (per-tile launch overhead,
    collective launch).  Consumed by ``kernels/autotune.py``."""
    return max(flops / PEAK_FLOPS, bytes_accessed / HBM_BW,
               collective_bytes / NVLINK_BW) + dispatch_overhead_s


def compute_time_s(cost: dict) -> float:
    """FLOPs over the peak of their dtype (``PEAK_FLOPS`` for a dtype
    the table lacks, or a report without ``flops_by_dtype``)."""
    by = cost.get("flops_by_dtype")
    if not by:
        return max(cost["flops"], 0.0) / PEAK_FLOPS
    return sum(max(f, 0.0) / PEAK_FLOPS_BY_DTYPE.get(d, PEAK_FLOPS)
               for d, f in by.items())


def collective_time_s(cost: dict) -> float:
    """The collective bytes over their links' rates: NVLink and network
    from ``collective_bytes_by_link``, or all at ``NVLINK_BW`` in a
    report without it."""
    by = cost.get("collective_bytes_by_link")
    if by is None:
        return max(sum(cost["collective_bytes"].values()), 0.0) / NVLINK_BW
    return max(by.get("nvlink", 0.0), 0.0) / NVLINK_BW + \
        max(by.get("network", 0.0), 0.0) / NET_BW


def model_flops(report: dict) -> float:
    """6*N*D (train) / 2*N*D (fwd-only), N = active params, D = tokens."""
    n = report["active_params"]
    kind = report["kind"]
    if kind == "train":
        tokens = report["seq"] * report["global_batch"]
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = report["seq"] * report["global_batch"]
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * report["global_batch"]


def analyze_cell(report: dict) -> Optional[dict]:
    if report.get("status") != "ok":
        return None
    chips = N_CHIPS[report["mesh"]]
    ce = report.get("cost_extrapolated")
    if not ce:
        return None
    flops_dev = max(ce["flops"], 0.0)
    bytes_dev = max(ce["bytes"], 0.0)

    t_compute = compute_time_s(ce)
    t_memory = bytes_dev / HBM_BW
    # depth-extrapolation noise can drive tiny cells negative — clamped
    t_coll = collective_time_s(ce)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)

    mf = model_flops(report)
    hlo_global = flops_dev * chips
    useful = mf / hlo_global if hlo_global else float("nan")
    # roofline fraction: useful work vs what the dominant term costs
    t_ideal = (mf / chips) / PEAK_FLOPS
    frac = t_ideal / max(terms[dominant], 1e-30)

    return {
        "arch": report["arch"], "shape": report["shape"],
        "mesh": report["mesh"], "kind": report["kind"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": mf, "hlo_flops_global": hlo_global,
        "useful_ratio": useful, "roofline_fraction": frac,
        "collective_breakdown": ce["collective_bytes"],
        "memory_per_device": report.get("memory", {}),
    }


_SUGGESTIONS = {
    "compute": ("compute-bound: raise tensor-core utilization — keep the "
                "products in bf16 (float32 runs at 67 of 989 TFLOP/s), "
                "fuse the attention softmax (the flash kernels), drop "
                "remat recompute on cheap ops."),
    "memory": ("memory-bound: cut HBM traffic — fuse elementwise chains "
               "into the matmuls, keep activations bf16, shard the "
               "largest resident tensor further."),
    "collective": ("collective-bound: overlap or shrink comms — "
                   "reduce-scatter instead of all-reduce+slice, "
                   "sequence-shard the KV cache, async collectives "
                   "overlapped with compute."),
}


def suggestion(row: dict) -> str:
    base = _SUGGESTIONS[row["dominant"]]
    if row["useful_ratio"] < 0.4 and row["dominant"] == "compute":
        base += (" useful/HLO flops is low (remat or redundant "
                 "recompute dominates) — revisit checkpoint policy.")
    return base


def load_reports(dryrun_dir: str) -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rep = json.load(f)
        rep["_optimized"] = path.endswith("_opt.json")
        out.append(rep)
    return out


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def to_markdown(rows: List[dict], skipped: List[dict]) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPS | useful/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute_s'])} | "
            f"{fmt_s(r['t_memory_s'])} | {fmt_s(r['t_collective_s'])} | "
            f"**{r['dominant']}** | {r['model_flops']:.3g} | "
            f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} |")
    lines.append("")
    lines.append("Per-cell bottleneck notes:")
    for r in rows:
        lines.append(f"* `{r['arch']} x {r['shape']}`: {suggestion(r)}")
    if skipped:
        lines.append("")
        lines.append("Skipped cells (assignment rules):")
        for s in skipped:
            lines.append(f"* `{s['arch']} x {s['shape']}` ({s['mesh']}): "
                         f"{s.get('reason', '')}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Roofline tables of the port's dry-run reports: one "
                    "H100, and per device of each mesh found, with and "
                    "without --opt.")
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--out", default="experiments/roofline_torch.md")
    ap.add_argument("--json-out", default="experiments/roofline_torch.json")
    args = ap.parse_args(argv)

    # one table a (mesh, --opt) group, the one card's first ("baseline")
    groups = {}
    for rep in load_reports(args.dryrun_dir):
        if rep.get("mesh") not in N_CHIPS:
            continue
        key = rep["mesh"] + ("_opt" if rep["_optimized"] else "")
        rows, skipped = groups.setdefault(key, ([], []))
        if rep.get("status") == "skipped":
            skipped.append(rep)
            continue
        row = analyze_cell(rep)
        if row:
            rows.append(row)
    order = [k for m in N_CHIPS for k in (m, m + "_opt") if k in groups]
    for rows, _ in groups.values():
        rows.sort(key=lambda r: (r["arch"], r["shape"]))

    for path in (args.out, args.json_out):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump({("baseline" if k == "1xH100" else k): groups[k][0]
                   for k in order}, f, indent=1)
    md = []
    for k in order:
        title = ("One H100 (the port's dry-run)" if k == "1xH100" else
                 f"{k.replace('_opt', '')} per device, rank 0"
                 + (", --opt" if k.endswith("_opt") else "")
                 + " (predicted at the data-sheet constants)")
        md += ([""] if md else []) + [f"## {title}", "",
                                      to_markdown(*groups[k])]
    text = "\n".join(md)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)


if __name__ == "__main__":
    main()
