"""The readings a cell's limits are set from, several seeds in one
process on the card: each seed's run of the timed path (set-up, a
window of ``--seconds``, the comparison), and with ``--control`` the
control's reading on the same sample (the reference in the next lower
precision, put in the program's place):

    python3 restore_bench/calibrate.py --workload <cell> --seeds 1 2 3 \
        --seconds <s> [--control]

Prints one JSON line a seed."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from restore_bench import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args()
    harness.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    for seed in a.seeds:
        t = time.perf_counter()
        out = harness.run_cell(a.workload, seed, a.seconds, False, "cuda:0",
                               t)
        drv = out["_driver"]
        line = {"seed": seed, "correct": out["correct"],
                "attempted": out["attempted"], "failed": out["failed"],
                "program": {k: v["value"] for k, v in out["compared"].items()},
                "checked": out["_checked"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        if a.control:
            t1 = time.perf_counter()
            line["control"] = drv.control()
            line["control_s"] = time.perf_counter() - t1
        line["wall_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del out, drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
