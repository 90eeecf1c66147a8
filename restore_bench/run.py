"""Run one cell of the benchmark once:

    python3 restore_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Prints the result as the last line of standard output (one
JSON object) and every compared number beside its limit as the last
lines of standard error.  Exits non-zero, printing no result, without
the cards, without the program, or when JAX or the JAX package was
loaded."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from restore_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    harness.cache_dirs()
    spec = harness.load_spec()
    entry = harness.cell_entry(spec, a.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"restore_bench: needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"restore_bench: the program is missing: {e}", file=sys.stderr)
        return 4
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           "cuda:0", T_START, spec=spec)
    bad = sorted(set(out["_forbidden"]) | set(harness.forbidden_modules()))
    if bad:
        print("restore_bench: loaded in this process: " + ", ".join(bad),
              file=sys.stderr)
        return 5
    checked = out.pop("_checked")
    for k in [k for k in out if k.startswith("_")]:
        out.pop(k)
    print(json.dumps(out), flush=True)
    print("restore_bench: " + ", ".join(f"{k} {v:g}"
                                        for k, v in checked.items()),
          file=sys.stderr)
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
