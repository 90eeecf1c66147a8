"""Run one cell several times in a row, each run a process of its own,
and print each run's numbers and every metric's spread (the distance
between the quartiles of ``statistics.quantiles(values, n=4)`` as a
share of the median):

    python3 restore_bench/sets.py --workload <cell> --seeds 1 2 3 \
        --seconds <s> [--trace-last K] [--out DIR]

Each run's standard output and error are kept under ``--out``."""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace-last", type=int, default=0)
    ap.add_argument("--out", default="build/sets")
    a = ap.parse_args()
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    n = len(a.seeds)
    for i, seed in enumerate(a.seeds):
        trace = int(i >= n - a.trace_last)
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, str(ROOT / "restore_bench" / "run.py"),
             "--workload", a.workload, "--seed", str(seed), "--seconds",
             str(a.seconds), "--trace", str(trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        tag = f"{a.workload}_{i:02d}_{seed}_t{trace}"
        (out / f"{tag}.out").write_text(p.stdout)
        (out / f"{tag}.err").write_text(p.stderr)
        res = None
        if p.returncode == 0 and p.stdout.strip():
            res = json.loads(p.stdout.strip().splitlines()[-1])
        rows.append((seed, trace, res))
        line = {"seed": seed, "trace": trace, "rc": p.returncode,
                "wall_s": round(wall, 1)}
        if res:
            line.update(correct=res["correct"], attempted=res["attempted"],
                        failed=res["failed"],
                        metrics={k: v["value"]
                                 for k, v in res["metrics"].items()},
                        compared={k: v["value"]
                                  for k, v in res["compared"].items()},
                        peak=res["device"]["memory_peak_bytes"],
                        busy=res["device"].get("busy_s"),
                        window=res["device"].get("window_s"))
            notes = [ln for ln in p.stderr.splitlines()
                     if ln.startswith("restore_bench: ")]
            if notes:
                line["notes"] = notes[-1][len("restore_bench: "):]
        else:
            line["stderr"] = p.stderr[-1500:]
        print(json.dumps(line), flush=True)
    vals = {}
    for _, trace, res in rows:
        if res and not trace:
            for k, v in res["metrics"].items():
                vals.setdefault(k, []).append(v["value"])
    for k, v in vals.items():
        print(json.dumps({"metric": k, "n": len(v),
                          "median": statistics.median(v),
                          "spread": spread(v), "values": v}), flush=True)


if __name__ == "__main__":
    main()
