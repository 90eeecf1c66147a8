#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--log2-rows 24] [--seed 0]

Phase 0  the card: name and power limit, torch/CUDA versions, and the
         build of the port's CUDA kernels from ``src/repro_torch/csrc``.
Phase 1  every kernel against its plain PyTorch version on the card: the
         ragged and tie-heavy generators of the kernel parity tests
         (sizes 1-4097) and the main path's shapes, with times for the
         kernel, the plain version and one PyTorch library call that
         computes the same function (a yardstick the port never calls).
Phase 2  the main path: the ReStore loop over PigMix at ``page_views`` =
         2**log2_rows rows (n_users = 2**16) held on the card.  Every
         query runs plain -> store -> reuse as
         ``benchmarks/common.py::measure_query`` does, with disk-rooted
         stores so artifacts take the write path and its compaction
         kernel.  Each arm's rows are checked: the plain arm against a
         numpy oracle computed from the generator's draws, the store and
         reuse arms against the plain arm.  The kernels' launch counters
         are zeroed just before this phase and must all be positive
         after it.

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
        shape=f"N={n} probes (int64 lanes), R={r} sorted build keys"))

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
        bound_ms=b, bound_by=by,
        shape=f"N={n} rows x D={d} f32 lanes, {int(ids[-1]) + 1} segments"))

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


def profile_plain_arm(plan_fn, catalog, dev, keep):
    """Where the time goes in one query's plain arm (disk-rooted store,
    as in phase 2, after a warm run), flush to disk included: wall
    clock, device-busy time and the device activities (kernels and
    copies) that take most of it, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        once()
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
    return wall_ms, busy_ms, [(e.key, dev_us(e) / 1e3, e.count)
                              for e in top]


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
    counters = {"join_probe": hj.launches, "segment_sum": sr.launches,
                "filter_compact": fp.launches}
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
    for k, n in launches.items():
        check(n > 0, f"{k} was never launched on the main path")

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
    for k in kernels:
        k["launches"] = launches[k["name"]]
        log(f"kernel {k['name']:<15} kernel {k['ms']:.4f} ms  plain "
            f"{k['plain_ms']:.4f} ms  library {k['library_ms']:.4f} ms  "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})  launches "
            f"{k['launches']} [{card}]")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels, "queries": times,
                      "page_views_rows": n_rows}))
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
