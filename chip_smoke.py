#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card    — the card's name and power limit (``nvidia-smi``);
2. build   — ``nvcc`` for every CUDA source of the port, all in parallel;
3. kernels — each hand-written kernel against its plain PyTorch version on
             the card, bitwise, at the main path's shapes (16,777,216 rows;
             a 4,194,304-key join index; P = 8 partitions, and P = 4096 and
             100,003 across the shared-memory histogram limit, on uniform
             and Zipf(1.3) keys), with edge cases; kernel, plain and
             library-call times from CUDA events;
4. main    — one S/C refresh round: ``generate_workload(12, seed=4)``
             realized at 512 MiB per root on the card, calibrated, solved
             for a 1.6 GB Memory Catalog, run serially and with S/C; the
             S/C output must be bitwise the serial output, the catalog
             within budget, and every kernel of the round launched; the S/C
             round then runs once more under ``torch.profiler`` for the
             device's busy share;
5. part    — the same calibrated workload through an incremental scenario
             (one round of 10% ingest, 5% update, 2% delete after the
             build), hash-partitioned P = 8 ways and unpartitioned, with the
             1.6 GB catalog: the partitioned stores must reassemble bitwise
             to the unpartitioned ones, every round's catalog stay within
             budget, and ``pid_hist`` and the weighted encode launch;
6. cpu     — the round, and the partitioned scenario (two incremental
             rounds), at 4 MiB per root on
             the card and on the CPU (plain versions): every stored MV and
             partition bitwise equal, and both partitioned stores equal to
             a full-recompute scenario on the card;
7. a JSON line listing every kernel with its launches over every path,
   its times and its bound; then the JSON result line.

Exits with 2, printing no result, when CUDA is unavailable or the port's
sources are not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_ROWS = 16_777_216           # rows of one scan table at 512 MiB per root
N_INDEX = 4_194_304           # join-index keys (distinct keys of a scan)
MAIN_BYTES_PER_ROOT = 512 << 20
MAIN_BUDGET = 1.6e9           # the paper's Memory Catalog
SMALL_BYTES_PER_ROOT = 4 << 20
PEAK_FLOPS = 67e12            # f32 outside the tensor cores, H100 SXM
ISSUE_PER_SM = 128            # 4 warp schedulers x 32 lanes per clock
I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)
N_PARTITIONS = 8
SCENARIO = dict(mode="incremental", ingest_frac=0.1, update_frac=0.05,
                delete_frac=0.02, n_rounds=2)
# Incremental rounds of the 512 MiB scenario: cut from 2 to keep the whole
# script near 400 s (396-443 s on an H100 with 2; storage fsync dominates).
MAIN_SCENARIO_ROUNDS = 1
# The kernels of the one-round main path; pid_hist joins them on the
# partitioned path, and hash64 lies on neither (as in the reference, only
# partition._hash64 reaches it).
ROUND_KERNELS = ("filter_gt", "map_derived", "fixed_point_encode", "probe_sorted")
# SASS functions of the two integer kernels, whose operation bound is their
# instructions per row (read from the build) over the card's issue rate.
HASH_SASS = {"hash64": "hash64_kernel", "pid_hist": "pid_hist_kernelILb1"}

# Which Pallas kernel each port kernel replaces (JAX package, file:line).
REPLACES = {
    "filter_gt": "src/repro/mv/dataplane.py:364",
    "map_derived": "src/repro/mv/dataplane.py:376",
    "fixed_point_encode": "src/repro/mv/dataplane.py:395",
    "probe_sorted": "src/repro/mv/dataplane.py:421",
    "hash64": "src/repro/mv/dataplane.py:300",
    "pid_hist": "src/repro/mv/dataplane.py:325",
}
SOURCE = "src/repro_torch/csrc/dataplane.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def hbm_bytes_per_s(name: str) -> float:
    """Device-memory rate of the card ``nvidia-smi`` names (NVIDIA data
    sheets)."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12
    if "H100" in n and "NVL" in n:
        return 3.9e12
    if "H100" in n:
        return 3.35e12
    raise RuntimeError(f"no memory rate on record for card {name!r}")


def issue_rate(torch) -> float:
    """Instructions per second the card can issue: SMs x 4 schedulers x 32
    lanes x the maximum SM clock ``nvidia-smi`` reports. No instruction mix
    runs faster; integer work splits between the 64-lane ALU pipe and the
    IMAD (FMA) pipe of each SM, so a mix of both can reach it and a pure ALU
    stream reaches half."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * ISSUE_PER_SM * mhz * 1e6


def sass_per_row(lib_path, functions: dict[str, str]) -> dict[str, float]:
    """SASS instructions each kernel executes per row, read from the built
    library with ``cuobjdump -sass``: the instructions of its main loop
    (the backward branch whose body holds the most global loads), plus
    those of any routine the loop calls up to its return — the 64-bit
    remainder ``% P`` compiles to, as the card has no 64-bit divide — over
    the rows one trip handles (its global loads: unrolled loops load
    several)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs[line.split("Function :", 1)[1].strip()] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for kernel, fn in functions.items():
        ins = next(v for k, v in funcs.items() if fn in k)
        at = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (a, text) in enumerate(ins):
            m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < a:
                body = ins[at[int(m.group(1), 16)]:i + 1]
                loads = sum(bool(re.search(r"\bLDG\b", t)) for _, t in body)
                if loads:
                    loops.append((loads, body))
        loads, body = max(loops, key=lambda lb: (lb[0], len(lb[1])))
        count = len(body)
        for _, text in body:
            m = re.search(r"\bCALL\.REL\.NOINC\s+(0x[0-9a-f]+)", text)
            if m:
                j = at[int(m.group(1), 16)]
                k = next(k for k in range(j, len(ins))
                         if re.search(r"\bRET\b", ins[k][1]))
                count += k - j + 1
        out[kernel] = count / loads
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, samples: int = 21, batch: int = 10) -> float:
    """Median per-call device time over ``samples`` CUDA-event windows of
    ``batch`` back-to-back calls each, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def max_abs_err(torch, got, want) -> float:
    """Largest |kernel − plain| over the outputs (NaN pairs count as 0)."""
    err = 0.0
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs().nan_to_num(0.0, 0.0, 0.0)
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def bitwise_equal(torch, got, want) -> bool:
    return all(
        g.dtype == w.dtype and g.shape == w.shape and torch.equal(
            g.contiguous().view(torch.uint8), w.contiguous().view(torch.uint8))
        for g, w in zip(got, want)
    )


def kernel_cases(torch, np, dp, dev, per_row):
    """(kernel, case, inputs, kernel fn, plain fn, library fn or None,
    operations) at the main path's shapes, with edge values written into
    the first rows. ``per_row`` holds the hash kernels' SASS instructions
    per row."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n = N_ROWS

    def randn(dtype):
        return torch.randn(n, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    f32, f64 = randn(torch.float32), randn(torch.float64)
    i64 = (randn(torch.float64) * 100).to(torch.int64)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                             0.0, 1e-40, 0.1, 3e38], device=dev)
    f32[:8] = specials
    f64[:8] = specials.double()
    i64[:4] = torch.tensor([I64MAX, I64MIN, 0, -1], device=dev)
    b32 = randn(torch.float32) * 50
    b32[:8] = specials.flip(0)
    v32 = randn(torch.float32) * 100
    half = 0.5 / 65536.0
    v32[:6] = torch.tensor([half, -half, 3 * half, 1.0 + half, 123.456, 0.0],
                           device=dev)
    w = torch.randint(-3, 4, (n,), generator=gen, device=dev)
    w[:6] = torch.tensor([7, -7, 1 << 45, -(1 << 50), I64MAX, I64MIN], device=dev)
    uniq = torch.arange(N_INDEX, device=dev, dtype=torch.int64) * 2 - N_INDEX
    uniq[-1] = I64MAX
    probe = torch.randint(-N_INDEX - 4, N_INDEX + 4, (n,), generator=gen,
                          device=dev)
    probe[:6] = torch.tensor([I64MAX, I64MIN, I64MAX - 1, N_INDEX - 2,
                              -N_INDEX, -N_INDEX - 1], device=dev)
    steps = math.ceil(math.log2(N_INDEX)) + 1
    thr = 0.1
    edges = torch.tensor([I64MIN, I64MAX, -1, 0], device=dev)
    keys = torch.from_numpy(np.random.default_rng(12).integers(
        I64MIN, I64MAX, n, dtype=np.int64, endpoint=True)).to(dev)
    keys[:4] = edges
    zipf = torch.from_numpy(np.random.default_rng(13).zipf(1.3, n)).to(dev)
    zipf[:4] = edges

    def hist_case(case, k, P):
        return ("pid_hist", case, (k,), lambda: dp.pid_hist(k, P),
                lambda: dp._pid_hist_plain(k, P), None, per_row["pid_hist"] * n)

    cases = [
        ("filter_gt", "f32", (f32,), lambda: (dp.filter_mask(f32, thr),),
         lambda: (dp._filter_plain(f32, thr),), lambda: (torch.gt(f32, thr),), n),
        ("filter_gt", "f64", (f64,), lambda: (dp.filter_mask(f64, thr),),
         lambda: (dp._filter_plain(f64, thr),), lambda: (torch.gt(f64, thr),), n),
        ("filter_gt", "i64", (i64,), lambda: (dp.filter_mask(i64, -0.3),),
         lambda: (dp._filter_plain(i64, -0.3),), None, n),
        ("map_derived", "two_f32", (f32, b32),
         lambda: (dp.map_derived(f32, b32),), lambda: (dp._map_plain(f32, b32),),
         None, 5 * n),
        ("map_derived", "one_f32", (f32,), lambda: (dp.map_derived(f32, None),),
         lambda: (dp._map_plain(f32, None),), None, 3 * n),
        ("map_derived", "two_f64", (f64, b32),
         lambda: (dp.map_derived(f64, b32),), lambda: (dp._map_plain(f64, b32),),
         None, 5 * n),
        ("fixed_point_encode", "f32", (v32,),
         lambda: (dp.fixed_point_encode(v32),),
         lambda: (dp._encode_plain(v32, None),), None, 2 * n),
        ("fixed_point_encode", "f32_weighted", (v32, w),
         lambda: (dp.fixed_point_encode(v32, w),),
         lambda: (dp._encode_plain(v32, w),), None, 3 * n),
        ("fixed_point_encode", "f64", (f64,),
         lambda: (dp.fixed_point_encode(f64),),
         lambda: (dp._encode_plain(f64, None),), None, 2 * n),
        ("probe_sorted", "16.7M_into_4.2M", (uniq, probe),
         lambda: dp.probe_sorted(uniq, probe), lambda: dp._probe_plain(uniq, probe),
         lambda: (torch.searchsorted(uniq, probe),), steps * n),
        # uint64 output, compared (and timed) through an int64 view
        ("hash64", "uniform", (keys,), lambda: (dp.hash64(keys).view(torch.int64),),
         lambda: (dp._hash64_i64(keys),), None, per_row["hash64"] * n),
        ("hash64", "zipf1.3", (zipf,), lambda: (dp.hash64(zipf).view(torch.int64),),
         lambda: (dp._hash64_i64(zipf),), None, per_row["hash64"] * n),
        hist_case("uniform_P8", keys, N_PARTITIONS),
        hist_case("zipf1.3_P8", zipf, N_PARTITIONS),
        hist_case("uniform_P4096", keys, 4096),
        hist_case("zipf1.3_P4096", zipf, 4096),
        hist_case("uniform_P100003", keys, 100_003),
        hist_case("zipf1.3_P100003", zipf, 100_003),
    ]
    return cases


def kernel_phase(torch, np, dp, dev, bw, inst_rate, per_row):
    """Hold every kernel against its plain version; time the cases. Returns
    per-case rows and the case each kernel reports on the kernels line (the
    shape and dtype its main-path calls take). A float kernel's operations
    count against the f32 rate, a hash kernel's SASS instructions against
    the card's issue rate."""
    rows = []
    for kernel, case, inputs, kfn, pfn, lfn, ops in kernel_cases(
            torch, np, dp, dev, per_row):
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        if not bitwise_equal(torch, got, want):
            raise AssertionError(f"{kernel}/{case}: kernel differs from plain")
        err = max_abs_err(torch, got, want)
        nbytes = sum(t.nbytes for t in inputs) + sum(t.nbytes for t in got)
        bytes_ms = nbytes / bw * 1e3
        rate = inst_rate if kernel in HASH_SASS else PEAK_FLOPS
        ops_ms = ops / rate * 1e3
        row = dict(
            kernel=kernel, case=case, max_abs_err=err,
            ms=time_ms(torch, kfn), plain_ms=time_ms(torch, pfn),
            library_ms=None if lfn is None else time_ms(torch, lfn),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes,
        )
        rows.append(row)
        log(f"kernel {kernel:<19} {case:<16} bitwise ok  max_abs_err={err} "
            f"ms={row['ms']} plain_ms={row['plain_ms']} "
            f"library_ms={row['library_ms']} bound_ms={row['bound_ms']} "
            f"({row['bound_by']}, {nbytes} B, bytes {bytes_ms} ms, "
            f"ops {ops_ms} ms)")
        if kernel == "pid_hist":
            check_grouping(torch, dp, inputs[0], got[0], case)
    return rows


def check_grouping(torch, dp, keys, pid, case):
    """``partition_index`` on the card (pid_hist, then the stable sort)
    against the plain grouping, bitwise; and the sort's own time, the
    grouping's cost beside the kernel."""
    P = int(case.rsplit("_P", 1)[1])
    got = dp.partition_index(keys, P)
    plain_pid, plain_counts = dp._pid_hist_plain(keys, P)
    want = (torch.sort(plain_pid, stable=True).indices, plain_counts)
    torch.cuda.synchronize()
    if not bitwise_equal(torch, got, want):
        raise AssertionError(f"partition_index/{case}: order differs from plain")
    sort_ms = time_ms(torch, lambda: torch.sort(pid, stable=True))
    log(f"kernel pid_hist            {case:<16} partition_index order bitwise "
        f"ok; grouping torch.sort(pid, stable=True) ms={sort_ms}")


# ---------------------------------------------------------------------------
# phases 4-5: the refresh round
# ---------------------------------------------------------------------------

def on_device_fns(torch, wl, dev_type):
    """The workload with every node fn wrapped to check that each table it
    is handed and each table it returns lies on ``dev_type``."""
    def check(name, table):
        for col, v in table.items():
            if v.device.type != dev_type:
                raise AssertionError(f"{name}.{col} on {v.device}, not {dev_type}")

    def wrap(node):
        def fn(inputs):
            for t in inputs:
                check(node.name + " input", t)
            out = node.fn(inputs)
            check(node.name, out)
            return out
        return dataclasses.replace(node, fn=fn)

    return dataclasses.replace(wl, nodes=[wrap(n) for n in wl.nodes])


def refresh_round(torch, core, mv, root, bytes_per_root, budget, device):
    """Realize, calibrate, solve, then a serial and an S/C run. Returns the
    stores, reports, plan and launch counts of each step."""
    from repro_torch.mv import dataplane as dp

    wl = mv.realize_workload(mv.generate_workload(12, seed=4),
                             bytes_per_root=bytes_per_root, device=device)
    wl = on_device_fns(torch, wl, torch.device(device).type)
    dp.reset_launches()
    t0 = time.perf_counter()
    wl = mv.calibrate_sizes(wl, mv.DiskStore(root / "calib", device=device))
    calib_s = time.perf_counter() - t0
    shutil.rmtree(root / "calib")
    graph = wl.to_graph()
    plan = core.solve(graph, budget=budget)
    serial = mv.DiskStore(root / "serial", device=device)
    serial_rep = mv.Controller(wl, serial, 0.0).run(core.serial_plan(graph))
    before_sc = dict(dp.launches)
    sc = mv.DiskStore(root / "sc", device=device)
    sc_rep = mv.Controller(wl, sc, budget).run(plan)
    launches = dict(dp.launches)
    sc_launches = {k: launches[k] - before_sc[k] for k in launches}
    names = [n.name for n in wl.nodes]
    for store in (serial, sc):
        missing = set(names) - set(store.manifest())
        if missing:
            raise AssertionError(f"manifest lacks {sorted(missing)}")
    if not sc_rep.peak_catalog_bytes <= budget:
        raise AssertionError(
            f"peak catalog {sc_rep.peak_catalog_bytes} exceeds budget {budget}")
    return dict(wl=wl, graph=graph, plan=plan, serial=serial, sc=sc,
                serial_rep=serial_rep, sc_rep=sc_rep, calib_s=calib_s,
                launches=launches, sc_launches=sc_launches, names=names)


def profiled_round(torch, mv, wl, plan, budget, root):
    """Rerun the S/C round under ``torch.profiler`` (device activity only)
    and print the device's busy share and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep = mv.Controller(wl, mv.DiskStore(root, device="cuda"), budget).run(plan)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if us > 0:
            by_name[e.key] = (us, e.count)
    copy_us = sum(us for k, (us, _) in by_name.items()
                  if k.startswith(("Memcpy", "Memset")))
    kernel_us = sum(us for us, _ in by_name.values()) - copy_us
    wall_us = rep.elapsed * 1e6
    log(f"profile: S/C round {rep.elapsed:.3f}s under the profiler; device "
        f"kernels {kernel_us / 1e3:.3f} ms, copies {copy_us / 1e3:.3f} ms; "
        f"busy share {(kernel_us + copy_us) / wall_us:.5f} "
        f"(kernels alone {kernel_us / wall_us:.6f})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for k, (us, count) in top:
        log(f"profile:   {us / 1e3:10.3f} ms  {count:5d}x  {k[:100]}")


# ---------------------------------------------------------------------------
# phases 5-6: the incremental scenario, hash-partitioned and unpartitioned
# ---------------------------------------------------------------------------

def run_scenarios(torch, core, mv, dp, wl, root, budget, device, n_rounds):
    """The incremental scenario P-way partitioned (``planner="auto"``) and
    unpartitioned on ``wl``, each into its own store, with the launch
    counts of each run; the partitioned stores must reassemble bitwise to
    the unpartitioned ones, and every round's catalog stay in budget."""
    spec = mv.UpdateSpec(**dict(SCENARIO, n_rounds=n_rounds))
    out = {}
    for label in ("partitioned", "unpartitioned"):
        store = mv.DiskStore(root / f"{label}_{device}", device=device)
        dp.reset_launches()
        t0 = time.perf_counter()
        if label == "partitioned":
            rep = mv.run_partitioned_scenario(wl, N_PARTITIONS, store, budget, spec,
                                              core.PAPER_COST_MODEL, planner="auto")
        else:
            rep = mv.run_scenario(wl, store, budget, spec, core.PAPER_COST_MODEL)
        out[label] = dict(rep=rep, store=store, seconds=time.perf_counter() - t0,
                          launches=dict(dp.launches),
                          variants=dict(dp.variant_launches))
        for r in rep.rounds:
            if not r.run.peak_catalog_bytes <= budget:
                raise AssertionError(
                    f"{label} round {r.round_idx}: peak catalog "
                    f"{r.run.peak_catalog_bytes} exceeds budget {budget}")
    t0 = time.perf_counter()
    mv.verify_partitioned_equivalence(wl, out["partitioned"]["store"],
                                      N_PARTITIONS, out["unpartitioned"]["store"])
    out["verify_seconds"] = time.perf_counter() - t0
    return out


def log_rounds(label, rep):
    """Per round: wall, planning and store seconds, catalog hits, the count
    of each refresh status, JOIN fallbacks and the skipped (clean) tasks."""
    for r in rep.rounds:
        counts = {s: list(r.statuses.values()).count(s)
                  for s in ("static", "appended", "delta", "replaced")}
        log(f"part: {label} round {r.round_idx} ({r.mode}) elapsed "
            f"{r.elapsed:.3f}s plan {r.plan_seconds:.3f}s read "
            f"{r.run.read_seconds:.3f}s write {r.run.write_seconds:.3f}s "
            f"catalog_hits {r.run.catalog_hits} peak_catalog "
            f"{r.run.peak_catalog_bytes:.0f} B flagged {len(r.plan.flagged)} "
            f"statuses {counts} join_fallbacks {r.join_fallbacks} "
            f"skipped {len(r.run.skipped)} {sorted(r.run.skipped)}")


def check_finite(torch, name, table):
    for col, v in table.items():
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}.{col} holds non-finite values")


def main() -> int:
    if not (HERE / "src" / "repro_torch" / "mv" / "dataplane.py").is_file():
        print("chip_smoke: the port (src/repro_torch) is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch.core as core
    import repro_torch.mv as mv
    from repro_torch import native
    from repro_torch.mv import dataplane as dp
    from repro_torch.mv import tableops as T

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # -- 1. card --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw = hbm_bytes_per_s(kind)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()} hbm_rate {bw:.3e} B/s")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = native.build()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")
    inst_rate = issue_rate(torch)
    per_row = sass_per_row(native.library_path("dataplane"), HASH_SASS)
    log(f"issue rate {inst_rate:.4e} instructions/s; SASS instructions per row "
        f"{per_row}")

    # -- 3. kernels -------------------------------------------------------------
    t_phase = time.perf_counter()
    rows = kernel_phase(torch, np, dp, dev, bw, inst_rate, per_row)
    log(f"phase kernels {time.perf_counter() - t_phase:.1f}s")

    # -- 4. main path -----------------------------------------------------------
    t_phase = time.perf_counter()
    store_root = HERE / "build" / "chip_smoke_store"
    shutil.rmtree(store_root, ignore_errors=True)
    store_root.mkdir(parents=True)
    log(f"disk free under {store_root}: {shutil.disk_usage(store_root).free:.3e} B")
    torch.cuda.reset_peak_memory_stats()
    main = refresh_round(torch, core, mv, store_root / "main",
                         MAIN_BYTES_PER_ROOT, MAIN_BUDGET, "cuda")
    peak_mem = torch.cuda.max_memory_allocated()
    sc_rep, serial_rep = main["sc_rep"], main["serial_rep"]
    for name in main["names"]:
        a, b = main["serial"].read(name), main["sc"].read(name)
        T.assert_tables_bitwise(a, b, f"serial vs S/C {name}")
        check_finite(torch, name, b)
        del a, b
    unlaunched = [k for k in ROUND_KERNELS if main["launches"][k] <= 0]
    if unlaunched:
        raise AssertionError(f"kernels never launched on the main path: {unlaunched}")
    total_bytes = sum(main["graph"].sizes)
    log(f"main: 12 MVs, {total_bytes:.4e} B of MV output, budget {MAIN_BUDGET:.3e} B, "
        f"flagged {sorted(main['plan'].flagged)}")
    log(f"main: calibrate {main['calib_s']:.3f}s serial {serial_rep.elapsed:.3f}s "
        f"S/C {sc_rep.elapsed:.3f}s speedup {serial_rep.elapsed / sc_rep.elapsed:.3f}x "
        f"catalog_hits {sc_rep.catalog_hits} peak_catalog {sc_rep.peak_catalog_bytes:.0f} B "
        f"max_memory_allocated {peak_mem} B")
    log(f"main: serial read {serial_rep.read_seconds:.3f}s write "
        f"{serial_rep.write_seconds:.3f}s; S/C read {sc_rep.read_seconds:.3f}s "
        f"write {sc_rep.write_seconds:.3f}s")
    log("main: S/C node seconds " + json.dumps(
        {k: round(v, 4) for k, v in sc_rep.node_seconds.items()}))
    log(f"main: launches (calibrate+serial+S/C) {main['launches']}; "
        f"S/C round alone {main['sc_launches']}")
    log("main: S/C output bitwise equal to serial; every kernel of the round "
        "launched; peak catalog within budget")
    shutil.rmtree(store_root / "main")
    profiled_round(torch, mv, main["wl"], main["plan"], MAIN_BUDGET,
                   store_root / "profiled")
    shutil.rmtree(store_root / "profiled")
    log(f"phase main {time.perf_counter() - t_phase:.1f}s")

    # -- 5. the partitioned incremental scenario -----------------------------------
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    part = run_scenarios(torch, core, mv, dp, main["wl"], store_root,
                         MAIN_BUDGET, "cuda", MAIN_SCENARIO_ROUNDS)
    part_mem = torch.cuda.max_memory_allocated()
    for label in ("partitioned", "unpartitioned"):
        run = part[label]
        log_rounds(label, run["rep"])
        log(f"part: {label} scenario {run['seconds']:.3f}s launches "
            f"{run['launches']} {run['variants']}")
    part_launches = part["partitioned"]["launches"]
    unlaunched = [k for k in (*ROUND_KERNELS, "pid_hist") if part_launches[k] <= 0]
    if part["partitioned"]["variants"]["fixed_point_encode/weighted"] <= 0:
        unlaunched.append("fixed_point_encode/weighted")
    if unlaunched:
        raise AssertionError(
            f"kernels never launched on the partitioned path: {unlaunched}")
    log(f"part: P={N_PARTITIONS} stores reassemble bitwise to the unpartitioned "
        f"scenario (verify {part['verify_seconds']:.3f}s); every round within "
        f"budget; max_memory_allocated {part_mem} B")
    del part
    shutil.rmtree(store_root, ignore_errors=True)
    log(f"phase part {time.perf_counter() - t_phase:.1f}s")

    # -- 6. card against CPU ------------------------------------------------------
    t_phase = time.perf_counter()
    small_budget = MAIN_BUDGET * SMALL_BYTES_PER_ROOT / MAIN_BYTES_PER_ROOT
    on_card = refresh_round(torch, core, mv, store_root / "small_cuda",
                            SMALL_BYTES_PER_ROOT, small_budget, "cuda")
    on_cpu = refresh_round(torch, core, mv, store_root / "small_cpu",
                           SMALL_BYTES_PER_ROOT, small_budget, "cpu")
    if on_card["plan"].order != on_cpu["plan"].order or \
            on_card["plan"].flagged != on_cpu["plan"].flagged:
        raise AssertionError("card and CPU rounds solved different plans")
    for name in on_card["names"]:
        T.assert_tables_bitwise(on_cpu["sc"].read(name), on_card["sc"].read(name),
                                f"cpu vs card {name}")
    log(f"cpu: 4 MiB/root round, 12 MVs bitwise equal card vs CPU "
        f"(card S/C {on_card['sc_rep'].elapsed:.3f}s, CPU S/C "
        f"{on_cpu['sc_rep'].elapsed:.3f}s)")
    small = {dev_: run_scenarios(torch, core, mv, dp, r["wl"], store_root / "small",
                                 small_budget, dev_, SCENARIO["n_rounds"])["partitioned"]
             for dev_, r in (("cuda", on_card), ("cpu", on_cpu))}
    card_store, cpu_store = small["cuda"]["store"], small["cpu"]["store"]
    if card_store.manifest() != cpu_store.manifest():
        raise AssertionError("card and CPU partitioned stores hold other entries")
    for name in card_store.manifest():
        T.assert_tables_bitwise(cpu_store.read(name), card_store.read(name),
                                f"cpu vs card {name}")
    full = mv.DiskStore(store_root / "small_full", device="cuda")
    mv.run_scenario(on_card["wl"], full, small_budget,
                    mv.UpdateSpec(**dict(SCENARIO, mode="full")), core.PAPER_COST_MODEL)
    for store in (card_store, cpu_store):
        mv.verify_partitioned_equivalence(on_card["wl"], store, N_PARTITIONS, full)
    log(f"cpu: 4 MiB/root P={N_PARTITIONS} incremental scenario, "
        f"{len(card_store.manifest())} partition entries bitwise equal card vs "
        f"CPU; both reassemble to the full-recompute scenario "
        f"(card {small['cuda']['seconds']:.3f}s, CPU {small['cpu']['seconds']:.3f}s)")
    shutil.rmtree(store_root, ignore_errors=True)
    log(f"phase cpu {time.perf_counter() - t_phase:.1f}s")

    # -- 7. kernels line ------------------------------------------------------------
    headline = {"filter_gt": "f32", "map_derived": "two_f32",
                "fixed_point_encode": "f32", "probe_sorted": "16.7M_into_4.2M",
                "hash64": "uniform", "pid_hist": "uniform_P8"}
    kernels = []
    for kernel, case in headline.items():
        row = next(r for r in rows if r["kernel"] == kernel and r["case"] == case)
        kernels.append(dict(
            name=kernel, route="cuda", source=SOURCE, replaces=REPLACES[kernel],
            launches=main["launches"][kernel] + part_launches[kernel],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == kernel),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    log(f"launches: main path {main['launches']}; partitioned path {part_launches}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
