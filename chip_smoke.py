#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and drives replicated hypergraph partitioning
(``partition_with_replication``) through them.  Phases, in order; any
failure propagates and the exit code is nonzero:

1. build the kernels; print the build time and the card's name and
   power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the partitioning path gives it (exact equality), and time both;
3. the device-resident pass on ``large_row_net(8192)``, P = 8:
   ``fm_refine`` then ``replicate_local_search`` on CUDA against the host
   (numpy) path -- equal masks and cost, counter bounds; then one FM pass
   timed plain and under ``torch.profiler`` (where the time goes);
4. the per-front path on an MoE expert-placement instance (float weights,
   128 experts): ``partition_with_replication`` on CUDA against numpy;
5. full size: ``partition_with_replication(large_row_net(32768))``, P = 8,
   on CUDA, with its time, costs, counters and peak device memory.

Launch counts are reset just before each driven run (phases 3-5) and read
just after; the kernel line reports those of phases 4 and 5, the
``partition_with_replication`` runs.  The min-cover kernel has two counts:
``min_cover_lambdas`` where it prices a front (the Pallas kernel's role)
and ``min_cover_apply`` where the device pass recomputes the lambdas of a
committed move's edges; each is timed at its own commonest shape.  A
``summary`` line near the end holds every number the run reports, so the
last 2 KB of the output carry them.  The last line is the JSON verdict.
Without a CUDA device, or outside a checkout of the repository, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit non-tensor rate (data sheet, fp32)
OPS_PER_ELEM = 3               # compare, select, min per loaded element

# file:line of the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "front_dlam": "src/repro/kernels/gain.py:78",
    "min_cover_lambdas": "src/repro/kernels/gain.py:53",
    "min_cover_apply": "src/repro/kernels/gain.py:53",
}
# launch counter -> the kernel it counts
KERNEL_OF = {"front_dlam": "front_dlam",
             "min_cover_lambdas": "min_cover_lambdas",
             "min_cover_apply": "min_cover_lambdas"}
SOURCE = "src/repro_torch/kernels/csrc/gain.cu"


T0 = time.perf_counter()


def log(*a) -> None:
    print(f"{time.perf_counter() - T0:8.2f}s", *a, flush=True)


def sig(x: float) -> float:
    """``x`` to six significant digits: the summary line's times."""
    return float(f"{x:.6g}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Mean time per eager call of ``fn`` over ``iters`` calls, CUDA
    events around the run: the host's enqueue cost included, as the
    partitioning path pays it."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``launches`` calls captured in one
    CUDA graph and replayed back to back, so no host gap sits between
    them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def bound_ms(kernel: str, R: int, M: int) -> tuple[float, str]:
    """Least time for the work: each input read once, each output written
    once, over the memory rate; the masked-min operations over the
    32-bit rate.  The larger wins."""
    nbytes = 4 * (R * M + M + R) + (4 * R if kernel == "front_dlam" else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEM * R * M / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def popcount_pc(P: int) -> np.ndarray:
    from repro_torch.core.partition.engine import _tables
    from repro_torch.kernels.gain import _NO_COVER
    _, _, order_pc, _ = _tables(P)
    return np.concatenate(([_NO_COVER], order_pc)).astype(np.int32)


def kernel_inputs(R: int, P: int, seed: int):
    """Uncov-like int32 rows on the card: mostly positive, some zeros,
    every seventh row with no zero at all (its lambda is the sentinel)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    M = 1 << P
    rows = torch.randint(1, 4, (R, M), generator=g, device=dev,
                         dtype=torch.int32)
    rows *= (torch.rand((R, M), generator=g, device=dev) > 0.05)
    rows[::7] = 1
    pc = torch.from_numpy(popcount_pc(P)).to(dev)
    lam_old = torch.randint(0, P + 2, (R,), generator=g, device=dev,
                            dtype=torch.int32)
    return rows, pc, lam_old


def check_kernel(kernel: str, R: int, P: int, seed: int) -> dict:
    """Kernel against plain version at (R, 2^P): exact, then timed."""
    import torch
    from repro_torch.kernels import gain, ref
    rows, pc, lam_old = kernel_inputs(R, P, seed)
    if kernel == "front_dlam":
        def run():
            return gain.front_dlam(rows, pc, lam_old)

        def plain():
            return ref.front_dlam_ref(rows, pc, lam_old)
    else:
        def run():
            return gain.min_cover(rows, pc)

        def plain():
            return ref.min_cover_ref(rows, pc)
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max().item())
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel} at R={R}, P={P}: kernel != plain "
                             f"(max abs err {err})")
    if kernel == "min_cover_lambdas" and not bool(
            (got[::7] == gain._NO_COVER).all()):
        raise AssertionError("all-nonzero rows must give the sentinel 127")
    ms, plain_ms = graph_ms(run), graph_ms(plain)
    b, by = bound_ms(kernel, R, 1 << P)
    return {"kernel": kernel, "R": R, "M": 1 << P, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "call_ms": time_ms(run), "plain_call_ms": time_ms(plain)}


class Recorder:
    """Observes a driven run: the device passes it attached and the shape
    of every kernel launch (launch counts stay in ``ops.launches``)."""

    def __init__(self) -> None:
        from repro_torch.kernels import front_pass, gain
        self.passes: list = []
        self.shapes: Counter = Counter()   # (counter, R, M) -> launches
        real_attach, real_launch = front_pass.attach, gain._launch

        def attach(*a, **kw):
            dev = real_attach(*a, **kw)
            if dev is not None:
                self.passes.append(dev)
            return dev

        def launch(kernel, rows_perm, pc, lam_old, count_as):
            self.shapes[(count_as,) + tuple(rows_perm.shape)] += 1
            return real_launch(kernel, rows_perm, pc, lam_old, count_as)

        front_pass.attach, gain._launch = attach, launch

    def reset(self) -> None:
        from repro_torch.kernels import ops
        self.passes.clear()
        ops.reset_launches()

    def counters(self) -> dict:
        keys = ("commits", "finds", "syncs", "pass_scans",
                "apply_dispatches")
        return {k: sum(getattr(d, k) for d in self.passes) for k in keys}


def check_bounds(passes, *, fused: bool) -> None:
    for d in passes:
        if not d.commits <= d.finds <= d.commits + d.pass_scans:
            raise AssertionError(f"finds bound broken: {vars_of(d)}")
        if d.syncs < d.finds:
            raise AssertionError(f"syncs < finds: {vars_of(d)}")
        if fused and d.apply_dispatches:
            raise AssertionError(f"pure sweep dispatched applies: "
                                 f"{vars_of(d)}")


def vars_of(d) -> dict:
    return {k: getattr(d, k) for k in ("commits", "finds", "syncs",
                                       "pass_scans", "apply_dispatches")}


def where_time_goes(hg, P, cap, m0) -> dict:
    """One device FM pass from ``m0``, plain and under ``torch.profiler``:
    wall time, finds, and the device's busy time by kernel name.  Only
    device activity is traced: host-op events of a whole pass take the
    profiler minutes to summarize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.frontier import device_pass
    from repro_torch.core.partition import PartitionState

    perm = np.random.default_rng(3).permutation(hg.n)

    def one_pass():
        st = PartitionState(hg, P, masks=m0.copy())
        dev = device_pass(st, cap, backend="torch", device="cuda")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev.fm_pass(perm)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, vars_of(dev)
        finally:
            dev.detach()

    wall, counts = one_pass()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_prof, counts_prof = one_pass()
    if counts_prof != counts:
        raise AssertionError("profiled pass took other decisions")
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    ms_find = 1e3 * wall / max(counts["finds"], 1)
    log(f"[3b] one device FM pass, n={hg.n}: {wall:.3f} s "
        f"({wall_prof:.3f} s profiled), {counts}; "
        f"host ms per find {ms_find:.4f}")
    out = {"pass_s": sig(wall), "finds": counts["finds"],
           "syncs": counts["syncs"], "ms_per_find": sig(ms_find)}
    if busy == 0:
        log("[3b] device busy time: not measured (no device events)")
        return out | {"busy_s": "not measured"}
    # every device -> host copy is a blocking read the pass must count
    reads = sum(e.count for e in kern if e.key.startswith("Memcpy DtoH"))
    if reads != counts["syncs"]:
        raise AssertionError(f"{reads} device->host copies, but the pass "
                             f"counted {counts['syncs']} syncs")
    log(f"[3b] device busy {busy:.4f} s = {busy / wall:.4f} of the "
        f"unprofiled pass; {reads} device->host reads; by kernel (name: "
        f"count, ms): " + "; ".join(
            f"{e.key[:60]}: {e.count}, {e.self_device_time_total / 1e3:.3f}"
            for e in top))
    return out | {"busy_s": sig(busy), "busy_share": sig(busy / wall)}


def check_result(hg, P, eps, res) -> None:
    """Valid, balanced masks whose recomputed cost is the reported one."""
    from repro_torch.core.partition.cost import is_valid, partition_cost
    if not is_valid(hg, res.masks, P, eps):
        raise AssertionError("invalid or unbalanced partition")
    cost = partition_cost(hg, res.masks, P)
    if not (np.isfinite(res.cost) and cost == res.cost):
        raise AssertionError(f"reported cost {res.cost} != recomputed {cost}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.partition.cost import capacity
    from repro_torch.core.partition.heuristic import (
        fm_refine, greedy_initial, partition_with_replication,
        replicate_local_search)
    from repro_torch.datagen import large_row_net, moe_dataset
    from repro_torch.kernels import _build, front_pass, ops

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    _build.load("gain")
    build_s = time.perf_counter() - t0
    log(f"[1] built and loaded {_build._lib_path('gain').name} in "
        f"{build_s:.2f} s")
    summary: dict = {"build_s": sig(build_s)}
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -------------------------------------------- 2. kernels vs plain
    # front_dlam sees chunks of 1, 2, 4, ... row blocks (R_blk rows each);
    # min_cover_lambdas sees per-front chunks of up to _CHUNK_ELEMS / 2^P
    # rows, and the device pass's applies one row per incident edge.
    timed: dict = {}
    hg8 = large_row_net(8192, seed=8192)
    P = 8
    dmax = int(np.diff(hg8.xinc).max())
    r_blk = max(front_pass._R_BLK_MIN, front_pass._pow2(P * dmax))
    shapes = [("front_dlam", r_blk * k, p) for p in (4, 8)
              for k in (1, 8, 64)]
    shapes += [("min_cover_lambdas", r, p) for p in (4, 8)
               for r in (dmax, 4096, 15625, r_blk * 64)]
    log(f"[2] kernels vs plain versions (R_blk = {r_blk} at P = 8)")
    for i, (kernel, R, p) in enumerate(shapes):
        row = check_kernel(kernel, R, p, seed=i)
        timed[(kernel, R, 1 << p)] = row
        log("    " + json.dumps(row))

    rec = Recorder()

    # ------------------------------------ 3. device pass vs host path
    eps = 0.05
    cap = capacity(hg8, P, eps) + 1e-9
    m0 = greedy_initial(hg8, P, eps, np.random.default_rng(0))
    out = {}
    for frontier in ("torch", "numpy"):
        rec.reset()
        t0 = time.perf_counter()
        masks = fm_refine(hg8, m0.copy(), P, eps, np.random.default_rng(1),
                          frontier=frontier, device="cuda")
        fm_passes = list(rec.passes)
        rep = replicate_local_search(hg8, masks.copy(), P, eps, seed=2,
                                     frontier=frontier, device="cuda")
        torch.cuda.synchronize()
        out[frontier] = (masks, rep, time.perf_counter() - t0,
                         dict(ops.launches), fm_passes, list(rec.passes))
    (mt, rt, st_, lt, fmp, allp), (mn, rn, sn, _, _, _) = \
        out["torch"], out["numpy"]
    if not (np.array_equal(mt, mn) and np.array_equal(rt.masks, rn.masks)
            and rt.cost == rn.cost):
        raise AssertionError("device pass differs from the host path")
    if len(fmp) != 1 or len(allp) != 2:
        raise AssertionError(f"device pass did not attach: {len(allp)}")
    check_bounds(fmp, fused=True)
    check_bounds(allp, fused=False)
    if lt["front_dlam"] == 0:
        raise AssertionError("front_dlam never launched in phase 3")
    check_result(hg8, P, eps, rn)
    log(f"[3] large_row_net(8192) P=8: fm+rep cost {rt.cost} equal on "
        f"cuda ({st_:.2f} s) and numpy ({sn:.2f} s); launches {lt}; "
        f"fm {vars_of(fmp[0])}; rep {vars_of(allp[1])}")
    summary["p3"] = {"cuda_s": sig(st_), "numpy_s": sig(sn), "cost": rt.cost}
    summary["p3b"] = where_time_goes(hg8, P, cap, m0)

    # --------------------------------------------- 4. per-front path (MoE)
    hgm = moe_dataset("moe8", n_layers=1, kappa0=50_000, n_experts=128)[0]
    log(f"[4] moe8 layer 0: n={hgm.n} experts, {len(hgm.edges)} edges, "
        f"{len(hgm.pins)} pins, integer mu: "
        f"{bool(np.all(hgm.mu == np.rint(hgm.mu)))}")
    rec.reset()
    rec.shapes.clear()
    t0 = time.perf_counter()
    bm_t, rm_t = partition_with_replication(hgm, P, eps, frontier="torch",
                                            device="cuda")
    torch.cuda.synchronize()
    s4 = time.perf_counter() - t0
    l4 = dict(ops.launches)
    if rec.passes:
        raise AssertionError("float-mu instance attached the device pass")
    t0 = time.perf_counter()
    bm_n, rm_n = partition_with_replication(hgm, P, eps, frontier="numpy")
    s4n = time.perf_counter() - t0
    if not (np.array_equal(bm_t.masks, bm_n.masks) and bm_t.cost == bm_n.cost
            and np.array_equal(rm_t.masks, rm_n.masks)
            and rm_t.cost == rm_n.cost):
        raise AssertionError("per-front path differs from the host path")
    if l4["min_cover_lambdas"] == 0:
        raise AssertionError("min_cover_lambdas never launched in phase 4")
    check_result(hgm, P, eps, rm_t)
    shapes4 = Counter(rec.shapes)
    max_rows = max(r for (_, r, _) in shapes4)
    log(f"[4] cost {bm_t.cost} -> {rm_t.cost} (replicated), equal on cuda "
        f"({s4:.2f} s) and numpy ({s4n:.2f} s); launches {l4}; "
        f"front rows: max {max_rows}")
    summary["p4"] = {"cuda_s": sig(s4), "numpy_s": sig(s4n),
                     "base": bm_t.cost, "rep": rm_t.cost, "max_rows": max_rows}

    # --------------------------------------------------- 5. full size
    n5 = 32768
    hg5 = large_row_net(n5, seed=n5)
    rec.reset()
    rec.shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b5, r5 = partition_with_replication(hg5, P, eps, frontier="torch",
                                        device="cuda")
    torch.cuda.synchronize()
    s5 = time.perf_counter() - t0
    l5 = dict(ops.launches)
    c5 = rec.counters()
    peak = torch.cuda.max_memory_allocated()
    shapes5 = Counter(rec.shapes)
    check_result(hg5, P, eps, b5)
    check_result(hg5, P, eps, r5)
    check_bounds(rec.passes, fused=False)
    if not r5.cost <= b5.cost:
        raise AssertionError("replication made the cost worse")
    if l5["front_dlam"] == 0:
        raise AssertionError("front_dlam never launched in phase 5")
    log(f"[5] large_row_net({n5}) P=8: {s5:.2f} s, base cost {b5.cost}, "
        f"replicated cost {r5.cost}, device passes {len(rec.passes)}, "
        f"{c5}, syncs/commit {c5['syncs'] / max(c5['commits'], 1):.3f}, "
        f"launches {l5}, max_memory_allocated {peak} B")
    summary["p5"] = {"n": n5, "s": sig(s5), "base": b5.cost, "rep": r5.cost,
                     **c5, "syncs_per_commit": sig(c5["syncs"] / max(
                         c5["commits"], 1)), "peak_B": peak}

    # ----------------------------------------------------- kernel line
    launches = {k: l4[k] + l5[k] for k in l4}
    shapes_all = shapes4 + shapes5
    log(f"launch shapes (counter, R, M): count, phases 4+5: "
        f"{dict(shapes_all.most_common(12))}")
    kernels = []
    for name, kernel in KERNEL_OF.items():
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        # time each count's kernel at its most frequent shape on the path
        (_, R, M), _ = max(((s, c) for s, c in shapes_all.items()
                            if s[0] == name), key=lambda sc: sc[1])
        row = timed.get((kernel, R, M))
        if row is None:
            row = check_kernel(kernel, R, M.bit_length() - 1, seed=99)
            timed[(kernel, R, M)] = row
            log("    " + json.dumps(row))
        errs = [r["max_abs_err"] for (k, _, _), r in timed.items()
                if k == kernel]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": [R, M], "call_ms": row["call_ms"]})
    # the largest shape of phase 2, per kernel: the kernel against its bound
    # where launch latency no longer hides it
    summary["p2_largest"] = {
        k: [R, M, sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"])]
        for (k, R, M), r in timed.items() if R == r_blk * 64 and M == 256}
    compact = (",", ":")
    log("summary " + json.dumps(summary, separators=compact))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}, separators=compact))
    log("kernels: " + ", ".join(dict.fromkeys(KERNEL_OF.values())))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
