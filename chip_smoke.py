#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and drives its paths through them: replicated hypergraph
partitioning (``partition_with_replication``, flat and as a multilevel
V-cycle), serving ``hymba-1.5b`` and serving ``olmoe-1b-7b`` with
replicated expert placement (``launch.serve.serve``), and BSP scheduling
with replication, whose window pricers run as int32 PyTorch programs on
the card (``kernels.front_pass.DeviceScheduleWindows``).  Phases, in order; any failure
propagates and the exit code is nonzero:

1. build the kernels, one ``nvcc`` per source, all started together;
   print the build time, what ``ptxas`` reports for the find, attention,
   grouped-matmul and scan kernels (registers, shared memory, spills) and
   the card's name, power limit, maximum SM clock and SM count;
2. hold each kernel against its plain PyTorch version on the card and
   time both: the min-cover kernel at the shapes the per-front path gives
   it, and the device pass's fused find (``front_find``) at phase 3's
   block shape -- 1, 8 and 64 active blocks, P 4 and 8, FM and
   replication, one queued move to apply, with the pass's feasibility and
   with none (a scan of every block) -- both exactly equal (the triple and
   the buffers after the apply), the find timed beside its bound and an
   empty cooperative launch on its grid (the latency floor); attention and the selective scan at hymba's
   and olmoe's serving shapes and the grouped matmul at olmoe's, in bf16
   and in f32 (tolerances at ``MODEL_TOL``), with TF32 off for the f32
   products of the plain versions.  The scan's bound is the larger of its
   bytes and its arithmetic at the card's maximum SM clock (phase 1
   prints it): the recurrence's FMA-pipe instructions and one exp2 per
   (t, d, n), the exps split between the special-function unit and an
   emulation on the FMA pipe so that both pipes finish together
   (``scan_bound``); the decode step is timed beside an empty launch on
   its grid.  Each attention row names its route
   (``flash_attention.route``: ``prefill_tc``, ``decode_split`` or
   ``cuda_core``) and asserts that the call took it, as each grouped-matmul
   row does with ``moe_gmm.route`` (``gmm_tc``, ``gmv``, ``cuda_core``).
   The grouped matmul also runs fill-aware: slot fills from a seeded
   uniform top-8 routing (4 x 2048 tokens for prefill, 4 for decode), rows
   past each fill exact zeros, the bound counted over the live rows and
   slots, ``torch.bmm`` timed on the full buffers;
3. the device-resident pass on ``large_row_net(8192)``, P = 8:
   ``fm_refine`` then ``replicate_local_search`` on CUDA against the host
   (numpy) path -- equal masks and cost, counter bounds, one find launch
   and one read per find; then one FM pass timed plain and under
   ``torch.profiler`` (where the time goes: one device->host read per
   find, no PyTorch index, gather or scatter kernel);
4. the per-front path on an MoE expert-placement instance (float weights,
   128 experts): ``partition_with_replication`` on CUDA against numpy;
5. full size: ``partition_with_replication(large_row_net(32768))``, P = 8,
   on CUDA, with its time, costs, counters (one find launch and one read
   per find), the queue and active blocks per find and peak device memory;
6. serve ``hymba-1.5b`` at full width and depth: 4 prompts of 2048
   tokens, 32 new tokens each, in bf16; prefill seconds, decode ms per
   token, tokens/s, peak memory, launches per counter (each of the four
   model kernels must launch) and per attention route (bf16 serving runs
   ``prefill_tc`` and ``decode_split`` only), and the scan's share of the
   prefill.  Then prefill and three teacher-forced decode steps (seeded
   tokens, the same in every run): of the f32 model through the kernels
   (prefill on ``cuda_core``, decode on ``decode_split``) and through the
   plain versions (``ops.force("ref")``), within ``F32_LOGIT_TOL`` of the
   largest logit; of the bf16 model through both; and of the bf16 model's
   weights, cast to f32, through the plain versions, from which each bf16
   path's distance is reported (weight rounding left out);
7. serve ``olmoe-1b-7b`` at full width and depth with
   ``placement="replicated"`` (4 prompts of 2048 tokens, 32 new tokens
   each, bf16): the placement's lambda-costs and min-cover launches,
   prefill seconds, decode ms per token, tokens/s, peak memory, launches
   per counter (exactly as expected: three grouped products per MoE layer
   and call, prefill on ``gmm_tc`` and decode on ``gmv``, never
   ``cuda_core``) and one device->host copy per profiled decode step.  Then
   the f32 model: each layer's MoE block on the same input through the
   kernel and the plain version within ``MODEL_TOL`` (the routing is then
   identical, so this isolates the kernel), and prefill plus three
   teacher-forced decode steps within ``F32_LOGIT_TOL`` (if a router
   near-tie breaks that, the run counts the top-k choices on which the
   two paths' route traces differ and reports them with the gap); the
   bf16 paths' distances from the f32 plain path at the bf16 weights as
   in phase 6.
   Last, the serving benchmark's SMOKE drift replay through the online
   controller on CUDA and on the host path: equal totals, commits and
   migration bytes;
8. the V-cycle: ``partition_with_replication(large_row_net(16384),
   multilevel=True, workers=None)``, P = 8, with ``frontier="torch"`` on
   CUDA and ``frontier="numpy"``: equal base and replicated masks and
   costs; per level on the card (levels of at least ``DEVICE_MIN_NODES``
   nodes) commits, finds, reads and find launches, reads = finds =
   launches, each pass released; ``min_cover_lambdas`` launched on the
   coarse levels; the level sizes, both times and peak device memory.
   Then heavy-pin matching on a 2-worker pool forked after CUDA is up:
   byte-identical to serial, the pool not failed;
9. scheduling with replication: on ``sptrsv_dag(6000, band=48)`` and
   ``psdd_dag(500 leaves, depth 16)`` at P = 8, g = 4, L = 20,
   ``hill_climb`` of the list schedule with ``backend="torch"`` on CUDA
   and ``backend="numpy"``, then ``advanced_heuristic``: equal
   assignments, comms and costs, and the replicated cost against the
   baseline; then ``multilevel_schedule(large_sptrsv_dag(16384))`` on
   both backends, equal, with window reads on the card (the engine-scale
   hill climbs price no window long enough for the device).  The window
   programs are then timed on the V-cycle's schedule: the host's time
   per priced window, and under ``torch.profiler`` the kernels one
   launches and their device time.

Launch counts are reset just before each driven run (phases 3-8) and read
just after; the kernel line reports those of phases 4 and 5 (the flat
``partition_with_replication`` runs) for the gain kernels, with phase 8's
beside them (``vcycle_launches``), and those of the
serve runs of phases 6 and 7, summed, for the model kernels.  The
attention kernels count ``flash_attention`` (no window, no positions: the
Pallas kernel's role) apart from ``attention_masked``, and the line has
one entry per (count, route) the serve runs took, plus one for the
``cuda_core`` route with the launches of phase 6's f32 kernel path (the
bf16 runs never take it); the grouped matmul likewise has one entry per
route of the serve runs (``gmm_tc``, ``gmv``) timed at its fill-aware
case, and one for ``cuda_core`` with the launches of phase 7's f32
checks; the scan ``mamba_scan`` (from zeros) apart from ``mamba_step``
(decode, from a state), each with its bound's terms
(``bound_terms_ms``, the exps' share on the special-function unit
``exp_sfu_share``) and the step with an empty launch's time
(``empty_ms``); each count is timed at its commonest shape on the path.
``min_cover_lambdas`` (the per-front path) is timed at its
commonest shape; ``front_find`` (the device pass's finds, which also take
the min-cover kernel's apply role: ``also_replaces``) at phase 2's P = 8
FM case nearest the path's median count of active blocks, with
``path_ms``, its device time per launch in phase 3b's profile.  A
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit non-tensor rate (data sheet, fp32)
OPS_PER_ELEM = 3               # compare, select, min per loaded element

BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core rate (data sheet)
F32_FLOPS_PER_S = 67e12        # fp32 rate outside the tensor cores
# issue rates per clock per SM (CUDA C Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): f32 add/multiply/FMA on
# the FMA pipe, and exp2 (MUFU.EX2) on the special-function unit
FMA_PER_CLK_PER_SM = 128
EXP_PER_CLK_PER_SM = 16
SCAN_FMA_PER_ELEM = 4          # per (t, d, n): dt * A, (dt * u) * B, the
                               # state's FMA and y's FMA
EXP_EMULATED_FMA = 10          # FMA-pipe instructions of one exp2 off the
                               # special-function unit: 3 to split y into
                               # j + f (add and subtract 1.5 * 2^23, f =
                               # y - j), 6 Horner FMAs of a degree-6
                               # polynomial for 2^f on [-1/2, 1/2] (f32
                               # accuracy), 1 IMAD adding j << 23 into its
                               # exponent

# file:line of the Pallas kernel each CUDA kernel replaces; the fused find
# also takes the min-cover kernel's apply role (FIND_ALSO_REPLACES)
REPLACES = {
    "front_find": "src/repro/kernels/gain.py:78",
    "min_cover_lambdas": "src/repro/kernels/gain.py:53",
    "flash_attention": "src/repro/kernels/flash_attention.py:25",
    "attention_masked": "src/repro/kernels/flash_attention.py:25",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:24",
    "mamba_step": "src/repro/kernels/mamba_scan.py:24",
    "grouped_matmul": "src/repro/kernels/moe_gmm.py:23",
}
# launch counter -> the kernel it counts
FIND_ALSO_REPLACES = "src/repro/kernels/gain.py:53"
KERNEL_OF = {"front_find": "front_find",
             "min_cover_lambdas": "min_cover_lambdas",
             "flash_attention": "flash_attention",
             "attention_masked": "flash_attention",
             "mamba_scan": "mamba_scan",
             "mamba_step": "mamba_scan",
             "grouped_matmul": "grouped_matmul"}
# kernel -> its source, the name of its library in _build
SOURCES = {"front_find": "front_find", "min_cover_lambdas": "gain",
           "flash_attention": "flash_attention", "mamba_scan": "mamba_scan",
           "grouped_matmul": "moe_gmm"}
# grouped-matmul route -> its source; the routes of the bf16 serve runs
GMM_SOURCES = {"gmm_tc": "moe_gmm_tc", "gmv": "moe_gmm",
               "cuda_core": "moe_gmm"}
GMM_PATH = ("gmm_tc", "gmv")
# attention route -> its source
ATTN_SOURCES = {"prefill_tc": "attention_prefill_tc",
                "decode_split": "attention_decode",
                "cuda_core": "flash_attention"}
# the (count, route) pairs of the bf16 serving runs, each a kernel-line entry
ATTN_PATH = (("flash_attention", "prefill_tc"),
             ("attention_masked", "prefill_tc"),
             ("attention_masked", "decode_split"))
MODEL_COUNTERS = ("flash_attention", "attention_masked", "mamba_scan",
                  "mamba_step", "grouped_matmul")
# kernel vs plain version: tests/test_kernels.py's bounds, f32 relaxed from
# 2e-6 to 1e-5 for the summation order on the card
MODEL_TOL = {("attn", "float32"): 1e-5, ("attn", "bfloat16"): 2e-2,
             ("scan", "float32"): 1e-5, ("scan", "bfloat16"): 3e-2,
             ("gmm", "float32"): 1e-5, ("gmm", "bfloat16"): 3e-2}
# phase 6: the f32 kernel path against the f32 plain path, as a share of
# the largest |logit|
F32_LOGIT_TOL = 1e-3


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


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = out.stdout.strip().splitlines()[0].split()[0]
    return float(mhz) * 1e6


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
    nbytes = 4 * (R * M + M + R)
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
    return rows, pc


def check_kernel(kernel: str, R: int, P: int, seed: int) -> dict:
    """Kernel against plain version at (R, 2^P): exact, then timed."""
    import torch
    from repro_torch.kernels import gain, ref
    rows, pc = kernel_inputs(R, P, seed)

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


def find_pass(hg, P: int, rep: bool, masks: np.ndarray, cap: float,
              seed: int):
    """A device pass on the card over ``hg`` from ``masks`` (for replication
    with a second replica on every tenth node), its blocks cut for a
    seeded visit order."""
    from repro_torch.core.partition import PartitionState
    from repro_torch.kernels import front_pass
    rng = np.random.default_rng(seed)
    masks = masks.copy()
    if rep:
        extra = rng.random(hg.n) < 0.1
        masks[extra] |= 1 << rng.integers(0, P, size=int(extra.sum()))
    st = PartitionState(hg, P, masks=masks)
    dev = front_pass.attach(st, cap, device="cuda")
    if dev is None:
        raise AssertionError("the device pass did not attach")
    dev._build_blocks(rng.permutation(hg.n))
    return dev


def find_bound(dev, blocks, pos: int, queue) -> tuple[float, str, dict]:
    """Least time for one find from position 0: the bytes of every (node,
    edge) uncov row the scan must price -- the positions of ``blocks`` up
    to the event ``pos`` (all of them when there is none) -- with each
    row's mu and lambda and the nodes' index, mask and feasibility entries,
    plus the applied rows (read and written) and the work list, over the
    memory rate; the masked-min operations (``OPS_PER_ELEM`` per column and
    candidate) over the 32-bit rate.  The larger wins."""
    P, M = dev.P, dev.nsub
    poss = np.concatenate([np.arange(dev._bounds[b], dev._bounds[b + 1])
                           for b in blocks]) if len(blocks) else np.zeros(0)
    poss = poss[poss <= pos].astype(np.int64)
    rows = int(dev.deg[dev._perm[poss]].sum())
    nodes = len(poss)
    applied = sum(int(dev.deg[v]) for v, old, new in queue if old != new)
    nbytes = (rows * (4 * M + 12) + nodes * (16 + P)
              + applied * (8 * M + 8) + 4 * (3 * len(queue) + 2 * len(blocks)
                                              + 1) + 12)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEM * rows * M * P / INT32_OPS_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound + ({"rows": rows, "nodes": nodes, "bytes": nbytes},)


def check_find(dev, rep: bool, k: int, full_scan: bool, seed: int) -> dict:
    """The fused find against its plain version on the pass's buffers: the
    first ``k`` blocks active, one queued move (node v to another
    processor, or a replica added), with the pass's feasibility or, for
    ``full_scan``, none (no move fits, so FM scans every block).  Exact
    equality of the triple and of uncov, lambdas and masks after the apply;
    then both timed on alternating queues (the move, then its reversal), the
    kernel as pure launches of pre-uploaded work lists in a CUDA graph, and
    one eager call through the wrapper."""
    import torch
    from repro_torch.kernels import front_find as ff
    rng = np.random.default_rng(seed)
    P, n = dev.P, dev.n
    blocks = np.arange(min(k, dev._nb))
    x = dev._inputs()
    if full_scan:
        x.fits = torch.zeros_like(x.fits)
    v = int(dev._perm[int(rng.integers(0, n))])
    old = int(dev.state.masks[v])
    unset = [q for q in range(P) if not (old >> q) & 1]
    if rep:        # a replica added (or, on a full mask, one dropped)
        new = old | (1 << unset[0]) if unset else old & (old - 1)
    else:          # moved to the next processor
        new = 1 << (old.bit_length() % P)
    fwd, back = [(v, old, new)], [(v, new, old)]
    kw = dict(rep=rep, start_pos=0, resume_p=-1, maxrep=P + 1)

    def clone(t):
        return ff.FindInputs(**{**t.__dict__, "uncov": t.uncov.clone(),
                                "lam": t.lam.clone(), "masks": t.masks.clone()})
    xk, xr = clone(x), clone(x)
    got = ff.front_find(xk, fwd, blocks, **kw)
    want = ff.front_find_ref(xr, fwd, blocks, **kw)
    torch.cuda.synchronize()
    same = got.tolist() == want.tolist() and all(
        torch.equal(getattr(xk, f), getattr(xr, f))
        for f in ("uncov", "lam", "masks"))
    err = max(int((getattr(xk, f).long() - getattr(xr, f).long()).abs().max())
              for f in ("uncov", "lam", "masks"))
    err = max(err, max(abs(a - b) for a, b in zip(got.tolist(),
                                                  want.tolist())))
    if not same:
        raise AssertionError(f"front_find P={P} rep={rep} k={k}: kernel "
                             f"{got.tolist()} != plain {want.tolist()} "
                             f"(max abs err {err})")
    pos = got.tolist()[0]
    # timing: the buffers go back and forth between the two states
    work = [ff.upload_work(ff.pack_work(q, blocks, x.bounds_host),
                           x.uncov.device).clone() for q in (fwd, back)]

    def pair():
        for w in work:
            ff.launch(xk, w, 1, len(blocks), **kw)

    def call_pair():
        for q in (fwd, back):
            ff.front_find(xk, q, blocks, **kw)

    def plain_pair():
        for q in (fwd, back):
            ff.front_find_ref(xr, q, blocks, **kw)
    ms = graph_ms(pair, launches=10) / 2
    grid = ff.find_grid(P, rep, xk.uncov.device)
    empty_ms = graph_ms(lambda: ff.empty_launch(grid, ff.THREADS,
                                                xk.uncov.device, True),
                        launches=10)
    b, by, work_of = find_bound(dev, blocks, pos, fwd)
    return {"kernel": "front_find", "P": P, "rep": rep, "blocks": len(blocks),
            "full_scan": full_scan, "triple": got.tolist(), **work_of,
            "max_abs_err": err, "ms": ms, "empty_ms": empty_ms,
            "plain_ms": time_ms(plain_pair, iters=5) / 2, "bound_ms": b,
            "bound_by": by, "call_ms": time_ms(call_pair) / 2}


def rel_ok(got, want, tol: float) -> tuple[bool, float]:
    """``|got - want| <= tol + tol * |want|`` everywhere (the rule of
    ``assert_allclose`` with rtol = atol = tol), and the max abs error."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return ok, float(diff.max())


# (name, counter, B, Sq, Sk, H, KV, hd, hd_v, causal, window, positions,
# on the path): hymba's prefill (global and window 1024) and decode
# (linear cache of 2080 at position 2060, full ring of 1024), a ring whose
# left slots are still padding, a non-causal shape, and MLA's 192/128 dims
ATTN_CASES = [
    ("prefill", "flash_attention", 4, 2048, 2048, 25, 5, 64, 64, True, 0,
     None, True),
    ("prefill_window", "attention_masked", 4, 2048, 2048, 25, 5, 64, 64,
     True, 1024, None, True),
    ("decode_global", "attention_masked", 4, 1, 2080, 25, 5, 64, 64, True,
     0, "linear", True),
    ("decode_window", "attention_masked", 4, 1, 1024, 25, 5, 64, 64, True,
     0, "ring", True),
    ("decode_ring_pads", "attention_masked", 4, 1, 1024, 25, 5, 64, 64,
     True, 0, "ring_pads", False),
    ("noncausal", "flash_attention", 2, 1024, 1024, 25, 5, 64, 64, False, 0,
     None, False),
    ("hd192_v128", "flash_attention", 1, 1024, 1024, 16, 16, 192, 128, True,
     0, None, False),
    # olmoe: prefill, and decode on a linear cache of 2048 + 32
    ("olmoe_prefill", "flash_attention", 4, 2048, 2048, 16, 16, 128, 128,
     True, 0, None, True),
    ("olmoe_decode", "attention_masked", 4, 1, 2080, 16, 16, 128, 128, True,
     0, "linear", True),
]
# (name, counter, B, S, di, N, with a state, on the path)
SCAN_CASES = [
    ("prefill", "mamba_scan", 4, 2048, 3200, 16, False, True),
    ("decode", "mamba_step", 4, 1, 3200, 16, True, True),
]
# (name, G, C, D, F, on the path, routed tokens): olmoe's expert
# products, 64 slots -- gate/up (D 2048 -> F 1024) and down (1024 ->
# 2048) -- at decode (C = 1) and prefill (C = 2560), and one odd shape;
# the ``_fill`` cases hand the kernel the slot fills of that many tokens
# routed top-8 uniformly at random (None: every row live)
GMM_CASES = [
    ("decode_gate_up", 64, 1, 2048, 1024, True, None),
    ("decode_down", 64, 1, 1024, 2048, True, None),
    ("prefill_gate_up", 64, 2560, 2048, 1024, True, None),
    ("prefill_down", 64, 2560, 1024, 2048, True, None),
    ("odd", 8, 37, 96, 80, False, None),
    ("prefill_gate_up_fill", 64, 2560, 2048, 1024, True, 4 * 2048),
    ("prefill_down_fill", 64, 2560, 1024, 2048, True, 4 * 2048),
    ("decode_fill", 64, 1, 2048, 1024, True, 4),
]
GMM_TOP_K = 8


def attn_key(q, k, v, window: int) -> tuple:
    return (tuple(q.shape), tuple(k.shape), v.shape[-1], window)


def check_attention(case, dtype_name: str, seed: int) -> dict:
    """The attention kernel of the case's route against the plain version;
    timed with the plain version and SDPA (``library_ms``) where on the
    path."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    (name, counter, B, Sq, Sk, H, KV, hd, hdv, causal, window, pos,
     on_path) = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KV, hdv), generator=g, device=dev).to(dtype)
    qp = kp = None
    if pos is not None:
        at = {"linear": 2060, "ring": 2060, "ring_pads": 700}[pos]
        qp = torch.full((B, Sq), at, dtype=torch.int32, device=dev)
        first = 0 if pos == "linear" else at - Sk + 1
        kp = torch.arange(first, first + Sk, dtype=torch.int32,
                          device=dev).expand(B, Sk).contiguous()
    kw = dict(causal=causal, window=window, q_pos=qp, k_pos=kp)

    def run():
        return ops.attention(q, k, v, **kw)

    def plain():
        return ref.attention_ref(q, k, v, **kw)
    route = fa.route(dtype, B, Sq, Sk, H, KV, hd, hdv, window,
                     pos is not None)
    ops.reset_launches()
    got, want = run(), plain()
    torch.cuda.synchronize()
    taken = {r: c for r, c in ops.route_launches.items() if c}
    if taken != {route: 1}:
        raise AssertionError(f"attention {name} {dtype_name}: routes "
                             f"{taken}, expected {route}")
    tol = MODEL_TOL[("attn", dtype_name)]
    ok, err = rel_ok(got, want, tol)
    if not ok:
        raise AssertionError(f"attention {name} {dtype_name}: kernel != "
                             f"plain within {tol} (max abs err {err})")
    # the bound: the pairs the mask leaves, 2 (hd + hd_v) FLOPs per pair
    # and q head; q, k, v (and positions) read once, o written once
    qpos = qp if qp is not None else torch.arange(
        Sq, device=dev).expand(B, Sq)
    kpos = kp if kp is not None else torch.arange(
        Sk, device=dev).expand(B, Sk)
    keep = (kpos[:, None, :] >= 0).expand(B, Sq, Sk)
    if causal:
        keep = keep & (qpos[:, :, None] >= kpos[:, None, :])
    if window:
        keep = keep & (qpos[:, :, None] - kpos[:, None, :] < window)
    pairs = int(keep.sum())
    flops = 2 * H * pairs * (hd + hdv)
    nbytes = got.element_size() * (q.numel() + k.numel() + v.numel()
                                   + got.numel())
    if qp is not None:
        nbytes += 4 * (qp.numel() + kp.numel())
    rate = BF16_FLOPS_PER_S if dtype_name == "bfloat16" else F32_FLOPS_PER_S
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    row = {"case": name, "counter": counter, "route": route,
           "dtype": dtype_name,
           "shape": [B, Sq, Sk, H, KV, hd, hdv], "window": window,
           "key": attn_key(q, k, v, window),
           "max_abs_err": err, "tol": tol, "ms": graph_ms(run, 10, 5),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    if on_path:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None if (pos is None and not window) else keep[:, None]

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
        row.update(call_ms=time_ms(run, 10), plain_ms=graph_ms(plain, 2, 2),
                   library_ms=graph_ms(library, 10, 5))
    return row


def scan_bound(B: int, S: int, di: int, N: int, esize: int, state: bool,
               clock_hz: float, sms: int) -> dict:
    """Least time for a scan: the larger of its bytes (u, dt and y once, Bc
    and Cc once, A, D and the states once) over the memory rate and its
    arithmetic on ``sms`` SMs at ``clock_hz``.  The arithmetic is
    ``SCAN_FMA_PER_ELEM`` FMA-pipe instructions and one exp2 per (t, d, n),
    a share x of the exps on the special-function unit and the rest
    emulated on the FMA pipe (``EXP_EMULATED_FMA`` each), x chosen so that
    the two pipes finish together.  ``bound_terms_ms`` also holds the FMA
    pipe's time without exps (a lower floor) and the exps' time all on the
    unit (not a floor: some of them can move)."""
    nbytes = (esize * (3 * B * S * di + 2 * B * S * N)
              + 4 * (di * N + di + B * di * N * (2 if state else 1)))
    exps = B * S * di * N
    per_s = sms * clock_hz
    sfu = exps / (EXP_PER_CLK_PER_SM * per_s)
    fma = SCAN_FMA_PER_ELEM * exps / (FMA_PER_CLK_PER_SM * per_s)
    emul = EXP_EMULATED_FMA * exps / (FMA_PER_CLK_PER_SM * per_s)
    share = min(1.0, (fma + emul) / (sfu + emul))   # sfu*x = fma + emul(1-x)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fma_pipe": fma * 1e3, "exps_sfu": sfu * 1e3,
             "arithmetic": max(fma, share * sfu) * 1e3}
    by = "bytes" if terms["bytes"] >= terms["arithmetic"] else "operations"
    return {"bound_ms": max(terms["bytes"], terms["arithmetic"]),
            "bound_by": by, "bound_terms_ms": terms,
            "exp_sfu_share": share, "bytes": nbytes, "exps": exps}


def check_scan(case, dtype_name: str, seed: int, clock_hz: float,
               sms: int) -> dict:
    """The scan kernel against its plain version at one shape, timed; the
    decode step (S = 1) also beside an empty launch on its grid."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import front_find as ff
    from repro_torch.kernels import ops, ref
    name, counter, B, S, di, N, state, on_path = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    u = rnd(B, S, di).to(dtype)
    dt = F.softplus(rnd(B, S, di)).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(di, N).contiguous()
    Bc, Cc = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype)
    D = rnd(di)
    h0 = rnd(B, di, N) if state else None

    def run():
        return ops.mamba_scan(u, dt, A, Bc, Cc, D, init_state=h0)

    def plain():
        return ref.mamba_scan_ref(u, dt, A, Bc, Cc, D, init_state=h0)
    ops.reset_launches()
    (y, last), (y_ref, last_ref) = run(), plain()
    torch.cuda.synchronize()
    taken = {c: n for c, n in ops.launches.items() if n}
    if taken != {counter: 1}:
        raise AssertionError(f"scan {name} {dtype_name}: launches {taken}, "
                             f"expected {counter}")
    tol = MODEL_TOL[("scan", dtype_name)]
    ok_y, err_y = rel_ok(y, y_ref, tol)
    ok_h, err_h = rel_ok(last, last_ref, tol)
    if not (ok_y and ok_h):
        raise AssertionError(f"scan {name} {dtype_name}: kernel != plain "
                             f"within {tol} (max abs err y {err_y}, "
                             f"state {err_h})")
    row = {"case": name, "counter": counter, "dtype": dtype_name,
           "shape": [B, S, di, N], "key": ((B, S, di), N),
           "max_abs_err": max(err_y, err_h),
           "tol": tol, "ms": graph_ms(run, 10, 5),
           **scan_bound(B, S, di, N, u.element_size(), state, clock_hz,
                        sms)}
    if S == 1:     # the step kernel's grid: N / min(N, 4) lanes a channel
        lanes = B * di * (N // min(N, 4))
        row["empty_ms"] = graph_ms(
            lambda: ff.empty_launch(-(-lanes // 256), 256, dev), 10, 5)
    if on_path:
        row.update(call_ms=time_ms(run, 10), plain_ms=graph_ms(plain, 1, 2),
                   library_ms=None)
    return row


def uniform_fills(G: int, C: int, tokens: int, seed: int):
    """(G,) int32 slot fills of ``tokens`` tokens that each pick
    ``GMM_TOP_K`` distinct slots uniformly at random (a seeded router),
    each fill clamped to the capacity ``C`` as the dispatch does."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.rand((tokens, G), generator=g, device=dev).topk(
        GMM_TOP_K, dim=1).indices.reshape(-1)
    counts = torch.zeros(G, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts.clamp(max=C).to(torch.int32)


def check_gmm(case, dtype_name: str, seed: int) -> dict:
    """The grouped-matmul kernel of the case's route against its plain
    version at one shape, with the case's fills (rows past a fill exact
    zeros); timed with the plain version and ``torch.bmm`` on the full
    buffers (``library_ms``) where on the path."""
    import torch
    from repro_torch.kernels import moe_gmm, ops, ref
    name, G, C, D, F, on_path, tokens = case
    dtype = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((G * C, D), generator=g, device=dev).to(dtype)
    w = (torch.randn((G, D, F), generator=g, device=dev)
         * D ** -0.5).to(dtype)
    fills = None if tokens is None else uniform_fills(G, C, tokens, seed)

    def run():
        return ops.grouped_matmul_aligned(x, w, C, fills)

    def plain():
        return ref.grouped_matmul_aligned_ref(x, w, C, fills)
    route = moe_gmm.route(dtype, C, D, F)
    ops.reset_launches()
    got, want = run(), plain()
    torch.cuda.synchronize()
    taken = {r: c for r, c in ops.gmm_route_launches.items() if c}
    if taken != {route: 1}:
        raise AssertionError(f"grouped_matmul {name} {dtype_name}: routes "
                             f"{taken}, expected {route}")
    tol = MODEL_TOL[("gmm", dtype_name)]
    ok, err = rel_ok(got, want, tol)
    if not ok:
        raise AssertionError(f"grouped_matmul {name} {dtype_name}: kernel "
                             f"!= plain within {tol} (max abs err {err})")
    live_rows, live_slots = G * C, G
    if fills is not None:
        past = torch.arange(C, device=dev)[None, :] >= fills[:, None]
        if not bool((got.view(G, C, F)[past] == 0).all()):
            raise AssertionError(f"grouped_matmul {name} {dtype_name}: rows "
                                 "past the fills are not exact zeros")
        live_rows = int(fills.sum())
        live_slots = int((fills > 0).sum())
    # the live rows' products; x's live rows and the live slots' weights
    # read once (and the fills), every output row written once
    flops = 2 * live_rows * D * F
    nbytes = got.element_size() * (live_rows * D + live_slots * D * F
                                   + got.numel())
    if fills is not None:
        nbytes += 4 * G
    rate = BF16_FLOPS_PER_S if dtype_name == "bfloat16" else F32_FLOPS_PER_S
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    n = 10 if C < 64 else 2      # a prefill-shaped call takes milliseconds
    row = {"case": name, "counter": "grouped_matmul", "route": route,
           "dtype": dtype_name, "shape": [G, C, D, F], "key": (G, C, D, F),
           "fill": fills is not None, "live_rows": live_rows,
           "live_slots": live_slots,
           "max_abs_err": err, "tol": tol, "ms": graph_ms(run, n, 2),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    if on_path:
        xv = x.view(G, C, D)

        def library():
            return torch.bmm(xv, w)
        row.update(call_ms=time_ms(run, n), plain_ms=graph_ms(plain, n, 2),
                   library_ms=graph_ms(library, n, 2))
    return row


class ModelShapes:
    """Counts the model kernels' launches of a driven run by (counter,
    shape key, dtype), to time each counter at its commonest shape, and
    the attention and grouped-matmul calls by (counter, route, shape key,
    dtype) in ``routes``."""

    def __init__(self) -> None:
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import mamba_scan as ms
        from repro_torch.kernels import moe_gmm as mg
        self.shapes: Counter = Counter()
        self.routes: Counter = Counter()
        real_fa, real_ms, real_mg = (fa.flash_attention, ms.mamba_scan,
                                     mg.grouped_matmul)

        def attention(q, k, v, *, window=0, q_pos=None, k_pos=None, **kw):
            plain = window == 0 and q_pos is None and k_pos is None
            counter = "flash_attention" if plain else "attention_masked"
            key, dt = attn_key(q, k, v, window), str(q.dtype)
            self.shapes[(counter, key, dt)] += 1
            B, Sq, H, hd = q.shape
            route = fa.route(q.dtype, B, Sq, k.shape[1], H, k.shape[2], hd,
                             v.shape[3], window,
                             q_pos is not None or k_pos is not None)
            self.routes[(counter, route, key, dt)] += 1
            return real_fa(q, k, v, window=window, q_pos=q_pos,
                           k_pos=k_pos, **kw)

        def scan(u, dt, A, Bc, Cc, D, init_state=None):
            self.shapes[("mamba_scan" if init_state is None else
                         "mamba_step", (tuple(u.shape), A.shape[1]),
                         str(u.dtype))] += 1
            return real_ms(u, dt, A, Bc, Cc, D, init_state=init_state)

        def gmm(x, w, capacity, fills=None):
            key = (w.shape[0], capacity) + tuple(w.shape[1:])
            self.shapes[("grouped_matmul", key, str(x.dtype))] += 1
            route = mg.route(x.dtype, capacity, *w.shape[1:])
            self.routes[("grouped_matmul", route, key, str(x.dtype))] += 1
            return real_mg(x, w, capacity, fills)

        fa.flash_attention, ms.mamba_scan = attention, scan
        mg.grouped_matmul = gmm


def commonest(shapes: Counter, counter: str) -> tuple:
    """The (shape key, dtype) a counter launched most often; ``counter``
    may be a (counter, route) pair for ``ModelShapes.routes``."""
    head = counter if isinstance(counter, tuple) else (counter,)
    n = len(head)
    return max((k[n:] for k in shapes if k[:n] == head),
               key=lambda kd: shapes[head + kd])


def kernel_name(mangled: str) -> str:
    """A mangled entry name (after ``_Z``) as its last name component --
    anonymous namespaces dropped -- with its template arguments, cut to 40
    characters."""
    import re
    rest = mangled[1:] if mangled.startswith("N") else mangled
    name = ""
    while (m := re.match(r"(\d+)", rest)):
        n = int(m.group(1))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    return name + rest[:40]


def ptxas_summary(log: str) -> list:
    """``nvcc -Xptxas -v`` output, one line per kernel: its name (the
    template arguments kept), registers, shared memory and spills; and
    every warning (e.g. wgmma serialized by ptxas) as it is."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif "warning" in line.lower():
            out.append(line.strip())
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def expected_serve_launches(cfg, G: int) -> dict:
    """What one serve run launches: each global layer's prefill attention
    is plain, each windowed layer's and every decode call masked; the SSM
    mixer runs twice per layer in prefill (block, then cache) and once per
    layer and decode step."""
    n = cfg.n_layers
    n_window = sum(s.n_layers for s in cfg.segments if s.sliding_window)
    n_ssm = sum(s.n_layers for s in cfg.segments
                if s.kind in ("mamba", "hybrid"))
    n_moe = sum(s.n_layers for s in cfg.segments if s.kind == "moe")
    return {"flash_attention": n - n_window,
            "attention_masked": n_window + (G - 1) * n,
            "mamba_scan": 2 * n_ssm, "mamba_step": (G - 1) * n_ssm,
            "grouped_matmul": 3 * n_moe * G}


def logits_through(model, prompts, forced, which: str, max_len: int):
    """Prefill logits and those of ``forced`` teacher-forced decode steps,
    every kernel call sent to ``which`` ("cuda" or "ref")."""
    import torch
    from repro_torch.kernels import ops
    S = prompts.shape[1]
    ops.force(which)
    try:
        with torch.inference_mode():
            logits, caches = model.prefill({"tokens": prompts}, max_len)
            out = [logits]
            for i in range(forced.shape[1]):
                logits, caches = model.decode_step(forced[:, i:i + 1],
                                                   caches, S + i)
                out.append(logits)
        torch.cuda.synchronize()
    finally:
        ops.force(None)
    return torch.cat(out, dim=1)


def round_weights(model32, model16) -> bool:
    """Overwrite the f32 ``model32``'s weights with the bf16 ``model16``'s,
    cast: the f32 reference of the bf16 paths, with the weights' rounding
    left out.  Returns whether ``make_model`` drew ``model32``'s own
    weights as those the bf16 model rounds (checked on the embedding,
    before the copy)."""
    import torch
    same_draw = bool(torch.equal(model32.embed.to(model16.embed.dtype),
                                 model16.embed))
    p16 = dict(model16.named_parameters())
    with torch.no_grad():
        for name, p in model32.named_parameters():
            p.copy_(p16[name])
    return same_draw


def bf16_errors(kern16, plain16, plain32) -> dict:
    """The bf16 kernel path's and bf16 plain path's max |diff| from the f32
    plain path at the same weights, as shares of its largest |logit|; and
    the kernel path's against the plain path's in bf16 (``bf16_gap``, the
    share of the bf16 plain path's largest |logit|)."""
    scale = float(plain32.abs().max())
    err_k = float((kern16.float() - plain32).abs().max()) / scale
    err_p = float((plain16.float() - plain32).abs().max()) / scale
    gap = float((kern16 - plain16).abs().max()) / float(plain16.abs().max())
    return {"bf16_kernel_err": sig(err_k), "bf16_plain_err": sig(err_p),
            "bf16_err_ratio": sig(err_k / err_p), "bf16_gap": sig(gap)}


def decode_profile(model, prompts, forced, max_len: int,
                   tag: str = "6b") -> dict:
    """Where a decode step's time goes: after an unprofiled prefill, the
    ``forced`` decode steps run plain (wall time) and again under
    ``torch.profiler`` (device activity only): device busy time by kernel
    name and its share of the wall time, and the copies between host and
    device per step.  Each step reads its greedy token on the host, as the
    serve loop does (its one device->host copy)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    S = prompts.shape[1]
    with torch.inference_mode():
        _, caches0 = model.prefill({"tokens": prompts}, max_len)

        def steps():
            caches = caches0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(forced.shape[1]):
                logits, caches = model.decode_step(forced[:, i:i + 1],
                                                   caches, S + i)
                logits[:, -1].argmax(dim=-1).cpu()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        steps()
        wall = steps()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    n = forced.shape[1]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    d2h = sum(e.count for e in kern if e.key.startswith("Memcpy DtoH"))
    h2d = sum(e.count for e in kern if e.key.startswith("Memcpy HtoD"))
    log(f"[{tag}] {n} decode steps: {1e3 * wall / n:.4f} ms/step wall; "
        f"device busy {1e3 * busy / n:.4f} ms/step = {busy / wall:.4f} of "
        f"it; launches/step {sum(e.count for e in kern) / n:.1f}; "
        f"device->host copies/step {d2h / n:.2f}, host->device "
        f"{h2d / n:.2f}; by kernel (name: count, ms): " + "; ".join(
            f"{e.key[:50]}: {e.count}, {e.self_device_time_total / 1e3:.3f}"
            for e in top))
    if busy == 0:
        return {"ms_per_step": sig(1e3 * wall / n), "busy": "not measured"}
    return {"ms_per_step": sig(1e3 * wall / n),
            "busy_ms_per_step": sig(1e3 * busy / n),
            "busy_share": sig(busy / wall),
            "launches_per_step": sig(sum(e.count for e in kern) / n),
            "d2h_per_step": sig(d2h / n), "h2d_per_step": sig(h2d / n)}


class Recorder:
    """Observes a driven run: the device passes it attached and the shape
    of every kernel launch (launch counts stay in ``ops.launches``)."""

    def __init__(self) -> None:
        from repro_torch.kernels import front_find, front_pass, gain
        self.passes: list = []
        self.shapes: Counter = Counter()   # (counter, R, M) -> launches
        self.finds: Counter = Counter()    # (queued, active blocks) -> finds
        self.level_finds: Counter = Counter()  # level's n -> find launches
        real_attach, real_launch = front_pass.attach, gain._launch
        real_find = front_find.launch

        def attach(*a, **kw):
            dev = real_attach(*a, **kw)
            if dev is not None:
                self.passes.append(dev)
            return dev

        def launch(rows_perm, pc):
            self.shapes[("min_cover_lambdas",) + tuple(rows_perm.shape)] += 1
            return real_launch(rows_perm, pc)

        def find(x, work, Q, NA, **kw):
            self.finds[(Q, NA)] += 1
            if kw.get("count_as", "front_find") == "front_find":
                self.level_finds[x.n] += 1
            return real_find(x, work, Q, NA, **kw)

        front_pass.attach, gain._launch = attach, launch
        front_find.launch = find

    def reset(self) -> None:
        from repro_torch.kernels import ops
        self.passes.clear()
        self.finds.clear()
        self.level_finds.clear()
        ops.reset_launches()

    def find_shape(self) -> dict:
        """Queued mutations and active blocks per find launch of the run."""
        n = sum(self.finds.values())
        q = [k[0] for k, c in self.finds.items() for _ in range(c)]
        na = sorted(k[1] for k, c in self.finds.items() for _ in range(c))
        return {"launches": n, "max_queue": max(q, default=0),
                "mean_queue": sig(sum(q) / max(n, 1)),
                "median_blocks": na[len(na) // 2] if na else 0,
                "max_blocks": max(na, default=0)}

    def counters(self) -> dict:
        keys = ("commits", "finds", "syncs", "pass_scans",
                "apply_dispatches")
        return {k: sum(getattr(d, k) for d in self.passes) for k in keys}


def check_bounds(passes, launches: dict) -> None:
    """The device passes of one run: ``commits <= finds <= commits +
    pass_scans``, one read per find, no apply outside a find, and one
    launch of the fused find per find."""
    for d in passes:
        if not d.commits <= d.finds <= d.commits + d.pass_scans:
            raise AssertionError(f"finds bound broken: {vars_of(d)}")
        if d.syncs != d.finds or d.apply_dispatches:
            raise AssertionError(f"syncs != finds or a standalone apply: "
                                 f"{vars_of(d)}")
    finds = sum(d.finds for d in passes)
    if not finds or launches["front_find"] != finds or launches["front_apply"]:
        raise AssertionError(f"{finds} finds, launches {launches}")


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
    # every device -> host copy is a blocking read the pass must count: one
    # per find; and the pass runs the fused find and copies, nothing else
    # of PyTorch's (no index, gather or scatter kernel)
    reads = sum(e.count for e in kern if e.key.startswith("Memcpy DtoH"))
    if not reads == counts["syncs"] == counts["finds"]:
        raise AssertionError(f"{reads} device->host copies, but the pass "
                             f"counted {counts['syncs']} syncs and "
                             f"{counts['finds']} finds")
    torch_ops = [e.key for e in kern if any(
        w in e.key.lower() for w in ("index", "gather", "scatter"))]
    if torch_ops:
        raise AssertionError(f"the pass ran PyTorch kernels {torch_ops}")
    found = [e for e in kern if "front_find_kernel" in e.key]
    launches = sum(e.count for e in found)
    if launches != counts["finds"]:
        raise AssertionError(f"{launches} find launches for "
                             f"{counts['finds']} finds")
    find_ms = sum(e.self_device_time_total for e in found) / 1e3
    log(f"[3b] device busy {busy:.4f} s = {busy / wall:.4f} of the "
        f"unprofiled pass; {reads} device->host reads; by kernel (name: "
        f"count, ms): " + "; ".join(
            f"{e.key[:60]}: {e.count}, {e.self_device_time_total / 1e3:.3f}"
            for e in top))
    return out | {"busy_s": sig(busy), "busy_share": sig(busy / wall),
                  "find_ms_per_launch": sig(find_ms / launches),
                  "h2d_per_find": sig(sum(
                      e.count for e in kern
                      if e.key.startswith("Memcpy HtoD")) / launches)}


def moe_layer_check(model, prompts) -> list:
    """Each MoE layer's block on one input through the kernel and through
    the plain version (f32, within ``MODEL_TOL``): the prompts' hidden
    state (a2a, the prefill path) and its last token (tp, decode).  Both
    run the same router on the same input, so the routing is identical and
    only the grouped products differ.  The layers advance on the kernel's
    output.  Returns the max abs error per layer and mode."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.moe import moe_apply
    cfg = model.cfg
    tol = MODEL_TOL[("gmm", "float32")]
    errs = []
    with torch.inference_mode():
        x = model._embed_inputs({"tokens": prompts})
        for seg, layers in zip(cfg.segments, model.segments):
            for j, lp in enumerate(layers):
                x = x + model._mixer(lp, x, seg)
                h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
                for mode, hin in (("a2a", h), ("tp", h[:, -1:])):
                    got, _ = moe_apply(lp["moe"], hin, cfg, model.plan, mode)
                    ops.force("ref")
                    try:
                        want, _ = moe_apply(lp["moe"], hin, cfg, model.plan,
                                            mode)
                    finally:
                        ops.force(None)
                    ok, err = rel_ok(got, want, tol)
                    if not ok:
                        raise AssertionError(
                            f"MoE layer {j} ({mode}): kernel path != plain "
                            f"path within {tol} (max abs err {err})")
                    errs.append(err)
                    if mode == "a2a":
                        y = got
                x = x + y
    return errs


def route_flips(model, prompts) -> int:
    """Router choices on which the route traces through the kernels and
    through the plain versions differ."""
    import torch
    from repro_torch.kernels import ops
    traces = {}
    for which in ("cuda", "ref"):
        ops.force(which)
        try:
            with torch.inference_mode():
                traces[which] = model.route_trace({"tokens": prompts})
        finally:
            ops.force(None)
    return int(sum((a != b).sum() for a, b in zip(traces["cuda"],
                                                  traces["ref"])))


def check_routes(routes: dict, launches: dict, model: str) -> None:
    """A bf16 serve run's attention calls all took the two Hopper routes,
    each at least once."""
    calls = launches["flash_attention"] + launches["attention_masked"]
    if (sum(routes.values()) != calls or routes["cuda_core"]
            or routes["prefill_tc"] < launches["flash_attention"]
            or not routes["prefill_tc"] or not routes["decode_split"]):
        raise AssertionError(f"{model} serve: attention routes {routes} "
                             f"for {calls} calls")


def check_gmm_routes(routes: dict, launches: dict, n_moe: int,
                     G: int) -> None:
    """A bf16 serve run's grouped products: prefill (three per MoE layer)
    on ``gmm_tc``, every decode step's on ``gmv``, none on ``cuda_core``."""
    want = {"gmv": 3 * n_moe * (G - 1), "gmm_tc": 3 * n_moe, "cuda_core": 0}
    if (routes != want
            or sum(routes.values()) != launches["grouped_matmul"]):
        raise AssertionError(f"serve: grouped-matmul routes {routes}, "
                             f"expected {want}")


def check_result(hg, P, eps, res) -> None:
    """Valid, balanced masks whose recomputed cost is the reported one."""
    from repro_torch.core.partition.cost import is_valid, partition_cost
    if not is_valid(hg, res.masks, P, eps):
        raise AssertionError("invalid or unbalanced partition")
    cost = partition_cost(hg, res.masks, P)
    if not (np.isfinite(res.cost) and cost == res.cost):
        raise AssertionError(f"reported cost {res.cost} != recomputed {cost}")


def find_entry(find_rows: list, launches: int, shape: dict,
               p3b: dict) -> dict:
    """The fused find's kernel-line entry: timed at phase 2's P = 8 FM case
    (the pass's feasibility, an event to find) whose count of active blocks
    is nearest the path's median, with the device time per launch that
    phase 3b's profile measured on the path beside it."""
    med = max(shape["median_blocks"], 1)
    row = min((r for r in find_rows if r["P"] == 8 and not r["rep"]
               and not r["full_scan"]),
              key=lambda r: abs(np.log(r["blocks"] / med)))
    return {"name": "front_find", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{SOURCES['front_find']}.cu",
            "replaces": REPLACES["front_find"],
            "also_replaces": FIND_ALSO_REPLACES, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in find_rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": [row["P"], row["blocks"]],
            "call_ms": row["call_ms"], "empty_ms": row["empty_ms"],
            "path_ms": p3b.get("find_ms_per_launch", "not measured")}


def check_levels(passes, level_finds: Counter, launches: dict) -> dict:
    """The V-cycle's device passes by level (its node count): commits,
    finds, syncs and pass scans, and the level's find launches, which
    must equal its finds and its reads; every pass released."""
    levels: dict = {}
    for d in passes:
        row = levels.setdefault(d.n, Counter())
        row["passes"] += 1
        for k in ("commits", "finds", "syncs", "pass_scans"):
            row[k] += getattr(d, k)
        if d.state.device is not None:
            raise AssertionError(f"a device pass at n={d.n} was not "
                                 f"released")
    for lv, row in levels.items():
        row["launches"] = level_finds[lv]
        if not row["finds"] == row["syncs"] == row["launches"]:
            raise AssertionError(f"level n={lv}: {dict(row)}")
    if sum(level_finds.values()) != launches["front_find"]:
        raise AssertionError("a find launch outside the V-cycle's passes")
    return levels


def vcycle_phase(rec: Recorder, P: int, eps: float, n: int,
                 device: str = "cuda") -> dict:
    """Phase 8: ``partition_with_replication(large_row_net(n), multilevel=
    True, workers=None)`` with ``frontier="torch"`` on the card and with
    ``frontier="numpy"``: equal base and replicated masks and costs; on
    the card, per level, one find launch and one read per find, and the
    min-cover kernel on the coarse levels.  Then the pool forks after the
    card is up: sharded heavy-pin matching byte-identical to serial."""
    import torch
    from repro_torch.core.partition import multilevel as ml
    from repro_torch.core.partition.heuristic import (
        partition_with_replication)
    from repro_torch.core.partition.parallel import ParallelContext
    from repro_torch.datagen import large_row_net
    from repro_torch.kernels import front_pass, ops

    hg = large_row_net(n, seed=n)
    sizes: list = []
    real_build = ml.build_levels

    def build(*a, **kw):
        out = real_build(*a, **kw)
        sizes.append([lv.n for lv in out[0]])
        return out

    runs = {}
    ml.build_levels = build
    try:
        for frontier in ("torch", "numpy"):
            rec.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            base, rep = partition_with_replication(
                hg, P, eps, multilevel=True, workers=None, frontier=frontier,
                device=device)
            torch.cuda.synchronize()
            runs[frontier] = {
                "base": base, "rep": rep, "s": time.perf_counter() - t0,
                "launches": dict(ops.launches), "passes": list(rec.passes),
                "level_finds": Counter(rec.level_finds),
                "peak_B": torch.cuda.max_memory_allocated()}
    finally:
        ml.build_levels = real_build
    t, h = runs["torch"], runs["numpy"]
    for a, b in ((t["base"], h["base"]), (t["rep"], h["rep"])):
        if not (np.array_equal(a.masks, b.masks) and a.cost == b.cost):
            raise AssertionError("the V-cycle on the card differs from the "
                                 "host path")
    if h["passes"] or any(h["launches"].values()):
        raise AssertionError(f"the numpy V-cycle used the card: "
                             f"{h['launches']}")
    for res in (t["base"], t["rep"]):
        check_result(hg, P, eps, res)
    if not t["rep"].cost <= t["base"].cost:
        raise AssertionError("replication made the V-cycle's cost worse")
    check_bounds(t["passes"], t["launches"])
    levels = check_levels(t["passes"], t["level_finds"], t["launches"])
    if min(levels, default=0) < front_pass.DEVICE_MIN_NODES:
        raise AssertionError(f"device pass below the floor: {list(levels)}")
    if t["launches"]["min_cover_lambdas"] == 0:
        raise AssertionError("min_cover_lambdas never launched on the "
                             "coarse levels")
    stops = ml._refinement_schedule(len(sizes[0]),
                                    ml.MultilevelOptions().refine_every)
    log(f"[8] V-cycle on large_row_net({n}) P={P}: levels {sizes[0]}, "
        f"refined at n {[sizes[0][i] for i in stops]}; base cost "
        f"{t['base'].cost}, replicated {t['rep'].cost}, equal on cuda "
        f"({t['s']:.2f} s) and numpy ({h['s']:.2f} s); launches "
        f"{t['launches']}; per level on the card (n: counts) "
        + "; ".join(f"{lv}: {dict(row)}" for lv, row in sorted(levels.items(),
                                                              reverse=True))
        + f"; max_memory_allocated {t['peak_B']} B")

    # the pool, forked after the card is up: its workers run numpy only
    cap = (min(ml.MultilevelOptions().cluster_cap_frac, 0.5 * eps)
           * float(hg.omega.sum()) / P)
    t0 = time.perf_counter()
    with ParallelContext(2) as ctx:
        cm_p, nc_p = ml.heavy_pin_matching(hg, cap, np.random.default_rng(0),
                                           ctx=ctx)
        failed, method = ctx.failed, ctx.start_method
    s_pool = time.perf_counter() - t0
    t0 = time.perf_counter()
    cm_s, nc_s = ml.heavy_pin_matching(hg, cap, np.random.default_rng(0))
    s_serial = time.perf_counter() - t0
    if failed or nc_p != nc_s or cm_p.tobytes() != cm_s.tobytes():
        raise AssertionError(f"pooled matching ({method}): failed={failed}, "
                             f"{nc_p} clusters against {nc_s} serial")
    log(f"[8] heavy_pin_matching on a 2-worker pool ({method}, after CUDA "
        f"init): {nc_p} clusters, byte-identical to serial; "
        f"{s_pool:.2f} s pooled, {s_serial:.2f} s serial")
    return {"n": n, "levels": sizes[0],
            "refined_at": [sizes[0][i] for i in stops],
            "cuda_s": sig(t["s"]), "numpy_s": sig(h["s"]),
            "base": t["base"].cost, "rep": t["rep"].cost,
            "launches": {k: v for k, v in t["launches"].items() if v},
            "per_level": {str(lv): dict(row) for lv, row in levels.items()},
            "peak_B": t["peak_B"], "pool": method,
            "pool_s": sig(s_pool), "serial_match_s": sig(s_serial)}


def window_probe(sched, device: str = "cuda", calls: int = 50) -> dict:
    """Each window program of ``DeviceScheduleWindows`` on one state of
    ``sched``: the longest comm window, the longest compute window and the
    node move touching the most supersteps (the floor on touched steps
    lowered so that the move takes the device fold).  Per priced window:
    the host's time for the whole call (``call_ms``, its read included)
    and, under ``torch.profiler``, the kernels it launches and their
    device time (``device_ms``), copies apart.  Each result is held
    against the numpy front."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.frontier import schedule_front as sf
    from repro_torch.core.schedule import list_sched
    from repro_torch.kernels import front_pass

    def width(lo_hi):
        return lo_hi[1] - lo_hi[0] + 1

    (v, dst) = max(sorted(sched.comms),
                   key=lambda k: width(list_sched._comm_window(sched, *k)))
    lo, hi = list_sched._comm_window(sched, v, dst)
    ts_c = np.arange(lo, hi + 1)
    single = [u for u in range(sched.inst.dag.n)
              if len(sched.assign[u]) == 1]
    comp = [(u, next(iter(sched.assign[u]))) for u in single
            if (u, next(iter(sched.assign[u]))) not in sched.comms]
    (u, p) = max(comp, key=lambda k: width(list_sched._comp_window(sched,
                                                                   *k)))
    lo2, hi2 = list_sched._comp_window(sched, u, p)
    ts_p = np.arange(lo2, hi2 + 1)
    w = max(single, key=lambda k: len(front_pass._node_move_cells(sched, k)))
    T = len(front_pass._node_move_cells(sched, w))
    win = front_pass.DeviceScheduleWindows(sched, device=device)
    progs = {
        "comm": (lambda: win.price_comm_moves(v, dst, ts_c),
                 lambda: sf.price_comm_moves(sched, v, dst, ts_c), len(ts_c)),
        "comp": (lambda: win.price_comp_moves(u, p, ts_p),
                 lambda: sf.price_comp_moves(sched, u, p, ts_p), len(ts_p)),
        "node": (lambda: win.price_node_moves(w),
                 lambda: sf.price_node_moves(sched, w), T)}
    saved = front_pass.DEVICE_MIN_STEPS
    front_pass.DEVICE_MIN_STEPS = 1
    out = {}
    try:
        for kind, (dev, host, size) in progs.items():
            if not np.array_equal(dev(), host()):
                raise AssertionError(f"{kind} window differs from numpy")
            for _ in range(5):
                dev()
            t0 = time.perf_counter()
            for _ in range(calls):
                dev()
            call_ms = (time.perf_counter() - t0) / calls * 1e3
            t0 = time.perf_counter()
            for _ in range(calls):
                host()
            host_ms = (time.perf_counter() - t0) / calls * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    dev()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
            kern = [e for e in ev if not e.key.startswith("Memcpy")]
            copies = sum(e.count for e in ev if e.key.startswith("Memcpy"))
            dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
            out[kind] = {
                "size": size, "call_ms": sig(call_ms),
                "numpy_ms": sig(host_ms),
                "launches_per_window": sig(sum(e.count for e in kern)
                                           / calls) if kern else
                "not measured",
                "device_ms": sig(dev_ms / calls) if kern else
                "not measured",
                "copies_per_window": sig(copies / calls)}
    finally:
        front_pass.DEVICE_MIN_STEPS = saved
    return out


def schedule_phase(P: int, g: float, L: float, n_ml: int,
                   device: str = "cuda") -> dict:
    """Phase 9: scheduling with replication on the card.  On the engine-
    scale pair (``sptrsv_6000``, ``psdd_2035``): ``hill_climb`` of the
    list schedule, then ``advanced_heuristic``, with ``backend="torch"``
    on the card and ``backend="numpy"`` -- equal assignments, comms and
    costs; then ``multilevel_schedule`` on ``large_sptrsv_dag(n_ml)`` on
    both.  The windows priced on the card are counted (syncs, refreshes,
    launches per program), and must be some."""
    import torch
    from repro_torch.core.schedule import (BspInstance, advanced_heuristic,
                                           bspg_schedule, hill_climb,
                                           multilevel_schedule)
    from repro_torch.datagen import large_sptrsv_dag, psdd_dag, sptrsv_dag
    from repro_torch.kernels import front_pass

    wins: list = []
    sizes: dict = {"comm": [], "comp": []}   # window lengths priced
    Real = front_pass.DeviceScheduleWindows

    class Counted(Real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            wins.append(self)

        def price_comm_moves(self, v, dst, ts):
            sizes["comm"].append(len(ts))
            return super().price_comm_moves(v, dst, ts)

        def price_comp_moves(self, v, p, ts):
            sizes["comp"].append(len(ts))
            return super().price_comp_moves(v, p, ts)

    def counts() -> dict:
        out = Counter()
        for w in wins:
            out["windows"] += 1
            out["syncs"] += w.syncs
            out["refreshes"] += w.refreshes
            for k, c in w.launches.items():
                out[f"{k}_launches"] += c
        for k, got in sizes.items():
            if got:
                out[f"{k}_len_median"] = int(np.median(got))
                out[f"{k}_len_max"] = max(got)
            got.clear()
        return dict(out)

    def same(a, b) -> bool:
        return (a.current_cost() == b.current_cost() and a.assign == b.assign
                and a.comms == b.comms)

    out: dict = {}
    front_pass.DeviceScheduleWindows = Counted
    try:
        for name, dag in (("sptrsv_6000", sptrsv_dag(n=6000, band=48,
                                                     seed=0)),
                          ("psdd_2035", psdd_dag(n_leaves=500, depth=16,
                                                 seed=0))):
            inst = BspInstance(dag, P=P, g=g, L=L)
            res = {}
            for backend in ("torch", "numpy"):
                wins.clear()
                t0 = time.perf_counter()
                hc = hill_climb(bspg_schedule(inst, seed=0), seed=0,
                                backend=backend, device=device)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                adv = advanced_heuristic(hc.copy())
                t2 = time.perf_counter()
                res[backend] = (hc, adv, t1 - t0, t2 - t1, counts())
            (hc, adv, s_hc, s_adv, c), (hcn, advn, s_hcn, s_advn, cn) = \
                res["torch"], res["numpy"]
            if not (same(hc, hcn) and same(adv, advn)):
                raise AssertionError(f"{name}: the schedule on the card "
                                     f"differs from the host path's")
            if cn or not c.get("windows"):
                raise AssertionError(f"{name}: windows {c} / {cn}")
            if adv.validate():
                raise AssertionError(f"{name}: invalid replicated schedule")
            base_c, rep_c = hc.current_cost(), adv.current_cost()
            log(f"[9] {name} (n={dag.n}) P={P} g={g} L={L}: hill_climb "
                f"cost {base_c} on cuda ({s_hc:.3f} s) and numpy "
                f"({s_hcn:.3f} s); advanced_heuristic {rep_c} "
                f"({s_adv:.3f} s after the card's climb, {s_advn:.3f} s "
                f"after numpy's): {100 * (1 - rep_c / base_c):.2f} % "
                f"below the baseline; windows on the card {c}")
            out[name] = {"n": dag.n, "base": base_c, "rep": rep_c,
                         "reduction_pct": sig(100 * (1 - rep_c / base_c)),
                         "hc_cuda_s": sig(s_hc), "hc_numpy_s": sig(s_hcn),
                         "adv_s": [sig(s_adv), sig(s_advn)], "windows": c}
        dag = large_sptrsv_dag(n=n_ml, band=48, seed=0)
        inst = BspInstance(dag, P=P, g=g, L=L)
        res = {}
        for backend in ("torch", "numpy"):
            wins.clear()
            t0 = time.perf_counter()
            sched = multilevel_schedule(inst, seed=0, backend=backend,
                                        device=device)
            torch.cuda.synchronize()
            res[backend] = (sched, time.perf_counter() - t0, counts())
        (mt, s_t, c), (mn, s_n, cn) = res["torch"], res["numpy"]
    finally:
        front_pass.DeviceScheduleWindows = Real
    if not same(mt, mn):
        raise AssertionError("multilevel_schedule on the card differs from "
                             "the host path's")
    if cn or not c.get("syncs"):
        raise AssertionError(f"multilevel_schedule: no window priced on "
                             f"the card ({c}; numpy {cn})")
    if mt.validate():
        raise AssertionError("multilevel_schedule: invalid schedule")
    log(f"[9] multilevel_schedule on large_sptrsv_dag({n_ml}): cost "
        f"{mt.current_cost()} ({mt.S} supersteps) on cuda ({s_t:.2f} s) and "
        f"numpy ({s_n:.2f} s); windows on the card {c}")
    out["ml"] = {"n": n_ml, "cost": mt.current_cost(), "S": mt.S,
                 "cuda_s": sig(s_t), "numpy_s": sig(s_n), "windows": c}
    out["probe"] = window_probe(mt, device)
    log(f"[9] window programs on the V-cycle's schedule: {out['probe']}")
    return out


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
    libs = sorted(set(SOURCES.values()) | set(ATTN_SOURCES.values())
                  | set(GMM_SOURCES.values()))
    with ThreadPoolExecutor(len(libs)) as pool:   # nvcc runs outside the GIL
        list(pool.map(_build.load, libs))
    build_s = time.perf_counter() - t0
    log(f"[1] built and loaded "
        f"{', '.join(_build._lib_path(n).name for n in libs)} in "
        f"{build_s:.2f} s")
    for n in _build.PTXAS_REPORT:
        for line in ptxas_summary(_build.build_log.get(n, "")) or [
                "(loaded from an earlier build: no ptxas report)"]:
            log(f"[1] ptxas {n}: {line}")
    summary: dict = {"build_s": sig(build_s)}
    card = card_line()
    clock_hz = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"card: {card}; max SM clock {clock_hz / 1e6:.0f} MHz, {sms} SMs "
        f"(the scan's arithmetic bound: per SM and clock "
        f"{FMA_PER_CLK_PER_SM} FMA-pipe instructions, {EXP_PER_CLK_PER_SM} "
        f"exps on the special-function unit)")
    summary["max_sm_clock_mhz"], summary["sms"] = clock_hz / 1e6, sms
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -------------------------------------------- 2. kernels vs plain
    # min_cover_lambdas sees per-front chunks of up to _CHUNK_ELEMS / 2^P
    # rows; the fused find sees phase 3's blocks (R_blk rows each), the
    # active ones from the current position on.
    timed: dict = {}
    hg8 = large_row_net(8192, seed=8192)
    P, eps = 8, 0.05
    dmax = int(np.diff(hg8.xinc).max())
    r_blk = max(front_pass._R_BLK_MIN, front_pass._pow2(P * dmax))
    shapes = [("min_cover_lambdas", r, p) for p in (4, 8)
              for r in (dmax, 4096, 15625, r_blk * 64)]
    log(f"[2] kernels vs plain versions (R_blk = {r_blk} at P = 8)")
    for i, (kernel, R, p) in enumerate(shapes):
        row = check_kernel(kernel, R, p, seed=i)
        timed[(kernel, R, 1 << p)] = row
        log("    " + json.dumps(row))
    find_rows: list = []
    for p in (4, 8):
        m0p = greedy_initial(hg8, p, eps, np.random.default_rng(0))
        for rep in (False, True):
            dev = find_pass(hg8, p, rep, m0p, capacity(hg8, p, eps) + 1e-9,
                            seed=p + rep)
            try:
                for k in (1, 8, 64):
                    for full in (False, True):
                        find_rows.append(check_find(dev, rep, k, full,
                                                    seed=len(find_rows)))
                        log("    " + json.dumps(find_rows[-1]))
            finally:
                dev.detach()
    summary["p2_find"] = {
        f"P{r['P']}{'rep' if r['rep'] else 'fm'}k{r['blocks']}"
        f"{'full' if r['full_scan'] else ''}": [
            sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"]),
            sig(r["empty_ms"]), r["rows"]] for r in find_rows}
    torch.cuda.empty_cache()

    # the model kernels at hymba's shapes; the f32 plain versions run their
    # products in full f32 (TF32 off for matmuls and cuDNN alike)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[2] attention and scan vs plain versions (TF32 off)")
    model_rows: list = []
    for i, case in enumerate(ATTN_CASES):
        for dtype_name in ("bfloat16", "float32"):
            model_rows.append(check_attention(case, dtype_name, seed=100 + i))
            log("    " + json.dumps(model_rows[-1]))
    for i, case in enumerate(SCAN_CASES):
        for dtype_name in ("bfloat16", "float32"):
            model_rows.append(check_scan(case, dtype_name, seed=200 + i,
                                         clock_hz=clock_hz, sms=sms))
            log("    " + json.dumps(model_rows[-1]))
    for i, case in enumerate(GMM_CASES):
        for dtype_name in ("bfloat16", "float32"):
            model_rows.append(check_gmm(case, dtype_name, seed=300 + i))
            log("    " + json.dumps(model_rows[-1]))
    summary["p2_model"] = {
        f"{r['counter']}:{r['case']}/{r['dtype'][:4]}": [
            sig(r["ms"]), sig(r["bound_ms"]),
            sig(r["plain_ms"]) if "plain_ms" in r else None,
            sig(r["library_ms"]) if r.get("library_ms") else None,
            sig(r["max_abs_err"])]
        for r in model_rows}
    torch.cuda.empty_cache()

    rec = Recorder()

    # ------------------------------------ 3. device pass vs host path
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
    check_bounds(allp, lt)
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
    find5 = rec.find_shape()
    peak = torch.cuda.max_memory_allocated()
    shapes5 = Counter(rec.shapes)
    check_result(hg5, P, eps, b5)
    check_result(hg5, P, eps, r5)
    check_bounds(rec.passes, l5)
    if not r5.cost <= b5.cost:
        raise AssertionError("replication made the cost worse")
    log(f"[5] large_row_net({n5}) P=8: {s5:.2f} s, base cost {b5.cost}, "
        f"replicated cost {r5.cost}, device passes {len(rec.passes)}, "
        f"{c5}, syncs/commit {c5['syncs'] / max(c5['commits'], 1):.4f}, "
        f"find launches {find5}, "
        f"launches {l5}, max_memory_allocated {peak} B")
    summary["p5"] = {"n": n5, "s": sig(s5), "base": b5.cost, "rep": r5.cost,
                     **c5, "syncs_per_commit": sig(c5["syncs"] / max(
                         c5["commits"], 1)), "peak_B": peak, "finds": find5}

    # ------------------------------------------------ 6. serve hymba-1.5b
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_model, make_prompts, serve
    cfg = get_config("hymba-1.5b")
    B6, S6, G6 = 4, 2048, 32
    shapes = ModelShapes()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve(cfg, B6, S6, G6, device="cuda", seed=0)
    peak6 = torch.cuda.max_memory_allocated()
    r6 = dict(ops.route_launches)
    if any(ops.gmm_route_launches.values()):
        raise AssertionError(f"hymba ran grouped products: "
                             f"{ops.gmm_route_launches}")
    shapes6, routes6 = Counter(shapes.shapes), Counter(shapes.routes)
    l6 = {c: res.launches[c] for c in MODEL_COUNTERS}
    check_routes(r6, l6, "hymba")
    if res.tokens.shape != (B6, G6) or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise AssertionError(f"bad generated tokens {res.tokens.shape}")
    for c in MODEL_COUNTERS[:4]:       # hymba runs all but the MoE kernel
        if l6[c] == 0:
            raise AssertionError(f"{c} never launched while serving")
    want6 = expected_serve_launches(cfg, G6)
    if l6 != want6:
        raise AssertionError(f"serve launched {l6}, expected {want6}")
    log(f"[6] serve {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, bf16): {B6} prompts x {S6} tokens, {G6} new each; "
        f"prefill {res.prefill_s:.4f} s, decode {res.ms_per_token:.4f} "
        f"ms/token, {res.tokens_per_s:.2f} tok/s, max_memory_allocated "
        f"{peak6} B; launches {l6}; attention routes {r6}; sample "
        f"{res.tokens[0][:8].tolist()}")
    # the scan's share of the prefill: its launches at phase 2's device time
    scan_row = next(r for r in model_rows if r["case"] == "prefill"
                    and r["counter"] == "mamba_scan"
                    and r["dtype"] == "bfloat16")
    scan_ms = l6["mamba_scan"] * scan_row["ms"]
    log(f"[6] the scan in prefill: {l6['mamba_scan']} launches x "
        f"{scan_row['ms']:.6g} ms (phase 2, device time) = {scan_ms:.6g} ms "
        f"of {1e3 * res.prefill_s:.6g} ms")
    # prefill and three teacher-forced decode steps.  The f32 model (its
    # own draw) through the kernels and through the plain versions, within
    # F32_LOGIT_TOL; then its weights overwritten by the bf16 model's, cast,
    # through the plain versions: the reference each bf16 path is held to
    prompts6 = torch.from_numpy(make_prompts(cfg, B6, S6, 0)).cuda()
    # forced tokens drawn apart from the serve run, so that runs on other
    # kernels hold their paths to the same inputs
    forced = torch.from_numpy(make_prompts(cfg, B6, 3, 1)).cuda()
    model32 = make_model(cfg.with_(dtype="float32"), device="cuda", seed=0)
    ops.reset_launches()
    kern32 = logits_through(model32, prompts6, forced, "cuda", S6 + G6)
    r6_f32 = dict(ops.route_launches)     # f32 prefill takes cuda_core
    log(f"[6] f32 kernel path, prefill + 3 decode steps: attention routes "
        f"{r6_f32}")
    if not (r6_f32["cuda_core"] and r6_f32["decode_split"]):
        raise AssertionError(f"f32 attention routes {r6_f32}")
    plain32 = logits_through(model32, prompts6, forced, "ref", S6 + G6)
    model = make_model(cfg, device="cuda", seed=0)
    same_draw = round_weights(model32, model)
    ref32 = logits_through(model32, prompts6, forced, "ref", S6 + G6)
    del model32
    torch.cuda.empty_cache()
    kern16 = logits_through(model, prompts6, forced, "cuda", S6 + G6)
    plain16 = logits_through(model, prompts6, forced, "ref", S6 + G6)
    summary["p6b"] = decode_profile(model, prompts6, forced, S6 + G6)
    del model
    torch.cuda.empty_cache()
    for name, kern in (("float32", kern32), ("bfloat16", kern16)):
        if not (torch.isfinite(kern).all()
                and kern.shape == (B6, 4, cfg.vocab)):
            raise AssertionError(f"{name} logits not finite or misshapen: "
                                 f"{tuple(kern.shape)}")
    gap32, scale32 = (float((kern32 - plain32).abs().max()),
                      float(plain32.abs().max()))
    if not gap32 <= F32_LOGIT_TOL * scale32:
        raise AssertionError(f"f32 kernel path off the plain path by "
                             f"{gap32} > {F32_LOGIT_TOL} x {scale32}")
    errs6 = bf16_errors(kern16, plain16, ref32)
    log(f"[6] f32 kernel path vs plain path, prefill + 3 decode steps: max "
        f"|diff| {gap32:.6g}, max |logit| {scale32:.6g}, ratio "
        f"{gap32 / scale32:.6g}")
    log(f"[6] bf16 paths against the f32 plain path at the bf16 weights "
        f"(make_model draws the f32 weights the bf16 model rounds: "
        f"{same_draw}), shares of its largest |logit|: kernel "
        f"{errs6['bf16_kernel_err']}, plain {errs6['bf16_plain_err']} "
        f"(ratio {errs6['bf16_err_ratio']}); kernel vs plain in bf16 "
        f"{errs6['bf16_gap']}")
    summary["p6"] = {
        "prefill_s": sig(res.prefill_s), "ms_per_token": sig(
            res.ms_per_token), "tok_s": sig(res.tokens_per_s),
        "peak_B": peak6, "launches": l6, "routes": r6,
        "f32_routes": r6_f32, "f32_gap": sig(gap32 / scale32), **errs6,
        "same_draw": same_draw, "scan_prefill_ms": sig(scan_ms)}

    # ----------------------------------------- 7. serve olmoe-1b-7b (MoE)
    from repro_torch.core.placement import SMOKE, drift_replay
    t7 = time.perf_counter()
    cfg7 = get_config("olmoe-1b-7b")
    B7, S7, G7 = 4, 2048, 32
    shapes.shapes.clear()
    shapes.routes.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res7 = serve(cfg7, B7, S7, G7, device="cuda", seed=0,
                 placement="replicated")
    peak7 = torch.cuda.max_memory_allocated()
    r7 = dict(ops.route_launches)
    g7 = dict(ops.gmm_route_launches)
    shapes7, routes7 = Counter(shapes.shapes), Counter(shapes.routes)
    l7 = {c: res7.launches[c] for c in MODEL_COUNTERS}
    check_routes(r7, l7, "olmoe")
    n_moe7 = sum(sg.n_layers for sg in cfg7.segments if sg.kind == "moe")
    check_gmm_routes(g7, l7, n_moe7, G7)
    if res7.tokens.shape != (B7, G7) or not (
            (res7.tokens >= 0) & (res7.tokens < cfg7.vocab)).all():
        raise AssertionError(f"bad generated tokens {res7.tokens.shape}")
    want7 = expected_serve_launches(cfg7, G7)
    if l7 != want7:
        raise AssertionError(f"olmoe serve launched {l7}, expected {want7}")
    pl = res7.placement
    log(f"[7] placement over {pl['n_shards']} shards from the prompts' "
        f"router trace ({pl['seconds']:.3f} s): lambda-cost "
        f"{pl['lambda_cost_no_repl']} -> {pl['lambda_cost_repl']} with "
        f"replication, local fraction {pl['local_fraction_no_repl']:.4f} -> "
        f"{pl['local_fraction_repl']:.4f}; launches while planning "
        f"{pl['launches']}")
    log(f"[7] serve {cfg7.name} ({cfg7.n_layers} layers, d_model "
        f"{cfg7.d_model}, {cfg7.n_experts} experts top-{cfg7.top_k}, bf16): "
        f"{B7} prompts x {S7} tokens, {G7} new each; prefill "
        f"{res7.prefill_s:.4f} s, decode {res7.ms_per_token:.4f} ms/token, "
        f"{res7.tokens_per_s:.2f} tok/s, max_memory_allocated {peak7} B; "
        f"launches {l7}; attention routes {r7}; grouped-matmul routes "
        f"{g7}; sample {res7.tokens[0][:8].tolist()}")
    prompts7 = torch.from_numpy(make_prompts(cfg7, B7, S7, 0)).cuda()
    forced7 = torch.from_numpy(make_prompts(cfg7, B7, 3, 1)).cuda()
    # as in phase 6: the f32 model's own draw through both paths, gated;
    # then the bf16 model's weights, cast, through the plain versions
    model32 = make_model(cfg7.with_(dtype="float32"), device="cuda", seed=0)
    ops.reset_launches()
    layer_errs = moe_layer_check(model32, prompts7)
    log(f"[7] f32 MoE block per layer on one input, kernel vs plain: max "
        f"abs err {max(layer_errs):.6g} (a2a and tp, {len(layer_errs)} "
        f"checks within {MODEL_TOL[('gmm', 'float32')]})")
    kern = logits_through(model32, prompts7, forced7, "cuda", S7 + G7)
    g7_f32 = dict(ops.gmm_route_launches)     # the f32 checks' products
    log(f"[7] f32 checks (MoE blocks, prefill + 3 decode steps): "
        f"grouped-matmul routes {g7_f32}")
    if not (g7_f32["cuda_core"] and g7_f32["gmv"]) or g7_f32["gmm_tc"]:
        raise AssertionError(f"f32 grouped-matmul routes {g7_f32}")
    plain = logits_through(model32, prompts7, forced7, "ref", S7 + G7)
    gap32, scale32 = (float((kern - plain).abs().max()),
                      float(plain.abs().max()))
    flips = None
    if not gap32 <= F32_LOGIT_TOL * scale32:
        flips = route_flips(model32, prompts7)
        log(f"[7] f32 logits off by {gap32} > {F32_LOGIT_TOL} x {scale32}; "
            f"the route traces differ in {flips} top-k choices")
        if flips == 0:
            raise AssertionError("f32 kernel path off the plain path with "
                                 "identical routing")
    del plain
    model = make_model(cfg7, device="cuda", seed=0)
    same_draw7 = round_weights(model32, model)
    ref32 = logits_through(model32, prompts7, forced7, "ref", S7 + G7)
    del model32
    torch.cuda.empty_cache()
    summary["p7b"] = decode_profile(model, prompts7, forced7, S7 + G7,
                                    tag="7b")
    if summary["p7b"].get("d2h_per_step") != 1:
        raise AssertionError(f"decode is not one device->host copy a step: "
                             f"{summary['p7b']}")
    kern16 = logits_through(model, prompts7, forced7, "cuda", S7 + G7)
    plain16 = logits_through(model, prompts7, forced7, "ref", S7 + G7)
    del model
    for name, k in (("float32", kern), ("bfloat16", kern16)):
        if not (torch.isfinite(k).all() and k.shape == (B7, 4, cfg7.vocab)):
            raise AssertionError(f"{name} logits not finite or misshapen: "
                                 f"{tuple(k.shape)}")
    errs7 = bf16_errors(kern16, plain16, ref32)
    del kern, kern16, plain16, ref32
    torch.cuda.empty_cache()
    log(f"[7] f32 kernel path vs plain path, prefill + 3 decode steps: max "
        f"|diff| {gap32:.6g} of max |logit| {scale32:.6g} (ratio "
        f"{gap32 / scale32:.6g})")
    log(f"[7] bf16 paths against the f32 plain path at the bf16 weights "
        f"(make_model draws the f32 weights the bf16 model rounds: "
        f"{same_draw7}), shares of its largest |logit|: kernel "
        f"{errs7['bf16_kernel_err']}, plain {errs7['bf16_plain_err']} "
        f"(ratio {errs7['bf16_err_ratio']}); kernel vs plain in bf16 "
        f"{errs7['bf16_gap']}")
    replay = {}
    for drift in (0.8, 0.0):
        t0 = time.perf_counter()
        on_card = drift_replay(**SMOKE, drift_rate=drift, device="cuda")
        s_card = time.perf_counter() - t0
        host = drift_replay(**SMOKE, drift_rate=drift, frontier="numpy")
        if on_card["policies"] != host["policies"]:
            raise AssertionError(f"drift {drift}: the replay on CUDA "
                                 f"{on_card['policies']} != host "
                                 f"{host['policies']}")
        pol = on_card["policies"]
        replay[drift] = [pol[k]["comm_cost"] for k in pol] + [
            pol["online_replicated"]["commits"],
            pol["online_replicated"]["migration_bytes"]]
        log(f"[7] SMOKE drift replay, drift {drift}: {pol}, equal on CUDA "
            f"({s_card:.2f} s) and the host path")
    s7 = time.perf_counter() - t7
    log(f"[7] phase 7 took {s7:.2f} s")
    summary["p7"] = {
        "prefill_s": sig(res7.prefill_s), "ms_per_token": sig(
            res7.ms_per_token), "tok_s": sig(res7.tokens_per_s),
        "peak_B": peak7, "launches": l7, "routes": r7, "gmm_routes": g7,
        "f32_gmm_routes": g7_f32,
        "lam_cost": [pl["lambda_cost_no_repl"], pl["lambda_cost_repl"]],
        "plan_launches": pl["launches"]["min_cover_lambdas"],
        "layer_err": sig(max(layer_errs)), "f32_gap": sig(gap32 / scale32),
        "route_flips": flips, **errs7, "same_draw": same_draw7,
        "replay": {str(k): v for k, v in replay.items()}, "s": sig(s7)}

    # ------------------------------------------------ 8. the V-cycle
    t8 = time.perf_counter()
    summary["p8"] = vcycle_phase(rec, P, eps, n=16384)
    log(f"[8] phase 8 took {time.perf_counter() - t8:.2f} s")
    torch.cuda.empty_cache()

    # ------------------------------------ 9. scheduling with replication
    t9 = time.perf_counter()
    summary["p9"] = schedule_phase(P=8, g=4.0, L=20.0, n_ml=16384)
    log(f"[9] phase 9 took {time.perf_counter() - t9:.2f} s")

    # ----------------------------------------------------- kernel line
    launches = {k: l4[k] + l5[k] for k in l4}
    shapes_all = shapes4 + shapes5
    log(f"launch shapes (counter, R, M): count, phases 4+5: "
        f"{dict(shapes_all.most_common(12))}")
    kernels = []
    for name, kernel in KERNEL_OF.items():
        if name in MODEL_COUNTERS:
            continue
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        if name == "front_find":
            kernels.append(find_entry(find_rows, launches[name], find5,
                                      summary["p3b"]))
            continue
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
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[kernel]}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": [R, M], "call_ms": row["call_ms"]})
    # the partition kernels' launches on the V-cycle's path (phase 8)
    for k in kernels:
        k["vcycle_launches"] = summary["p8"]["launches"].get(k["name"], 0)
    shapes_model = shapes6 + shapes7
    log(f"model kernel launch shapes (counter, key, dtype): count, phases "
        f"6+7: {dict(shapes_model.most_common(14))}")
    def timed_row(counter, key, dt, route=None, fill=False):
        rows = [r for r in model_rows if r["counter"] == counter
                and r["dtype"] == dt.removeprefix("torch.")
                and "plain_ms" in r and r["key"] == key
                and route in (None, r.get("route"))
                and r.get("fill", False) == fill]
        if not rows:
            raise AssertionError(f"{counter} {route}: its commonest shape "
                                 f"{key} {dt} was not timed in phase 2")
        return rows[0]

    def row_fields(row):
        return {"max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"], "dtype": row["dtype"],
                "call_ms": row["call_ms"]}

    def second(case, dtype, prefix):   # another path shape of a kernel
        r = next(r for r in model_rows if r["case"] == case
                 and r["dtype"] == dtype)
        return {f"{prefix}_{k}": r[k] for k in (
            "ms", "bound_ms", "plain_ms", "library_ms", "call_ms")}

    # attention: one entry per (count, route) of the bf16 serve runs, and
    # cuda_core with the launches of phase 6's f32 kernel path.  In those
    # runs every plain call is a prefill (prefill_tc) and every decode call
    # masked (decode_split), so the serve counts split by route as below
    # (``ModelShapes`` also sees the placement planner's calls: it only
    # picks the commonest shape)
    routes_model = routes6 + routes7
    log(f"attention calls by (counter, route, key, dtype), phases 6+7, "
        f"planner included: {dict(routes_model)}")
    n_plain = l6["flash_attention"] + l7["flash_attention"]
    by_route = {
        ("flash_attention", "prefill_tc"): n_plain,
        ("attention_masked", "prefill_tc"):
            r6["prefill_tc"] + r7["prefill_tc"] - n_plain,
        ("attention_masked", "decode_split"):
            r6["decode_split"] + r7["decode_split"]}
    for counter, route in ATTN_PATH:
        key, dt = commonest(routes_model, (counter, route))
        row = timed_row(counter, key, dt, route)
        kernels.append({
            "name": f"{counter}:{route}", "route": "cuda",
            "attn_route": route,
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{ATTN_SOURCES[route]}.cu",
            "replaces": REPLACES[counter],
            "launches": by_route[(counter, route)], **row_fields(row)})
        if (counter, route) == ("flash_attention", "prefill_tc"):
            kernels[-1].update(second("prefill", row["dtype"], "hymba"))
        if route == "decode_split":
            kernels[-1].update(second("olmoe_decode", row["dtype"],
                                      "olmoe"))
    row = next(r for r in model_rows if r["case"] == "prefill"
               and r["dtype"] == "float32")
    kernels.append({
        "name": "attention:cuda_core", "route": "cuda",
        "attn_route": "cuda_core",
        "source": f"src/repro_torch/kernels/csrc/"
                  f"{ATTN_SOURCES['cuda_core']}.cu",
        "replaces": REPLACES["flash_attention"],
        "launches": r6_f32["cuda_core"],
        "launches_from": "phase 6, f32 kernel path", **row_fields(row)})
    for name in ("mamba_scan", "mamba_step"):
        key, dt = commonest(shapes_model, name)
        row = timed_row(name, key, dt)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{SOURCES[KERNEL_OF[name]]}.cu",
            "replaces": REPLACES[name], "launches": l6[name] + l7[name],
            **row_fields(row), "bound_terms_ms": row["bound_terms_ms"],
            "exp_sfu_share": row["exp_sfu_share"]})
        if "empty_ms" in row:
            kernels[-1]["empty_ms"] = row["empty_ms"]
    # grouped matmul: one entry per route of the bf16 serve runs, timed at
    # the fill-aware case of its commonest path shape (the path hands the
    # kernel the slot fills), the full buffers beside it; and cuda_core
    # with the launches of phase 7's f32 checks
    gmm_launches = dict(g7, cuda_core=g7_f32["cuda_core"])
    for route in GMM_PATH + ("cuda_core",):
        if route == "cuda_core":
            key, dt = (64, 2560, 2048, 1024), "float32"
        else:
            key, dt = commonest(routes_model, ("grouped_matmul", route))
        row = timed_row("grouped_matmul", key, dt, route, fill=True)
        full = timed_row("grouped_matmul", key, dt, route)
        kernels.append({
            "name": f"grouped_matmul:{route}", "route": "cuda",
            "gmm_route": route,
            "source": f"src/repro_torch/kernels/csrc/{GMM_SOURCES[route]}.cu",
            "replaces": REPLACES["grouped_matmul"],
            "launches": gmm_launches[route], **row_fields(row),
            "live_rows": row["live_rows"], "live_slots": row["live_slots"],
            **{f"full_{k}": full[k] for k in (
                "ms", "bound_ms", "plain_ms", "library_ms", "call_ms")}})
        if route == "cuda_core":
            kernels[-1]["launches_from"] = "phase 7, f32 checks"
        elif route == "gmm_tc":           # also the down product's shape
            kernels[-1].update(second("prefill_down_fill", row["dtype"],
                                      "down"))
            kernels[-1].update(second("prefill_down", row["dtype"],
                                      "down_full"))
    # the largest shape of phase 2, per kernel: the kernel against its bound
    # where launch latency no longer hides it
    summary["p2_largest"] = {
        k: [R, M, sig(r["ms"]), sig(r["bound_ms"]), sig(r["plain_ms"])]
        for (k, R, M), r in timed.items() if R == r_blk * 64 and M == 256}
    compact = (",", ":")
    log("summary " + json.dumps(summary, separators=compact))
    log(f"card: {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}, separators=compact), flush=True)
    log("kernels: " + ", ".join(k["name"] for k in kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
