#!/usr/bin/env python3
"""Where the fused backwards' time goes: rmsnorm's and the Mamba conv's
backward kernels of ``csrc/fused.cu`` timed launch by launch, beside
another source of the same kernels, on one GPU, in one process; with
``--fwd`` the conv's forward instead.

    mkdir -p build/other
    git show <commit>:src/repro_torch/kernels/csrc/fused.cu \\
        > build/other/fused.cu
    python3 probe_fused_bwd.py --other build/other [--abi first] \\
        [--ops causal_conv] [--fwd [--steps 16 32]]

``--abi`` says how the other source's backward launchers are called:
``checkout`` (the default) as the checkout's are (``_build.SIGNATURES``,
at the checkout's plans), ``first`` as the first design's were (rmsnorm
with an ``rstd`` scratch and 64 rows a part, the conv with 64-step
chunks, each chunk a part; kernels ``fused_rmsnorm_bwd_kernel``,
``fused_rmsnorm_dw_kernel``, ``fused_rmsnorm_dwsum_kernel``,
``fused_conv_bwd_kernel``, ``fused_conv_dwsum_kernel``; the conv's
forward from zeros a thread a chunk of 64 steps: its launcher's chunk
64).

``--fwd``: the conv's forward at phase 23's cases (``FUSED_CASES``:
hymba's and falcon's training shapes on a column slice of in_proj's
output, decode from a state), bf16 and f32, and at an odd one (3 x 1001
x 1000), each source held bit for bit to the plain version (a miss is
reported), timed in CUDA-graph replay in turns (other, checkout,
checkout, other) beside its bound (bytes over 3.35 TB/s), with the
forward kernels' ptxas report; ``--steps`` also times the checkout's
kernel from zeros at other chunk lengths (whole slots: multiples of 16
bf16 or 8 f32 steps) than its plan's, called through its launcher.

The cases are phase 23's (``chip_smoke.FUSED_CASES``' rmsnorm and conv
shapes but decode's, ``chip_smoke.fused_case``'s inputs), bf16 and f32.
Each backward is held against its written-out plain version
(``chip_smoke.GRAD_TOL``: a miss is reported, not raised), timed in
CUDA-graph replay (``chip_smoke.graph_ms``) in turns (other, checkout,
checkout, other) and split by launch under ``torch.profiler``
(``chip_smoke.kernel_split_ms``).  Both sources build with ``-Xptxas
-v``, whose report of each backward kernel (registers, spills) is
printed.  Prints the card's name and power limit, a JSON line a case,
then one JSON line of them all.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# the first design's launchers: rmsnorm's backward (x, w, dy, dx, dw,
# rstd, part, R, D, sx, rows_per, eps, x_bf16, w_bf16, stream), the conv's
# (u, w, b, dy, du, dw, db, part, B, S, di, K, sub, sus, chunk, is_bf16,
# stream); its kernels by launch
FIRST = {
    "repro_rmsnorm_bwd": (_P,) * 7 + (_LL, _I, _LL, _I, _F, _I, _I, _P),
    "repro_causal_conv_bwd": (_P,) * 8 + (_I,) * 4 + (_LL, _LL, _I, _I, _P),
}
FIRST_SPLIT = {"rmsnorm": {"row": "fused_rmsnorm_bwd_kernel",
                           "dw": "fused_rmsnorm_dw_kernel",
                           "dwsum": "fused_rmsnorm_dwsum_kernel"},
               "causal_conv": {"main": "fused_conv_bwd_kernel",
                               "dwsum": "fused_conv_dwsum_kernel"}}


def build(src: Path, tag: str) -> tuple[ctypes.CDLL, str]:
    """``src`` built with the checkout's nvcc flags and ``-Xptxas -v``
    (the checkout's headers on the include path): the library and
    ptxas's report."""
    from repro_torch.kernels import _build
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libfused_{tag}_{key}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", f"-I{_build.CSRC}", "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True,
                    help="directory with the other source's fused.cu")
    ap.add_argument("--abi", choices=("checkout", "first"),
                    default="checkout")
    ap.add_argument("--ops", nargs="+", default=["rmsnorm", "causal_conv"],
                    help="the ops whose backwards to probe")
    ap.add_argument("--fwd", action="store_true",
                    help="probe the conv's forward instead")
    ap.add_argument("--steps", nargs="*", type=int, default=[],
                    help="with --fwd: other chunk lengths to time")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, fused

    print(cs.card_line(), flush=True)
    _build.load("fused")   # built with -Xptxas -v (``PTXAS_REPORT``)
    other, other_log = build(args.other / "fused.cu", "other")
    first = args.abi == "first"
    sigs = FIRST if first else _build.SIGNATURES["fused"]
    for fn in ("repro_rmsnorm_bwd", "repro_causal_conv_bwd"):
        getattr(other, fn).argtypes = list(sigs[fn])
        getattr(other, fn).restype = ctypes.c_int
    out: dict = {"card": cs.card_line(), "abi": args.abi, "ptxas": {
        name: [s for s in cs.ptxas_summary(log)
               if any(k in s for k in ("bwd", "dwsum", "dw_kernel"))]
        for name, log in (("checkout", _build.build_log.get("fused", "")),
                          ("other", other_log))}, "rows": []}
    for k, lines in out["ptxas"].items():
        for line in lines:
            print(f"ptxas {k}: {line}", flush=True)
    if args.fwd:
        return probe_fwd(other, other_log, first, args.steps)

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def bf(t) -> int:
        return int(t.dtype == torch.bfloat16)

    def launch(fn: str, *a) -> None:
        err = getattr(other, fn)(*a, stream())
        assert err == 0, f"{fn}: error {err}"

    cases = [(op, tag, shape) for op, tag, shape in cs.FUSED_CASES
             if op in args.ops and tag != "decode"]
    for i, (op, tag, shape) in enumerate(cases):
        for dt in ("bfloat16", "float32"):
            c = cs.fused_case(op, tag, shape, dt, seed=i)
            dy = c["dy"]
            want = c["plain_bwd"](dy)
            row = {"op": op, "case": tag, "dtype": dt, "shape": list(shape)}
            if op == "rmsnorm":
                x, w = c["args"]
                R, D = x.shape
                plan = fused.norm_bwd_plan(R, D, x.element_size())
                parts = min(-(-R // 64), 1024) if first else plan["parts"]
                rstd = torch.empty(R, device="cuda")
                part = torch.empty((parts, D), device="cuda")
                outs = (torch.empty_like(x), torch.empty_like(w))
                tail = (-(-R // parts),) if first else (
                    plan["threads_x"], plan["groups"], plan["band"])

                def theirs(x=x, w=w, dy=dy, part=part, rstd=rstd, o=outs,
                           R=R, D=D, tail=tail):
                    launch("repro_rmsnorm_bwd", x.data_ptr(), w.data_ptr(),
                           dy.data_ptr(), o[0].data_ptr(), o[1].data_ptr(),
                           *((rstd.data_ptr(),) if first else ()),
                           part.data_ptr(), R, D, x.stride(0), *tail, 1e-5,
                           bf(x), bf(w))
                    return o
            else:
                u, w, b = c["args"]
                B, S, di = u.shape
                K = w.shape[0]
                plan = fused.conv_bwd_plan(B, S, u.element_size())
                parts = B * -(-S // 64) if first else plan["parts"]
                part = torch.empty((parts, K + 1, di), device="cuda")
                outs = (torch.empty(u.shape, dtype=u.dtype, device="cuda"),
                        torch.empty_like(w), torch.empty_like(b))
                tail = (64,) if first else (plan["steps"], plan["parts"])

                def theirs(u=u, w=w, b=b, dy=dy, part=part, o=outs, B=B,
                           S=S, di=di, K=K, tail=tail):
                    launch("repro_causal_conv_bwd", u.data_ptr(),
                           w.data_ptr(), b.data_ptr(), dy.data_ptr(),
                           o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(),
                           part.data_ptr(), B, S, di, K, u.stride(0),
                           u.stride(1), *tail, bf(u))
                    return o

            def mine(bwd=c["bwd"], dy=dy):
                return bwd(dy)
            for key, f in (("err_other", theirs), ("err", mine)):
                gap = max(cs.grad_gap(a, b) for a, b in zip(f(), want))
                if not gap <= cs.GRAD_TOL[dt]:
                    print(f"MISS {op} {tag} {dt} {key}: {gap}", flush=True)
                row[key] = cs.sig(gap)
            one = [t.clone() for t in mine()]
            row["repeats_bits"] = all(torch.equal(a, b)
                                      for a, b in zip(one, mine()))
            turns = [cs.graph_ms(f, launches=10, replays=5)
                     for f in (theirs, mine, mine, theirs)]
            row["other_ms"] = [cs.sig(turns[0]), cs.sig(turns[3])]
            row["ms"] = [cs.sig(turns[1]), cs.sig(turns[2])]
            row["split_other_ms"] = cs.kernel_split_ms(
                theirs, (FIRST_SPLIT if first else cs.FUSED_BWD_SPLIT)[op], 10)
            row["split_ms"] = cs.kernel_split_ms(mine, cs.FUSED_BWD_SPLIT[op],
                                                 10)
            row["bound_ms"] = cs.sig(1e3 * c["cost"][1] / cs.HBM_BYTES_PER_S)
            print(json.dumps(row), flush=True)
            out["rows"].append(row)
            del c, want, one
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def probe_fwd(other, other_log: str, first: bool, steps: list) -> int:
    """``--fwd``: the conv's forward, the other source's beside the
    checkout's, and the checkout's at the chunk lengths ``steps`` (see the
    module docstring)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, fused, ref
    mine_lib = _build.load("fused")
    for lib in (other, mine_lib):
        lib.repro_causal_conv.argtypes = list(
            _build.SIGNATURES["fused"]["repro_causal_conv"])
    out: dict = {"card": cs.card_line(), "abi": "first" if first else
                 "checkout", "ptxas": {
                     name: [s for s in cs.ptxas_summary(log)
                            if "conv" in s and "bwd" not in s
                            and "dwsum" not in s]
                     for name, log in (
                         ("checkout", _build.build_log.get("fused", "")),
                         ("other", other_log))}, "rows": []}
    for k, lines in out["ptxas"].items():
        for line in lines:
            print(f"ptxas {k}: {line}", flush=True)
    cases = [(tag, shape) for op, tag, shape in cs.FUSED_CASES
             if op == "causal_conv"] + [("odd", (3, 1001, 1000))]
    for i, (tag, (B, S, di)) in enumerate(cases):
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            g = torch.Generator(device="cuda").manual_seed(i)

            def t(*s, scale=1.0, g=g, dtype=dtype):
                return (torch.randn(s, generator=g, device="cuda")
                        * scale).to(dtype)
            u = t(B, S, 2 * di)[..., :di]
            w, b = t(4, di, scale=0.5), t(di, scale=0.25)
            st = t(B, 3, di) if tag == "decode" else None
            want, want_st = ref.causal_conv_ref(u, w, b, st)
            y = torch.empty((B, S, di), dtype=dtype, device="cuda")
            held = None if st is None else st.clone()
            new = held if st is not None else torch.empty(
                (B, 3, di), dtype=dtype, device="cuda")
            chunk = S if st is not None else (
                64 if first else fused.conv_fwd_plan(
                    B, S, u.element_size())["steps"])

            def theirs(u=u, w=w, b=b, y=y, held=held, new=new, chunk=chunk,
                       lib=other):
                err = lib.repro_causal_conv(
                    u.data_ptr(), w.data_ptr(), b.data_ptr(),
                    None if held is None else held.data_ptr(), y.data_ptr(),
                    new.data_ptr(), u.shape[0], u.shape[1], u.shape[2], 4,
                    u.stride(0), u.stride(1), chunk,
                    int(u.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, f"repro_causal_conv: error {err}"
                return y, new

            def mine(u=u, w=w, b=b, held=held):
                return fused.causal_conv(u, w, b, held)
            row = {"op": "causal_conv", "case": tag, "dtype": dt,
                   "shape": [B, S, di], "from_state": st is not None}
            for key, f in (("exact_other", theirs), ("exact", mine)):
                if held is not None:
                    held.copy_(st)
                got, got_st = f()
                torch.cuda.synchronize()
                row[key] = bool(torch.equal(got, want)
                                and torch.equal(got_st, want_st))
                if not row[key]:
                    print(f"MISS conv {tag} {dt} {key}", flush=True)
            turns = [cs.graph_ms(f, launches=20, replays=5)
                     for f in (theirs, mine, mine, theirs)]
            row["other_ms"] = [cs.sig(turns[0]), cs.sig(turns[3])]
            row["ms"] = [cs.sig(turns[1]), cs.sig(turns[2])]
            row["bound_ms"] = cs.sig(1e3 * fused.conv_cost(
                u, w, st is not None)[1] / cs.HBM_BYTES_PER_S)
            if st is None:
                row["steps"] = fused.conv_fwd_plan(
                    B, S, u.element_size())["steps"]
                for n in steps:
                    def at(n=n):
                        return theirs(chunk=n, lib=mine_lib)
                    got, got_st = at()
                    torch.cuda.synchronize()
                    row[f"exact_steps_{n}"] = bool(
                        torch.equal(got, want) and torch.equal(got_st, want_st))
                    row[f"ms_steps_{n}"] = cs.sig(cs.graph_ms(
                        at, launches=20, replays=5))
            print(json.dumps(row), flush=True)
            out["rows"].append(row)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
