#!/usr/bin/env python3
"""Where the f32 attention backward's time goes: ``csrc/attention_bwd.cu``
(route ``general``) timed kernel by kernel (dq, dkv) beside another
source of it and beside variants of its tiles, on one GPU, in one process.

    mkdir -p build/other
    git show <commit>:src/repro_torch/kernels/csrc/attention_bwd.cu \\
        > build/other/attention_bwd.cu
    python3 probe_attention_bwd.py --other build/other [--abi first] \\
        [--tiles "w1=32;1;HD == 80 ? 16 : 32;1"] [--cases deepseek]

``--abi`` says how the other source's launcher is called: ``checkout``
(the default) as the checkout's is, ``first`` as the first design's was
(it recomputed the LSE into scratch of its own, ``(q, k, v, o, do, dq,
dk, dv, lse, delta, ..., scale, is_bf16, stream)``).  ``--tiles``
builds copies of the checkout's source with its ``Tiles`` set to
``BK;WQ;BQ;WKV`` (each a C++ expression in the head dims HD, HDV: dq's
keys a tile and warps a 16-row strip, dkv's queries a tile and warps a
strip).

The cases are the f32 training calls of phases 13a-16a and 20k: hymba's
windowed and global (4, 2048², 25/5, 64), olmoe's (4, 2048², 16/16,
128), deepseek's MLA (4, 2048², 128/128, 192/128), hubert's non-causal
(8, 1500², 16/16, 80) and rank 1's (8, 2048 x 4096, 9/3, 64) at
``q_off`` 2048.  Each build is held to ``attention_bwd_ref`` on the
first batch element (``chip_smoke.GRAD_TOL``: a miss is reported, not
raised) and to itself over two calls (bit-equal), timed in CUDA-graph
replay in turns (other, checkout, variants..., checkout, other) and
split by launch under ``torch.profiler`` (``chip_smoke.kernel_split_ms``).
Every build is compiled with ``-Xptxas -v``, whose report of each kernel
(registers, spills) is printed, with each kernel's blocks an SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.  Prints the card's
name and power limit, a JSON line a case, then one JSON line of them all.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the first design's launcher, and a report appended to its source: its
# f32 kernels' blocks an SM, registers and local bytes
FIRST = (_P,) * 10 + (_I,) * 10 + (_F, _I, _P)
FIRST_REPORT = r"""
template <int HD, int HDV>
int probe_report(int* out) {
  constexpr int BK = 32, BQ = HD == 64 ? 32 : 16;
  using Q = DqCfg<float, HD, HDV, BK>;
  using KVc = DkvCfg<float, HD, HDV, BQ>;
  auto dq = dq_kernel<float, HD, HDV, BK>;
  auto dkv = dkv_kernel<float, HD, HDV, BQ>;
  cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(Q::kBytes));
  cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(KVc::kBytes));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, dq, kThreads, Q::kBytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, dkv, kThreads,
                                                KVc::kBytes);
  cudaFuncAttributes fa{}, fb{};
  cudaFuncGetAttributes(&fa, dq);
  cudaFuncGetAttributes(&fb, dkv);
  out[2] = fa.numRegs; out[3] = fb.numRegs;
  out[4] = static_cast<int>(fa.localSizeBytes);
  out[5] = static_cast<int>(fb.localSizeBytes);
  out[6] = BK; out[7] = BQ; out[8] = 1; out[9] = 1;
  return static_cast<int>(cudaGetLastError());
}
}  // namespace
extern "C" int repro_attention_bwd_report(int hd, int hd_v, int* out) {
  if (hd == 64) return probe_report<64, 64>(out);
  if (hd == 80) return probe_report<80, 80>(out);
  if (hd == 128) return probe_report<128, 128>(out);
  return probe_report<192, 128>(out);
}
"""
# (name, B, Sq, Sk, H, KV, hd, hd_v, causal, window, q_off)
CASES = [("hymba_window", 4, 2048, 2048, 25, 5, 64, 64, True, 1024, 0),
         ("hymba_global", 4, 2048, 2048, 25, 5, 64, 64, True, 0, 0),
         ("olmoe", 4, 2048, 2048, 16, 16, 128, 128, True, 0, 0),
         ("deepseek", 4, 2048, 2048, 128, 128, 192, 128, True, 0, 0),
         ("hubert", 8, 1500, 1500, 16, 16, 80, 80, False, 0, 0),
         ("rank1", 8, 2048, 4096, 9, 3, 64, 64, True, 0, 2048)]
TILES = re.compile(r"struct Tiles \{\n.*?\n\};", re.S)


def tiles_source(bk: str, wq: str, bq: str, wkv: str) -> str:
    """The checkout's source with its ``Tiles`` set (C++ expressions)."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "attention_bwd.cu").read_text()
    new = (f"struct Tiles {{\n  static constexpr int BK = {bk};\n"
           f"  static constexpr int WQ = {wq};\n"
           f"  static constexpr int BQ = {bq};\n"
           f"  static constexpr int WKV = {wkv};\n}};")
    out, n = TILES.subn(new, src)
    if n != 1:
        raise RuntimeError("attention_bwd.cu: no Tiles struct to set")
    return out


def build(src: str, tag: str) -> tuple[ctypes.CDLL, str]:
    """``src`` built with the checkout's nvcc flags and ``-Xptxas -v``:
    the library and ptxas's report."""
    from repro_torch.kernels import _build
    key = hashlib.sha256(src.encode()).hexdigest()[:16]
    d = _build.BUILD_DIR / "probe"
    d.mkdir(parents=True, exist_ok=True)
    path, out = d / f"attention_bwd_{tag}.cu", d / f"lib_{tag}_{key}.so"
    path.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", f"-I{_build.CSRC}", "-o", str(out),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def report(lib, hd: int, hd_v: int) -> dict:
    out = (ctypes.c_int * 10)()
    err = lib.repro_attention_bwd_report(hd, hd_v, out)
    keys = ("dq_blocks_per_sm", "dkv_blocks_per_sm", "dq_regs", "dkv_regs",
            "dq_local_bytes", "dkv_local_bytes", "BK", "BQ", "WQ", "WKV")
    return {"err": err, **dict(zip(keys, list(out)))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, default=None,
                    help="directory with the other source's attention_bwd.cu")
    ap.add_argument("--abi", choices=("checkout", "first"),
                    default="checkout")
    ap.add_argument("--tiles", nargs="*", default=[],
                    help="variants NAME=BK;WQ;BQ;WKV of the checkout")
    ap.add_argument("--cases", nargs="*", default=[c[0] for c in CASES])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa

    print(cs.card_line(), flush=True)
    first = args.abi == "first"
    srcs = {}
    if args.other is not None:
        other = (args.other / "attention_bwd.cu").read_text()
        if first:
            other = other.replace("}  // namespace\n", FIRST_REPORT, 1)
        srcs["other"] = other
    srcs["checkout"] = (_build.CSRC / "attention_bwd.cu").read_text()
    for spec in args.tiles:
        name, vals = spec.split("=", 1)
        srcs[name] = tiles_source(*vals.split(";"))
    _build.load("flash_attention")
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: build(kv[1], kv[0]),
                                        srcs.items())))
    libs = {}
    out: dict = {"card": cs.card_line(), "abi": args.abi, "ptxas": {},
                 "rows": []}
    for name, (lib, log) in built.items():
        sig = FIRST if first and name == "other" else \
            _build.SIGNATURES["attention_bwd"]["repro_attention_bwd"]
        lib.repro_attention_bwd.argtypes = list(sig)
        lib.repro_attention_bwd.restype = ctypes.c_int
        lib.repro_attention_bwd_report.argtypes = [_I, _I, _P]
        libs[name] = lib
        out["ptxas"][name] = [s for s in cs.ptxas_summary(log)
                              if "float" in s or "dq_kernel" in s
                              or "dkv_kernel" in s]
        for line in out["ptxas"][name]:
            print(f"ptxas {name}: {line}", flush=True)
    order = ["other"] if "other" in libs else []
    order += ["checkout", *[n for n in libs if n not in ("other",
                                                         "checkout")]]
    turns = order + order[::-1]
    for case in CASES:
        name, B, Sq, Sk, H, KV, hd, hd_v, causal, window, q_off = case
        if name not in args.cases:
            continue
        g = torch.Generator(device="cuda").manual_seed(len(name))
        q = torch.randn((B, Sq, H, hd), generator=g, device="cuda")
        k = torch.randn((B, Sk, KV, hd), generator=g, device="cuda")
        v = torch.randn((B, Sk, KV, hd_v), generator=g, device="cuda")
        do = torch.randn((B, Sq, H, hd_v), generator=g, device="cuda")
        scale = hd ** -0.5
        kw = dict(causal=causal, window=window, q_off=q_off)
        with torch.no_grad():
            o, lse = fa.flash_attention(q, k, v, scale=scale,
                                        return_lse=True, **kw)
        want = ref.attention_bwd_ref(q[:1], k[:1], v[:1], o[:1], do[:1],
                                     scale=scale, lse=lse[:1], **kw)
        lse_err = float((lse[:1] - ref.attention_lse_ref(
            q[:1], k[:1], scale=scale, **kw)).abs().max())
        outs = [torch.empty_like(t) for t in (q, k, v)]
        scratch = torch.empty((2, B, H, Sq), device="cuda")
        stream = torch.cuda.current_stream

        def call(lib, old):
            ptrs = [t.data_ptr() for t in (q, k, v, o, do)]
            if old:
                err = lib.repro_attention_bwd(
                    *ptrs, *(t.data_ptr() for t in outs),
                    scratch[0].data_ptr(), scratch[1].data_ptr(), B, Sq, Sk,
                    H, KV, hd, hd_v, int(causal), window, q_off, scale, 0,
                    stream().cuda_stream)
            else:
                err = lib.repro_attention_bwd(
                    *ptrs, lse.data_ptr(), *(t.data_ptr() for t in outs),
                    scratch[1].data_ptr(), B, Sq, Sk, H, KV, hd, hd_v,
                    int(causal), window, q_off, scale, stream().cuda_stream)
            if err:
                raise RuntimeError(f"attention_bwd: CUDA error {err}")
        fns = {n: (lambda lib=lib, old=first and n == "other": call(lib, old))
               for n, lib in libs.items()}
        row = {"case": name, "shape": [B, Sq, Sk, H, KV, hd, hd_v],
               "causal": causal, "window": window, "q_off": q_off,
               "pairs": B * fa.live_pairs(Sq, Sk, causal, window, q_off),
               "lse_err": cs.sig(lse_err)}
        flops, nbytes = fa.attention_bwd_cost(4, B, Sq, Sk, H, KV, hd, hd_v,
                                              causal, window, q_off)
        row["bound_ms"] = cs.sig(max(flops / cs.F32_TC_FLOPS_PER_S,
                                     nbytes / cs.HBM_BYTES_PER_S) * 1e3)
        reps = 2 if name == "deepseek" else 5
        for n, f in fns.items():
            f()
            one = [t.clone() for t in outs]
            f()
            torch.cuda.synchronize()
            gaps = [cs.grad_gap(a[:1], b) for a, b in zip(outs, want)]
            rep = report(libs[n], hd, hd_v)
            row[n] = {"err": cs.sig(max(gaps)),
                      "repeats_bits": all(torch.equal(a, b)
                                          for a, b in zip(one, outs)),
                      **{k_: v_ for k_, v_ in rep.items() if k_ != "err"}}
            if not max(gaps) <= cs.GRAD_TOL["float32"]:
                print(f"MISS {name} {n}: {gaps}", flush=True)
            del one
        times: dict = {}
        for n in turns:
            times.setdefault(n, []).append(cs.graph_ms(fns[n], reps, 2))
        for n, ts in times.items():
            row[n]["ms"] = [cs.sig(t) for t in ts]
            row[n]["split_ms"] = cs.kernel_split_ms(
                fns[n], {"dq": "dq_kernel", "dkv": "dkv_kernel"}, reps)
        print(json.dumps(row), flush=True)
        out["rows"].append(row)
        del q, k, v, o, do, lse, want, outs, scratch
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
