#!/usr/bin/env python3
"""Where the scan backward's time goes: timing probes of
``csrc/mamba_scan_bwd.cu`` on one GPU, in one process.

    python3 probe_scan_bwd.py

Each probe is a copy of the source with one part of the work cut out
(``PROBES``: the exps, the dBc/dCc butterfly, both, pass 2's output pass,
its walk), built beside the checkout's own library and launched through
``mamba_scan.mamba_scan_bwd`` in its place.  The probes' gradients are
wrong: they exist only here, never on the training path.  At
``chip_smoke.BWD_SCAN_CASE`` with ``check_scan_bwd``'s inputs, in bf16
and f32, each build's call is timed in CUDA-graph replay
(``chip_smoke.graph_ms``) and split by pass under ``torch.profiler``
(``chip_smoke.kernel_split_ms``); the checkout's own build runs first
and last, and once at each segment length of ``SEGMENTS`` beside the
plan's.  A cut that no longer matches the source raises.  Prints the
card's name and power limit, then one JSON line of the times.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEGMENTS = (128, 512, 2048)    # steps, beside the plan's

# the cuts of each probe: (start, end, text) puts ``text`` in place of the
# source from the first ``start`` up to the first ``end`` after it
NO_EXPS = ("  return 0.5f * ex2(fmaf(dt, a2, 1.f));", "\n}",
           "  return 0.5f * __saturatef(fmaf(dt, a2, 1.f));")
NO_BUTTERFLY = ("  constexpr int kLevels = log2i(V), kAll = log2i(32 / G);",
                "\n}\n",
                "  float x = 0.f;\n#pragma unroll\n"
                "  for (int i = 0; i < V; ++i) x += v[i];\n  return x;")
NO_OUTPUT_PASS = ("    // du and ddt: each channel's sums over its G lanes",
                  "  }\n  const size_t o = (static_cast<size_t>(b) * a.nseg",
                  "")
NO_WALK = ("    // the walk back:",
           "    __syncthreads();   // every warp's sums of the chunk",
           "#pragma unroll\n    for (int e = 0; e < KC; ++e)\n#pragma unroll\n"
           "      for (int k = 0; k < K; ++k)\n"
           "        dA[e][k] += H[kT][e][k] + Dc[0][e][k];\n")
PROBES = {"no_exps": (NO_EXPS,), "no_butterfly": (NO_BUTTERFLY,),
          "neither": (NO_EXPS, NO_BUTTERFLY),
          "no_output_pass": (NO_OUTPUT_PASS,), "no_walk": (NO_WALK,)}


def cut(src: str, start: str, end: str, text: str) -> str:
    if src.count(start) != 1:
        raise ValueError(f"probe cut: {start!r} is not in the source once")
    i = src.index(start)
    j = src.find(end, i + len(start))
    if j < 0:
        raise ValueError(f"probe cut: no {end!r} after {start!r}")
    return src[:i] + text + src[j:]


def build_probe(name: str, cuts: tuple) -> ctypes.CDLL:
    """The source with ``cuts`` made, built with the checkout's nvcc flags
    and typed as ``_build.SIGNATURES`` types it."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "mamba_scan_bwd.cu").read_text()
    for c in cuts:
        src = cut(src, *c)
    key = hashlib.sha256(src.encode()).hexdigest()[:16]
    stem = f"mamba_scan_bwd_probe_{name}_{key}"
    out = _build.BUILD_DIR / f"lib{stem}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = _build.BUILD_DIR / f"{stem}.cu"
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", str(out), str(cu)],
                       check=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES["mamba_scan_bwd"].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_scan as ms
    card = cs.card_line()
    print(card, flush=True)
    with ThreadPoolExecutor(len(PROBES) + 1) as pool:
        mine = pool.submit(_build.load, "mamba_scan_bwd")
        probes = dict(zip(PROBES, pool.map(lambda kv: build_probe(*kv),
                                           PROBES.items())))
    libs = {"mine": mine.result(), **probes}
    real_load = _build.load
    use = {"which": "mine"}

    def load(name):
        return libs[use["which"]] if name == "mamba_scan_bwd" \
            else real_load(name)
    _build.load = load
    B, S, di, N = cs.BWD_SCAN_CASE
    res: dict = {"card": card, "shape": [B, S, di, N],
                 "segment_steps": ms.bwd_plan(B, S, di, N)["seg_len"]}
    for dname in ("bfloat16", "float32"):
        ins, dy = cs.scan_bwd_inputs(dname, 500)

        def run(**kw):
            return ms.mamba_scan_bwd(*ins, dy, **kw)
        out = {}
        for w in ("mine", *PROBES, "mine_again"):
            use["which"] = "mine" if w == "mine_again" else w
            out[w] = {"ms": cs.sig(cs.graph_ms(run, 3, 3)),
                      "pass_ms": cs.kernel_split_ms(run, cs.SCAN_BWD_PASSES,
                                                    10)}
            print(dname, w, out[w], flush=True)
        use["which"] = "mine"
        out["segment_ms"] = {L: cs.sig(cs.graph_ms(
            lambda: run(segment=L), 3, 3)) for L in SEGMENTS}
        print(dname, "segments", out["segment_ms"], flush=True)
        res[dname] = out
        del ins, dy
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
