#!/usr/bin/env python3
"""Time some routes' kernels of another commit beside this checkout's, on
one GPU, in one process.

    git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/parent/flash_attention.cu
    git show <commit>:src/repro_torch/kernels/csrc/moe_gmm.cu \\
        > build/parent/moe_gmm.cu
    python3 probe_parent_kernels.py --parent build/parent
    python3 probe_parent_kernels.py --parent build/parent --routes gmm_tc

``--routes`` (default ``general``) names the attention and grouped-matmul
routes to probe; the sources of those routes (``chip_smoke.ATTN_SOURCES``,
``GMM_SOURCES``) are the ones taken from ``--parent``, and must keep the
C entry points of ``kernels/_build.py``'s ``SIGNATURES``.  The parent's
sources build into ``build/repro_torch/`` beside this checkout's, and the
wrappers' ``_build.load`` is swapped for one that hands out either
library.  The cases are ``chip_smoke``'s (``ATTN_CASES``, ``GMM_CASES``,
with its seeds and inputs) that take one of the routes; each runs with
the parent's library, this checkout's, this checkout's again and the
parent's (``chip_smoke.graph_ms``: device time per call in CUDA-graph
replay).  With ``general`` among the routes, so does hubert-xlarge's
encoder forward as phase 10 sets it up (``chip_smoke.hubert_inputs``: 8
clips of 1500 frames, bf16, seeded weights; ``Model.forward`` then
``logits_fn``: the median of 3 forwards after a warm-up, host clock),
its attention kept on the general route
(``chip_smoke.bf16_prefill_on_general``; its bf16 calls take
``prefill_tc`` otherwise).
Each kernel's result is held against the plain version
(``chip_smoke.MODEL_TOL``: a miss is reported, not raised), and the two
kernels' hubert logits against each other (their largest difference, a
share of the largest logit).  Prints the card's name and power limit,
then one JSON line of the times and errors.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build_parent(src: Path) -> ctypes.CDLL:
    """``src`` built with this checkout's nvcc flags, its entry points
    typed as ``_build.SIGNATURES`` types the checkout's source of the same
    name."""
    from repro_torch.kernels import _build
    key = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"lib{src.stem}_parent_{key}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES[src.stem].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with the other commit's sources of "
                         "the probed routes")
    ap.add_argument("--routes", nargs="+", default=["general"],
                    help="attention and grouped-matmul routes to probe")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, moe_gmm, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    routes = set(args.routes)
    sources = ({cs.ATTN_SOURCES[r] for r in routes & set(cs.ATTN_SOURCES)}
               | {cs.GMM_SOURCES[r] for r in routes & set(cs.GMM_SOURCES)})
    mine = {n: _build.load(n) for n in sorted(sources)}
    parent = {n: build_parent(args.parent / f"{n}.cu") for n in mine}
    real_load = _build.load
    libs = {"mine": mine, "parent": parent}
    use = {"which": "mine"}

    def load(name):
        return libs[use["which"]].get(name) or real_load(name)
    _build.load = load
    card = cs.card_line()
    print(card, flush=True)
    order = ("parent", "mine", "mine", "parent")
    res: dict = {"card": card, "attention": {}, "gmm": {}}

    def turns(run, plain, tol, n):
        """``run`` timed with each library in ``order`` and held to
        ``plain()``; the last turn's error of each library."""
        want = plain()
        out = {w: [] for w in libs}
        for w in order:
            use["which"] = w
            out[w].append(cs.graph_ms(run, n, 2 if n < 10 else 5))
            ok, err = cs.rel_ok(run(), want, tol)
            out[f"{w}_err"] = [err, ok]
        return out
    # chip_smoke's cases on the probed routes, with its seeds
    for i, case in enumerate(cs.ATTN_CASES):
        for dt in ("bfloat16", "float32"):
            if cs.attention_case_route(case, dt) not in routes:
                continue
            q, k, v, kw = cs.attention_inputs(case, dt, seed=100 + i)
            times = turns(lambda: ops.attention(q, k, v, **kw),
                          lambda: ref.attention_ref(q, k, v, **kw),
                          cs.MODEL_TOL[("attn", dt)], 10)
            res["attention"][f"{case[0]}/{dt[:4]}"] = times
            print(case[0], dt, times, flush=True)
            del q, k, v
    for i, case in enumerate(cs.GMM_CASES):
        name, G, C, D, F = case[:5]
        for dt in ("bfloat16", "float32"):
            if moe_gmm.route(getattr(torch, dt), C, D, F) not in routes:
                continue
            x, w_, fills = cs.gmm_inputs(case, dt, seed=300 + i)
            times = turns(
                lambda: ops.grouped_matmul_aligned(x, w_, C, fills),
                lambda: ref.grouped_matmul_aligned_ref(x, w_, C, fills),
                cs.MODEL_TOL[("gmm", dt)], 10 if C < 64 else 2)
            res["gmm"][f"{name}/{dt[:4]}"] = times
            print(name, dt, times, flush=True)
            del x, w_
    torch.cuda.empty_cache()
    if "general" not in routes:
        print(json.dumps(res), flush=True)
        return 0
    _, frames, model = cs.hubert_inputs(8, 1500)
    fw = {w: [] for w in libs}
    logits = {}
    for w in order:
        use["which"] = w
        with cs.bf16_prefill_on_general():
            logits[w] = cs.encoder_logits(model, frames, "cuda")  # warm-up
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                cs.encoder_logits(model, frames, "cuda")
                runs.append(time.perf_counter() - t0)
        fw[w].append(sorted(runs)[1])
    gap = float((logits["mine"] - logits["parent"]).abs().max())
    scale = float(logits["parent"].abs().max())
    res["hubert_forward_s"] = fw
    res["hubert_logit_gap"] = gap / scale
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
