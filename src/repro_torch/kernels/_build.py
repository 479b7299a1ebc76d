"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  Libraries go to ``build/repro_torch/`` at the root of the checkout,
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is loaded as it is.  Nothing is built at import: the
first kernel launch builds (``load``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C signatures of the launchers, per source; each returns cudaError_t as int
SIGNATURES = {
    # (rows, pc, out, R, M, stream)
    "gain": {
        "repro_min_cover": (_P, _P, _P, _I, _I, _P),
    },
    # (uncov, lam, masks, mu, colsub, pc, fits, xinc, inc_edges, perm,
    #  bounds, work, scratch, out, n, P, rep, Q, NA, start_pos, resume_p,
    #  maxrep, stream); the find's cooperative grid: (P, rep); an empty
    #  kernel: (grid, block, cooperative, stream)
    "front_find": {
        "repro_front_find": (_P,) * 14 + (_I,) * 8 + (_P,),
        "repro_front_find_grid": (_I, _I),
        "repro_empty_launch": (_I, _I, _I, _P),
    },
    # (q, k, v, o, lse, q_pos, k_pos, B, Sq, Sk, H, KV, hd, hdv, causal,
    #  window, q_off, scale, is_bf16, stream); lse null or (B, H, Sq) f32
    "flash_attention": {
        "repro_flash_attention": (_P,) * 7 + (_I,) * 10 + (_F, _I, _P),
    },
    # (u, dt, A, Bc, Cc, D, init, y, last, B, S, di, N, is_bf16, stream)
    "mamba_scan": {
        "repro_mamba_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _P),
    },
    # (x, w, y, fills, G, C, D, F, is_bf16, decode, stream)
    "moe_gmm": {
        "repro_grouped_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _P),
    },
    # (x, w, y, fills, G, C, D, F, ctas, stream)
    "moe_gmm_tc": {
        "repro_grouped_matmul_tc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    # (q, k, v, o, lse, B, Sq, Sk, H, KV, hd, hdv, causal, window, q_off,
    #  scale, stream); lse null or (B, H, Sq) f32
    "attention_prefill_tc": {
        "repro_attention_prefill_tc": (_P,) * 5 + (_I,) * 10 + (_F, _P),
    },
    # (q, k, v, o, do, lse, dq, dk, dv, delta, B, Sq, Sk, H, KV, hd, hdv,
    #  causal, window, q_off, scale, stream), f32; the report of (hd, hdv)'s
    #  kernels: (hd, hdv, out[9] int32)
    "attention_bwd": {
        "repro_attention_bwd": (_P,) * 10 + (_I,) * 10 + (_F, _P),
        "repro_attention_bwd_report": (_I, _I, _P),
    },
    # (x, w, dy, dx, dw, fills, G, C, D, F, is_bf16, stream); dx or dw
    # null skips its product
    "moe_gmm_bwd": {
        "repro_grouped_matmul_bwd": (_P,) * 6 + (_I,) * 5 + (_P,),
    },
    # (q, k, v, o, do, lse, dq, dk, dv, lse_pad, delta_pad, B, Sq, Sk, H,
    #  KV, hd, hdv, causal, window, q_off, scale, stream)
    "attention_bwd_tc": {
        "repro_attention_bwd_tc": (_P,) * 11 + (_I,) * 10 + (_F, _P),
    },
    # (x, w, dy, dx, dw, fills, G, C, D, F, ctas, stream); dx or dw null
    # skips its product
    "moe_gmm_bwd_tc": {
        "repro_grouped_matmul_bwd_tc": (_P,) * 6 + (_I,) * 5 + (_P,),
    },
    # (u, dt, A, Bc, Cc, D, dy, du, ddt, dA, dBc, dCc, dD, ckpt, cumdt,
    #  hend, gsum, dtsum, part, dA_part, dD_part, B, S, di, N, chunk,
    #  seg_len, is_bf16, stream); the scratch as
    #  ``mamba_scan.bwd_plan`` shapes it
    "mamba_scan_bwd": {
        "repro_mamba_scan_bwd": (_P,) * 21 + (_I,) * 7 + (_P,),
    },
    # (g, m, v, master, p, scalars, n, g_bf16, m_bf16, p_bf16, b1, 1 - b1,
    #  b2, 1 - b2, eps, weight_decay, stream); scalars 4 f32 on the device
    "adamw": {
        "repro_adamw": (_P,) * 6 + (_LL, _I, _I, _I) + (_F,) * 6 + (_P,),
    },
    # the fused elementwise kernels: rmsnorm (x, w, y, R, D, sx, eps,
    # x_bf16, w_bf16, stream), its backward (x, w, dy, dx, dw, part, R, D,
    # sx, tx, ty, band, eps, x_bf16, w_bf16, stream); rope (x, pos,
    # freqs, out, B, S, H, half, sxb, sxs, sxh, spb, sps, negate, is_bf16,
    # stream); the conv (u, w, b, state_in, y, state_out, B, S, di, K, sub,
    # sus, chunk, is_bf16, stream), its backward (u, w, b, dy, du, dw, db,
    # part, B, S, di, K, sub, sus, steps, parts, is_bf16, stream); the gate
    # (g, u, y, R, D, sg, su, is_bf16, stream), its backward (g, u, dy, dg,
    # du, R, D, sg, su, is_bf16, stream)
    "fused": {
        "repro_rmsnorm": (_P, _P, _P, _LL, _I, _LL, _F, _I, _I, _P),
        "repro_rmsnorm_bwd": (_P,) * 6 + (_LL, _I, _LL, _I, _I, _I, _F, _I,
                                          _I, _P),
        "repro_rope": (_P,) * 4 + (_I,) * 4 + (_LL,) * 5 + (_I, _I, _P),
        "repro_causal_conv": (_P,) * 6 + (_I,) * 4 + (_LL, _LL, _I, _I, _P),
        "repro_causal_conv_bwd": (_P,) * 8 + (_I,) * 4 + (_LL, _LL, _I, _I,
                                                          _I, _P),
        "repro_silu_gate": (_P, _P, _P, _LL, _I, _LL, _LL, _I, _P),
        "repro_silu_gate_bwd": (_P,) * 5 + (_LL, _I, _LL, _LL, _I, _P),
    },
    # (q, k, v, o, q_pos, k_pos, ws, B, Sq, Sk, H, KV, hd, hdv, causal,
    #  window, scale, is_bf16, splits, chunk, stream)
    "attention_decode": {
        "repro_attention_decode_split": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                         _I, _I, _P),
    },
}
# sources built with ``-Xptxas -v``: ptxas reports each kernel's registers,
# shared memory and spills, kept per source in ``build_log``
PTXAS_REPORT = ("flash_attention", "attention_prefill_tc", "attention_decode",
                "moe_gmm_tc", "moe_gmm", "front_find", "mamba_scan",
                "attention_bwd", "mamba_scan_bwd", "moe_gmm_bwd",
                "attention_bwd_tc", "moe_gmm_bwd_tc", "adamw", "fused")
build_log: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + (("-Xptxas", "-v") if name in PTXAS_REPORT else ())


def _lib_path(name: str) -> Path:
    # the shared headers go into every source's key: an edited header
    # rebuilds the sources that may include it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(_flags(name)).encode()
    key = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    out = _lib_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {out.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            build_log[name] = proc.stdout + proc.stderr
            os.replace(tmp, out)   # atomic: a concurrent loader sees all
        finally:
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib
