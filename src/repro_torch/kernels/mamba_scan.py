"""Mamba-1 selective scan on the card: the wrapper of ``csrc/mamba_scan.cu``.

The kernel replaces the JAX package's Pallas ``mamba_scan`` and also takes
the initial state that the JAX ``ops.mamba_scan`` sends to its jnp
reference, so the decode step runs it too (S = 1, the source's step
kernel).  ``ops.mamba_scan`` dispatches here for CUDA tensors;
``ref.mamba_scan_ref`` is the plain version.
"""
from __future__ import annotations

import torch

from . import ops

_DTYPES = (torch.float32, torch.bfloat16)
STATE_SIZES = (1, 2, 4, 8, 16)


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
               init_state: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """u, dt (B, S, di) and Bc, Cc (B, S, N), all f32 or all bf16; A
    (di, N), D (di,) and ``init_state`` (B, di, N) f32; every tensor
    contiguous on one CUDA device.  Returns y (B, S, di) in u's dtype and
    the last state (B, di, N) f32.

    Counts as ``mamba_scan`` without ``init_state`` (the Pallas kernel's
    role), else as ``mamba_step``."""
    from ._build import load
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError("u must be (B, S, di) and A (di, N)")
    B, S, di = u.shape
    N = A.shape[1]
    dev = u.device
    ops.check("u", u, (B, S, di), _DTYPES, dev)
    ops.check("dt", dt, (B, S, di), (u.dtype,), dev)
    ops.check("A", A, (di, N), (torch.float32,), dev)
    ops.check("Bc", Bc, (B, S, N), (u.dtype,), dev)
    ops.check("Cc", Cc, (B, S, N), (u.dtype,), dev)
    ops.check("D", D, (di,), (torch.float32,), dev)
    if init_state is not None:
        ops.check("init_state", init_state, (B, di, N), (torch.float32,), dev)
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not in {STATE_SIZES}")
    if S == 0:
        raise ValueError("the sequence must hold at least one step")
    y = torch.empty((B, S, di), dtype=u.dtype, device=dev)
    last = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    fn = load("mamba_scan").repro_mamba_scan
    with torch.cuda.device(dev):
        err = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bc.data_ptr(),
                 Cc.data_ptr(), D.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), last.data_ptr(), B, S, di, N,
                 int(u.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    ops.launches["mamba_scan" if init_state is None else "mamba_step"] += 1
    return y, last

