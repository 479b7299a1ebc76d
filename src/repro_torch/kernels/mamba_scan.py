"""Mamba-1 selective scan on the card: the wrapper of ``csrc/mamba_scan.cu``.

The kernel replaces the JAX package's Pallas ``mamba_scan`` and also takes
the initial state that the JAX ``ops.mamba_scan`` sends to its jnp
reference, so the decode step runs it too (S = 1, the source's step
kernel).  ``ops.mamba_scan`` dispatches here for CUDA tensors;
``ref.mamba_scan_ref`` is the plain version.

Training: ``mamba_scan_train`` runs the scan from zeros through
``_MambaScan``, an autograd Function whose backward is
``csrc/mamba_scan_bwd.cu`` (``mamba_scan_bwd``), which cuts the sequence
into segments that run in parallel (``bwd_plan``);
``ref.mamba_scan_bwd_ref`` is its plain version, segments and all.  The
scan from a state has no backward.

On meta tensors (``ops``: the dry run) ``mamba_scan`` and
``mamba_scan_bwd`` check the call and allocate its outputs (and the
backward's scratch), launch nothing, and count the FLOPs and bytes of its
bound (``scan_cost``) in ``ops.meta_cost``.
"""
from __future__ import annotations

import torch

from . import ops

_DTYPES = (torch.float32, torch.bfloat16)
STATE_SIZES = (1, 2, 4, 8, 16)
BWD_CHUNK = 8      # steps between the backward's checkpoints (its kT)
BWD_CHANNELS = 32  # channels of a block of the backward's passes
# blocks of the backward's pass 2 that the segment count aims at: about
# six waves of the four blocks an SM holds at N = 16 (128 registers a
# thread), so hymba's (4, 2048, 3200, 16) runs 8 segments of 256 steps,
# 3,200 blocks
BWD_TARGET_BLOCKS = 3200
# the bound's arithmetic per (t, d, n): FMA-pipe instructions and exps of
# the forward (dt * A, dt * u * B, the state's FMA, its product with C) and
# of the backward (a forward recurrence for the states and the reverse
# walk); an FMA counts as 2 FLOPs, an exp as 1
SCAN_FMA, SCAN_EXP = 4, 1
SCAN_BWD_FMA, SCAN_BWD_EXP = 13, 2


def scan_cost(esize: int, B: int, S: int, di: int, N: int, state: bool,
              backward: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of the scan's bound.  Forward: u, dt and y once, Bc
    and Cc once, A, D and the state(s) once (f32).  Backward: u, dt, dy,
    du and ddt once, Bc, Cc, dBc and dCc once, A, dA, D and dD once."""
    elems = B * S * di * N
    if backward:
        flops = (2 * SCAN_BWD_FMA + SCAN_BWD_EXP) * elems
        nbytes = (esize * (5 * B * S * di + 4 * B * S * N)
                  + 4 * (2 * di * N + 2 * di))
    else:
        flops = (2 * SCAN_FMA + SCAN_EXP) * elems
        nbytes = (esize * (3 * B * S * di + 2 * B * S * N)
                  + 4 * (di * N + di + B * di * N * (2 if state else 1)))
    return flops, nbytes


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
    if dev.type == "meta":
        ops.add_meta_cost("mamba_scan" if init_state is None
                          else "mamba_step",
                          *scan_cost(u.element_size(), B, S, di, N,
                                     init_state is not None))
        return y, last
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


def bwd_plan(B: int, S: int, di: int, N: int,
             segment: int | None = None) -> dict:
    """How ``mamba_scan_bwd`` cuts the sequence, and its scratch.

    The kernel's two passes run one block per (channel block, batch row,
    segment); the segment count aims at ``BWD_TARGET_BLOCKS`` blocks of
    pass 2, each segment a whole number of ``BWD_CHUNK``-step chunks, at
    most one segment per chunk.  ``segment`` (steps, a multiple of
    ``BWD_CHUNK``) sets the segments' length instead.  Returns ``seg_len``
    (steps), ``nseg`` and ``shapes``: the f32 scratch tensors by name, in
    the launcher's order."""
    chunks = -(-S // BWD_CHUNK)
    nblk = -(-di // BWD_CHANNELS)
    if segment is None:
        want = -(-BWD_TARGET_BLOCKS // (nblk * B))
        seg_len = -(-chunks // min(chunks, want)) * BWD_CHUNK
    elif segment > 0 and segment % BWD_CHUNK == 0:
        seg_len = segment
    else:
        raise ValueError(f"a segment of {segment} steps is not a positive "
                         f"multiple of {BWD_CHUNK}")
    nseg = -(-S // seg_len)
    shapes = {"ckpt": (B, chunks, di, N), "cumdt": (B, chunks, di),
              "hend": (B, nseg, di, N), "gsum": (B, nseg, di, N),
              "dtsum": (B, nseg, di), "part": (nblk, B, S, 2 * N),
              "dA_part": (B, nseg, di, N), "dD_part": (B, nseg, di)}
    return {"seg_len": seg_len, "nseg": nseg, "shapes": shapes}


def mamba_scan_bwd(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                   dy: torch.Tensor, *, segment: int | None = None) -> tuple:
    """The gradients (du, ddt, dA, dBc, dCc, dD) of the scan from zeros,
    ``y`` (B, S, di) given ``dy``: inputs as ``mamba_scan`` takes them
    (no ``init_state``), ``dy`` in u's dtype.  du, ddt, dBc and dCc come
    out in u's dtype, dA and dD in f32.  Deterministic: the sums over
    channels, segments and batch rows run in a fixed order.  Counts as
    ``mamba_scan_bwd``.

    ``segment`` sets the segments' length (``bwd_plan``)."""
    from ._build import load
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError("u must be (B, S, di) and A (di, N)")
    B, S, di = u.shape
    N = A.shape[1]
    dev = u.device
    ops.check("u", u, (B, S, di), _DTYPES, dev)
    for name, t, shape in (("dt", dt, (B, S, di)), ("Bc", Bc, (B, S, N)),
                           ("Cc", Cc, (B, S, N)), ("dy", dy, (B, S, di))):
        ops.check(name, t, shape, (u.dtype,), dev)
    ops.check("A", A, (di, N), (torch.float32,), dev)
    ops.check("D", D, (di,), (torch.float32,), dev)
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not in {STATE_SIZES}")
    if S == 0:
        raise ValueError("the sequence must hold at least one step")
    plan = bwd_plan(B, S, di, N, segment)
    scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in plan["shapes"].values()]
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dBc, dCc = torch.empty_like(Bc), torch.empty_like(Cc)
    dA = torch.empty((di, N), dtype=torch.float32, device=dev)
    dD = torch.empty((di,), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        ops.add_meta_cost("mamba_scan_bwd", *scan_cost(
            u.element_size(), B, S, di, N, False, backward=True))
        return du, ddt, dA, dBc, dCc, dD
    with torch.cuda.device(dev):
        err = load("mamba_scan_bwd").repro_mamba_scan_bwd(
            *(t.data_ptr() for t in (u, dt, A, Bc, Cc, D, dy, du, ddt, dA,
                                     dBc, dCc, dD)),
            *(t.data_ptr() for t in scratch),
            B, S, di, N, BWD_CHUNK, plan["seg_len"],
            int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan backward launch failed: CUDA error "
                           f"{err}")
    ops.launches["mamba_scan_bwd"] += 1
    return du, ddt, dA, dBc, dCc, dD


class _MambaScan(torch.autograd.Function):
    """``mamba_scan`` from zeros forward, ``mamba_scan_bwd`` backward; the
    last state is an output without a gradient."""

    @staticmethod
    def forward(ctx, u, dt, A, Bc, Cc, D):
        y, last = mamba_scan(u, dt, A, Bc, Cc, D)
        ctx.save_for_backward(u, dt, A, Bc, Cc, D)
        ctx.mark_non_differentiable(last)
        ctx.set_materialize_grads(False)
        return y, last

    @staticmethod
    def backward(ctx, dy, dlast):
        if dlast is not None:
            raise RuntimeError("the scan's last state has no gradient")
        if dy is None:
            return (None,) * 6
        return mamba_scan_bwd(*ctx.saved_tensors, dy.contiguous())


def mamba_scan_train(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mamba_scan`` from zeros with a gradient: (y, last state)."""
    return _MambaScan.apply(u, dt, A, Bc, Cc, D)
