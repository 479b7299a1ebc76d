"""The layers' elementwise ops on the card: the wrappers of
``csrc/fused.cu``.

The kernels replace no TPU kernel: the JAX package writes rmsnorm, rope,
the Mamba mixer's causal depthwise conv with its bias and SiLU, and the SiLU
gate as jnp that XLA fuses into its jitted steps, and these are those
fusions, a forward and a backward kernel each.  ``ops.rmsnorm``,
``ops.rope``, ``ops.causal_conv`` and ``ops.silu_gate`` dispatch here for
CUDA (and meta) tensors; ``ref.rmsnorm_ref``, ``ref.rope_ref``,
``ref.causal_conv_ref`` and ``ref.silu_gate_ref`` are the plain versions,
``ref.*_bwd_ref`` the backwards written out.

Each op has a forward wrapper (``rmsnorm``, ``rope``, ``causal_conv``,
``silu_gate``), a backward wrapper (``*_bwd``) and an autograd Function
around the two (``*_train``).  The wrappers check their inputs, allocate
outputs and scratch, launch through one small function each (``_launch_*``:
the tests put the plain versions in their place) and count the launch in
``ops.launches`` under the op's name, the backward under ``<name>_bwd``.
Inputs may be views whose last dim is contiguous: rmsnorm's and the gate's
rows and the conv's positions with a stride of their own (MLA's latent
part of ``wkv_a``'s output, the mixer's halves of ``in_proj``'s), rope's
four strides (MLA's rope parts); outputs are contiguous.

On meta tensors (``ops``: the dry run) the wrappers check the call, allocate
on the meta device what the launch would, launch nothing and count each
call's bytes (``*_cost``: each input read once, each output written once;
no tensor-core work) in ``ops.meta_cost``.
"""
from __future__ import annotations

import functools

import torch

from . import ops, ref

_DTYPES = (torch.float32, torch.bfloat16)
CONV_TAPS = (2, 3, 4)  # the conv widths the kernels are built for
# the conv from zeros and its backward (``conv_fwd_plan``,
# ``conv_bwd_plan``): a tile of CONV_CY chunks of CONV_FWD_STEPS or
# CONV_STEPS steps (csrc/fused.cu's CONV_CY; its launchers refuse a chunk
# that is not whole slots, and the backward's a plan whose parts do not
# match)
CONV_FWD_STEPS = 16    # steps a warp of the forward walks: a chunk
CONV_STEPS = 32        # steps a warp of the backward walks
CONV_CY = 8            # chunks a block
CONV_CW = 64           # channels a block
# rmsnorm's backward (``norm_bwd_plan``; csrc/fused.cu's launcher refuses
# a plan whose groups do not hold a row or fit a block)
NORM_H = 16            # elements of a row a thread holds
NORM_MAX_TX = 512      # threads a block at most: D up to 8192
NORM_BLOCK = {2: 512, 4: 256}   # threads a block of narrower rows, by
#                                 x's element bytes
NORM_BANDS = 256       # about this many bands of rows (dw's partial sums)

# rope's frequencies, as the plain expression computes them, per (half,
# theta, device): made once, outside any captured step's first call
_FREQS: dict = {}


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _call(fn: str, dev: torch.device, *args) -> None:
    """``csrc/fused.cu``'s launcher ``fn`` on ``dev``'s current stream."""
    from ._build import load
    if dev.type != "cuda":
        raise ValueError(f"{fn} takes CUDA tensors, got {dev}")
    with torch.cuda.device(dev):
        err = getattr(load("fused"), fn)(*args, _stream(dev))
    if err:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _on(name: str, t: torch.Tensor, dev: torch.device, dtypes) -> None:
    """``t`` on ``dev`` with one of ``dtypes`` (the launch itself refuses
    a device that is not CUDA)."""
    if t.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {t.device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} must be {names}, got {t.dtype}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., D) as (R, D) rows with a stride of their own and the
    last dim contiguous: a view where one exists, else a copy."""
    t2 = t.reshape(-1, t.shape[-1])
    if t2.shape[1] > 1 and t2.stride(1) != 1:
        t2 = t2.contiguous()
    return t2


# ----------------------------------------------------------------- costs
def rmsnorm_cost(x: torch.Tensor, w: torch.Tensor,
                 backward: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of the bound: forward x read, y written, w read;
    backward x and dy read, dx written, w read and dw written."""
    n, D = x.numel(), x.shape[-1]
    if backward:
        return 0, 3 * n * x.element_size() + 2 * D * w.element_size()
    return 0, 2 * n * x.element_size() + D * w.element_size()


def rope_cost(x: torch.Tensor, pos: torch.Tensor) -> tuple[int, int]:
    """x (or dy) read, the output written, the positions and frequencies
    read."""
    return 0, (2 * x.numel() * x.element_size() + 4 * pos.numel()
               + 2 * x.shape[-1])


def conv_cost(u: torch.Tensor, conv_w: torch.Tensor, state: bool,
              backward: bool = False) -> tuple[int, int]:
    """Forward: u read, u_conv and the new state written (the old one read
    too, from a state), the taps and bias read.  Backward: u and dy read,
    du written, the taps and bias read and their gradients written."""
    B, S, di = u.shape
    K, e = conv_w.shape[0], u.element_size()
    weights = (K + 1) * di * e
    if backward:
        return 0, 3 * B * S * di * e + 2 * weights
    return 0, (2 * B * S * di * e + B * (K - 1) * di * e * (2 if state else 1)
               + weights)


def gate_cost(g: torch.Tensor, backward: bool = False) -> tuple[int, int]:
    """Forward: g and u read, the product written; backward: g, u and dy
    read, dg and du written."""
    return 0, (5 if backward else 3) * g.numel() * g.element_size()


# ----------------------------------------------------------------- plans
@functools.lru_cache(maxsize=None)
def norm_bwd_plan(R: int, D: int, elem: int = 2) -> dict:
    """How ``rmsnorm_bwd`` cuts (R, D) rows of ``elem``-byte elements: a
    row group of ``threads_x`` threads (a multiple of 32, each holding
    ``NORM_H`` elements of a row), ``groups`` of them a block (about
    ``NORM_BLOCK`` threads); a block a band of ``band`` consecutive rows,
    ``parts`` bands (dw's partial sums, the rows of the f32 scratch
    ``part``); ``shared_bytes`` of shared memory a block.  It depends on
    the shape and the dtype alone (whether a thread's elements go four an
    access or one does not change it), never on the card, so dw's
    summation order does not either.  Cached: callers read it only."""
    tx = 32 * -(-D // (32 * NORM_H))
    if tx > NORM_MAX_TX:
        raise ValueError(f"rmsnorm's backward takes D up to "
                         f"{NORM_MAX_TX * NORM_H}, got {D}")
    ty = 1 if tx >= NORM_BLOCK[elem] else NORM_BLOCK[elem] // tx
    rows = max(1, -(-R // NORM_BANDS))
    band = ty * -(-rows // ty)
    return {"threads_x": tx, "groups": ty, "threads": tx * ty,
            "band": band, "parts": max(1, -(-R // band)),
            "shared_bytes": 4 * (4 * ty * (tx // 32) + ty * D)}


@functools.lru_cache(maxsize=None)
def conv_fwd_plan(B: int, S: int, elem: int = 2) -> dict:
    """How ``causal_conv`` from zeros cuts B sequences of S steps of
    ``elem``-byte elements: a warp a chunk of ``steps`` steps (whole 2 KB
    slots of a ``CONV_CW``-channel row: 16 bf16 or 8 f32 steps a slot), a
    block ``CONV_CY`` consecutive chunks (a tile of ``tile_steps``
    steps), ``tiles`` tiles a sequence; ``shared_bytes`` of shared memory
    a block (the warps' rings of two slots of u and three rows of u
    before each chunk, as ``csrc/fused.cu``'s ``conv_fwd_smem`` counts
    them).  16 steps: at hymba's and falcon's shapes the probe
    (``probe_fused_bwd.py --fwd``) found 16-step chunks faster than 32
    with five blocks an SM.  It depends on the shape and the dtype alone;
    from a state (decode) the conv walks the sequence a thread a channel
    group instead.  Cached: callers read it only."""
    slot = 2048 // (CONV_CW * elem)
    tiles = -(-(-(-S // CONV_FWD_STEPS)) // CONV_CY)
    return {"steps": CONV_FWD_STEPS, "tile_steps": CONV_CY * CONV_FWD_STEPS,
            "tiles": tiles,
            "shared_bytes": CONV_CY * CONV_CW * (2 * slot + 3) * elem}


@functools.lru_cache(maxsize=None)
def conv_bwd_plan(B: int, S: int, elem: int = 2) -> dict:
    """How ``causal_conv_bwd`` cuts B sequences of S steps of
    ``elem``-byte elements: a warp a chunk of ``steps`` steps, a block
    ``CONV_CY`` consecutive chunks (a tile of ``tile_steps`` steps) of
    ``CONV_CW`` channels; ``tiles`` tiles a sequence, ``parts`` = B tiles
    partial sums of dw and db (the rows of the f32 scratch ``part``,
    (parts, K + 1, di)); ``shared_bytes`` of shared memory a block (the
    warps' rings of two 2 KB slots of u and of dy, three rows of u before
    and of u and dy after each chunk, and three f32 rows of dv a chunk, as
    ``csrc/fused.cu``'s ``conv_smem`` counts them).  It depends on the
    shape and the dtype alone.  Cached: callers read it only."""
    tiles = -(-(-(-S // CONV_STEPS)) // CONV_CY)
    rows = 2 * 2 * (2048 // (CONV_CW * elem)) + 9
    return {"steps": CONV_STEPS, "tile_steps": CONV_CY * CONV_STEPS,
            "tiles": tiles, "parts": max(1, B * tiles),
            "shared_bytes": CONV_CY * CONV_CW * (rows * elem + 3 * 4)}


# --------------------------------------------------------------- rmsnorm
def _launch_rmsnorm(x2, w, y2, eps: float) -> None:
    R, D = x2.shape
    _call("repro_rmsnorm", x2.device, x2.data_ptr(), w.data_ptr(),
          y2.data_ptr(), R, D, x2.stride(0), eps, _bf16(x2), _bf16(w))


def _launch_rmsnorm_bwd(x2, w, dy2, dx2, dw, part, plan: dict,
                        eps: float) -> None:
    R, D = x2.shape
    _call("repro_rmsnorm_bwd", x2.device, x2.data_ptr(), w.data_ptr(),
          dy2.data_ptr(), dx2.data_ptr(), dw.data_ptr(), part.data_ptr(), R,
          D, x2.stride(0), plan["threads_x"], plan["groups"], plan["band"],
          eps, _bf16(x2), _bf16(w))


def _check_norm(x: torch.Tensor, w: torch.Tensor) -> None:
    dev = x.device
    _on("x", x, dev, _DTYPES)
    _on("w", w, dev, _DTYPES)
    if x.dim() < 1 or tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f"w must be (D,) for x (..., D), got "
                         f"{tuple(w.shape)} for {tuple(x.shape)}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D) bf16 or f32 normed by its rows' root mean square, times
    ``w`` (D,), in f32, rounded once to x's dtype.  Counts as
    ``rmsnorm``."""
    _check_norm(x, w)
    x2 = _rows(x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.is_meta:
        ops.add_meta_cost("rmsnorm", *rmsnorm_cost(x, w))
        return y
    _launch_rmsnorm(x2, w, y.view(x2.shape), eps)
    ops.launches["rmsnorm"] += 1
    return y


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rmsnorm`` given ``dy`` (x's shape and dtype; D up to
    8192) in one pass over x and dy: r recomputed from x, dw summed
    within each band of ``norm_bwd_plan`` and then over the bands, in a
    fixed order.  Counts as ``rmsnorm_bwd``."""
    _check_norm(x, w)
    _on("dy", dy, x.device, (x.dtype,))
    if dy.shape != x.shape:
        raise ValueError(f"dy must have x's shape {tuple(x.shape)}")
    x2 = _rows(x)
    R, D = x2.shape
    dy2 = dy.reshape(R, D).contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty_like(w)
    plan = norm_bwd_plan(R, D, x.element_size())
    part = torch.empty((plan["parts"], D), dtype=torch.float32,
                       device=x.device)
    if x.is_meta:
        ops.add_meta_cost("rmsnorm_bwd", *rmsnorm_cost(x, w, backward=True))
        return dx, dw
    _launch_rmsnorm_bwd(x2, w, dy2, dx.view(R, D), dw, part, plan, eps)
    ops.launches["rmsnorm_bwd"] += 1
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


def rmsnorm_train(x: torch.Tensor, w: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """``rmsnorm`` with a gradient (``rmsnorm_bwd``)."""
    return _RMSNorm.apply(x, w, eps)


# ------------------------------------------------------------------- rope
def rope_freqs(half: int, theta: float, dev: torch.device) -> torch.Tensor:
    """``ref.rope_freqs`` on ``dev``, made once per (half, theta, dev)."""
    key = (half, float(theta), dev)
    if key not in _FREQS:
        _FREQS[key] = ref.rope_freqs(half, theta, dev)
    return _FREQS[key]


def _launch_rope(x, pos, theta: float, out, negate: bool) -> None:
    B, S, H, hd = x.shape
    freqs = rope_freqs(hd // 2, theta, x.device)
    _call("repro_rope", x.device, x.data_ptr(), pos.data_ptr(),
          freqs.data_ptr(), out.data_ptr(), B, S, H, hd // 2, x.stride(0),
          x.stride(1), x.stride(2), pos.stride(0), pos.stride(1),
          int(negate), _bf16(x))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         negate: bool = False) -> torch.Tensor:
    """x (B, S, H, hd) bf16 or f32 (any strides, the last dim contiguous)
    rotated by ``pos`` (B, S) int32 (any strides) times rope's frequencies:
    (B, S, H, hd) contiguous in x's dtype.  ``negate`` rotates by the
    negated angles (the backward).  Counts as ``rope`` (``rope_bwd`` with
    ``negate``)."""
    dev = x.device
    _on("x", x, dev, _DTYPES)
    _on("pos", pos, dev, (torch.int32,))
    if x.dim() != 4 or x.shape[-1] % 2 or tuple(pos.shape) != tuple(
            x.shape[:2]):
        raise ValueError(f"x must be (B, S, H, hd) with hd even and pos "
                         f"(B, S), got {tuple(x.shape)} and "
                         f"{tuple(pos.shape)}")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    name = "rope_bwd" if negate else "rope"
    if x.is_meta:
        ops.add_meta_cost(name, *rope_cost(x, pos))
        return out
    _launch_rope(x, pos, theta, out, negate)
    ops.launches[name] += 1
    return out


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, theta):
        ctx.save_for_backward(pos)
        ctx.theta = theta
        return rope(x, pos, theta)

    @staticmethod
    def backward(ctx, dy):
        pos, = ctx.saved_tensors
        return rope(dy, pos, ctx.theta, negate=True), None, None


def rope_train(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """``rope`` with a gradient: the rotation by the negated angles."""
    return _Rope.apply(x, pos, theta)


# --------------------------------------------------------------- the conv
def _launch_conv(u, conv_w, conv_b, state_in, y, state_out,
                 chunk: int) -> None:
    B, S, di = u.shape
    _call("repro_causal_conv", u.device, u.data_ptr(), conv_w.data_ptr(),
          conv_b.data_ptr(), _ptr(state_in), y.data_ptr(), _ptr(state_out),
          B, S, di, conv_w.shape[0], u.stride(0), u.stride(1), chunk,
          _bf16(u))


def _launch_conv_bwd(u, conv_w, conv_b, dy, du, dw, db, part,
                     plan: dict) -> None:
    B, S, di = u.shape
    _call("repro_causal_conv_bwd", u.device, u.data_ptr(), conv_w.data_ptr(),
          conv_b.data_ptr(), dy.data_ptr(), du.data_ptr(), dw.data_ptr(),
          db.data_ptr(), part.data_ptr(), B, S, di, conv_w.shape[0],
          u.stride(0), u.stride(1), plan["steps"], plan["parts"], _bf16(u))


def _check_conv(u: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor) -> torch.Tensor:
    dev = u.device
    _on("u", u, dev, _DTYPES)
    for name, t in (("conv_w", conv_w), ("conv_b", conv_b)):
        _on(name, t, dev, (u.dtype,))
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u.dim() != 3 or conv_w.dim() != 2 or \
            tuple(conv_b.shape) != (u.shape[2],) or \
            conv_w.shape[1] != u.shape[2]:
        raise ValueError(f"u must be (B, S, di), conv_w (d_conv, di) and "
                         f"conv_b (di,), got {tuple(u.shape)}, "
                         f"{tuple(conv_w.shape)} and {tuple(conv_b.shape)}")
    if conv_w.shape[0] not in CONV_TAPS:
        raise ValueError(f"d_conv {conv_w.shape[0]} not in {CONV_TAPS}")
    if u.shape[2] > 1 and u.stride(2) != 1:
        u = u.contiguous()
    return u


def causal_conv(u: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixer's causal depthwise conv, bias and SiLU: u (B, S, di) bf16
    or f32 (its positions with any stride, channels contiguous), conv_w
    (d_conv, di) and conv_b (di,) in u's dtype; ``state`` (B, d_conv - 1,
    di) contiguous, the inputs before u (decode), written in place with the
    new state.  Returns (u_conv (B, S, di) contiguous, the new state:
    ``state``, or a new tensor).  Counts as ``causal_conv``."""
    u = _check_conv(u, conv_w, conv_b)
    B, S, di = u.shape
    K = conv_w.shape[0]
    dev = u.device
    if state is not None:
        _on("state", state, dev, (u.dtype,))
        if tuple(state.shape) != (B, K - 1, di) or not state.is_contiguous():
            raise ValueError(f"state must be contiguous (B, d_conv - 1, di) "
                             f"= {(B, K - 1, di)}, got {tuple(state.shape)}")
    y = torch.empty((B, S, di), dtype=u.dtype, device=dev)
    new = state if state is not None else torch.empty(
        (B, K - 1, di), dtype=u.dtype, device=dev)
    if u.is_meta:
        ops.add_meta_cost("causal_conv",
                          *conv_cost(u, conv_w, state is not None))
        return y, new
    # from a state one thread walks every step of its channels (the thread
    # that reads the state writes it): no chunk
    chunk = (conv_fwd_plan(B, S, u.element_size())["steps"] if state is None
             else 0)
    _launch_conv(u, conv_w, conv_b, state, y, new, chunk)
    ops.launches["causal_conv"] += 1
    return y, new


def causal_conv_bwd(u: torch.Tensor, conv_w: torch.Tensor,
                    conv_b: torch.Tensor, dy: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(du, dw, db) of ``causal_conv`` from zeros given ``dy`` (B, S, di):
    du contiguous, dw and db summed within each tile of
    ``conv_bwd_plan`` and then over the tiles, in a fixed order.  Counts
    as ``causal_conv_bwd``."""
    u = _check_conv(u, conv_w, conv_b)
    B, S, di = u.shape
    K = conv_w.shape[0]
    _on("dy", dy, u.device, (u.dtype,))
    if tuple(dy.shape) != (B, S, di):
        raise ValueError(f"dy must be {(B, S, di)}, got {tuple(dy.shape)}")
    dy = dy.contiguous()
    du = torch.empty((B, S, di), dtype=u.dtype, device=u.device)
    dw, db = torch.empty_like(conv_w), torch.empty_like(conv_b)
    plan = conv_bwd_plan(B, S, u.element_size())
    part = torch.empty((plan["parts"], K + 1, di), dtype=torch.float32,
                       device=u.device)
    if u.is_meta:
        ops.add_meta_cost("causal_conv_bwd",
                          *conv_cost(u, conv_w, False, backward=True))
        return du, dw, db
    _launch_conv_bwd(u, conv_w, conv_b, dy, du, dw, db, part, plan)
    ops.launches["causal_conv_bwd"] += 1
    return du, dw, db


class _CausalConv(torch.autograd.Function):
    """``causal_conv`` from zeros forward, ``causal_conv_bwd`` backward;
    the new state is an output without a gradient."""

    @staticmethod
    def forward(ctx, u, conv_w, conv_b):
        y, new = causal_conv(u, conv_w, conv_b)
        ctx.save_for_backward(u, conv_w, conv_b)
        ctx.mark_non_differentiable(new)
        ctx.set_materialize_grads(False)
        return y, new

    @staticmethod
    def backward(ctx, dy, dnew):
        if dnew is not None:
            raise RuntimeError("the conv's new state has no gradient")
        if dy is None:
            return None, None, None
        return causal_conv_bwd(*ctx.saved_tensors, dy)


def causal_conv_train(u: torch.Tensor, conv_w: torch.Tensor,
                      conv_b: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``causal_conv`` from zeros with a gradient: (u_conv, new state)."""
    return _CausalConv.apply(u, conv_w, conv_b)


# --------------------------------------------------------------- the gate
def _launch_gate(g2, u2, y2) -> None:
    R, D = g2.shape
    _call("repro_silu_gate", g2.device, g2.data_ptr(), u2.data_ptr(),
          y2.data_ptr(), R, D, g2.stride(0), u2.stride(0), _bf16(g2))


def _launch_gate_bwd(g2, u2, dy2, dg2, du2) -> None:
    R, D = g2.shape
    _call("repro_silu_gate_bwd", g2.device, g2.data_ptr(), u2.data_ptr(),
          dy2.data_ptr(), dg2.data_ptr(), du2.data_ptr(), R, D, g2.stride(0),
          u2.stride(0), _bf16(g2))


def _check_gate(g: torch.Tensor, u: torch.Tensor) -> None:
    _on("g", g, g.device, _DTYPES)
    _on("u", u, g.device, (g.dtype,))
    if g.shape != u.shape or g.dim() < 1:
        raise ValueError(f"g and u must have one shape, got "
                         f"{tuple(g.shape)} and {tuple(u.shape)}")


def silu_gate(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) * u`` for g and u (..., D) of one shape and dtype (bf16
    or f32; rows with strides of their own): SiLU in f32 rounded to the
    dtype, then the product rounded.  Counts as ``silu_gate``."""
    _check_gate(g, u)
    y = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    if g.is_meta:
        ops.add_meta_cost("silu_gate", *gate_cost(g))
        return y
    g2, u2 = _rows(g), _rows(u)
    _launch_gate(g2, u2, y.view(g2.shape))
    ops.launches["silu_gate"] += 1
    return y


def silu_gate_bwd(g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dg, du) of ``silu_gate`` given ``dy``, in one pass.  Counts as
    ``silu_gate_bwd``."""
    _check_gate(g, u)
    _on("dy", dy, g.device, (g.dtype,))
    if dy.shape != g.shape:
        raise ValueError(f"dy must have g's shape {tuple(g.shape)}")
    dg = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    du = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    if g.is_meta:
        ops.add_meta_cost("silu_gate_bwd", *gate_cost(g, backward=True))
        return dg, du
    g2, u2 = _rows(g), _rows(u)
    _launch_gate_bwd(g2, u2, dy.reshape(g2.shape).contiguous(),
                     dg.view(g2.shape), du.view(g2.shape))
    ops.launches["silu_gate_bwd"] += 1
    return dg, du


class _SiluGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return silu_gate(g, u)

    @staticmethod
    def backward(ctx, dy):
        dg, du = silu_gate_bwd(*ctx.saved_tensors, dy)
        return (dg if ctx.needs_input_grad[0] else None,
                du if ctx.needs_input_grad[1] else None)


def silu_gate_train(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu_gate`` with a gradient (``silu_gate_bwd``)."""
    return _SiluGate.apply(g, u)
