"""GQA attention on the card: the wrappers of the three attention kernels
and the choice between them.

The kernels replace the JAX package's Pallas ``flash_attention`` and also
compute the masks (sliding window, explicit query and key positions,
padded keys) that the JAX ``ops.attention`` sends to its jnp reference, so
every attention call of the serving path runs on one of them.
``ops.attention`` dispatches here for CUDA tensors; ``ref.attention_ref``
is the plain version.  Routes, chosen by ``route`` from the shapes alone:

- ``decode_split`` (``csrc/attention_decode.cu``): at most
  ``DECODE_ROWS`` (query, head) rows per (batch, kv head), f32 or bf16 --
  split-K over the cache, ``plan_splits`` blocks per (batch, kv head),
  then a log-sum-exp combine;
- ``prefill_tc`` (``csrc/attention_prefill_tc.cu``): bf16, (hd, hd_v) in
  ``TC_HEAD_DIMS`` -- (64, 64), hubert's (80, 80), (128, 128) and MLA's
  (192, 128) -- no explicit positions (a query offset is not one) --
  wgmma on the tensor cores, K/V by TMA;
- ``general`` (``csrc/flash_attention.cu``): everything else -- f32
  prefill, other head dims (any up to ``MAX_HEAD_DIM``, hd and hd_v
  unequal), positions with many rows -- on the tensor cores (mma.sync:
  bf16, or 3xTF32 for f32, near f32 accuracy), K/V tiles by cp.async.

``prefill_tc`` and ``general`` write the row log-sum-exp beside the
output where asked (``return_lse``); ``decode_split`` does not, so a call
that asks for it never goes there.

A kernel that fails to build or launch raises; no route falls back to
another or to the plain version.

A query offset ``q_off`` (>= 0, no explicit positions) places query row i
at position i + q_off and key j at j: a rank's block of queries in a
sequence split over ranks (``models.layers.gqa_attention``), against the
keys of the whole sequence.  ``prefill_tc``, ``general`` and both backward
kernels take it; ``decode_split`` does not, so a call with an offset goes
to one of the other two.

Training: ``attention_train`` runs the forward above through
``_Attention``, an autograd Function whose backward is ``attention_bwd``,
for the calls the training path makes -- no explicit positions (a query
offset is not one), (hd, hd_v) in ``BWD_HEAD_DIMS`` (hymba's and olmoe's (64, 64) and (128, 128),
hubert's (80, 80), MLA's (192, 128)), f32 or bf16, causal or not, any
window -- and raises
for any other call that needs a gradient.  Backward routes, chosen by
``bwd_route`` from the dtype and the shapes alone:

- ``tc`` (``csrc/attention_bwd_tc.cu``): bf16 -- wgmma on the tensor cores,
  tiles by TMA;
- ``general`` (``csrc/attention_bwd.cu``): f32 -- mma.sync in 3xTF32.

Both take the forward's row log-sum-exp, which the forward writes beside
its output (``flash_attention(..., return_lse=True)``: ``prefill_tc`` in
bf16, ``general`` in f32; ``_Attention`` saves it).

``ref.attention_bwd_ref`` is their plain version, ``ref.attention_lse_ref``
the log-sum-exp's.

On meta tensors (``ops``: the dry run) ``flash_attention`` and
``attention_bwd`` check the call, choose its route and allocate its
outputs (the LSE too where asked; the backward's scratch), launch nothing,
and count the FLOPs and bytes of its bound (``attention_cost``,
``attention_bwd_cost``) in ``ops.meta_cost``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ops

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
DECODE_ROWS = 16        # (query, head) rows per (batch, kv head)
TC_HEAD_DIMS = ((64, 64), (80, 80), (128, 128), (192, 128))  # (hd, hd_v)
MAX_SPLITS = 64         # the decode kernel's combine holds this many
# the backward's (hd, hd_v): the tc route takes the LSE from prefill_tc
BWD_HEAD_DIMS = TC_HEAD_DIMS
_BWD_TC_PAD = 128           # the tc backward's scratch rows: Sq rounded up


def _pieces_ok(dim: int, itemsize: int) -> bool:
    """``dim`` is 16-byte pieces times a power of two <= 32: what a lane
    group of the decode kernel reads per key."""
    vec = 16 // itemsize
    n = dim // vec
    return dim % vec == 0 and 1 <= n <= 32 and n & (n - 1) == 0


def route(dtype, B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
          hd_v: int, window: int, has_positions: bool,
          with_lse: bool = False, q_off: int = 0) -> str:
    """The kernel an attention call of these shapes goes to (see the module
    docstring); a pure function of the shapes.  ``with_lse``: the call
    also wants the row log-sum-exp, which ``prefill_tc`` and ``general``
    write and ``decode_split`` does not (a training forward: any number of
    rows goes to one of the two).  A query offset (``q_off`` > 0) keeps
    the call off ``decode_split``."""
    itemsize = dtype.itemsize
    if (not with_lse and not q_off and Sq * (H // KV) <= DECODE_ROWS
            and _pieces_ok(hd, itemsize) and _pieces_ok(hd_v, itemsize)):
        return "decode_split"
    if (dtype == torch.bfloat16 and (hd, hd_v) in TC_HEAD_DIMS
            and not has_positions):
        return "prefill_tc"
    return "general"


def plan_splits(B: int, KV: int, Sk: int, rows: int,
                sm_count: int) -> tuple[int, int]:
    """(splits, chunk) of the decode kernel's grid: split s reads keys
    ``[s * chunk, min((s + 1) * chunk, Sk))``, every key exactly once and no
    split empty.  Aims at four blocks per SM over the B * KV (batch, kv
    head) pairs with one row, two with more: a block keeps each row's
    query and accumulator in registers, so with five rows (hymba's G) only
    three fit on an SM, and a second wave costs more than fewer, longer
    splits.  At least ``max(16, 64 // rows)`` keys per split (fewer rows do
    less work per key), chunks a multiple of 16."""
    min_keys = max(16, 64 // max(rows, 1))
    per_sm = 4 if rows <= 1 else 2
    want = _cdiv(per_sm * sm_count, max(B * KV, 1))
    splits = max(1, min(want, _cdiv(Sk, min_keys), MAX_SPLITS))
    chunk = 16 * _cdiv(_cdiv(Sk, splits), 16)
    return _cdiv(Sk, chunk), chunk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def live_pairs(Sq: int, Sk: int, causal: bool, window: int,
               q_off: int = 0) -> int:
    """(query, key) pairs of one batch row that the mask keeps, query i
    and key j at positions i + ``q_off`` and j: ``i + q_off >= j`` if
    ``causal``, ``i + q_off - j < window`` if ``window``."""
    i = np.arange(Sq, dtype=np.int64) + q_off
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_cost(esize: int, B: int, Sq: int, Sk: int, H: int, KV: int,
                   hd: int, hd_v: int, causal: bool, window: int,
                   n_positions: int = 0, with_lse: bool = False,
                   q_off: int = 0) -> tuple[int, int]:
    """(FLOPs, bytes) of the forward's bound: 2 (hd + hd_v) FLOPs per live
    pair and q head (the queries at ``q_off`` on); q, k, v (and the
    ``n_positions`` int32 positions) read once, the output (and the f32
    LSE) written once.  With positions the live pairs are not known from
    the shapes: every pair counts."""
    pairs = B * (Sq * Sk if n_positions else live_pairs(Sq, Sk, causal,
                                                         window, q_off))
    flops = 2 * H * pairs * (hd + hd_v)
    nbytes = esize * (B * Sq * H * (hd + hd_v) + B * Sk * KV * (hd + hd_v))
    nbytes += 4 * n_positions + (4 * B * H * Sq if with_lse else 0)
    return flops, nbytes


def attention_bwd_cost(esize: int, B: int, Sq: int, Sk: int, H: int,
                       KV: int, hd: int, hd_v: int, causal: bool,
                       window: int, q_off: int = 0) -> tuple[int, int]:
    """(FLOPs, bytes) of the backward's bound, on either route (both take
    the forward's LSE): per live pair and q head 2 hd FLOPs for each of S,
    dQ and dK, 2 hd_v for dP and dV; q, k, v, o, do read once and dq, dk,
    dv written once; the queries at ``q_off`` on."""
    pairs = B * live_pairs(Sq, Sk, causal, window, q_off)
    flop_pair = 2 * (3 * hd + 2 * hd_v)
    nbytes = esize * 2 * (B * Sq * H * (hd + hd_v) + B * Sk * KV * (hd + hd_v))
    return flop_pair * H * pairs, nbytes


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_pos: torch.Tensor | None = None,
                    k_pos: torch.Tensor | None = None,
                    scale: float | None = None, return_lse: bool = False,
                    q_off: int = 0):
    """q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hd_v) on one
    CUDA device, contiguous, all f32 or all bf16; ``q_pos``/``k_pos``
    (B, Sq)/(B, Sk) int32, or without ``q_pos`` the queries at ``q_off``
    (>= 0) on.  Returns (B, Sq, H, hd_v) in q's dtype; with
    ``return_lse``, (that, the (B, H, Sq) f32 row log-sum-exp in log2
    units, as ``ref.attention_lse_ref``), from ``prefill_tc`` or
    ``general``.

    Counts as ``flash_attention`` without a window and positions (the
    Pallas kernel's role), else as ``attention_masked``; and once in
    ``ops.route_launches`` under its route."""
    from ._build import load
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, head_dim)")
    B, Sq, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    ops.check("q", q, (B, Sq, H, hd), _DTYPES, dev)
    ops.check("k", k, (B, Sk, KV, hd), (q.dtype,), dev)
    ops.check("v", v, (B, Sk, KV, hd_v), (q.dtype,), dev)
    if KV == 0 or H % KV:
        raise ValueError(f"{H} q heads do not split over {KV} kv heads")
    if not (0 < hd <= MAX_HEAD_DIM and 0 < hd_v <= MAX_HEAD_DIM):
        raise ValueError(f"head dims ({hd}, {hd_v}) must be in 1.."
                         f"{MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    _check_q_off(q_off, q_pos)
    if q_pos is not None:
        ops.check("q_pos", q_pos, (B, Sq), (torch.int32,), dev)
    if k_pos is not None:
        ops.check("k_pos", k_pos, (B, Sk), (torch.int32,), dev)
    scale = scale if scale is not None else hd ** -0.5
    which = route(q.dtype, B, Sq, Sk, H, KV, hd, hd_v, window,
                  q_pos is not None or k_pos is not None, return_lse, q_off)
    if which != "general" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"route {which} needs 16-byte aligned q, k and v")
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    plain = window == 0 and q_pos is None and k_pos is None
    if dev.type == "meta":
        n_pos = sum(t.numel() for t in (q_pos, k_pos) if t is not None)
        ops.add_meta_cost(
            "flash_attention" if plain else "attention_masked",
            *attention_cost(q.element_size(), B, Sq, Sk, H, KV, hd, hd_v,
                            causal, window, n_pos, return_lse, q_off))
        return (out, lse) if return_lse else out
    qp = None if q_pos is None else q_pos.data_ptr()
    kp = None if k_pos is None else k_pos.data_ptr()
    is_bf16 = int(q.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if which == "decode_split":
            rows = Sq * (H // KV)
            splits, chunk = plan_splits(B, KV, Sk, rows, sm_count(dev.index))
            ws = torch.empty(B * KV * splits * rows * (hd_v + 2),
                             dtype=torch.float32, device=dev)
            err = load("attention_decode").repro_attention_decode_split(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), qp,
                kp, ws.data_ptr(), B, Sq, Sk, H, KV, hd, hd_v, int(causal),
                int(window), float(scale), is_bf16, splits, chunk, stream)
        elif which == "prefill_tc":
            err = load("attention_prefill_tc").repro_attention_prefill_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV,
                hd, hd_v, int(causal), int(window), int(q_off), float(scale),
                stream)
        else:
            err = load("flash_attention").repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), qp, kp, B, Sq, Sk,
                H, KV, hd, hd_v, int(causal), int(window), int(q_off),
                float(scale), is_bf16, stream)
    if err:
        raise RuntimeError(f"attention ({which}) launch failed: CUDA error "
                           f"{err}")
    ops.launches["flash_attention" if plain else "attention_masked"] += 1
    ops.route_launches[which] += 1
    return (out, lse) if return_lse else out


def bwd_route(dtype, Sq: int, Sk: int, hd: int, hd_v: int, window: int,
              has_positions: bool, q_off: int = 0) -> str:
    """The backward kernel an attention call of these shapes goes to (see
    the module docstring): ``"tc"`` for bf16, ``"general"`` for f32; a pure
    function of the dtype and the shapes.  Raises for a call that neither
    takes: explicit positions, (hd, hd_v) not in ``BWD_HEAD_DIMS``,
    another dtype, or a window that leaves query positions (rows +
    ``q_off``) past ``Sk + window - 1`` without a key."""
    if has_positions:
        raise RuntimeError("attention with explicit positions has no "
                           "backward kernel")
    if (hd, hd_v) not in BWD_HEAD_DIMS:
        raise RuntimeError(f"attention head dims ({hd}, {hd_v}) have no "
                           f"backward kernel: it takes (hd, hd_v) in "
                           f"{BWD_HEAD_DIMS}")
    if dtype not in _DTYPES:
        raise RuntimeError(f"attention in {dtype} has no backward kernel")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and Sq + q_off - window >= Sk:
        raise RuntimeError(f"window {window} leaves query positions past "
                           f"{Sk + window - 1} without a key")
    return "tc" if dtype == torch.bfloat16 else "general"


def _check_q_off(q_off: int, q_pos) -> None:
    if q_off < 0:
        raise ValueError(f"q_off must be >= 0, got {q_off}")
    if q_off and q_pos is not None:
        raise ValueError("q_off and q_pos both place the queries: pass one")


def _check_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int, has_positions: bool, q_off: int = 0) -> str:
    """``bwd_route`` of a call of these tensors (raising where no backward
    kernel takes it)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, head_dim)")
    return bwd_route(q.dtype, q.shape[1], k.shape[1], q.shape[-1],
                     v.shape[-1], window, has_positions, q_off)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                  window: int, scale: float, lse: torch.Tensor | None = None,
                  q_off: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention without positions (the queries at
    ``q_off`` >= 0 on; a key that no query reaches gets zeros): q (B, Sq,
    H, hd), k
    (B, Sk, KV, hd), v (B, Sk, KV, hd_v), o, do (B, Sq, H, hd_v),
    contiguous and 16-byte aligned on one CUDA device, all f32 or all
    bf16, (hd, hd_v) in ``BWD_HEAD_DIMS``; o the forward's output;
    ``lse`` the forward's (B, H, Sq) f32 row log-sum-exp (log2 units),
    which both routes require.  The gradients come out in q's dtype.
    Counts as ``attention_bwd`` and once in ``ops.bwd_route_launches``
    under its route."""
    _check_q_off(q_off, None)
    which = _check_bwd(q, k, v, window, False, q_off)
    if lse is None:
        raise ValueError("the attention backward needs the forward's "
                         "log-sum-exp: flash_attention(..., "
                         "return_lse=True)")
    dq, dk, dv = _bwd_launch(which, q, k, v, o, do, lse, causal, window,
                             scale, q_off)
    if q.is_meta:
        B, Sq, H, hd = q.shape
        Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
        ops.add_meta_cost("attention_bwd", *attention_bwd_cost(
            q.element_size(), B, Sq, Sk, H, KV, hd, hd_v, causal,
            window, q_off))
        return dq, dk, dv
    ops.launches["attention_bwd"] += 1
    ops.bwd_route_launches[f"attention_{which}"] += 1
    return dq, dk, dv


def _bwd_launch(which: str, q, k, v, o, do, lse, causal: bool, window: int,
                scale: float, q_off: int):
    """Check the tensors and launch route ``which``'s backward kernel."""
    from ._build import load
    B, Sq, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    dev = q.device
    ops.check("q", q, (B, Sq, H, hd), _DTYPES, dev)
    ops.check("k", k, (B, Sk, KV, hd), (q.dtype,), dev)
    ops.check("v", v, (B, Sk, KV, hd_v), (q.dtype,), dev)
    for name, t in (("o", o), ("do", do)):
        ops.check(name, t, (B, Sq, H, hd_v), (q.dtype,), dev)
    ops.check("lse", lse, (B, H, Sq), (torch.float32,), dev)
    if KV == 0 or H % KV:
        raise ValueError(f"{H} q heads do not split over {KV} kv heads")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("the attention backward needs 16-byte aligned "
                         "q, k, v, o and do")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if which == "tc":
        pad = B * H * _cdiv(Sq, _BWD_TC_PAD) * _BWD_TC_PAD
        scratch = torch.empty(2 * pad, dtype=torch.float32, device=dev)
    else:
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return dq, dk, dv
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if which == "tc":
            err = load("attention_bwd_tc").repro_attention_bwd_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), scratch.data_ptr(), scratch[pad:].data_ptr(),
                B, Sq, Sk, H, KV, hd, hd_v, int(causal), int(window),
                int(q_off), float(scale), stream)
        else:
            err = load("attention_bwd").repro_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(), B, Sq, Sk, H, KV, hd, hd_v,
                int(causal), int(window), int(q_off), float(scale), stream)
    if err:
        raise RuntimeError(f"attention backward ({which}) launch failed: "
                           f"CUDA error {err}")
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """``flash_attention`` forward, ``attention_bwd`` backward; saves q, k,
    v, the output and the forward's row log-sum-exp (the forward runs on
    ``prefill_tc`` in bf16 and ``general`` in f32, which write it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float,
                q_off: int):
        kw = dict(causal=causal, window=window, scale=scale, q_off=q_off)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, do.contiguous(), lse=lse,
                                   **ctx.args)
        return dq, dk, dv, None, None, None, None


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_pos: torch.Tensor | None = None,
                    k_pos: torch.Tensor | None = None,
                    scale: float | None = None,
                    q_off: int = 0) -> torch.Tensor:
    """``flash_attention`` with a gradient: raises before anything runs
    where the backward kernel does not take the call (``_check_bwd``)."""
    _check_q_off(q_off, q_pos)
    _check_bwd(q, k, v, window, q_pos is not None or k_pos is not None,
               q_off)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _Attention.apply(q, k, v, causal, window, scale, q_off)
