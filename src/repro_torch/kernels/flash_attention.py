"""GQA attention on the card: the wrapper of ``csrc/flash_attention.cu``.

The kernel replaces the JAX package's Pallas ``flash_attention`` and also
computes the masks (sliding window, explicit query and key positions,
padded keys) that the JAX ``ops.attention`` sends to its jnp reference, so
every attention call of the serving path runs on it.  ``ops.attention``
dispatches here for CUDA tensors; ``ref.attention_ref`` is the plain
version.
"""
from __future__ import annotations

import torch

from . import ops

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_pos: torch.Tensor | None = None,
                    k_pos: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV, hd_v) on one
    CUDA device, contiguous, all f32 or all bf16; ``q_pos``/``k_pos``
    (B, Sq)/(B, Sk) int32.  Returns (B, Sq, H, hd_v) in q's dtype.

    Counts as ``flash_attention`` without a window and positions (the
    Pallas kernel's role), else as ``attention_masked``."""
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
    if q_pos is not None:
        ops.check("q_pos", q_pos, (B, Sq), (torch.int32,), dev)
    if k_pos is not None:
        ops.check("k_pos", k_pos, (B, Sk), (torch.int32,), dev)
    scale = scale if scale is not None else hd ** -0.5
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=dev)
    fn = load("flash_attention").repro_flash_attention
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if q_pos is None else q_pos.data_ptr(),
                 None if k_pos is None else k_pos.data_ptr(),
                 B, Sq, Sk, H, KV, hd, hd_v, int(causal), int(window),
                 float(scale), int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    plain = window == 0 and q_pos is None and k_pos is None
    ops.launches["flash_attention" if plain else "attention_masked"] += 1
    return out
