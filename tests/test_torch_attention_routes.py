"""The attention routes of the port, on the CPU: which kernel
``flash_attention.route`` picks for the serving path's shapes, the decode
kernel's split planner, and a plain model of its split-and-combine
arithmetic (``ref.attention_split_ref``) held against the JAX package's
``attention_reference`` on the decode masks.  The kernels themselves are
held against the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

H100_SMS = 132


def _attn_shapes(name):
    """(H, KV, hd, windows) of a registry model's attention layers."""
    cfg = get_config(name)
    H = cfg.n_heads_padded or cfg.n_heads
    windows = sorted({s.sliding_window for s in cfg.segments})
    return H, cfg.n_kv_heads, cfg.hd, windows


@pytest.mark.parametrize("name", ["hymba-1.5b", "olmoe-1b-7b",
                                  "llama-3.2-vision-11b"])
def test_route_of_the_serving_shapes(name):
    H, KV, hd, windows = _attn_shapes(name)
    B, S, max_len = 4, 2048, 2048 + 32
    for window in windows:
        assert fa.route(torch.bfloat16, B, S, S, H, KV, hd, hd, window,
                        False) == "prefill_tc"
        assert fa.route(torch.float32, B, S, S, H, KV, hd, hd, window,
                        False) == "general"
        # decode: a linear cache of max_len or a ring of the window
        Sk = min(window, max_len) if window else max_len
        for dtype in (torch.float32, torch.bfloat16):
            assert fa.route(dtype, B, 1, Sk, H, KV, hd, hd, 0,
                            True) == "decode_split"


@pytest.mark.parametrize("shape,dtype,want", [
    ((1, 40, 40, 4, 2, 192, 128, 0, False), torch.float32, "general"),
    ((2, 70, 70, 6, 2, 16, 16, 0, False), torch.bfloat16, "general"),
    ((2, 9, 20, 4, 2, 64, 64, 6, True), torch.bfloat16, "general"),
    ((2, 3, 90, 10, 2, 64, 64, 0, True), torch.bfloat16, "decode_split"),
    ((2, 4, 90, 10, 2, 64, 64, 0, False), torch.float32, "general"),
    ((1, 1, 90, 4, 4, 256, 256, 0, True), torch.float32, "general"),
    ((1, 1, 90, 4, 4, 256, 256, 0, True), torch.bfloat16, "decode_split"),
    ((1, 1, 90, 4, 4, 96, 96, 0, True), torch.bfloat16, "general"),
    ((1, 40, 40, 4, 2, 192, 128, 0, False), torch.bfloat16, "prefill_tc"),
    ((1, 40, 40, 4, 2, 192, 128, 0, True), torch.bfloat16, "general"),
    ((1, 40, 40, 4, 4, 128, 192, 0, False), torch.bfloat16, "general"),
    ((1, 40, 40, 4, 4, 192, 192, 0, False), torch.bfloat16, "general"),
])
def test_route_of_other_shapes(shape, dtype, want):
    """Many rows with positions, odd head dims and f32 past 512 bytes a
    row stay on the general kernel; bf16 at MLA's head dims (192, 128),
    GQA or not, takes the tensor-core prefill."""
    assert fa.route(dtype, *shape) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hubert_encoder_takes_the_general_route(dtype):
    """hubert-xlarge's full-size encoder call (8 clips of 30 s at 50
    frames/s, 16 heads of 80, non-causal) takes the general route in f32
    only: in bf16, serving and training alike, its head dims (80, 80) go to
    the tensor-core prefill; either route writes the training forward's LSE.
    Its backward goes to ``tc`` in bf16 and ``general`` in f32."""
    cfg = get_config("hubert-xlarge")
    H, KV, hd, windows = _attn_shapes("hubert-xlarge")
    assert (H, KV, hd, windows) == (16, 16, 80, [0])
    assert not cfg.segments[0].causal
    want = "prefill_tc" if dtype == torch.bfloat16 else "general"
    assert fa.route(dtype, 8, 1500, 1500, H, KV, hd, hd, 0,
                    False) == want
    # a training forward writes the LSE on its usual route
    assert fa.route(dtype, 8, 1500, 1500, H, KV, hd, hd, 0, False,
                    with_lse=True) == want
    assert fa.bwd_route(dtype, 1500, 1500, hd, hd, 0, False) == (
        "tc" if dtype == torch.bfloat16 else "general")


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "prefill_tc"),
                                        (torch.float32, "general")])
def test_deepseek_prefill_route(dtype, want):
    """deepseek-v3's MLA prefill at the smoke's traffic (4 prompts of 2048
    tokens, 128 heads, q/k head dim 128 + 64, v head dim 128): bf16 on the
    tensor-core prefill, f32 on the general kernel; its decode step calls
    no attention kernel."""
    cfg = get_config("deepseek-v3-671b")
    hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert (cfg.n_heads, hd, cfg.v_head_dim) == (128, 192, 128)
    assert fa.route(dtype, 4, 2048, 2048, cfg.n_heads, cfg.n_heads, hd,
                    cfg.v_head_dim, 0, False) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vision_cross_routes(dtype):
    """llama-3.2-vision's cross-attention at the smoke's traffic (4
    prompts of 2048 tokens against 1024 image tokens, 32 q heads over 8 kv
    heads of 128, no mask, no positions): prefill on the tensor-core
    kernel in bf16 (the general kernel in f32), and the decode step's
    query on ``decode_split`` in both dtypes."""
    cfg = get_config("llama-3.2-vision-11b")
    H, KV, hd, N = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_image_tokens
    assert (H, KV, hd, N) == (32, 8, 128, 1024)
    prefill = "prefill_tc" if dtype == torch.bfloat16 else "general"
    assert fa.route(dtype, 4, 2048, N, H, KV, hd, hd, 0, False) == prefill
    assert fa.route(dtype, 4, 1, N, H, KV, hd, hd, 0, False) == \
        "decode_split"


@pytest.mark.parametrize("Sk", [1, 63, 1024, 2080])
@pytest.mark.parametrize("B,KV,rows", [(4, 16, 1), (4, 5, 5), (1, 1, 16)])
def test_split_plan_covers_every_key_once(Sk, B, KV, rows):
    splits, chunk = fa.plan_splits(B, KV, Sk, rows, H100_SMS)
    assert 1 <= splits <= fa.MAX_SPLITS and chunk % 16 == 0
    seen = np.zeros(Sk, np.int64)
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, Sk)
        assert lo < hi                                   # no split is empty
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("name,Sk", [("olmoe-1b-7b", 2080),
                                     ("hymba-1.5b", 1024),
                                     ("hymba-1.5b", 2080),
                                     ("llama-3.2-vision-11b", 1024),
                                     ("llama-3.2-vision-11b", 2080)])
def test_split_plan_fills_the_card(name, Sk):
    H, KV, _, _ = _attn_shapes(name)
    B = 4
    splits, _ = fa.plan_splits(B, KV, Sk, H // KV, H100_SMS)
    assert B * KV * splits >= H100_SMS


def _to_torch(a):
    return torch.from_numpy(np.array(a))


DECODE = [
    # (B, Sk, H, KV, hd, window, kind, splits)
    (2, 40, 4, 4, 16, 0, "linear", 5),      # the last split all future
    (2, 40, 6, 2, 8, 0, "linear", 8),
    (2, 64, 10, 2, 16, 0, "ring", 4),       # padded slots: first splits dead
    (1, 48, 4, 1, 8, 0, "ring", 6),
    (2, 50, 4, 2, 8, 7, "linear", 4),       # a window: early splits masked
]


@pytest.mark.parametrize("case", DECODE)
def test_split_model_matches_reference(case):
    B, Sk, H, KV, hd, window, kind, splits = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               [(B, 1, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)])
    if kind == "linear":                # the new token at 30, slots to Sk
        at = 30
        kp = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    else:                               # a ring of Sk slots, 9 filled
        at = 8
        kp = np.broadcast_to(at - Sk + 1 + np.arange(Sk, dtype=np.int32),
                             (B, Sk)).copy()
    qp = np.full((B, 1), at, np.int32)
    chunk = -(-Sk // splits)
    splits = -(-Sk // chunk)
    dead = [s for s in range(splits) if not any(
        kp[0, j] >= 0 and at >= kp[0, j] and (not window
                                              or at - kp[0, j] < window)
        for j in range(s * chunk, min((s + 1) * chunk, Sk)))]
    assert dead, "each case has a split with no live key"
    want = jref.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp))
    got = ref.attention_split_ref(
        _to_torch(q), _to_torch(k), _to_torch(v), splits=splits, chunk=chunk,
        causal=True, window=window, q_pos=_to_torch(qp), k_pos=_to_torch(kp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


def test_split_model_with_one_split_is_attention_ref():
    """With one split the model is the plain softmax: equal to
    ``attention_ref`` on a decode step."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in [(2, 1, 6, 8), (2, 33, 3, 8), (2, 33, 3, 8)])
    qp = torch.full((2, 1), 20, dtype=torch.int32)
    kp = torch.arange(33, dtype=torch.int32).expand(2, 33).contiguous()
    got = ref.attention_split_ref(q, k, v, splits=1, chunk=33, q_pos=qp,
                                  k_pos=kp)
    want = ref.attention_ref(q, k, v, q_pos=qp, k_pos=kp)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)
