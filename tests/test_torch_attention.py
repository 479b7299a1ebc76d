"""The port's plain attention (``repro_torch.kernels.ref.attention_ref``)
against the JAX package's Pallas ``flash_attention`` in interpret mode and
against its jnp reference with windows and positions, on the same numpy
inputs, at the tolerances of ``tests/test_kernels.py``.  The CUDA kernel
is held against this plain version on the card (``test_torch_cuda.py``,
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
from repro.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SHAPES_ATTN = [
    # (B, Sq, Sk, H, KV, hd, bq, bk), as tests/test_kernels.py
    (1, 8, 8, 1, 1, 4, 8, 8),
    (2, 16, 16, 4, 2, 8, 8, 8),
    (1, 32, 32, 4, 4, 16, 16, 8),
    (2, 24, 24, 6, 2, 8, 8, 12),     # GQA group 3
    (1, 64, 64, 2, 1, 32, 32, 32),
]
_TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _inputs(rng, shapes, dtype):
    """The same values for both packages: numpy f32, rounded to ``dtype``
    once on the JAX side and carried bit for bit to torch."""
    arrays = [jnp.asarray(rng.normal(size=s).astype(np.float32), dtype)
              for s in shapes]
    return arrays, [_to_torch(a) for a in arrays]


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES_ATTN)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_pallas_kernel(shape, dtype, causal):
    B, Sq, Sk, H, KV, hd, bq, bk = shape
    rng = np.random.default_rng(abs(hash((shape, causal))) % 2**31)
    (q, k, v), (tq, tk, tv) = _inputs(
        rng, [(B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)],
        getattr(jnp, dtype))
    want = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk,
                           interpret=True)
    got = ref.attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, H, hd)
    _close(got, want, _TOL[dtype])


def test_attention_ref_mixed_vdim():
    """MLA-style: the v head dim differs from the q/k head dim."""
    rng = np.random.default_rng(0)
    (q, k, v), (tq, tk, tv) = _inputs(
        rng, [(1, 16, 2, 12), (1, 16, 2, 12), (1, 16, 2, 8)], jnp.float32)
    want = flash_attention(q, k, v, causal=True, block_q=8, block_k=8,
                           interpret=True)
    got = ref.attention_ref(tq, tk, tv, causal=True)
    _close(got, want, 2e-6)


MASKED = [
    # (B, Sq, Sk, H, KV, hd, causal, window, positions)
    (2, 16, 16, 4, 2, 8, True, 5, "none"),          # prefill sliding window
    (1, 24, 24, 6, 2, 8, False, 7, "none"),         # window, not causal
    (2, 1, 40, 6, 2, 8, True, 0, "linear"),         # decode, linear cache
    (2, 1, 12, 4, 1, 16, True, 0, "ring"),          # decode, ring with pads
    (2, 8, 20, 4, 2, 8, True, 6, "shifted"),        # chunk at an offset
]


def _positions(kind, rng, B, Sq, Sk):
    if kind == "none":
        return None, None
    if kind == "linear":                 # new token at 30 of a 40-slot cache
        return (np.full((B, Sq), 30, np.int32),
                np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy())
    if kind == "ring":                   # W = Sk slots, only 5 filled so far
        pos = 4
        kp = pos - Sk + 1 + np.arange(Sk, dtype=np.int32)
        return (np.full((B, Sq), pos, np.int32),
                np.broadcast_to(kp, (B, Sk)).copy())
    q0 = rng.integers(12, 20, size=(B, 1))                # "shifted"
    return ((q0 + np.arange(Sq)).astype(np.int32),
            np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MASKED)
def test_attention_ref_matches_reference_with_masks(case, dtype):
    B, Sq, Sk, H, KV, hd, causal, window, kind = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    (q, k, v), (tq, tk, tv) = _inputs(
        rng, [(B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)],
        getattr(jnp, dtype))
    qp, kp = _positions(kind, rng, B, Sq, Sk)
    if kind == "ring":
        assert (kp < 0).any()
    want = jref.attention_reference(
        q, k, v, causal=causal, window=window,
        q_pos=None if qp is None else jnp.asarray(qp),
        k_pos=None if kp is None else jnp.asarray(kp))
    got = ops.attention(
        tq, tk, tv, causal=causal, window=window,
        q_pos=None if qp is None else torch.from_numpy(qp),
        k_pos=None if kp is None else torch.from_numpy(kp))
    _close(got, want, _TOL[dtype])


def test_ops_attention_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(1)
    _, (tq, tk, tv) = _inputs(
        rng, [(1, 8, 2, 8), (1, 8, 1, 8), (1, 8, 1, 8)], jnp.float32)
    ops.reset_launches()
    got = ops.attention(tq, tk, tv, window=3)
    assert torch.equal(got, ref.attention_ref(tq, tk, tv, window=3))
    assert ops.launches["flash_attention"] == 0
    assert ops.launches["attention_masked"] == 0
