"""The numerics of the general routes' f32 products, on the CPU.

The general attention and grouped-matmul kernels (``csrc/flash_attention.cu``,
``csrc/moe_gmm.cu``) multiply f32 operands on the TF32 tensor cores in
3xTF32 (``csrc/tc_mma.cuh``): each operand x splits into hi = rna_tf32(x)
and lo = x - hi, which the tensor core truncates to TF32, and a product
is hi*hi + hi*lo + lo*hi accumulated in f32.  Here that arithmetic is
emulated in plain PyTorch (rna: round to nearest, ties away from zero, on
the low 13 mantissa bits; the truncation clears them; a product of two
TF32 values is exact in f32) at the smoke's
attention and grouped-matmul shapes, cut to CPU time, and held against a
float64 product: within 2e-6 for attention and 1e-5 for the grouped
matmul (``tests/test_kernels.py``'s f32 bounds), which one TF32 product
misses.  The kernels themselves are held against the plain versions on
the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ATTN_TOL, GMM_TOL = 2e-6, 1e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    does: half of the dropped range added to the magnitude, the low 13
    bits cleared (the sign bit is apart, so ties go away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` truncated to TF32, as an MMA reads a TF32 operand: the low
    13 bits ignored."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' split as the MMA sees it: rna(x) and trunc(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b in f32 from TF32 products: ``passes`` 3 is 3xTF32 (the cross
    terms first, then hi*hi), 1 one TF32 product of the operands rounded
    to nearest."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    """|got - want| <= tol + tol * |want| everywhere (assert_allclose with
    rtol = atol = tol)."""
    return bool(((got.double() - want).abs()
                 <= tol + tol * want.abs()).all())


def _attention(q, k, v, causal, mm):
    """One (batch, head) of attention with ``mm`` for both products: f32
    scores and softmax, as the kernel keeps them."""
    s = mm(q, k.T) * q.shape[-1] ** -0.5
    if causal:
        Sq, Sk = s.shape
        keep = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None]
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    return mm(torch.softmax(s, dim=-1), v)


# (name, Sq, Sk, hd, hd_v, causal): the smoke's attention shapes on the
# general route -- olmoe's and hymba's f32 prefill, hubert's encoder call,
# MLA's dims -- one head, the sequence cut to 256 queries
ATTN = [("olmoe_prefill", 256, 256, 128, 128, True),
        ("hymba_prefill", 256, 256, 64, 64, True),
        ("hubert", 256, 300, 80, 80, False),
        ("hd192_v128", 256, 256, 192, 128, True)]
# (name, rows, D, F): olmoe's expert products, 64 rows of one slot
GMM = [("gate_up", 64, 2048, 1024), ("down", 64, 1024, 2048)]


def _attn_inputs(case):
    name, Sq, Sk, hd, hdv, causal = case
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in [(Sq, hd), (Sk, hd), (Sk, hdv)])
    want = _attention(q.double(), k.double(), v.double(), causal,
                      lambda a, b: a @ b)
    return q, k, v, causal, want


def _gmm_inputs(case):
    name, rows, D, F = case
    rng = np.random.default_rng(D + F)
    x = torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((D, F)) * D ** -0.5)
                         .astype(np.float32))
    return x, w, x.double() @ w.double()


def test_rna_rounds_to_ten_mantissa_bits_away_from_zero():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -11, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                         1 + 2 ** -9, 3.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    low = tf32_rna(torch.randn(1000)).view(torch.int32) & 0x1FFF
    assert bool((low == 0).all())


def test_split_keeps_21_bits():
    """hi is within half a TF32 ulp (2^-11 |x|) of x, and truncating lo
    loses at most 2^-10 |lo| more: hi + lo within 2^-21 |x| of x."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32))
    hi, lo = split(x)
    assert bool(((hi.double() - x.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


@pytest.mark.parametrize("case", ATTN, ids=[c[0] for c in ATTN])
def test_attention_in_3xtf32_holds_the_f32_tolerance(case):
    q, k, v, causal, want = _attn_inputs(case)
    got = _attention(q, k, v, causal,
                     lambda a, b: mm_tf32(a, b, passes=3))
    assert within(got, want, ATTN_TOL)


@pytest.mark.parametrize("case", ATTN, ids=[c[0] for c in ATTN])
def test_attention_in_one_tf32_product_misses_it(case):
    q, k, v, causal, want = _attn_inputs(case)
    got = _attention(q, k, v, causal,
                     lambda a, b: mm_tf32(a, b, passes=1))
    assert not within(got, want, ATTN_TOL)


@pytest.mark.parametrize("case", GMM, ids=[c[0] for c in GMM])
def test_grouped_product_in_3xtf32_holds_the_f32_tolerance(case):
    x, w, want = _gmm_inputs(case)
    assert within(mm_tf32(x, w, passes=3), want, GMM_TOL)


@pytest.mark.parametrize("case", GMM, ids=[c[0] for c in GMM])
def test_grouped_product_in_one_tf32_product_misses_it(case):
    x, w, want = _gmm_inputs(case)
    assert not within(mm_tf32(x, w, passes=1), want, GMM_TOL)
