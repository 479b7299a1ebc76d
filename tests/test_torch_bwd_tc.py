"""The training backward's routes on the CPU: the row log-sum-exp that the
attention forward hands its backward, the routes' choice, and the
autograd Functions' plumbing.

``ref.attention_lse_ref`` is the LSE that the prefill routes write
(``prefill_tc``, and ``general`` in f32) and both attention backwards
(``csrc/attention_bwd_tc.cu``, ``csrc/attention_bwd.cu``) take, in log2
units; here it is held to a numpy log-sum-exp of the masked scores (GQA,
causal and not, windows, Sq != Sk) within 1e-6, and
``ref.attention_bwd_ref`` given it to the same function recomputing it
and to ``jax.grad`` of the JAX package's ``attention_reference``, within
1e-5 in f32, also at MLA's head dims (hd, hd_v) = (192, 128) and hubert's
(80, 80) (non-causal, Sq != Sk, and a window).
``bwd_route`` of both modules is held case by case.  Under
``ops.force("cuda")``, with the forward kernels and the backward launches
monkeypatched to their plain versions on CPU tensors, ``_Attention`` must
hand the forward's LSE to both backward routes (the f32 Function's
gradients held to ``jax.grad`` at (192, 128) and (80, 80) too), both
Functions' gradients must equal autograd of the plain versions
(``_GroupedMatmul``'s with fills and NaN past them), and each call counts
once under its route in ``ops.bwd_route_launches``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import attention_reference  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm, ops, ref  # noqa: E402

jax.config.update("jax_enable_x64", False)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


# (B, Sq, Sk, H, KV, hd, causal, window); hd a pair (hd, hd_v) for
# MLA's (192, 128): causal, windowed, GQA, non-causal with Sq != Sk
ATTN_CASES = [
    (2, 13, 13, 6, 2, 8, True, 0),
    (2, 13, 13, 6, 2, 8, True, 5),
    (1, 9, 7, 4, 4, 16, False, 0),
    (2, 12, 12, 5, 1, 8, False, 4),
    (1, 10, 12, 6, 3, 8, True, 3),
    (1, 20, 20, 2, 1, 64, True, 7),
    (1, 7, 15, 4, 2, 16, False, 6),
    (2, 13, 13, 4, 4, (192, 128), True, 0),
    (1, 20, 20, 4, 2, (192, 128), True, 7),
    (1, 9, 12, 2, 1, (192, 128), False, 0),
    (2, 17, 17, 6, 3, (192, 128), True, 5),
    (1, 9, 12, 4, 4, 80, False, 0),
    (2, 14, 10, 4, 2, 80, False, 6),
    (1, 13, 13, 2, 2, 80, True, 4),
]


def _dims(hd) -> tuple[int, int]:
    """(hd, hd_v) of a case's head dim: an int (hd = hd_v) or a pair."""
    return hd if isinstance(hd, tuple) else (hd, hd)


def _masked_scores(q, k, causal, window, scale):
    """numpy: (B, H, Sq, Sk) scores times scale, masked pairs -1e30."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kk = np.repeat(k, H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  kk.astype(np.float64)) * scale
    i, j = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), dtype=bool)
    if causal:
        live &= i >= j
    if window:
        live &= i - j < window
    return np.where(live, s, -1e30)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", ATTN_CASES)
def test_attention_lse_ref_matches_numpy(B, Sq, Sk, H, KV, hd, causal,
                                         window):
    hd = _dims(hd)[0]
    rng = np.random.default_rng(Sq * 31 + H + window)
    q, k = _np(rng, B, Sq, H, hd), _np(rng, B, Sk, KV, hd)
    scale = hd ** -0.5
    s = _masked_scores(q, k, causal, window, scale)
    m = s.max(axis=-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(axis=-1))) / np.log(2.0)
    got = ref.attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                causal=causal, window=window, scale=scale)
    assert got.dtype == torch.float32 and got.shape == (B, H, Sq)
    keep = want > -1e29          # rows with a key (every row here)
    assert keep.all()
    assert np.abs(got.numpy() - want).max() <= 1e-6 * max(
        1.0, np.abs(want).max())


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", ATTN_CASES)
def test_attention_bwd_ref_with_lse_matches_jax_grad(B, Sq, Sk, H, KV, hd,
                                                     causal, window):
    hd, hd_v = _dims(hd)
    rng = np.random.default_rng(Sq * 17 + H + hd + window)
    q, k, v = (_np(rng, B, S, h, d) for S, h, d in ((Sq, H, hd),
                                                    (Sk, KV, hd),
                                                    (Sk, KV, hd_v)))
    do = _np(rng, B, Sq, H, hd_v)
    scale = hd ** -0.5
    kw = dict(causal=causal, window=window)

    def loss(qj, kj, vj):
        return jnp.sum(attention_reference(qj, kj, vj, scale=scale, **kw)
                       * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    o = attention_reference(q, k, v, scale=scale, **kw)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    ot, dot = torch.from_numpy(np.array(o)), torch.from_numpy(do)
    lse = ref.attention_lse_ref(qt, kt, scale=scale, **kw)
    given = ref.attention_bwd_ref(qt, kt, vt, ot, dot, scale=scale, lse=lse,
                                  **kw)
    recomputed = ref.attention_bwd_ref(qt, kt, vt, ot, dot, scale=scale,
                                       **kw)
    for name, a, b, c in zip("qkv", given, recomputed, want):
        c = torch.from_numpy(np.array(c))
        assert a.shape == c.shape, name
        assert _gap(a, b) <= 1e-5, (name, _gap(a, b))
        assert _gap(a, c) <= 1e-5, name
        assert _gap(b, c) <= 1e-5, name


# (dtype, Sq, Sk, hd, hd_v, window, positions) -> route, or the error
ATTN_ROUTES = [
    (torch.bfloat16, 2048, 2048, 64, 64, 0, False, "tc"),
    (torch.bfloat16, 2048, 2048, 128, 128, 1024, False, "tc"),
    (torch.bfloat16, 3, 3, 64, 64, 0, False, "tc"),
    (torch.float32, 2048, 2048, 64, 64, 1024, False, "general"),
    (torch.float32, 77, 130, 128, 128, 0, False, "general"),
    (torch.bfloat16, 64, 64, 64, 64, 0, True, "explicit positions"),
    (torch.bfloat16, 64, 64, 192, 128, 0, False, "tc"),
    (torch.float32, 2048, 2048, 192, 128, 0, False, "general"),
    (torch.bfloat16, 30, 30, 192, 128, 16, False, "tc"),
    (torch.bfloat16, 1500, 1500, 80, 80, 0, False, "tc"),     # hubert
    (torch.float32, 1500, 1500, 80, 80, 0, False, "general"),
    (torch.bfloat16, 64, 64, 80, 64, 0, False, "head dims"),
    (torch.bfloat16, 64, 64, 192, 192, 0, False, "head dims"),
    (torch.float32, 64, 64, 128, 64, 0, False, "head dims"),
    (torch.float32, 64, 64, 32, 32, 0, False, "head dims"),
    (torch.float16, 64, 64, 64, 64, 0, False, "no backward kernel"),
    (torch.bfloat16, 30, 8, 64, 64, 4, False, "without a key"),
]


@pytest.mark.parametrize("dtype,Sq,Sk,hd,hd_v,window,pos,want", ATTN_ROUTES)
def test_attention_bwd_route(dtype, Sq, Sk, hd, hd_v, window, pos, want):
    if want in ("tc", "general"):
        assert fa.bwd_route(dtype, Sq, Sk, hd, hd_v, window, pos) == want
    else:
        with pytest.raises(RuntimeError, match=want):
            fa.bwd_route(dtype, Sq, Sk, hd, hd_v, window, pos)


# (dtype, D, F) -> route, or the error
GMM_ROUTES = [
    (torch.bfloat16, 2048, 1024, "tc"),
    (torch.bfloat16, 40, 24, "tc"),
    (torch.float32, 1024, 2048, "general"),
    (torch.float32, 16, 8, "general"),
    (torch.bfloat16, 12, 16, "multiples of 8"),
    (torch.float32, 16, 4, "multiples of 8"),
    (torch.float16, 16, 8, "no backward kernel"),
]


@pytest.mark.parametrize("dtype,D,F,want", GMM_ROUTES)
def test_grouped_matmul_bwd_route(dtype, D, F, want):
    if want in ("tc", "general"):
        assert moe_gmm.bwd_route(dtype, D, F) == want
    else:
        with pytest.raises(RuntimeError, match=want):
            moe_gmm.bwd_route(dtype, D, F)


def test_attention_lse_only_from_prefill_tc():
    """The LSE comes from the prefill routes alone, ``prefill_tc`` in bf16
    and ``general`` in f32 (and wherever else ``general`` takes the call):
    a training forward with it goes to one of them even at decode's row
    count, and ``decode_split`` never writes it."""
    assert fa.route(torch.bfloat16, 1, 2, 2, 4, 2, 64, 64, 0, False) == \
        "decode_split"
    assert fa.route(torch.bfloat16, 1, 2, 2, 4, 2, 64, 64, 0, False,
                    with_lse=True) == "prefill_tc"
    assert fa.route(torch.float32, 1, 2, 2, 4, 2, 64, 64, 0, False) == \
        "decode_split"
    for dt in (torch.float32, torch.bfloat16):
        assert fa.route(dt, 1, 2, 2, 4, 2, 64, 32, 0, False,
                        with_lse=True) == "general"
    assert fa.route(torch.float32, 1, 2, 2, 4, 2, 64, 64, 0, False,
                    with_lse=True) == "general"
    assert fa.route(torch.float32, 1, 64, 64, 4, 2, 192, 128, 0, False,
                    with_lse=True) == "general"


@pytest.fixture
def plain_kernels(monkeypatch):
    """``ops.force("cuda")`` with the attention forward, the grouped
    matmul's forward and both backward launches on their plain versions:
    the Functions, routes and counters run as on the card, on CPU
    tensors.  Records what each backward launch was handed."""
    seen = {"attn": [], "gmm": []}

    def forward(q, k, v, *, causal, window, scale, return_lse=False,
                q_pos=None, k_pos=None, q_off=0):
        o = ref.attention_ref(q, k, v, causal=causal, window=window,
                              scale=scale, q_off=q_off)
        if return_lse:
            return o, ref.attention_lse_ref(q, k, causal=causal,
                                            window=window, scale=scale,
                                            q_off=q_off)
        return o

    def attn_launch(which, q, k, v, o, do, lse, causal, window, scale,
                    q_off=0):
        seen["attn"].append((which, lse))
        return ref.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                     window=window, scale=scale, lse=lse,
                                     q_off=q_off)

    def gmm_launch(which, x, w, dy, C, fills, need_dx, need_dw):
        seen["gmm"].append((which, need_dx, need_dw))
        dx, dw = ref.grouped_matmul_aligned_bwd_ref(x, w, dy, C, fills)
        return dx if need_dx else None, dw if need_dw else None

    monkeypatch.setattr(fa, "flash_attention", forward)
    monkeypatch.setattr(fa, "_bwd_launch", attn_launch)
    monkeypatch.setattr(moe_gmm, "grouped_matmul",
                        lambda x, w, C, fills=None:
                        ref.grouped_matmul_aligned_ref(x, w, C, fills))
    monkeypatch.setattr(moe_gmm, "_bwd_launch", gmm_launch)
    ops.force("cuda")
    ops.reset_launches()
    yield seen
    ops.force(None)
    ops.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (2, 13, 13, 6, 2, 64, True, 5), (1, 9, 12, 4, 4, 128, False, 0),
    (2, 11, 11, 4, 4, (192, 128), True, 0),
    (1, 14, 14, 4, 2, (192, 128), True, 5),
    (1, 9, 12, 2, 1, (192, 128), False, 0),
    (1, 9, 12, 4, 4, 80, False, 0), (2, 13, 11, 4, 2, 80, False, 5)])
def test_attention_function_hands_lse_to_its_backward(
        plain_kernels, B, Sq, Sk, H, KV, hd, causal, window, dtype):
    hd, hd_v = _dims(hd)
    rng = np.random.default_rng(hd + Sq + window)
    ins = [torch.from_numpy(_np(rng, B, S, h, d)).to(dtype)
           for S, h, d in ((Sq, H, hd), (Sk, KV, hd), (Sk, KV, hd_v))]
    do = torch.from_numpy(_np(rng, B, Sq, H, hd_v)).to(dtype)
    kw = dict(causal=causal, window=window)
    leaves = [t.clone().requires_grad_() for t in ins]
    ops.attention(*leaves, **kw).backward(do)
    got = [t.grad for t in leaves]
    ops.force(None)
    plain = [t.clone().requires_grad_() for t in ins]
    ref.attention_ref(*plain, **kw).backward(do)
    ops.force("cuda")
    which = "tc" if dtype == torch.bfloat16 else "general"
    (seen_route, lse), = plain_kernels["attn"]
    assert seen_route == which
    # both routes take the forward's LSE (``general`` no longer recomputes
    # it)
    want = ref.attention_lse_ref(*ins[:2], scale=hd ** -0.5, **kw)
    assert lse is not None and torch.equal(lse, want)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, plain):
        assert a.dtype == dtype and a.shape == b.shape
        assert _gap(a, b.grad) <= tol
    assert ops.launches["attention_bwd"] == 1
    assert ops.bwd_route_launches == {
        "attention_tc": int(which == "tc"),
        "attention_general": int(which == "general"),
        "gmm_tc": 0, "gmm_general": 0}


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (2, 13, 13, 4, 4, (192, 128), True, 0),
    (1, 20, 20, 4, 2, (192, 128), True, 7),
    (1, 9, 12, 4, 4, 80, False, 0),
    (2, 14, 10, 4, 2, 80, False, 6)])
def test_f32_attention_function_takes_the_forward_lse(
        plain_kernels, B, Sq, Sk, H, KV, hd, causal, window):
    """The f32 ``_Attention`` Function saves the forward's LSE and hands
    it to ``general``; its gradients within 1e-5 of ``jax.grad`` of the
    JAX package's ``attention_reference`` (f32, the largest entry's
    scale) at MLA's (192, 128) and hubert's (80, 80)."""
    hd, hd_v = _dims(hd)
    rng = np.random.default_rng(Sq * 13 + H + hd + window)
    q, k, v = (_np(rng, B, S, h, d) for S, h, d in ((Sq, H, hd),
                                                    (Sk, KV, hd),
                                                    (Sk, KV, hd_v)))
    do = _np(rng, B, Sq, H, hd_v)
    kw = dict(causal=causal, window=window)

    def loss(qj, kj, vj):
        return jnp.sum(attention_reference(qj, kj, vj, scale=hd ** -0.5,
                                           **kw) * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ops.attention(*leaves, **kw).backward(torch.from_numpy(do))
    (which, lse), = plain_kernels["attn"]
    assert which == "general"
    assert torch.equal(lse, ref.attention_lse_ref(
        *(t.detach() for t in leaves[:2]), scale=hd ** -0.5, **kw))
    for name, t, c in zip("qkv", leaves, want):
        assert _gap(t.grad, torch.from_numpy(np.array(c))) <= 1e-5, name
    assert ops.bwd_route_launches["attention_general"] == 1


def test_attention_backward_requires_lse_exactly_for_tc():
    """Both routes need the forward's LSE: without it ``tc`` (bf16) and
    ``general`` (f32) raise before any launch; with it the call goes on
    to the tensors' checks."""
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    kw = dict(causal=True, window=0, scale=0.125)
    with pytest.raises(ValueError, match="log-sum-exp"):
        fa.attention_bwd(q, k, k, q, q, **kw)
    with pytest.raises(ValueError, match="log-sum-exp"):
        fa.attention_bwd(q.float(), k.float(), k.float(), q.float(),
                         q.float(), **kw)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.attention_bwd(q.float(), k.float(), k.float(), q.float(),
                         q.float(), lse=lse, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.attention_bwd(q, k, k, q, q, lse=lse, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need", ["both", "dx", "dw"])
def test_grouped_matmul_function_matches_plain_autograd(plain_kernels,
                                                        dtype, need):
    G, C, D, F = 4, 70, 16, 24
    rng = np.random.default_rng(G + C + D)
    x = torch.from_numpy(_np(rng, G * C, D)).to(dtype)
    w = torch.from_numpy(_np(rng, G, D, F) / 4).to(dtype)
    dy = torch.from_numpy(_np(rng, G * C, F)).to(dtype)
    fills = torch.tensor([0, 1, 65, C], dtype=torch.int32)
    past = torch.arange(C)[None, :] >= fills[:, None]
    x.view(G, C, D)[past] = float("nan")
    dy.view(G, C, F)[past] = float("nan")
    leaves = [t.clone().requires_grad_(need in ("both", n))
              for t, n in ((x, "dx"), (w, "dw"))]
    y = ops.grouped_matmul_aligned(*leaves, C, fills)
    y.backward(dy)
    # autograd of the plain version on the same inputs with zeros past the
    # fills: its products would carry the NaN into dw as 0 * NaN
    ops.force(None)
    x0, dy0 = x.clone(), dy.clone()
    x0.view(G, C, D)[past] = 0
    dy0.view(G, C, F)[past] = 0
    plain = [t.clone().requires_grad_(need in ("both", n))
             for t, n in ((x0, "dx"), (w, "dw"))]
    ref.grouped_matmul_aligned_ref(*plain, C, fills).backward(dy0)
    ops.force("cuda")
    which = "tc" if dtype == torch.bfloat16 else "general"
    assert plain_kernels["gmm"] == [(which, need in ("both", "dx"),
                                     need in ("both", "dw"))]
    for a, b in zip(leaves, plain):
        if not a.requires_grad:
            assert a.grad is None
            continue
        assert torch.isfinite(a.grad).all()
        assert _gap(a.grad, b.grad) <= (1e-6 if dtype == torch.float32
                                        else 2e-2)
    if need != "dw":
        assert bool((leaves[0].grad.view(G, C, D)[past] == 0).all())
    assert ops.launches["grouped_matmul_bwd"] == 1
    assert ops.bwd_route_launches == {
        "attention_tc": 0, "attention_general": 0,
        "gmm_tc": int(which == "tc"), "gmm_general": int(which == "general")}
