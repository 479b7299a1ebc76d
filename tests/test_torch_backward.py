"""The backward kernels' plain versions and the gradient guard, on the CPU.

``ref.attention_bwd_ref`` and ``ref.mamba_scan_bwd_ref`` spell out the
arithmetic of ``csrc/attention_bwd.cu`` and ``csrc/mamba_scan_bwd.cu``;
here each is held against autograd of the plain forward (``attention_ref``,
``mamba_scan_ref``) on inputs drawn with numpy: GQA, causal and not,
windows, Sq != Sk, MLA's head dims (192, 128), several checkpoint
chunkings, segmentings and state sizes.  ``mamba_scan.bwd_plan``, the
scan backward's segment plan and scratch, is checked as the launcher
computes it.  In f32
the two agree within 1e-5 of each gradient's largest entry (the same
arithmetic in another order); bf16 inputs within 2e-2 (the gradients are
rounded to bf16, 8 bits).

The guard: a kernel call that needs a gradient and has no backward kernel
raises before anything runs, so a CPU tensor under ``ops.force("cuda")``
shows the message; a call the attention, scan or grouped-matmul backward
takes goes into its autograd Function, on to the kernel's input checks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# (B, Sq, Sk, H, KV, hd, causal, window); hd a pair (hd, hd_v) for
# MLA's call, (192, 128)
ATTN_CASES = [
    (2, 13, 13, 6, 2, 8, True, 0),
    (2, 13, 13, 6, 2, 8, True, 5),
    (1, 9, 7, 4, 4, 16, False, 0),
    (2, 12, 12, 5, 1, 8, False, 4),
    (1, 10, 12, 6, 3, 8, True, 3),
    (1, 20, 20, 2, 1, 64, True, 7),
    (2, 13, 13, 4, 4, (192, 128), True, 0),
    (1, 12, 12, 4, 2, (192, 128), True, 5),
    (1, 7, 10, 2, 1, (192, 128), False, 0),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", ATTN_CASES)
def test_attention_bwd_ref_matches_autograd(B, Sq, Sk, H, KV, hd, causal,
                                            window, dtype, tol):
    hd, hd_v = hd if isinstance(hd, tuple) else (hd, hd)
    rng = np.random.default_rng(Sq * 100 + H + window)
    q, k, v = (_t(rng, B, S, h, d, dtype=dtype).requires_grad_()
               for S, h, d in ((Sq, H, hd), (Sk, KV, hd), (Sk, KV, hd_v)))
    do = _t(rng, B, Sq, H, hd_v, dtype=dtype)
    o = ref.attention_ref(q, k, v, causal=causal, window=window)
    o.backward(do)
    got = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                o.detach(), do, causal=causal, window=window,
                                scale=hd ** -0.5)
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert _gap(g, t.grad) <= tol


# (B, S, di, N, chunk, segment): chunks shorter than, equal to and longer
# than S, not dividing it, and every state size, in one segment (ids as
# before segments existed); then segments that do not divide S, of one
# step, of one chunk, longer than S, and every state size across segments
SCAN_CASES = [
    *(pytest.param(*c, None, id="-".join(map(str, c))) for c in (
        (2, 23, 5, 4, 16), (2, 23, 5, 4, 4), (1, 33, 6, 4, 5),
        (2, 16, 3, 4, 16), (1, 7, 4, 16, 64), (2, 30, 3, 1, 7),
        (1, 20, 3, 2, 1), (1, 25, 2, 8, 8))),
    (2, 23, 5, 4, 4, 8), (1, 33, 6, 4, 5, 10), (1, 70, 6, 16, 16, 32),
    (2, 9, 3, 4, 16, 1), (1, 40, 5, 16, 8, 8), (2, 7, 4, 4, 16, 32),
    (2, 30, 3, 1, 7, 14), (1, 20, 3, 2, 4, 8), (1, 25, 2, 8, 8, 16),
    (1, 37, 4, 16, 16, 16),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,di,N,chunk,segment", SCAN_CASES)
def test_mamba_scan_bwd_ref_matches_autograd(B, S, di, N, chunk, segment,
                                             dtype, tol):
    rng = np.random.default_rng(S * 10 + N + chunk + (segment or 0))
    u = _t(rng, B, S, di, dtype=dtype).requires_grad_()
    dt = torch.nn.functional.softplus(_t(rng, B, S, di)).to(dtype)
    dt.requires_grad_()
    A = (-torch.arange(1, N + 1, dtype=torch.float32).expand(di, N)
         * torch.from_numpy(rng.uniform(0.2, 1.0, (di, 1)).astype(np.float32))
         ).contiguous().requires_grad_()
    Bc = _t(rng, B, S, N, dtype=dtype).requires_grad_()
    Cc = _t(rng, B, S, N, dtype=dtype).requires_grad_()
    D = _t(rng, di).requires_grad_()
    y, _ = ref.mamba_scan_ref(u, dt, A, Bc, Cc, D)
    dy = _t(rng, B, S, di, dtype=dtype)
    y.backward(dy)
    got = ref.mamba_scan_bwd_ref(*(t.detach() for t in (u, dt, A, Bc, Cc, D)),
                                 dy, chunk=chunk, segment=segment)
    for g, t in zip(got, (u, dt, A, Bc, Cc, D)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _gap(g, t.grad) <= tol


@pytest.mark.parametrize("B,S,di,N,segment,seg_len,nseg", [
    (4, 2048, 3200, 16, None, 256, 8),    # hymba's training shape
    (4, 2048, 3200, 16, 128, 128, 16),
    (4, 2048, 3200, 16, 2048, 2048, 1),
    (2, 37, 70, 4, None, 8, 5),           # one chunk a segment
    (1, 1, 33, 16, None, 8, 1),
    (2, 100, 64, 16, 48, 48, 3),
    (2, 129, 64, 16, 128, 128, 2),        # a last segment of one step
    (1, 100, 64, 16, None, 8, 13),        # at most a segment a chunk
])
def test_scan_bwd_plan(B, S, di, N, segment, seg_len, nseg):
    """The segment plan and scratch shapes ``mamba_scan_bwd`` launches
    with: whole chunks a segment, the segments cover S, the scratch in the
    launcher's order; a segment not a multiple of a chunk raises."""
    from repro_torch.kernels import mamba_scan as ms
    plan = ms.bwd_plan(B, S, di, N, segment)
    assert (plan["seg_len"], plan["nseg"]) == (seg_len, nseg)
    assert seg_len % ms.BWD_CHUNK == 0
    assert (nseg - 1) * seg_len < S <= nseg * seg_len
    with pytest.raises(ValueError, match="multiple"):
        ms.bwd_plan(B, S, di, N, ms.BWD_CHUNK + 1)
    chunks, nblk = -(-S // ms.BWD_CHUNK), -(-di // ms.BWD_CHANNELS)
    assert plan["shapes"] == {
        "ckpt": (B, chunks, di, N), "cumdt": (B, chunks, di),
        "hend": (B, nseg, di, N), "gsum": (B, nseg, di, N),
        "dtsum": (B, nseg, di), "part": (nblk, B, S, 2 * N),
        "dA_part": (B, nseg, di, N), "dD_part": (B, nseg, di)}


@pytest.fixture
def forced_cuda():
    ops.force("cuda")
    yield
    ops.force(None)


def test_guard_raises_for_kernels_without_backward(forced_cuda):
    rng = np.random.default_rng(0)
    q = _t(rng, 1, 8, 2, 64).requires_grad_()
    k = _t(rng, 1, 8, 1, 64)
    pos = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(RuntimeError, match="explicit positions"):
        ops.attention(q, k, k, q_pos=pos, k_pos=pos)
    q16 = _t(rng, 1, 8, 2, 16).requires_grad_()
    with pytest.raises(RuntimeError, match="head dims"):
        ops.attention(q16, _t(rng, 1, 8, 1, 16), _t(rng, 1, 8, 1, 16))
    with pytest.raises(RuntimeError, match="without a key"):
        ops.attention(_t(rng, 1, 30, 2, 64).requires_grad_(), k, k, window=4)
    q192 = _t(rng, 1, 8, 2, 192).requires_grad_()
    with pytest.raises(RuntimeError, match="head dims"):     # (192, 192)
        ops.attention(q192, _t(rng, 1, 8, 1, 192), _t(rng, 1, 8, 1, 192))
    u, dt = _t(rng, 1, 8, 6).requires_grad_(), _t(rng, 1, 8, 6)
    A, D = -torch.ones(6, 4), torch.ones(6)
    Bc, Cc, h0 = _t(rng, 1, 8, 4), _t(rng, 1, 8, 4), torch.zeros(1, 6, 4)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.mamba_scan(u, dt, A, Bc, Cc, D, init_state=h0)
    x, w = _t(rng, 8, 16).requires_grad_(), _t(rng, 2, 16, 4)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.grouped_matmul_aligned(x, w, 4)           # F = 4: not a multiple
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.grouped_matmul_aligned(x.detach().half(),
                                   w.half().requires_grad_(), 4)


def test_guard_lets_calls_the_backward_takes_reach_the_kernel(forced_cuda):
    """Under force("cuda") a CPU tensor reaches the kernel's input check:
    the call went into the autograd Function, not around it."""
    rng = np.random.default_rng(1)
    q = _t(rng, 1, 8, 2, 64).requires_grad_()
    k = _t(rng, 1, 8, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.attention(q, k, k, window=4)
    with pytest.raises(ValueError, match="CUDA tensor"):     # MLA's dims
        ops.attention(_t(rng, 1, 8, 2, 192).requires_grad_(),
                      _t(rng, 1, 8, 2, 192), _t(rng, 1, 8, 2, 128))
    u = _t(rng, 1, 8, 6).requires_grad_()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.mamba_scan(u, _t(rng, 1, 8, 6), -torch.ones(6, 4),
                       _t(rng, 1, 8, 4), _t(rng, 1, 8, 4), torch.ones(6))
    x, w = _t(rng, 8, 16), _t(rng, 2, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.grouped_matmul_aligned(x.requires_grad_(), w, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.grouped_matmul_aligned(x.detach(), w.requires_grad_(), 4)
    # no gradient needed: the forward kernels as before
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.attention(q, k, k, q_pos=torch.zeros(1, 8, dtype=torch.int32),
                          k_pos=torch.zeros(1, 8, dtype=torch.int32))


def test_plain_versions_differentiate_on_the_cpu():
    """CPU tensors take the plain versions, which autograd differentiates
    whatever the call: positions, a state, ragged groups."""
    rng = np.random.default_rng(2)
    q = _t(rng, 1, 6, 2, 16).requires_grad_()
    k = _t(rng, 1, 6, 1, 16)
    pos = torch.arange(6, dtype=torch.int32)[None]
    ops.attention(q, k, k, q_pos=pos, k_pos=pos).sum().backward()
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
    x = _t(rng, 8, 16).requires_grad_()
    ops.grouped_matmul_aligned(x, _t(rng, 2, 16, 4), 4).sum().backward()
    assert x.grad.abs().sum() > 0


def test_backward_counters_exist_and_reset():
    assert {"attention_bwd", "mamba_scan_bwd",
            "grouped_matmul_bwd"} <= set(ops.launches)
    assert set(ops.bwd_route_launches) == {
        "attention_tc", "attention_general", "gmm_tc", "gmm_general"}
    ops.launches["attention_bwd"] = 3
    ops.launches["grouped_matmul_bwd"] = 2
    ops.bwd_route_launches["attention_tc"] = 3
    ops.bwd_route_launches["gmm_general"] = 1
    ops.reset_launches()
    assert not any(ops.launches.values())
    assert not any(ops.bwd_route_launches.values())
