"""The port on the card: each CUDA kernel against its plain PyTorch
version, the device-resident pass on CUDA against the host path, and the
serving model's kernel path against its plain path.

These tests need a CUDA device and skip without one; they import nothing
of JAX, so they run on a machine with the card alone:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs tiny ops here: extra threads per pytest worker only contend
torch.set_num_threads(1)

from repro_torch.core.partition import heuristic as th  # noqa: E402
from repro_torch.core.partition.engine import _tables  # noqa: E402
from repro_torch.datagen import large_row_net  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.kernels import (front_find, front_pass,  # noqa: E402
                                 gain, moe_gmm, ops, ref)
from repro_torch.launch.serve import (GreedyStep, make_model,  # noqa: E402
                                      serve)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _pc(P):
    _, _, order_pc, _ = _tables(P)
    return np.concatenate(([gain._NO_COVER], order_pc)).astype(np.int32)


# ------------------------------------------------------ the fused find
def _find_case(P, seed, device, *, rep=False, queue=1, n=300, m=420,
               r_blk_min=16):
    """A random device pass on ``device`` in a pass's middle: random masks
    (several bits for replication), 20 isolated nodes, small row blocks (many
    of them), random feasibility, and ``queue`` host mutations queued for
    the next find (several share edges, and one node mutates twice).  Returns
    the pass, the kernel's inputs, a copy of the mutable buffers for the
    plain version, the queue and the active blocks."""
    from repro_torch.core.hypergraph import Hypergraph
    from repro_torch.core.partition import PartitionState
    rng = np.random.default_rng(seed)
    live = n - 20
    edges = [tuple(sorted(rng.choice(live, size=int(rng.integers(2, 7)),
                                     replace=False).tolist()))
             for _ in range(m)]
    hg = Hypergraph(n=n, edges=edges, omega=np.ones(n),
                    mu=rng.integers(1, 6, size=m).astype(float))
    if rep:
        masks = rng.integers(1, 1 << P, size=n)
    else:
        masks = 1 << rng.integers(0, P, size=n)
    st = PartitionState(hg, P, masks=masks.astype(np.int64))
    saved = front_pass.DEVICE_MIN_NODES, front_pass._R_BLK_MIN
    front_pass.DEVICE_MIN_NODES, front_pass._R_BLK_MIN = 1, r_blk_min
    try:
        dev = front_pass.attach(st, 1e9, device=device)
    finally:
        front_pass.DEVICE_MIN_NODES, front_pass._R_BLK_MIN = saved
    assert dev is not None
    dev._build_blocks(rng.permutation(n))
    v = int(hg.edges[0][0])
    u = int(hg.edges[0][1])                       # shares edge 0 with v
    nodes = [v, u, v] + rng.integers(0, n, size=3).tolist()
    for w in nodes[:queue]:
        st.apply(w, int(1 << rng.integers(0, P)) | (
            int(st.masks[w]) if rep else 0))
        st.commit()
    x = dev._inputs()
    fits = rng.random((n + 1, P)) < 0.8
    fits[n] = False
    x.fits = torch.from_numpy(fits).to(device)
    y = front_find.FindInputs(**{**x.__dict__, "uncov": x.uncov.clone(),
                                 "lam": x.lam.clone(),
                                 "masks": x.masks.clone()})
    queue_ = list(dev._pending)
    dev._pending.clear()
    active = np.flatnonzero(rng.random(dev._nb) < 0.7)
    return dev, x, y, queue_, active


def _run_find_case(x, y, queue, blocks, *, rep, start_pos, resume_p,
                   maxrep):
    kw = dict(rep=rep, start_pos=start_pos, resume_p=resume_p,
              maxrep=maxrep)
    got = front_find.front_find(x, queue, blocks, **kw)
    want = front_find.front_find_ref(y, queue, blocks, **kw)
    torch.cuda.synchronize()
    assert got.tolist() == want.tolist()
    for name in ("uncov", "lam", "masks"):
        assert torch.equal(getattr(x, name), getattr(y, name)), name
    return got.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("P,R", [(4, 2048), (8, 2048 * 9 + 5), (2, 1)])
def test_kernels_match_plain_versions(cuda, P, R):
    """The min-cover kernel and the fused find against their plain versions;
    ``front_dlam`` has no kernel of its own and refuses a CUDA tensor."""
    rng = np.random.default_rng(300 + P)
    M = 1 << P
    rows = (rng.random((R, M)) > 0.1).astype(np.int32) * rng.integers(
        1, 4, size=(R, M)).astype(np.int32)
    rows[::7] = 1                                  # no zero: the sentinel
    rows_t = torch.from_numpy(rows).to(cuda)
    pc_t = torch.from_numpy(_pc(P)).to(cuda)
    lam_old = torch.from_numpy(
        rng.integers(0, P + 2, size=R).astype(np.int32)).to(cuda)
    _, x, y, queue, blocks = _find_case(P, 300 + P, cuda)
    ops.reset_launches()
    lam = gain.min_cover(rows_t, pc_t)
    _run_find_case(x, y, queue, blocks, rep=False, start_pos=0, resume_p=-1,
                   maxrep=0)
    assert {k: ops.launches[k] for k in (
        "front_find", "front_apply", "min_cover_lambdas")} == {
        "front_find": 1, "front_apply": 0, "min_cover_lambdas": 1}
    assert torch.equal(lam, ref.min_cover_ref(rows_t, pc_t))
    assert bool((lam[::7] == gain._NO_COVER).all())
    with pytest.raises(ValueError, match="front_find"):
        gain.front_dlam(rows_t, pc_t, lam_old)


@pytest.mark.cuda
@pytest.mark.parametrize("queue", [0, 1, 4])
@pytest.mark.parametrize("mode", ["fm", "rep"])
@pytest.mark.parametrize("P", [2, 4, 8, 12])
def test_front_find_matches_plain_version(cuda, P, mode, queue):
    """Equal triples and equal buffers after the apply, over many small
    blocks: from the first active block, from a start position inside the
    list (the blocks before it hold no position in the window), with the
    replication resume protocol and a replica cap, and over no block at all
    (the apply alone)."""
    rep = mode == "rep"
    dev, x, y, q, blocks = _find_case(P, 17 * P + queue, cuda, rep=rep,
                                      queue=queue, n=120 if P == 12 else 300)
    assert dev._nb > 8
    mid = int(dev._bounds[blocks[len(blocks) // 2]]) + 1
    cases = [(0, -1, P + 1), (mid, -1, P + 1), (mid, 1, 2)]
    for i, (start, resume, maxrep) in enumerate(cases):
        _run_find_case(x, y, q if i == 0 else [], blocks, rep=rep,
                       start_pos=start, resume_p=resume, maxrep=maxrep)
    # the apply alone, then a scan past every block: no event
    _run_find_case(x, y, [(0, int(x.masks[0]), 1)], blocks[:0], rep=rep,
                   start_pos=0, resume_p=-1, maxrep=P + 1)
    got = _run_find_case(x, y, [], blocks, rep=rep, start_pos=dev.n,
                         resume_p=-1, maxrep=P + 1)
    assert got == [dev.n, 0, 0]


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    pc_t = torch.from_numpy(_pc(4)).to(cuda)
    with pytest.raises(ValueError, match="int32"):
        gain.min_cover(torch.ones((4, 16), dtype=torch.int64, device=cuda),
                       pc_t)
    with pytest.raises(ValueError, match="contiguous"):
        gain.min_cover(torch.ones((16, 4), dtype=torch.int32,
                                  device=cuda).t(), pc_t)
    with pytest.raises(ValueError, match="shape"):
        gain.min_cover(torch.ones((4, 8), dtype=torch.int32, device=cuda),
                       pc_t)


@pytest.mark.cuda
def test_device_pass_on_cuda_matches_host_path(cuda, monkeypatch):
    monkeypatch.setattr(front_pass, "DEVICE_MIN_NODES", 1)
    passes = []
    real_attach = front_pass.attach

    def attach(*a, **kw):
        d = real_attach(*a, **kw)
        passes.append(d)
        return d

    monkeypatch.setattr(front_pass, "attach", attach)
    hg = large_row_net(1024, seed=1024)
    ops.reset_launches()
    a = th.partition_with_replication(hg, 4, 0.05, frontier="torch",
                                      device=cuda)
    passes = [d for d in passes if d is not None]
    finds = sum(d.finds for d in passes)
    assert passes and finds > 0
    # one launch and one read per find; the queue always rides a find
    assert ops.launches["front_find"] == finds
    assert ops.launches["front_apply"] == 0
    for d in passes:
        assert d.syncs == d.finds and d.apply_dispatches == 0
        assert d.commits <= d.finds <= d.commits + d.pass_scans
    b = th.partition_with_replication(hg, 4, 0.05, frontier="numpy")
    for ra, rb in zip(a, b):
        assert np.array_equal(ra.masks, rb.masks) and ra.cost == rb.cost


# ------------------------------------------------------ attention and scan
# f32 1e-5 (the summation order differs from the plain version's), bf16
# 2e-2 for attention and 3e-2 for the scan: tests/test_kernels.py's bounds.
_ATOL = {torch.float32: {"attn": 1e-5, "scan": 1e-5},
         torch.bfloat16: {"attn": 2e-2, "scan": 3e-2}}


@pytest.fixture
def no_tf32():
    """f32 products in full f32 for the plain versions."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


ATTN_CASES = [
    # (B, Sq, Sk, H, KV, hd, hd_v, causal, window, positions, routes):
    # routes is the kernel ``flash_attention.route`` picks in f32 and bf16
    (2, 70, 70, 6, 2, 16, 16, True, 0, None,         # ragged tiles, G = 3
     ("general", "general")),
    (1, 33, 90, 5, 5, 64, 64, False, 0, None,        # not causal, Sq != Sk
     ("general", "prefill_tc")),
    (2, 130, 130, 5, 1, 32, 32, True, 24, None,      # sliding window, G = 5
     ("general", "general")),
    (2, 1, 150, 10, 2, 64, 64, True, 0, "linear",    # decode, linear cache
     ("decode_split", "decode_split")),
    (2, 1, 64, 10, 2, 64, 64, True, 0, "ring",       # decode, ring with pads
     ("decode_split", "decode_split")),
    (1, 40, 40, 4, 2, 192, 128, True, 0, None,       # hd 192, hd_v 128
     ("general", "prefill_tc")),
    # the tensor-core prefill: Sq and Sk not multiples of 64, G 5 and 1
    (2, 200, 200, 10, 2, 64, 64, True, 0, None,
     ("general", "prefill_tc")),
    (1, 150, 150, 4, 4, 128, 128, True, 0, None,
     ("general", "prefill_tc")),
    (1, 77, 190, 6, 6, 128, 128, False, 0, None,
     ("general", "prefill_tc")),
    # window edges inside a key tile
    (2, 300, 300, 5, 1, 64, 64, True, 100, None,
     ("general", "prefill_tc")),
    (1, 260, 260, 2, 2, 128, 128, True, 70, None,
     ("general", "prefill_tc")),
    # split-K decode: G 1 and 5 at hd 128, a window, and a ring of 1000
    # slots with 20 filled, so that its first splits are all padding
    (2, 1, 333, 4, 4, 128, 128, True, 0, "linear",
     ("decode_split", "decode_split")),
    (1, 1, 517, 10, 2, 128, 128, True, 0, "linear",
     ("decode_split", "decode_split")),
    (2, 1, 300, 8, 8, 64, 64, True, 50, "linear",
     ("decode_split", "decode_split")),
    (2, 1, 1000, 4, 2, 64, 64, True, 0, "ring",
     ("decode_split", "decode_split")),
    # the general route on the tensor cores: hd 40 and 20 (not a multiple
    # of 16; 20 loads element by element in bf16), 18 (element by element
    # in f32 too), hubert's 80 (non-causal, and with a window; bf16 on the
    # tensor-core prefill, two boxes a row), 256, MLA's 192/128
    # non-causal, ragged Sq and Sk
    (2, 37, 70, 4, 2, 40, 40, True, 0, None, ("general", "general")),
    (1, 50, 50, 2, 2, 20, 20, True, 0, None, ("general", "general")),
    (1, 33, 40, 2, 1, 18, 18, False, 0, None, ("general", "general")),
    (1, 100, 150, 4, 4, 80, 80, False, 0, None, ("general", "prefill_tc")),
    (2, 90, 90, 6, 2, 80, 80, True, 33, None, ("general", "prefill_tc")),
    (1, 70, 130, 2, 1, 256, 256, True, 0, None, ("general", "general")),
    (1, 65, 65, 4, 4, 192, 128, False, 0, None, ("general", "prefill_tc")),
    # positions with more than 16 rows per (batch, kv head): a chunk of
    # queries at the end of a cache whose first keys are padding
    (2, 24, 100, 6, 2, 64, 64, True, 0, "chunk", ("general", "general")),
    (1, 20, 96, 4, 4, 128, 128, True, 40, "chunk", ("general", "general")),
    # grids of at least 2 x 132 blocks of 128 rows, where the general
    # kernel takes two m tiles per warp: hubert's dims with ragged keys,
    # GQA with a window edge, MLA's dims, positions
    (4, 640, 700, 16, 16, 80, 80, False, 0, None,
     ("general", "prefill_tc")),
    (3, 600, 600, 20, 4, 48, 48, True, 200, None, ("general", "general")),
    (2, 1100, 1100, 16, 16, 192, 128, True, 0, None,
     ("general", "prefill_tc")),
    (4, 600, 700, 16, 16, 64, 64, True, 0, "chunk", ("general", "general")),
    # MLA's head dims (192, 128) on the tensor-core prefill (two stages of
    # 128-key tiles): Sq and Sk not multiples of the tile, KV = H and GQA,
    # causal and not, a window edge; and with positions on the general
    # route in bf16 too
    (1, 200, 200, 4, 4, 192, 128, True, 0, None, ("general", "prefill_tc")),
    (2, 77, 190, 6, 2, 192, 128, False, 0, None, ("general", "prefill_tc")),
    (2, 333, 333, 8, 2, 192, 128, True, 0, None, ("general", "prefill_tc")),
    (1, 300, 300, 4, 4, 192, 128, True, 70, None,
     ("general", "prefill_tc")),
    (1, 30, 90, 4, 4, 192, 128, True, 0, "chunk", ("general", "general")),
    # llama-3.2-vision's calls: a cross decode (non-causal, no positions:
    # every key counts), and the tensor-core prefill at GQA group 4, hd
    # 128, causal with Sq = Sk and cross (non-causal, Sk not a multiple of
    # the 128-key tile)
    (2, 1, 100, 8, 2, 128, 128, False, 0, None,
     ("decode_split", "decode_split")),
    (1, 200, 200, 8, 2, 128, 128, True, 0, None, ("general", "prefill_tc")),
    (2, 150, 70, 8, 2, 128, 128, False, 0, None, ("general", "prefill_tc")),
]


def _attn_inputs(case, dtype, dev):
    B, Sq, Sk, H, KV, hd, hdv, causal, window, kind, _ = case
    g = torch.Generator(device=dev).manual_seed(Sq * 7 + Sk)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KV, hdv), generator=g, device=dev).to(dtype)
    qp = kp = None
    if kind == "linear":                  # new token at Sk - 9, future slots
        qp = torch.full((B, 1), Sk - 9, dtype=torch.int32, device=dev)
        kp = torch.arange(Sk, dtype=torch.int32, device=dev).expand(
            B, Sk).contiguous()
    elif kind == "ring":                  # 20 of Sk slots filled so far
        qp = torch.full((B, 1), 19, dtype=torch.int32, device=dev)
        kp = torch.arange(19 - Sk + 1, 20, dtype=torch.int32,
                          device=dev).expand(B, Sk).contiguous()
    elif kind == "chunk":                 # queries at the cache's last Sq
        qp = torch.arange(Sk - Sq, Sk, dtype=torch.int32, device=dev).expand(
            B, Sq).contiguous()
        kp = torch.arange(Sk, dtype=torch.int32, device=dev).repeat(B, 1)
        kp[0, :5] = -1                    # batch row 0: 5 padded slots
    return q, k, v, dict(causal=causal, window=window, q_pos=qp, k_pos=kp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_kernel_matches_plain_version(cuda, no_tf32, case, dtype):
    q, k, v, kw = _attn_inputs(case, dtype, cuda)
    ops.reset_launches()
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    plain = kw["window"] == 0 and kw["q_pos"] is None
    assert ops.launches["flash_attention"] == int(plain)
    assert ops.launches["attention_masked"] == int(not plain)
    taken = case[-1][dtype == torch.bfloat16]
    assert ops.route_launches == {r: int(r == taken)
                                  for r in ops.route_launches}
    want = ref.attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    tol = _ATOL[dtype]["attn"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_prefill_tc_takes_mla_head_dims(cuda, no_tf32):
    """deepseek-v3's prefill head dims (q/k 192, v 128) at 128 heads:
    ``route`` sends bf16 to the tensor-core prefill and f32 to the
    general kernel, and each call launches its route's kernel once."""
    from repro_torch.kernels import flash_attention as fa
    shape = (1, 256, 256, 128, 128, 192, 128, 0, False)
    assert fa.route(torch.bfloat16, *shape) == "prefill_tc"
    assert fa.route(torch.float32, *shape) == "general"
    case = (1, 256, 256, 128, 128, 192, 128, True, 0, None, None)
    for dtype, taken in ((torch.bfloat16, "prefill_tc"),
                         (torch.float32, "general")):
        q, k, v, kw = _attn_inputs(case, dtype, cuda)
        ops.reset_launches()
        got = ops.attention(q, k, v, scale=192 ** -0.5, **kw)
        torch.cuda.synchronize()
        assert ops.route_launches == {r: int(r == taken)
                                      for r in ops.route_launches}
        want = ref.attention_ref(q, k, v, scale=192 ** -0.5, **kw)
        tol = _ATOL[dtype]["attn"]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_repeats_bit_for_bit(cuda, dtype, hd):
    """Two calls on the same inputs give the same bits: the warps of a
    block add their key slots' sums in a fixed order (olmoe's decode shape
    at hd 128: 16 heads, 2052 cached keys, positions)."""
    B, Sk, H, KV = 4, 2052, 16, 16
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((B, 1, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    qp = torch.full((B, 1), Sk - 1, dtype=torch.int32, device=cuda)
    kp = torch.arange(Sk, dtype=torch.int32, device=cuda).repeat(B, 1)
    ops.reset_launches()
    outs = [ops.attention(q, k, v, causal=True, q_pos=qp, k_pos=kp)
            for _ in range(8)]
    torch.cuda.synchronize()
    assert ops.route_launches["decode_split"] == 8
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_fully_masked_rows_are_zero(cuda, dtype):
    """A (batch, kv head) whose keys are all padding reads no split and
    writes 0; its neighbour, with live keys, matches the plain version."""
    B, Sk, H, KV, hd = 2, 300, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((B, 1, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    qp = torch.full((B, 1), Sk - 1, dtype=torch.int32, device=cuda)
    kp = torch.arange(Sk, dtype=torch.int32, device=cuda).repeat(B, 1)
    kp[0] = -1                                     # batch row 0: all padding
    ops.reset_launches()
    got = ops.attention(q, k, v, causal=True, q_pos=qp, k_pos=kp)
    torch.cuda.synchronize()
    assert ops.route_launches["decode_split"] == 1
    assert bool((got[0] == 0).all())
    want = ref.attention_ref(q[1:], k[1:], v[1:], causal=True, q_pos=qp[1:],
                             k_pos=kp[1:].contiguous())
    tol = _ATOL[dtype]["attn"]
    torch.testing.assert_close(got[1:].float(), want.float(), rtol=tol,
                               atol=tol)


def _scan_inputs(B, S, di, N, dtype, dev, seed, dt_kind="small"):
    """``dt_kind`` "small": dt = |normal| / 10 and A = -|normal| - 0.1 (long
    memories); "large": dt = softplus(normal) * 4 and the models' A = -(1,
    ..., N), so that the larger states' exps underflow."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    u = rnd(B, S, di).to(dtype)
    if dt_kind == "large":
        dt = (torch.nn.functional.softplus(rnd(B, S, di)) * 4).to(dtype)
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device=dev).expand(di, N).contiguous()
    else:
        dt = (rnd(B, S, di).abs() * 0.1).to(dtype)
        A = -rnd(di, N).abs() - 0.1
    Bc, Cc = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype)
    return u, dt, A, Bc, Cc, rnd(di)


# (B, S, di, N, with a state, dt kind): the prefill kernel stages 16 steps
# at a time, and a warp (a block) holds 32 / (N / 4) channels, 8 at
# N = 16; rows that are not 16-byte aligned take the element-wise path;
# S = 1 takes the step kernel
SCAN_CASES = [
    (2, 100, 70, 4, False, "small"), (1, 256, 64, 16, False, "small"),
    (3, 1, 96, 16, True, "small"), (2, 37, 40, 4, True, "small"),
    # di not a multiple of the channel tile: element-wise (70, 3204) and
    # 16-byte (3208 at N = 8, 16 channels a warp)
    (2, 100, 70, 16, False, "small"), (2, 64, 3204, 16, False, "small"),
    (2, 64, 3208, 8, False, "small"),
    # S below, equal to and not a multiple of the chunk
    (2, 5, 128, 16, False, "small"), (2, 16, 128, 16, True, "small"),
    (2, 100, 128, 16, False, "small"),
    # every state size
    *[(2, 70, 96, n, False, "small") for n in (1, 2, 4, 8, 16)],
    (2, 1, 96, 8, True, "small"), (2, 1, 96, 1, True, "small"),
    # a long sequence
    (1, 4096, 128, 16, False, "small"),
    # large dt: exps underflow
    (2, 100, 128, 16, False, "large"), (2, 1, 128, 16, True, "large"),
    # B = 1
    (1, 100, 192, 8, True, "small"),
    # the decode step at hymba's shape
    (4, 1, 3200, 16, True, "large"),
    # falcon-mamba-7b's d_inner: the prefill and the decode step.  The
    # prefill takes "small" dt, as the long sequences above: with "large"
    # dt over 2048 steps (|y| up to ~600) the f32 plain version itself is
    # 6.4e-5 off the recurrence in f64 (23 elements past 1e-5 + 1e-5 |y|),
    # and the kernel 6.7e-5 (16), at hymba's width as at falcon's
    # (``probe_scan_f64.py``)
    (4, 2048, 8192, 16, False, "small"), (4, 1, 8192, 16, True, "large"),
    # and a rank's half of its channels on a (1, 2) mesh
    (2, 2048, 4096, 16, False, "small"), (2, 1, 4096, 16, True, "large"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,N,state,dt_kind", SCAN_CASES)
def test_scan_kernel_matches_plain_version(cuda, B, S, di, N, state, dt_kind,
                                           dtype):
    u, dt, A, Bc, Cc, D = _scan_inputs(B, S, di, N, dtype, cuda, S + di,
                                       dt_kind)
    h0 = (torch.randn((B, di, N), device=cuda) if state else None)
    ops.reset_launches()
    y, last = ops.mamba_scan(u, dt, A, Bc, Cc, D, init_state=h0)
    torch.cuda.synchronize()
    assert ops.launches["mamba_step" if state else "mamba_scan"] == 1
    assert sum(ops.launches.values()) == 1
    y_ref, last_ref = ref.mamba_scan_ref(u, dt, A, Bc, Cc, D, init_state=h0)
    tol = _ATOL[dtype]["scan"]
    assert y.dtype == dtype and last.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(last, last_ref, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_model_kernel_wrappers_reject_bad_inputs(cuda):
    u, dt, A, Bc, Cc, D = _scan_inputs(1, 8, 32, 4, torch.float32, cuda, 0)
    xproj = torch.randn((1, 8, 12), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_scan(u, dt, A, xproj[..., 4:8], Cc, D)   # a strided slice
    with pytest.raises(ValueError, match="float32"):
        ops.mamba_scan(u, dt.bfloat16(), A, Bc, Cc, D)
    with pytest.raises(ValueError, match="float32"):
        ops.mamba_scan(u, dt, A.double(), Bc, Cc, D)
    q = torch.randn((1, 4, 2, 8), device=cuda)
    k = torch.randn((1, 4, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="int32"):
        ops.attention(q, k, k, q_pos=torch.zeros((1, 4), dtype=torch.int64,
                                                 device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b",
                                  "smollm-135m"])
def test_model_kernel_path_matches_plain_path(cuda, no_tf32, arch):
    """Reduced configs in f32: prefill and two decode steps through the
    kernels against the same model through the plain versions."""
    cfg = reduce_config(get_config(arch)).with_(dtype="float32")
    model = make_model(cfg, device=cuda, seed=4)
    tokens = torch.randint(0, cfg.vocab, (2, 24), device=cuda)
    runs = {}
    for which in ("cuda", "ref"):
        ops.force(which)
        try:
            with torch.no_grad():
                logits, caches = model.prefill({"tokens": tokens[:, :20]}, 26)
                out = [logits]
                for i in range(2):
                    logits, caches = model.decode_step(
                        tokens[:, 20 + i:21 + i], caches, 20 + i)
                    out.append(logits)
        finally:
            ops.force(None)
        runs[which] = torch.cat(out, dim=1)
    scale = runs["ref"].abs().max().item()
    assert (runs["cuda"] - runs["ref"]).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_serve_on_cuda_counts_every_model_kernel(cuda):
    res = serve(reduce_config(get_config("hymba-1.5b")), 2, 20, 3,
                device=cuda, seed=0)
    # 5 segments of one layer: 3 global, 2 sliding-window; 2 decode steps
    assert res.launches["flash_attention"] == 3
    assert res.launches["attention_masked"] == 2 + 2 * 5
    assert res.launches["mamba_scan"] == 2 * 5       # block + cache pass
    assert res.launches["mamba_step"] == 2 * 5       # G - 1 = 2 steps


def _vision_small(dtype, wide_heads=False):
    """Reduced llama-3.2-vision (two groups of 1 cross + 2 self
    sub-layers, 8 image tokens); ``wide_heads``: 8/2 heads of 128, the
    full model's head dim and GQA group."""
    cfg = reduce_config(get_config("llama-3.2-vision-11b"),
                        layers_per_segment=2).with_(dtype=dtype)
    if wide_heads:
        cfg = cfg.with_(d_model=256, n_heads=8, n_kv_heads=2, head_dim=128)
    return cfg


def _set_gates(model, gates=(0.7, -0.45)):
    with torch.no_grad():
        for lp, g in zip(model.segments[0], gates):
            lp["cross"]["gate"].fill_(g)


@pytest.mark.cuda
def test_vision_kernel_path_matches_plain_path(cuda, no_tf32):
    """Reduced llama-3.2-vision in f32, nonzero gates: prefill (self and
    cross attention on the general route) and two decode steps (cross
    decode without positions and self decode on ``decode_split``) through
    the kernels against the plain versions."""
    cfg = _vision_small("float32")
    model = make_model(cfg, device=cuda, seed=4)
    _set_gates(model)
    tokens = torch.randint(0, cfg.vocab, (2, 24), device=cuda)
    img = torch.randn((2, cfg.n_image_tokens, cfg.d_model), device=cuda)
    runs = {}
    for which in ("cuda", "ref"):
        ops.force(which)
        ops.reset_launches()
        try:
            with torch.no_grad():
                logits, caches = model.prefill(
                    {"tokens": tokens[:, :20], "image_embeds": img}, 26)
                out = [logits]
                for i in range(2):
                    logits, caches = model.decode_step(
                        tokens[:, 20 + i:21 + i], caches, 20 + i)
                    out.append(logits)
        finally:
            ops.force(None)
        runs[which] = torch.cat(out, dim=1)
        if which == "cuda":
            # prefill: 2 groups x 3 sub-layers, twice (block, cache pass);
            # decode: 2 cross calls and 4 self calls a step
            assert ops.launches["flash_attention"] == 12 + 2 * 2
            assert ops.launches["attention_masked"] == 2 * 4
            assert ops.route_launches == {"general": 12, "decode_split": 12,
                                          "prefill_tc": 0}
    scale = runs["ref"].abs().max().item()
    assert (runs["cuda"] - runs["ref"]).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_serve_vision_on_cuda_launches_per_route(cuda):
    """bf16 serving at the full model's head dim and GQA group: every
    prefill call (self and cross, twice per sub-layer) on ``prefill_tc``,
    every decode call on ``decode_split``, the cross ones unmasked."""
    res = serve(_vision_small("bfloat16", wide_heads=True), 2, 20, 3,
                device=cuda, seed=0)
    assert res.tokens.shape == (2, 3)
    assert res.launches["flash_attention"] == 12 + 2 * 2
    assert res.launches["attention_masked"] == 2 * 4
    assert ops.route_launches == {"prefill_tc": 12, "decode_split": 12,
                                  "general": 0}
    assert not any(res.launches[c] for c in ("mamba_scan", "mamba_step",
                                             "grouped_matmul"))


# ----------------------------------------------------------- grouped matmul
# f32 1e-5 (the summation order differs from the plain version's), bf16
# 3e-2: tests/test_kernels.py's bounds.
def _gmm_fills(kind, G, C, cuda):
    """None, or per group a fill of 0, C and one that ends inside a row
    tile (of ``gmm_tc``'s 128 rows where C > 128), in turn."""
    if kind is None:
        return None
    partial = C - 5 if C > 128 else max(1, C // 2 + 3)
    cycle = [0, C, partial]
    return torch.tensor([cycle[g % 3] for g in range(G)],
                        dtype=torch.int32, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("fills", [None, "edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,C,D,F", [
    (8, 1, 256, 128), (2, 3, 1100, 24), (3, 5, 33, 7),      # decode path
    (5, 37, 96, 80), (4, 128, 64, 40), (3, 37, 33, 7),      # wide paths
    (3, 200, 64, 256), (1, 37, 40, 24), (2, 300, 24, 264),  # gmm_tc edges
    (3, 130, 136, 520),
    (2, 260, 96, 136), (2, 129, 200, 130), (1, 300, 72, 264)])  # general
def test_grouped_matmul_kernel_matches_plain_version(cuda, no_tf32, G, C,
                                                     D, F, dtype, fills):
    """C <= 16 takes ``gmv`` (D = 1100 spans rows past a lane group's
    unroll), larger C ``gmm_tc`` in bf16 with D and F multiples of 8 (C
    200, 37, 300 and 130 leave a partial row tile, G = 1, D = 8 x odd, F =
    24 a partial column box) and ``general`` otherwise (C 260, 129 and 300
    cross row tiles, D 96, 200 and 72 end inside a 32-deep stage, F 136,
    130 and 264 inside a column tile); D = 33, F = 7 and F = 130 (f32) take
    the unvectorized loads.  With fills, the x rows past each fill
    hold random values and must still come out as exact zeros."""
    g = torch.Generator(device=cuda).manual_seed(G * C + D)
    x = torch.randn((G * C, D), generator=g, device=cuda).to(dtype)
    w = (torch.randn((G, D, F), generator=g, device=cuda)
         / D ** 0.5).to(dtype)
    fl = _gmm_fills(fills, G, C, cuda)
    ops.reset_launches()
    got = ops.grouped_matmul_aligned(x, w, C, fl)
    torch.cuda.synchronize()
    assert ops.launches["grouped_matmul"] == 1
    route = moe_gmm.route(dtype, C, D, F)
    assert {k: v for k, v in ops.gmm_route_launches.items() if v} == {
        route: 1}
    want = ref.grouped_matmul_aligned_ref(x, w, C, fl)
    assert got.dtype == dtype and got.shape == (G * C, F)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if fl is not None:
        past = torch.arange(C, device=cuda)[None, :] >= fl[:, None]
        assert bool((got.view(G, C, F)[past] == 0).all())


@pytest.mark.cuda
def test_grouped_matmul_rejects_bad_inputs(cuda):
    x = torch.randn((6, 8), device=cuda)
    w = torch.randn((2, 8, 5), device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_gmm.grouped_matmul(x.cpu(), w, 3)
    with pytest.raises(ValueError, match="float32"):
        moe_gmm.grouped_matmul(x, w.bfloat16(), 3)
    with pytest.raises(ValueError, match="shape"):
        moe_gmm.grouped_matmul(x, torch.randn((2, 7, 5), device=cuda), 3)
    with pytest.raises(ValueError, match="shape"):
        moe_gmm.grouped_matmul(x, w, 2)                  # 6 rows != 2 x 2
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.grouped_matmul(x, w.transpose(1, 2).contiguous()
                               .transpose(1, 2), 3)


@pytest.mark.cuda
def test_grouped_matmul_rejects_bad_fills_and_misaligned_tc_inputs(cuda):
    x = torch.randn((2 * 40, 16), device=cuda).bfloat16()
    w = torch.randn((2, 16, 24), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="int32"):
        moe_gmm.grouped_matmul(x, w, 40, torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        moe_gmm.grouped_matmul(x, w, 40, torch.ones(
            3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_gmm.grouped_matmul(x, w, 40, torch.ones(2, dtype=torch.int32))
    xs = torch.empty(2 * 40 * 16 + 1, device=cuda).bfloat16()[1:]
    with pytest.raises(ValueError, match="aligned"):
        moe_gmm.grouped_matmul(xs.view(2 * 40, 16), w, 40)


@pytest.mark.cuda
def test_olmoe_kernel_path_matches_plain_path(cuda, no_tf32):
    """Reduced olmoe in f32: prefill (a2a) and two decode steps (tp)
    through the kernels against the plain versions."""
    cfg = reduce_config(get_config("olmoe-1b-7b")).with_(dtype="float32")
    model = make_model(cfg, device=cuda, seed=4)
    tokens = torch.randint(0, cfg.vocab, (2, 24), device=cuda)
    runs = {}
    for which in ("cuda", "ref"):
        ops.force(which)
        ops.reset_launches()
        try:
            with torch.no_grad():
                logits, caches = model.prefill({"tokens": tokens[:, :20]}, 26)
                out = [logits]
                for i in range(2):
                    logits, caches = model.decode_step(
                        tokens[:, 20 + i:21 + i], caches, 20 + i)
                    out.append(logits)
        finally:
            ops.force(None)
        runs[which] = torch.cat(out, dim=1)
        if which == "cuda":       # one MoE layer, three products per call
            assert ops.launches["grouped_matmul"] == 3 * 3
    scale = runs["ref"].abs().max().item()
    assert (runs["cuda"] - runs["ref"]).abs().max().item() <= 1e-4 * scale


def _deepseek_small(mla_dims: bool, dtype: str):
    """reduce_config("deepseek-v3-671b") (one dense and one MoE layer, MLA,
    MTP 1), with deepseek's own MLA head dims (nope 128, rope 64, v 128)
    at 4 heads where ``mla_dims``."""
    cfg = reduce_config(get_config("deepseek-v3-671b")).with_(dtype=dtype)
    if mla_dims:
        cfg = cfg.with_(d_model=256, qk_nope_head_dim=128,
                        qk_rope_head_dim=64, v_head_dim=128,
                        q_lora_rank=96, kv_lora_rank=64)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("mla_dims", [False, True])
def test_deepseek_kernel_path_matches_plain_path(cuda, no_tf32, mla_dims):
    """A small-width deepseek-v3 in f32: prefill (MLA attention on the
    general route, MoE a2a) and two decode steps (MLA decode in plain
    PyTorch, MoE tp) through the kernels against the plain versions."""
    cfg = _deepseek_small(mla_dims, "float32")
    model = make_model(cfg, device=cuda, seed=4)
    tokens = torch.randint(0, cfg.vocab, (2, 24), device=cuda)
    runs = {}
    for which in ("cuda", "ref"):
        ops.force(which)
        ops.reset_launches()
        try:
            with torch.no_grad():
                logits, caches = model.prefill({"tokens": tokens[:, :20]}, 26)
                out = [logits]
                for i in range(2):
                    logits, caches = model.decode_step(
                        tokens[:, 20 + i:21 + i], caches, 20 + i)
                    out.append(logits)
        finally:
            ops.force(None)
        runs[which] = torch.cat(out, dim=1)
        if which == "cuda":
            assert ops.launches["flash_attention"] == 2      # prefill only
            assert ops.launches["attention_masked"] == 0
            assert ops.route_launches["general"] == 2
            assert ops.launches["grouped_matmul"] == 3 * 3   # 1 MoE layer
    scale = runs["ref"].abs().max().item()
    assert (runs["cuda"] - runs["ref"]).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_serve_deepseek_on_cuda_takes_prefill_tc(cuda):
    """bf16 serving at deepseek's MLA head dims: each layer's prefill
    attention on ``prefill_tc``, no attention kernel in decode, three
    grouped products per MoE layer and call (prefill ``gmm_tc``, decode
    ``gmv``)."""
    res = serve(_deepseek_small(True, "bfloat16"), 2, 20, 3, device=cuda,
                seed=0)
    assert res.tokens.shape == (2, 3)
    assert res.launches["flash_attention"] == 2
    assert res.launches["attention_masked"] == 0
    assert ops.route_launches == {"prefill_tc": 2, "decode_split": 0,
                                  "general": 0}
    assert res.launches["grouped_matmul"] == 3 * 3
    assert ops.gmm_route_launches == {"gmm_tc": 3, "gmv": 6, "general": 0}


@pytest.mark.cuda
def test_serve_olmoe_on_cuda_with_placement(cuda):
    res = serve(reduce_config(get_config("olmoe-1b-7b")), 2, 20, 3,
                device=cuda, seed=0, placement="replicated")
    assert res.launches["grouped_matmul"] == 3 * 3      # 1 layer, 3 calls
    assert res.launches["flash_attention"] == 1
    assert res.launches["attention_masked"] == 2
    assert res.placement["lambda_cost_repl"] <= \
        res.placement["lambda_cost_no_repl"]


# ------------------------------------------------ the captured decode step
GRAPH_KINDS = ["hymba-1.5b", "falcon-mamba-7b", "olmoe-1b-7b",
               "deepseek-v3-671b", "llama-3.2-vision-11b"]


def _served_small(arch: str, cuda):
    """A reduced bf16 model of each served kind and its prefill batch (2
    prompts of 20): hymba's 16-row windows, olmoe on a plan whose slots
    are not the identity (the slot gather runs in every step), deepseek
    at MLA's head dims, llama-vision at the full model's head dim with
    nonzero gates."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    plan = None
    if arch == "deepseek-v3-671b":
        cfg = _deepseek_small(True, "bfloat16")
    elif arch == "llama-3.2-vision-11b":
        cfg = _vision_small("bfloat16", wide_heads=True)
    else:
        cfg = reduce_config(get_config(arch)).with_(dtype="bfloat16")
    if cfg.n_experts:
        E = cfg.n_experts
        plan = moe._finalize_plan([[(3 * s + 1) % E for s in range(E)]], E,
                                  1, None, 1.25)
    model = Model(cfg, plan=plan, device=cuda, generator=gen)
    if cfg.n_image_tokens:
        _set_gates(model)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 20), device=cuda,
                                     generator=gen)}
    if cfg.n_image_tokens:
        batch["image_embeds"] = torch.randn(
            (2, cfg.n_image_tokens, cfg.d_model), device=cuda, generator=gen)
    return model, batch


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _ptrs(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree.data_ptr()]
    items = tree.values() if isinstance(tree, dict) else tree
    return [p for item in items for p in _ptrs(item)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_KINDS)
def test_captured_decode_matches_eager_in_place(cuda, arch):
    """From one prefill, 7 greedy steps of the in-place step run eagerly,
    and again as one eager step, a capture and 6 replays: bit-equal logits
    and equal tokens, the same launches counted, the caches' storage kept
    across replays, and no host->device copy in a replay (one
    device->host read a step, the token's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model, batch = _served_small(arch, cuda)
    runs = {}
    with torch.inference_mode():
        logits, caches0 = model.prefill(batch, 30)
        tok0 = logits[:, -1].argmax(dim=-1, keepdim=True)
        for graph in (False, True):
            caches = _clone(caches0)
            ptrs = _ptrs(caches)
            step = GreedyStep(model, tok0, caches, 20, graph=graph)
            ops.reset_launches()
            lg, tk = [], []
            for i in range(7):
                if graph and i == 1:
                    step.capture()
                if graph and i == 4:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(3):
                            step()
                            tk.append(step.token.cpu())
                            lg.append(step.logits.clone())
                        torch.cuda.synchronize()
                    break
                step()
                tk.append(step.token.cpu())
                lg.append(step.logits.clone())
                assert _ptrs(caches) == ptrs
            runs[graph] = (torch.cat(lg, dim=1), torch.cat(tk, dim=1),
                           ops.launch_counts())
    assert step.graph is not None and _ptrs(caches) == ptrs
    assert torch.equal(runs[True][1], runs[False][1])
    assert torch.equal(runs[True][0], runs[False][0])
    assert runs[True][2] == runs[False][2]
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in kern) > 3            # the replays traced
    assert not any(e.key.startswith("Memcpy HtoD") for e in kern)
    assert sum(e.count for e in kern
               if e.key.startswith("Memcpy DtoH")) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
def test_serving_head_multiplies_bf16_into_f32(cuda, no_tf32, arch):
    """The head of a bf16 model (bf16 by bf16 into f32, tied or not)
    against the f32 product of the same values: the products are exact in
    f32, only the order of the sums differs."""
    from repro_torch.models import layers as L
    cfg = reduce_config(get_config(arch)).with_(d_model=2048, vocab=32768,
                                                dtype="bfloat16")
    model = make_model(cfg, device=cuda, seed=5)
    x = torch.randn((3, 2, cfg.d_model), device=cuda).bfloat16()
    with torch.inference_mode():
        got = model.logits_fn(x)
        head = model.embed.T if cfg.tie_embeddings else model.lm_head
        want = L.rmsnorm(x, model.final_ln, cfg.norm_eps).float() \
            @ head.float()
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (3, 2, cfg.vocab)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_serve_on_cuda_decodes_as_a_graph(cuda):
    """One card: the first step eagerly, then a capture and G - 2
    replays; the launches counted as the eager loop's."""
    res = serve(reduce_config(get_config("hymba-1.5b")), 2, 20, 6,
                device=cuda, seed=0)
    assert res.decode == "graph" and res.capture_s > 0
    assert res.launches["mamba_step"] == 5 * 5
    assert res.launches["attention_masked"] == 2 + 5 * 5


# ------------------------------------------- the V-cycle and the pool
@pytest.mark.cuda
def test_vcycle_on_cuda_matches_host_path(cuda, monkeypatch):
    """``partition_with_replication(multilevel=True)`` with the floors
    lowered so that every level of at least 512 nodes runs the device
    pass and the coarser ones the min-cover kernel: the host path's masks
    and costs, one launch and one read per find."""
    from repro_torch.core.frontier import partition_front
    monkeypatch.setattr(front_pass, "DEVICE_MIN_NODES", 512)
    monkeypatch.setattr(partition_front, "_DEVICE_MIN_ROWS", 256)
    passes = []
    real_attach = front_pass.attach

    def attach(*a, **kw):
        d = real_attach(*a, **kw)
        if d is not None:
            passes.append(d)
        return d

    monkeypatch.setattr(front_pass, "attach", attach)
    hg = large_row_net(2048, seed=1)
    ops.reset_launches()
    a = th.partition_with_replication(hg, 4, 0.05, multilevel=True,
                                      frontier="torch", device=cuda)
    launches = dict(ops.launches)
    b = th.partition_with_replication(hg, 4, 0.05, multilevel=True,
                                      frontier="numpy")
    for ra, rb in zip(a, b):
        assert np.array_equal(ra.masks, rb.masks) and ra.cost == rb.cost
    assert passes and len({d.n for d in passes}) >= 2   # several levels
    assert launches["front_find"] == sum(d.finds for d in passes) > 0
    assert launches["min_cover_lambdas"] > 0
    for d in passes:
        assert d.syncs == d.finds and d.apply_dispatches == 0
        assert d.state.device is None


@pytest.mark.cuda
def test_pool_forks_after_cuda_is_up(cuda):
    """The pool forks after the card is initialised; its workers run
    numpy only, so the sharded matching is byte-identical to serial."""
    from repro_torch.core.partition.multilevel import heavy_pin_matching
    from repro_torch.core.partition.parallel import ParallelContext
    torch.ones(1, device=cuda).sum().item()       # CUDA is up
    hg = large_row_net(1200, seed=1)
    with ParallelContext(2, start_method="fork", min_nodes=64) as ctx:
        cm_p, nc_p = heavy_pin_matching(hg, 50.0, np.random.default_rng(7),
                                        ctx=ctx)
        assert not ctx.failed
    cm_s, nc_s = heavy_pin_matching(hg, 50.0, np.random.default_rng(7))
    assert nc_p == nc_s and cm_p.tobytes() == cm_s.tobytes()


# ------------------------------------------------- schedule windows
@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_schedule_windows_on_cuda_match_numpy(cuda, monkeypatch, seed):
    """Every window and node move priced on the card equals the numpy
    fronts, and a whole ``hill_climb`` on the card leaves the host path's
    schedule."""
    from repro_torch.core.frontier import device_windows, schedule_front
    from repro_torch.core.schedule import (BspInstance, bspg_schedule,
                                           list_sched)
    from repro_torch.datagen import sptrsv_dag
    monkeypatch.setattr(front_pass, "DEVICE_MIN_STEPS", 1)
    dag = sptrsv_dag(n=400, band=16, seed=seed)
    inst = BspInstance(dag, P=4, g=2.0, L=4.0)
    s = bspg_schedule(inst, seed=seed)
    win = device_windows(s, "torch", cuda)
    assert win is not None
    for (v, dst) in sorted(s.comms):
        lo, hi = list_sched._comm_window(s, v, dst)
        if hi >= lo:
            ts = np.arange(lo, hi + 1)
            assert np.array_equal(win.price_comm_moves(v, dst, ts),
                                  schedule_front.price_comm_moves(
                                      s, v, dst, ts))
    for v in range(dag.n):
        (p, _), = s.assign[v].items()
        if (v, p) not in s.comms:
            lo, hi = list_sched._comp_window(s, v, p)
            if hi >= lo:
                ts = np.arange(lo, hi + 1)
                assert np.array_equal(win.price_comp_moves(v, p, ts),
                                      schedule_front.price_comp_moves(
                                          s, v, p, ts))
        assert np.array_equal(win.price_node_moves(v),
                              schedule_front.price_node_moves(s, v))
    assert win.syncs == sum(win.launches.values()) > 0
    a = list_sched.hill_climb(s.copy(), seed=seed, backend="torch",
                              device=cuda)
    b = list_sched.hill_climb(s.copy(), seed=seed, backend="numpy")
    assert a.current_cost() == b.current_cost()
    assert a.assign == b.assign and a.comms == b.comms


# ------------------------------------------------------ backward kernels
# max |kernel - reference| over the largest |reference| of each gradient:
# bf16 rounds P and dS (attention) and the outputs to bf16 (8 bits); f32
# runs 3xTF32 products and sums in another order (attention), or the same
# recurrence with ex2.approx exps (scan)
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _grad_gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


# (B, Sq, Sk, H, KV, hd, causal, window): ragged tiles, GQA, windows that
# end inside a tile, non-causal with Sq != Sk, Sq and Sk off the tc
# kernels' 128-, 64- and 32-row tiles (190, 333), and hymba's and olmoe's
# training shapes; hd a pair (hd, hd_v) for MLA's (192, 128), the same
# kinds of case and deepseek's training call with 16 of its 128 heads;
# hubert's (80, 80): non-causal with ragged Sq != Sk, non-causal with a
# window, causal with a window, and its training call at 2 of 8 clips
BWD_ATTN_CASES = [
    (2, 100, 100, 6, 2, 64, True, 0),
    (2, 150, 150, 5, 1, 64, True, 40),
    (1, 77, 130, 4, 4, 128, False, 0),
    (2, 130, 130, 4, 2, 128, True, 0),
    (1, 200, 200, 8, 2, 128, False, 33),
    (2, 190, 190, 3, 3, 64, True, 0),
    (1, 333, 333, 4, 1, 128, True, 100),
    (1, 190, 333, 2, 1, 64, False, 70),
    (4, 2048, 2048, 25, 5, 64, True, 0),
    (4, 2048, 2048, 25, 5, 64, True, 1024),
    (4, 2048, 2048, 16, 16, 128, True, 0),
    (2, 100, 100, 4, 4, (192, 128), True, 0),
    (1, 150, 150, 6, 2, (192, 128), True, 40),
    (1, 77, 130, 4, 4, (192, 128), False, 0),
    (2, 333, 333, 4, 1, (192, 128), True, 100),
    (1, 190, 333, 2, 1, (192, 128), False, 70),
    (1, 2048, 2048, 16, 16, (192, 128), True, 0),
    (1, 190, 333, 4, 4, 80, False, 0),
    (2, 150, 130, 6, 2, 80, False, 40),
    (1, 333, 333, 4, 1, 80, True, 100),
    (2, 1500, 1500, 16, 16, 80, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", BWD_ATTN_CASES)
def test_attention_bwd_kernel_matches_plain_version(cuda, no_tf32, B, Sq, Sk,
                                                    H, KV, hd, causal,
                                                    window, dtype):
    """The kernel's (dq, dk, dv) on its route (``tc`` in bf16, ``general``
    in f32; both from the forward's LSE, which ``prefill_tc`` and
    ``general`` write) against ``attention_bwd_ref`` on the same o and do,
    and against autograd of ``attention_ref``, bit-equal over two runs;
    and the autograd Function's gradients (forward on its usual route,
    with the LSE) against autograd of the plain version."""
    from repro_torch.kernels import flash_attention as fa
    hd, hd_v = hd if isinstance(hd, tuple) else (hd, hd)
    g = torch.Generator(device=cuda).manual_seed(Sq + H + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, KV, hd_v), generator=g, device=cuda).to(dtype)
    do = torch.randn((B, Sq, H, hd_v), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window)
    scale = hd ** -0.5
    route = fa.bwd_route(dtype, Sq, Sk, hd, hd_v, window, False)
    assert route == ("tc" if dtype == torch.bfloat16 else "general")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref = ref.attention_ref(*leaves, **kw)
    o_ref.backward(do)
    want = [t.grad for t in leaves]
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    # writing the LSE leaves the forward's output as it was
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    lse_want = ref.attention_lse_ref(q, k, scale=scale, **kw)
    assert float((lse - lse_want).abs().max()) <= 1e-3
    ops.reset_launches()
    got = fa.attention_bwd(q, k, v, o, do, scale=scale, lse=lse, **kw)
    again = fa.attention_bwd(q, k, v, o, do, scale=scale, lse=lse, **kw)
    torch.cuda.synchronize()
    assert ops.launches["attention_bwd"] == 2
    assert ops.bwd_route_launches[f"attention_{route}"] == 2
    assert sum(ops.bwd_route_launches.values()) == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = ref.attention_bwd_ref(q, k, v, o, do, scale=scale, lse=lse, **kw)
    tol = GRAD_TOL[dtype]
    for name, a, b, c in zip("qkv", got, plain, want):
        assert a.dtype == dtype and a.shape == c.shape
        assert _grad_gap(a, b) <= tol, (name, _grad_gap(a, b))
        assert _grad_gap(a, c) <= tol, (name, _grad_gap(a, c))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    ops.attention(*leaves, **kw).backward(do)
    assert ops.launches["attention_bwd"] == 1
    assert ops.bwd_route_launches[f"attention_{route}"] == 1
    for t, c in zip(leaves, want):
        assert _grad_gap(t.grad, c) <= tol


# a rank's block of a sequence split over ranks: (B, Sq, H, KV, hd, window)
# with the queries at q_off on, against Sq + q_off keys and 192 more that
# no query reaches (whole key tiles of every kernel past the last query)
OFF_CASES = [(2, 256, 9, 3, 64, 0), (1, 200, 4, 2, 128, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_off", [0, 64, 2048])
@pytest.mark.parametrize("B,Sq,H,KV,hd,window", OFF_CASES)
def test_attention_kernels_take_a_query_offset(cuda, no_tf32, B, Sq, H, KV,
                                               hd, window, q_off, dtype):
    """The forward (``prefill_tc`` in bf16, ``general`` in f32, each with
    its LSE) and the backward (``tc``, ``general``) with a query offset
    against their plain versions, the backward bit-equal over two runs;
    the keys past the last query get exact zeros in dK and dV (the
    allocator handed NaNs first)."""
    from repro_torch.kernels import flash_attention as fa
    Sk = q_off + Sq + 192
    g = torch.Generator(device=cuda).manual_seed(q_off + Sq + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda).to(dtype)
    do = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    scale = hd ** -0.5
    kw = dict(causal=True, window=window, scale=scale, q_off=q_off)
    bf16 = dtype == torch.bfloat16
    ops.reset_launches()
    o = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.route_launches["prefill_tc" if bf16 else "general"] == 1
    tol = _ATOL[dtype]["attn"]
    torch.testing.assert_close(o.float(), ref.attention_ref(
        q, k, v, **kw).float(), rtol=tol, atol=tol)
    if q_off == 0:      # the offset's default: the same launch, bit-equal
        assert torch.equal(o, ops.attention(q, k, v, causal=True,
                                            window=window, scale=scale))
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    assert float((lse - ref.attention_lse_ref(q, k, **kw)).abs()
                 .max()) <= 1e-3
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.attention_ref(*leaves, **kw).backward(do)
    want = [t.grad for t in leaves]
    junk = torch.full((4 * k.numel(),), float("nan"), device=cuda)
    del junk
    ops.reset_launches()
    got = fa.attention_bwd(q, k, v, o, do, lse=lse, **kw)
    again = fa.attention_bwd(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    route = "tc" if bf16 else "general"
    assert ops.bwd_route_launches[f"attention_{route}"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = ref.attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
    for name, a, b, c in zip("qkv", got, plain, want):
        assert _grad_gap(a, b) <= GRAD_TOL[dtype], (name, _grad_gap(a, b))
        assert _grad_gap(a, c) <= GRAD_TOL[dtype], (name, _grad_gap(a, c))
    for t in got[1:]:
        assert not t[:, q_off + Sq:].any()          # exact zeros, no NaN
        assert torch.isfinite(t).all()


# falcon-mamba-7b's training step (2 x 2048 tokens) on one card and a
# rank's half of its channels on a (1, 2) mesh: ``bwd_plan`` cuts both
# into segments whose last is shorter than the rest
FALCON_BWD_CASES = [(2, 2048, 8192, 16), (2, 2048, 4096, 16)]


# (B, S, di, N, segment, dt scale): ragged chunks and channel blocks, every
# state size, and hymba's shape, on the plan's segments (ids as before
# segments existed); then S one step over and under a segment, S = 1, S
# under a chunk, di not a multiple of 32, and dt 40 times larger, where
# the decays of all but the smallest states underflow to zero
BWD_SCAN_CASES = [
    *(pytest.param(*c, None, 1.0, id="-".join(map(str, c))) for c in (
        (2, 37, 70, 4), (1, 100, 64, 16), (2, 16, 33, 16),
        *[(2, 45, 40, n) for n in (1, 2, 8)],
        (4, 2048, 3200, 16), *FALCON_BWD_CASES)),
    (2, 129, 64, 16, 128, 1.0), (2, 127, 64, 16, 128, 1.0),
    (2, 1, 64, 16, None, 1.0), (2, 9, 40, 8, None, 1.0),
    (1, 100, 50, 16, 32, 1.0), (2, 70, 70, 2, 32, 1.0),
    (2, 80, 64, 16, 32, 40.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,N,segment,dt_scale", BWD_SCAN_CASES)
def test_scan_bwd_kernel_matches_plain_version(cuda, B, S, di, N, segment,
                                               dt_scale, dtype):
    """The scan's gradients through the autograd Function (the plan's
    segments) against autograd of ``mamba_scan_ref``; the kernel on
    ``segment``-step segments against ``mamba_scan_bwd_ref`` on the same
    segments, and bit-equal over two calls; the model's dt (softplus,
    times ``dt_scale``) and A (-1 .. -N)."""
    from repro_torch.kernels import mamba_scan as ms
    u, dt, A, Bc, Cc, D = _scan_inputs(B, S, di, N, dtype, cuda, S + di,
                                       "large")
    dt = (dt * (dt_scale / 4)).to(dtype)      # softplus(normal) * dt_scale
    dy = torch.randn((B, S, di), device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (u, dt, A, Bc, Cc, D)]
    y_ref, _ = ref.mamba_scan_ref(*leaves)
    y_ref.backward(dy)
    want = [t.grad for t in leaves]
    leaves = [t.clone().requires_grad_() for t in (u, dt, A, Bc, Cc, D)]
    ops.reset_launches()
    y, _ = ops.mamba_scan(*leaves)
    y.backward(dy)
    torch.cuda.synchronize()
    assert ops.launches["mamba_scan"] == 1
    assert ops.launches["mamba_scan_bwd"] == 1
    tol = GRAD_TOL[dtype]
    for i, (t, c) in enumerate(zip(leaves, want)):
        assert t.grad.dtype == c.dtype
        assert _grad_gap(t.grad, c) <= tol, (i, _grad_gap(t.grad, c))
    if S <= 200:
        got = ms.mamba_scan_bwd(u, dt, A, Bc, Cc, D, dy, segment=segment)
        again = ms.mamba_scan_bwd(u, dt, A, Bc, Cc, D, dy, segment=segment)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        seg_len = ms.bwd_plan(B, S, di, N, segment)["seg_len"]
        plain = ref.mamba_scan_bwd_ref(u, dt, A, Bc, Cc, D, dy,
                                       segment=seg_len)
        for i, (a, b) in enumerate(zip(got, plain)):
            assert torch.isfinite(a).all()
            assert _grad_gap(a, b) <= tol, (i, _grad_gap(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,N", FALCON_BWD_CASES)
def test_scan_bwd_kernel_on_uneven_segments(cuda, B, S, di, N, dtype):
    """At falcon's widths: the plan's last segment shorter than the rest;
    the kernel against ``mamba_scan_bwd_ref`` on the same segments, and
    bit-equal over two calls."""
    from repro_torch.kernels import mamba_scan as ms
    plan = ms.bwd_plan(B, S, di, N)
    assert 0 < S - (plan["nseg"] - 1) * plan["seg_len"] < plan["seg_len"]
    u, dt, A, Bc, Cc, D = _scan_inputs(B, S, di, N, dtype, cuda, S + di,
                                       "large")
    dt = (dt / 4).to(dtype)                   # softplus(normal)
    dy = torch.randn((B, S, di), device=cuda).to(dtype)
    ops.reset_launches()
    got = ms.mamba_scan_bwd(u, dt, A, Bc, Cc, D, dy)
    again = ms.mamba_scan_bwd(u, dt, A, Bc, Cc, D, dy)
    torch.cuda.synchronize()
    assert ops.launches["mamba_scan_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = ref.mamba_scan_bwd_ref(u, dt, A, Bc, Cc, D, dy,
                                   segment=plan["seg_len"])
    for i, (a, b) in enumerate(zip(got, plain)):
        assert torch.isfinite(a).all()
        assert _grad_gap(a, b) <= GRAD_TOL[dtype], (i, _grad_gap(a, b))


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad(cuda):
    u, dt, A, Bc, Cc, D = _scan_inputs(1, 8, 32, 4, torch.float32, cuda, 0)
    h0 = torch.zeros((1, 32, 4), device=cuda)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.mamba_scan(u.requires_grad_(), dt, A, Bc, Cc, D, init_state=h0)
    q = torch.randn((1, 20, 2, 64), device=cuda, requires_grad=True)
    k = torch.randn((1, 20, 1, 64), device=cuda)
    pos = torch.arange(20, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(RuntimeError, match="explicit positions"):
        ops.attention(q, k, k, q_pos=pos, k_pos=pos)
    q32 = torch.randn((1, 20, 2, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="head dims"):
        ops.attention(q32, q32[:, :, :1].detach(), q32[:, :, :1].detach())
    x = torch.randn((2 * 4, 16), device=cuda, requires_grad=True)
    w = torch.randn((2, 16, 4), device=cuda)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.grouped_matmul_aligned(x, w, 4)           # F = 4: not a multiple
    with torch.no_grad():      # no gradient needed: the kernels run
        ops.grouped_matmul_aligned(x, w, 4)
        ops.mamba_scan(u, dt, A, Bc, Cc, D, init_state=h0)


# (G, C, D, F): row tiles that end inside a group (C 200, 300, 37), D and F
# that end inside a 128-wide tile and a 32-deep stage (136, 72, 40, 24),
# and olmoe's training shape with its fills
BWD_GMM_CASES = [(3, 200, 64, 136), (4, 130, 136, 72), (2, 300, 256, 128),
                 (5, 37, 40, 24), (64, 2560, 2048, 1024)]


def _bwd_fills(kind, G, C, cuda):
    """``_gmm_fills``, or "nan": per group a fill of 1, 64 k + 1 or C in
    turn (the tc route's 64-row stages end one row into a stage), with x
    and dy NaN past them."""
    if kind != "nan":
        return _gmm_fills(kind, G, C, cuda)
    cycle = [1, min(C, 64 * (1 + C // 128) + 1), C]
    return torch.tensor([cycle[g % 3] for g in range(G)], dtype=torch.int32,
                        device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("fills", [None, "edges", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,C,D,F", BWD_GMM_CASES)
def test_grouped_matmul_bwd_kernel_matches_plain_version(cuda, no_tf32, G, C,
                                                         D, F, dtype, fills):
    """The kernels' (dx, dw) on their route (``tc`` in bf16, ``general`` in
    f32) against ``grouped_matmul_aligned_bwd_ref`` and against autograd of
    the plain forward, with x and dy random (or NaN) past the fills (dx
    exact zeros there, nothing into dw); the autograd Function's gradients
    against autograd of the plain version; dx and dw bit-equal over two
    runs; one product alone where only one is asked for."""
    g = torch.Generator(device=cuda).manual_seed(G * C + D + F)
    x = torch.randn((G * C, D), generator=g, device=cuda).to(dtype)
    w = (torch.randn((G, D, F), generator=g, device=cuda)
         / D ** 0.5).to(dtype)
    dy = torch.randn((G * C, F), generator=g, device=cuda).to(dtype)
    fl = _bwd_fills(fills, G, C, cuda)
    route = moe_gmm.bwd_route(dtype, D, F)
    assert route == ("tc" if dtype == torch.bfloat16 else "general")
    # the references run where the rows past the fills are zeros: autograd
    # would carry NaN there into dw as 0 * NaN
    x0, dy0 = x.clone(), dy.clone()
    if fills == "nan":
        past = torch.arange(C, device=cuda)[None, :] >= fl[:, None]
        x.view(G, C, D)[past] = float("nan")
        dy.view(G, C, F)[past] = float("nan")
        x0.view(G, C, D)[past] = 0
        dy0.view(G, C, F)[past] = 0
    leaves = [t.clone().requires_grad_() for t in (x0, w)]
    ref.grouped_matmul_aligned_ref(*leaves, C, fl).backward(dy0)
    want = [t.grad for t in leaves]
    ops.reset_launches()
    got = moe_gmm.grouped_matmul_bwd(x, w, dy, C, fl)
    again = moe_gmm.grouped_matmul_bwd(x, w, dy, C, fl)
    torch.cuda.synchronize()
    assert ops.launches["grouped_matmul_bwd"] == 2
    assert ops.bwd_route_launches[f"gmm_{route}"] == 2
    assert sum(ops.bwd_route_launches.values()) == 2
    plain = ref.grouped_matmul_aligned_bwd_ref(x0, w, dy0, C, fl)
    tol = GRAD_TOL[dtype]
    for name, a, b, c in zip(("dx", "dw"), got, plain, want):
        assert a.dtype == dtype and a.shape == c.shape
        assert _grad_gap(a, b) <= tol, (name, _grad_gap(a, b))
        assert _grad_gap(a, c) <= tol, (name, _grad_gap(a, c))
    assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])
    if fl is not None:
        past = torch.arange(C, device=cuda)[None, :] >= fl[:, None]
        assert bool((got[0].view(G, C, D)[past] == 0).all())
        assert bool((got[1][fl == 0] == 0).all())
    dx_only = moe_gmm.grouped_matmul_bwd(x, w, dy, C, fl, need_dw=False)
    dw_only = moe_gmm.grouped_matmul_bwd(x, w, dy, C, fl, need_dx=False)
    assert dx_only[1] is None and torch.equal(dx_only[0], got[0])
    assert dw_only[0] is None and torch.equal(dw_only[1], got[1])
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    ops.reset_launches()
    ops.grouped_matmul_aligned(*leaves, C, fl).backward(dy)
    assert ops.launches["grouped_matmul"] == 1
    assert ops.launches["grouped_matmul_bwd"] == 1
    assert ops.bwd_route_launches[f"gmm_{route}"] == 1
    for t, c in zip(leaves, want):
        assert _grad_gap(t.grad, c) <= tol


@pytest.mark.cuda
def test_grouped_matmul_bwd_rejects_bad_inputs(cuda):
    x = torch.randn((2 * 40, 16), device=cuda)
    w = torch.randn((2, 16, 24), device=cuda)
    dy = torch.randn((2 * 40, 24), device=cuda)
    with pytest.raises(RuntimeError, match="multiples of 8"):
        moe_gmm.grouped_matmul_bwd(x[:, :12].contiguous(), w[:, :12], dy, 40)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        moe_gmm.grouped_matmul_bwd(x.half(), w.half(), dy.half(), 40)
    with pytest.raises(ValueError, match="shape"):
        moe_gmm.grouped_matmul_bwd(x, w, dy[:40], 40)
    with pytest.raises(ValueError, match="float32"):
        moe_gmm.grouped_matmul_bwd(x, w, dy.bfloat16(), 40)
    with pytest.raises(ValueError, match="CUDA tensor"):
        moe_gmm.grouped_matmul_bwd(x, w, dy.cpu(), 40)
    xs = torch.empty(2 * 40 * 16 + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        moe_gmm.grouped_matmul_bwd(xs.view(2 * 40, 16), w, dy, 40)


def _train_small(arch: str, dtype: str):
    """Reduced config with head dim 64 (the backward kernel's)."""
    return reduce_config(get_config(arch)).with_(dtype=dtype, head_dim=64,
                                                 remat="full")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "smollm-135m"])
def test_train_step_kernel_path_matches_plain_path(cuda, no_tf32, arch):
    """One f32 training step of a reduced model through the kernels and
    through the plain versions, from the same weights: equal losses,
    gradients within GRAD_TOL, and the launches the path makes.  After
    the AdamW step (whose first update is about lr * sign(grad)) the
    parameters differ by more than lr / 10 only where a tiny gradient's
    sign differs: in at most 5 elements (an H100 read 0 for hymba, 1 for
    smollm)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import batch_to, build_train_step
    cfg = _train_small(arch, "float32")
    batch = batch_to(SyntheticTokenStream(cfg, DataConfig(2, 80)).next_batch(),
                     cuda)
    grads, losses, params = {}, {}, {}
    lr = 1e-3
    for which in ("cuda", "ref"):
        ts = build_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=1),
                              device=cuda)
        st = ts.init_state(5)
        ops.force(which)
        ops.reset_launches()
        try:
            loss, _ = ts.model.loss(batch)
            loss.backward()
        finally:
            ops.force(None)
        counts = dict(ops.launches)
        losses[which] = float(loss.detach())
        grads[which] = {n: p.grad.clone() for n, p in st["params"].items()}
        from repro_torch.optim.adamw import apply_updates
        apply_updates(ts.opt_cfg, st["opt"], grads[which], st["params"])
        params[which] = {n: p.detach().clone()
                         for n, p in st["params"].items()}
        if which == "cuda":
            n_attn = cfg.n_layers
            n_scan = sum(s.n_layers for s in cfg.segments
                         if s.kind in ("hybrid", "mamba"))
            assert counts["attention_bwd"] == n_attn
            assert counts["mamba_scan_bwd"] == n_scan
            assert (counts["flash_attention"] + counts["attention_masked"]
                    == 2 * n_attn)                           # and recompute
            assert counts["mamba_scan"] == 2 * n_scan        # and recompute
    assert abs(losses["cuda"] - losses["ref"]) <= 1e-5 * abs(losses["ref"])
    for n, g in grads["ref"].items():
        assert _grad_gap(grads["cuda"][n], g) <= GRAD_TOL[torch.float32], n
    off = sum(int(((params["cuda"][n] - p).abs() > lr / 10).sum())
              for n, p in params["ref"].items())
    total = sum(p.numel() for p in params["ref"].values())
    assert off <= 5, (off, total)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_train_step_kernel_path_matches_plain_path(cuda, no_tf32,
                                                          dtype):
    """Reduced hubert-xlarge (frame input, non-causal) at its head dim 80,
    2 layers, frames and labels drawn with numpy: the loss and every
    gradient leaf through the kernels and through the plain versions from
    the same weights, within GRAD_TOL of each leaf's largest entry (bf16:
    the loss within 2e-2 relative), and the launches -- per layer two
    forwards (the forward and its recompute) on ``prefill_tc`` in bf16 and
    ``general`` in f32, one backward on ``tc`` or ``general``; the fused
    elementwise kernels' likewise (two norms, two ropes and a gate a layer,
    the final norm once)."""
    from repro_torch.train.step import batch_to, build_train_step
    cfg = reduce_config(get_config("hubert-xlarge"), 2).with_(
        dtype=dtype, head_dim=80, remat="full")
    rng = np.random.default_rng(6)
    batch = batch_to({
        "frames": rng.standard_normal((2, 300, cfg.d_model)).astype(
            np.float32),
        "labels": rng.integers(0, cfg.vocab, (2, 300)).astype(np.int32)},
        cuda)
    grads, losses = {}, {}
    for which in ("cuda", "ref"):
        ts = build_train_step(cfg, device=cuda)
        st = ts.init_state(5)
        ops.force(which)
        ops.reset_launches()
        try:
            loss, _ = ts.model.loss(batch)
            loss.backward()
        finally:
            ops.force(None)
        losses[which] = float(loss.detach())
        grads[which] = {n: p.grad for n, p in st["params"].items()
                        if p.grad is not None}
        if which == "cuda":
            n = cfg.n_layers
            bf16 = dtype == "bfloat16"
            assert {c: k for c, k in ops.launches.items() if k} == {
                "flash_attention": 2 * n, "attention_bwd": n,
                "rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1,
                "rope": 4 * n, "rope_bwd": 2 * n, "silu_gate": 2 * n,
                "silu_gate_bwd": n}
            assert ops.route_launches == {
                "decode_split": 0, "prefill_tc": 2 * n * bf16,
                "general": 2 * n * (not bf16)}
            assert ops.bwd_route_launches == {
                "attention_tc": n * bf16, "attention_general": n * (not bf16),
                "gmm_tc": 0, "gmm_general": 0}
    tol = GRAD_TOL[getattr(torch, dtype)]
    assert abs(losses["cuda"] - losses["ref"]) <= (
        1e-5 if dtype == "float32" else 2e-2) * abs(losses["ref"])
    assert grads["cuda"].keys() == grads["ref"].keys()
    for n, g in grads["ref"].items():
        assert torch.isfinite(grads["cuda"][n]).all(), n
        assert _grad_gap(grads["cuda"][n], g) <= tol, n


# ---------------------------------------- the fused AdamW update, captured
@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("n", [1, 7, 2 ** 20 + 3])
@pytest.mark.parametrize("m_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_matches_plain_version(cuda, p_dtype, m_dtype, n, view):
    """``csrc/adamw.cu`` against the plain per-leaf update on the card,
    two steps from random moments: within 1e-6 of each state leaf's
    largest entry, the parameter the master cast.  ``view``: every array
    one element into a larger buffer, which takes the scalar path."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import adamw
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    g = torch.Generator(device=cuda).manual_seed(n)

    def make(dtype, scale=1.0, positive=False):
        t = torch.randn(n + int(view), generator=g, device=cuda) * scale
        t = (t.abs() if positive else t).to(dtype)
        return t[1:] if view else t

    master = make(torch.float32)
    mine = {"m": make(m_dtype, 0.1), "v": make(torch.float32, 0.01, True),
            "master": master, "p": master.to(p_dtype, copy=True)}
    if view:
        mine["p"] = make(p_dtype)
        mine["p"].copy_(master)
    plain = {k: t.clone() for k, t in mine.items()}
    ops.reset_launches()
    for step in (1, 2):
        grad = make(p_dtype, 3.0)
        sc = torch.tensor([0.7, 1e-2 * step / 2, 1 - 0.9 ** step,
                           1 - 0.95 ** step], device=cuda)
        kadamw.fused_update(grad, mine["m"], mine["v"], mine["master"],
                            mine["p"], sc, cfg.b1, cfg.b2, cfg.eps,
                            cfg.weight_decay)
        adamw.update_leaf(cfg, grad, plain["m"], plain["v"],
                          plain["master"], plain["p"], *sc.unbind())
    torch.cuda.synchronize()
    assert ops.launches["adamw"] == 2
    for k in ("m", "v", "master"):
        assert _grad_gap(mine[k], plain[k]) <= 1e-6, k
    assert torch.equal(mine["p"], mine["master"].to(p_dtype))


def _captured_and_eager(cuda, arch: str, steps: int = 3):
    """``steps`` bf16 steps of reduced ``arch`` captured and eagerly, from
    the same weights and batches: each run's losses, final state and
    launch counts."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenStream
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import batch_to, build_train_step
    cfg = _train_small(arch, "bfloat16")
    out = {}
    for graph in (True, False):
        stream = SyntheticTokenStream(cfg, DataConfig(2, 128, seed=3))
        ts = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1),
                              device=cuda, graph=graph)
        state = ts.init_state(5)
        ops.reset_launches()
        losses, kinds, ptrs = [], [], set()
        for _ in range(steps):
            state, met = ts.step_fn(state, batch_to(stream.next_batch(),
                                                    cuda))
            losses.append(met["loss"].clone())
            kinds.append(ts.last_kind)
            ptrs.add(state["opt"]["master"]["final_ln"].data_ptr())
        torch.cuda.synchronize()
        out[graph] = dict(ts=ts, losses=torch.stack(losses), kinds=kinds,
                          ptrs=ptrs, launches=ops.launch_counts(),
                          state={f"{part}/{n}": t for part, tree in (
                              ("params", state["params"]),
                              ("master", state["opt"]["master"]),
                              ("m", state["opt"]["m"]),
                              ("v", state["opt"]["v"])) for n, t in
                              tree.items()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "olmoe-1b-7b"])
def test_captured_train_steps_equal_eager_steps(cuda, arch):
    """Three captured steps (the first eager on the capture's stream, then
    two replays) against three eager steps: losses and every state leaf
    bit-equal, the graph's state kept in place, the launches booked as
    the eager steps count them (the fused AdamW's among them)."""
    runs = _captured_and_eager(cuda, arch)
    cap, eager = runs[True], runs[False]
    assert cap["ts"].mode == "graph" and eager["ts"].mode == "eager"
    assert cap["kinds"] == ["capture", "replay", "replay"]
    assert cap["ts"].capture_s > 0 and cap["ts"].graph_pool_B > 0
    assert len(cap["ptrs"]) == 1
    assert torch.equal(cap["losses"], eager["losses"])
    for k, t in eager["state"].items():
        assert torch.equal(cap["state"][k], t), k
    assert cap["launches"] == eager["launches"]
    leaves = len(dict(eager["ts"].model.named_parameters()))
    assert cap["launches"][0]["adamw"] == 3 * leaves


@pytest.mark.cuda
def test_trainer_restarts_a_captured_step_on_cuda(cuda, tmp_path):
    """The trainer on one card, captured: a failure injected at step 5
    restores step 3's checkpoint into a new model and captures again; the
    losses and the final state equal an uninterrupted run's bit for bit,
    and each capture is booked apart from the replays."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    boom = {"armed": True}

    def failure_hook(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected chip failure")

    def run(d, hook=None):
        tr = Trainer(_train_small("smollm-135m", "bfloat16"),
                     DataConfig(2, 128), TrainerConfig(
                         steps=8, ckpt_every=3, ckpt_dir=str(d),
                         log_every=100),
                     AdamWConfig(lr=1e-3, total_steps=8), device=cuda,
                     failure_hook=hook)
        state, hist = tr.run()
        assert tr.ts.mode == "graph"
        return tr, state, hist
    tr_a, whole, hist_a = run(tmp_path / "a")
    tr_b, state, hist_b = run(tmp_path / "b", failure_hook)
    assert not boom["armed"]
    assert [h["kind"] for h in hist_a] == ["capture"] + ["replay"] * 7
    assert [h["step"] for h in hist_b] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    assert len(tr_a.capture_times) == 1 and len(tr_b.capture_times) == 2
    assert [h["loss"] for h in hist_b[5:]] == [h["loss"]
                                               for h in hist_a[3:]]
    for part in ("params", "master", "m", "v"):
        mine = whole["params"] if part == "params" else whole["opt"][part]
        theirs = state["params"] if part == "params" else state["opt"][part]
        for n, t in mine.items():
            assert torch.equal(t, theirs[n]), (part, n)


# ---------------------------------------- the fused elementwise kernels
# path shapes: hymba's norm and gate rows, rope's 25 query heads at 64, the
# conv's (4, 2048, 3200) as a slice of in_proj's output, hubert's heads at
# 80, MLA's rope part of a wider head, the decode step's four rows
FUSED_CASES = [
    ("rmsnorm", (8192, 1600)), ("rmsnorm", (4, 1, 7168)),
    ("rmsnorm_strided", (4096, 512)),
    ("rope", (4, 2048, 25, 64)), ("rope", (8, 1500, 16, 80)),
    ("rope_strided", (2, 512, 16, 64)), ("rope", (4, 1, 25, 64)),
    ("causal_conv", (4, 2048, 3200)), ("causal_conv", (2, 100, 8192)),
    ("causal_conv_state", (4, 1, 3200)),
    ("silu_gate", (8192, 5504)), ("silu_gate_strided", (4, 2048, 3200)),
    # widths off a multiple of four: the kernels' one-element paths
    ("rmsnorm", (37, 1001)), ("causal_conv", (2, 70, 1001)),
    ("silu_gate", (37, 1001)),
    # the backwards' plans at every norm width of the path at training
    # rows (8191: the last band short), MLA's kv_ln at training rows;
    # falcon's conv, a sequence off the conv's 256-step tile, S < d_conv,
    # and a di off the 64-channel tile
    ("rmsnorm", (32768, 576)), ("rmsnorm", (12000, 1280)),
    ("rmsnorm", (8192, 1536)), ("rmsnorm", (8191, 2048)),
    ("rmsnorm", (4096, 4096)), ("rmsnorm", (8192, 7168)),
    ("rmsnorm_strided", (8192, 512)),
    ("causal_conv", (2, 2048, 8192)), ("causal_conv", (4, 1000, 3200)),
    ("causal_conv", (2, 2, 3200)), ("causal_conv", (2, 300, 1000)),
]
FUSED_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _fused_case(name: str, shape: tuple, dtype, seed: int):
    """(kernel forward, plain forward, kernel backward or None, plain
    backward, inputs, cotangent) of one case on the card."""
    from repro_torch.kernels import fused
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def t(*s, scale=1.0, dt=dtype):
        return (torch.randn(s, generator=gen, device="cuda") * scale).to(dt)
    op = name.split("_strided")[0].removesuffix("_state")
    if op == "rmsnorm":
        R, D = shape[0] * (shape[1] if len(shape) == 3 else 1), shape[-1]
        x = t(R, D + 64, scale=2)[:, :D] if "strided" in name else t(R, D)
        ins = [x, 1 + t(D, scale=0.25, dt=torch.float32)]
        fwd = (lambda x, w: fused.rmsnorm(x, w, 1e-5),
               lambda x, w: ref.rmsnorm_ref(x, w, 1e-5))
        bwd = (lambda x, w, dy: fused.rmsnorm_bwd(x, w, dy, 1e-5),
               lambda x, w, dy: ref.rmsnorm_bwd_ref(x, w, dy, 1e-5))
        out_shape = x.shape
    elif op == "rope":
        B, S, H, hd = shape
        x = t(B, S, H, hd + 128)[..., 128:] if "strided" in name \
            else t(B, S, H, hd)
        off = 2047 if S == 1 else 0
        pos = (torch.arange(S, dtype=torch.int32, device="cuda")
               + off).expand(B, S)
        ins = [x, pos]
        fwd = (lambda x, p: fused.rope(x, p, 1e4),
               lambda x, p: ref.rope_ref(x, p, 1e4))
        bwd = (lambda x, p, dy: fused.rope(dy, p, 1e4, negate=True),
               lambda x, p, dy: ref.rope_bwd_ref(dy, p, 1e4))
        out_shape = x.shape
    elif op == "causal_conv":
        B, S, di = shape
        u = t(B, S, 2 * di)[..., :di]
        ins = [u, t(4, di, scale=0.5), t(di, scale=0.25)]
        if "state" in name:
            st = t(B, 3, di)
            ins.append(st)
            fwd = (lambda u, w, b, s: fused.causal_conv(u, w, b,
                                                        s.clone())[0],
                   lambda u, w, b, s: ref.causal_conv_ref(u, w, b, s)[0])
            bwd = None
        else:
            fwd = (lambda u, w, b: fused.causal_conv(u, w, b)[0],
                   lambda u, w, b: ref.causal_conv_ref(u, w, b)[0])
            bwd = (lambda u, w, b, dy: fused.causal_conv_bwd(u, w, b, dy),
                   lambda u, w, b, dy: ref.causal_conv_bwd_ref(u, w, b, dy))
        out_shape = u.shape
    else:
        if "strided" in name:
            B, S, di = shape
            g, u = t(B, S, 2 * di, scale=3)[..., di:], t(B, S, di)
        else:
            g, u = t(*shape, scale=3), t(*shape)
        ins = [g, u]
        fwd = (fused.silu_gate, ref.silu_gate_ref)
        bwd = (fused.silu_gate_bwd, ref.silu_gate_bwd_ref)
        out_shape = g.shape
    dy = t(*out_shape)
    return fwd, bwd, ins, dy


def _tup(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape", FUSED_CASES)
def test_fused_kernel_matches_plain_version(cuda, name, shape, dtype):
    """Each fused kernel, forward and backward, against its plain version
    on the same inputs at a path shape: the forward within the model
    kernels' tolerance (1e-5 f32, 2e-2 bf16, of the largest entry), the
    backward within the gradients' (1e-4 f32, 2e-2 bf16); one launch
    counted each."""
    fwd, bwd, ins, dy = _fused_case(name, shape, dtype, seed=len(name))
    op = name.split("_strided")[0].removesuffix("_state")
    ops.reset_launches()
    got = fwd[0](*ins)
    torch.cuda.synchronize()
    want = fwd[1](*ins)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous()
    assert _rel(got, want) <= FUSED_TOL[dtype][0]
    want_l = {op: 1}
    if bwd is not None:
        got_b = _tup(bwd[0](*ins, dy))
        torch.cuda.synchronize()
        for g, w in zip(got_b, _tup(bwd[1](*ins, dy)), strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert _rel(g, w) <= FUSED_TOL[dtype][1]
        want_l[f"{op}_bwd"] = 1
    assert {c: n for c, n in ops.launches.items() if n} == want_l


# the conv's forward from zeros (staged tiles) and from a state (a thread
# a channel group): (B, S, di, u's extra columns, from a state) -- a
# column slice of in_proj's output, S off the 256-step tile and the
# 32-step chunk, S under the taps, di off the 64-channel tile and not a
# multiple of the 16-byte pieces (one element at a time), u contiguous,
# and decode and a short prefill from a state
CONV_FWD_CASES = [
    (4, 2048, 3200, 3200, False), (2, 2048, 8192, 8192, False),
    (3, 1001, 1000, 1000, False), (2, 300, 1001, 7, False),
    (2, 5, 3200, 0, False), (1, 1, 64, 64, False), (2, 2, 1003, 0, False),
    (1, 33, 200, 3, False), (4, 1, 3200, 3200, True),
    (2, 7, 1000, 0, True), (2, 3, 1001, 5, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,extra,state", CONV_FWD_CASES)
def test_fused_conv_forward_bit_equal(cuda, B, S, di, extra, state, dtype):
    """The conv's forward, bias and SiLU bit for bit equal to its plain
    version, the new state too (from a state: written in place), at
    aligned, unaligned, odd and from-state shapes; one launch."""
    from repro_torch.kernels import fused
    gen = torch.Generator(device="cuda").manual_seed(B * S + di + extra)

    def t(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device="cuda")
                * scale).to(dtype)
    u = t(B, S, di + extra)[..., :di]
    w, b = t(4, di, scale=0.5), t(di, scale=0.25)
    st = t(B, 3, di) if state else None
    held = None if st is None else st.clone()
    ops.reset_launches()
    got, new = fused.causal_conv(u, w, b, held)
    torch.cuda.synchronize()
    want, want_new = ref.causal_conv_ref(u, w, b, st)
    assert torch.equal(got, want) and torch.equal(new, want_new)
    assert held is None or new is held
    assert {c: n for c, n in ops.launches.items() if n} == {
        "causal_conv": 1}


@pytest.mark.cuda
def test_fused_conv_writes_its_state_in_place(cuda):
    """The decode step's conv: the new state written into the state
    handed in, equal to the plain version's."""
    from repro_torch.kernels import fused
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        u = torch.randn((4, 1, 6400), generator=gen, device="cuda").to(dt)
        u = u[..., :3200]
        w = torch.randn((4, 3200), generator=gen, device="cuda").to(dt)
        b = torch.randn((3200,), generator=gen, device="cuda").to(dt)
        st = torch.randn((4, 3, 3200), generator=gen, device="cuda").to(dt)
        held = st.clone()
        _, new = fused.causal_conv(u, w, b, held)
        _, want = ref.causal_conv_ref(u, w, b, st)
        assert new is held and torch.equal(held, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape", [
    c for c in FUSED_CASES if c[0].split("_strided")[0] in (
        "rmsnorm", "causal_conv")])
def test_fused_backwards_repeat_bit_for_bit(cuda, name, shape, dtype):
    """rmsnorm's and the conv's backward, two calls on the same inputs
    with a call at another shape between them (its scratch then holds
    other sums): dx or du, dw and db with the same bits."""
    fwd, bwd, ins, dy = _fused_case(name, shape, dtype, seed=11)
    one = [t.clone() for t in _tup(bwd[0](*ins, dy))]
    _, obwd, oins, ody = _fused_case(name, tuple(
        n + 1 if i == 0 else n for i, n in enumerate(shape)), dtype, seed=12)
    obwd[0](*oins, ody)
    two = _tup(bwd[0](*ins, dy))
    for a, b in zip(one, two, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [c for c in FUSED_CASES
                                        if "state" not in c[0]])
def test_fused_backward_repeats_bit_for_bit(cuda, name, shape):
    """Two calls of each backward kernel on the same inputs: the same
    bits (the weight reductions run in a fixed order, no atomics)."""
    fwd, bwd, ins, dy = _fused_case(name, shape, torch.bfloat16, seed=7)
    one, two = _tup(bwd[0](*ins, dy)), _tup(bwd[0](*ins, dy))
    for a, b in zip(one, two, strict=True):
        assert torch.equal(a, b)
