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
from repro_torch.launch.serve import make_model, serve  # noqa: E402


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
     ("cuda_core", "cuda_core")),
    (1, 33, 90, 5, 5, 64, 64, False, 0, None,        # not causal, Sq != Sk
     ("cuda_core", "prefill_tc")),
    (2, 130, 130, 5, 1, 32, 32, True, 24, None,      # sliding window, G = 5
     ("cuda_core", "cuda_core")),
    (2, 1, 150, 10, 2, 64, 64, True, 0, "linear",    # decode, linear cache
     ("decode_split", "decode_split")),
    (2, 1, 64, 10, 2, 64, 64, True, 0, "ring",       # decode, ring with pads
     ("decode_split", "decode_split")),
    (1, 40, 40, 4, 2, 192, 128, True, 0, None,       # hd 192, hd_v 128
     ("cuda_core", "cuda_core")),
    # the tensor-core prefill: Sq and Sk not multiples of 64, G 5 and 1
    (2, 200, 200, 10, 2, 64, 64, True, 0, None,
     ("cuda_core", "prefill_tc")),
    (1, 150, 150, 4, 4, 128, 128, True, 0, None,
     ("cuda_core", "prefill_tc")),
    (1, 77, 190, 6, 6, 128, 128, False, 0, None,
     ("cuda_core", "prefill_tc")),
    # window edges inside a key tile
    (2, 300, 300, 5, 1, 64, 64, True, 100, None,
     ("cuda_core", "prefill_tc")),
    (1, 260, 260, 2, 2, 128, 128, True, 70, None,
     ("cuda_core", "prefill_tc")),
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
    (3, 130, 136, 520)])
def test_grouped_matmul_kernel_matches_plain_version(cuda, no_tf32, G, C,
                                                     D, F, dtype, fills):
    """C <= 16 takes ``gmv`` (D = 1100 spans rows past a lane group's
    unroll), larger C ``gmm_tc`` in bf16 with D and F multiples of 8 (C
    200, 37, 300 and 130 leave a partial row tile, G = 1, D = 8 x odd, F =
    24 a partial column box) and ``cuda_core`` otherwise; D = 33, F = 7
    take the unvectorized loads.  With fills, the x rows past each fill
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


@pytest.mark.cuda
def test_serve_olmoe_on_cuda_with_placement(cuda):
    res = serve(reduce_config(get_config("olmoe-1b-7b")), 2, 20, 3,
                device=cuda, seed=0, placement="replicated")
    assert res.launches["grouped_matmul"] == 3 * 3      # 1 layer, 3 calls
    assert res.launches["flash_attention"] == 1
    assert res.launches["attention_masked"] == 2
    assert res.placement["lambda_cost_repl"] <= \
        res.placement["lambda_cost_no_repl"]


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
