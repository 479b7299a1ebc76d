"""The port's MoE layer (``repro_torch.models.moe``) and the plain versions
of its grouped-matmul kernel against the JAX package, on the CPU.

Inputs are drawn with numpy and handed to both packages.  In f32 the two
agree within 1e-5; in bf16 they round at other places (JAX's bf16
``silu`` against PyTorch's, sums cast at other points), so products and
layer outputs are held within 6e-2 of the largest value, the bf16
tolerance of ``tests/test_torch_model.py``.  Integer results (router
choices, buffer rows, dropped choices) and the placement-plan arithmetic
are equal.  The slot paths (``moe_tp``, ``moe_a2a``) are held against the
JAX package's own, run under a one-device mesh with Auto axes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_config as jreduce_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import grouped_matmul as pallas_gmm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.parallel import sharding  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.kernels import moe_gmm, ops, ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import sharding as sharding_torch  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype="float32", **kw):
    jcfg = jreduce_config(jget_config("olmoe-1b-7b")).with_(dtype=dtype, **kw)
    cfg = reduce_config(get_config("olmoe-1b-7b")).with_(dtype=dtype, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages (the bf16 cast rounds alike)."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return (t.to(getattr(torch, dtype)),
            jnp.asarray(a, jnp.float32).astype(jnp.dtype(dtype)))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 6e-2 * max(np.abs(want).max(), 1)


@pytest.fixture
def one_device_mesh(monkeypatch):
    """The JAX package's slot paths need a mesh: one device, Auto axes."""
    monkeypatch.setattr(sharding, "_ACTIVE_MESH", None)
    sharding.set_active_mesh(jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    yield
    sharding._ACTIVE_MESH = None


def _moe_params(cfg, rng, dtype, shared=False):
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    arrs = {"router": rng.normal(size=(D, E)) / D ** 0.5,
            "e_gate": rng.normal(size=(E, D, F)) / D ** 0.5,
            "e_up": rng.normal(size=(E, D, F)) / D ** 0.5,
            "e_down": rng.normal(size=(E, F, D)) / F ** 0.5}
    if shared:
        Fs = cfg.n_shared_experts * F
        arrs.update(w_gate=rng.normal(size=(D, Fs)) / D ** 0.5,
                    w_up=rng.normal(size=(D, Fs)) / D ** 0.5,
                    w_down=rng.normal(size=(Fs, D)) / Fs ** 0.5)
    tp, jp = {}, {}
    for name, a in arrs.items():
        dt = "float32" if name == "router" else dtype
        tp[name], jp[name] = _pair(a, dt)
    return tp, jp


# ------------------------------------------------------------ grouped matmul
SHAPES_GMM = [   # tests/test_kernels.py's (G, capacity, D, F, br, bc, bk)
    (2, 8, 16, 16, 8, 8, 16),
    (4, 16, 32, 24, 8, 8, 16),
    (3, 8, 8, 8, 4, 8, 8),
    (8, 32, 16, 48, 16, 16, 16),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES_GMM)
def test_grouped_matmul_aligned_ref_matches_pallas(shape, dtype):
    """The plain version against the Pallas kernel in interpret mode."""
    G, C, D, F, br, bc, bk = shape
    rng = np.random.default_rng(G * 1000 + C * 10 + D)
    x, jx = _pair(rng.normal(size=(G * C, D)), dtype)
    w, jw = _pair(rng.normal(size=(G, D, F)), dtype)
    want = pallas_gmm(jx, jw, C, block_rows=br, block_cols=bc, block_k=bk,
                      interpret=True)
    got = ref.grouped_matmul_aligned_ref(x, w, C)
    assert got.dtype == x.dtype and got.shape == (G * C, F)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_grouped_matmul_matches_jax(dtype):
    rng = np.random.default_rng(11)
    sizes = np.array([3, 0, 5, 2], np.int32)
    x, jx = _pair(rng.normal(size=(int(sizes.sum()), 12)), dtype)
    w, jw = _pair(rng.normal(size=(4, 12, 7)), dtype)
    want = jref.grouped_matmul_reference(jx, jw, jnp.asarray(sizes))
    got = ops.grouped_matmul(x, w, torch.from_numpy(sizes))
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_grouped_matmul_dispatch_on_cpu():
    """A CPU tensor takes the plain version and launches nothing; forced
    onto the kernel it raises instead of falling back."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 8, 5)).astype(np.float32))
    ops.reset_launches()
    got = ops.grouped_matmul_aligned(x, w, 3)
    assert torch.equal(got, ref.grouped_matmul_aligned_ref(x, w, 3))
    assert ops.launches["grouped_matmul"] == 0
    ops.force("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.grouped_matmul_aligned(x, w, 3)
    finally:
        ops.force(None)


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("dtype", DTYPES)
def test_router_topk_matches_jax(dtype):
    cfg, jcfg = _cfgs(dtype)
    rng = np.random.default_rng(13)
    x, jx = _pair(rng.normal(size=(40, cfg.d_model)), dtype)
    r, jr = _pair(rng.normal(size=(cfg.d_model, cfg.n_experts)) / 8,
                  "float32")
    w, idx, aux = moe.router_topk(r, x, cfg)
    jw, jidx, jaux = jmoe.router_topk(jr, jx, jcfg)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert w.dtype == x.dtype
    _close(w, jw, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_router_ties_keep_the_lower_expert_first():
    """Equal router columns give equal probabilities: the lower expert
    comes first, as in ``lax.top_k``."""
    cfg, jcfg = _cfgs(top_k=3)
    rng = np.random.default_rng(14)
    r = rng.normal(size=(cfg.d_model, cfg.n_experts))
    r[:, 5] = r[:, 2]
    r[:, 7] = r[:, 2]
    x = rng.normal(size=(16, cfg.d_model))
    x[:4] = 0.0                                   # all eight experts tie
    tr, jr = _pair(r, "float32")
    tx, jx = _pair(x, "float32")
    _, idx, _ = moe.router_topk(tr, tx, cfg)
    _, jidx, _ = jmoe.router_topk(jr, jx, jcfg)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[:4].tolist() == [[0, 1, 2]] * 4


# ----------------------------------------------------------------- dispatch
DISPATCH_CASES = [
    # (T, k, n_slots, capacity, skew, keep share): skewed choices crowd
    # slots 0 and 1, so most of them are dropped
    (10, 2, 8, 3, False, 1.0),
    (12, 3, 4, 2, True, 1.0),
    (16, 2, 6, 2, True, 0.6),
    (5, 4, 8, 1, False, 0.8),
]


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_sort_dispatch_matches_jax(case):
    T, k, n_slots, cap, skew, keep_share = case
    rng = np.random.default_rng(T * 100 + k)
    D = 6
    if skew:
        slots = rng.choice([0, 1, 1, 0, 2], size=(T, k))
    else:
        slots = rng.integers(0, n_slots, size=(T, k))
    keep = rng.random((T, k)) < keep_share
    xt, jxt = _pair(rng.normal(size=(T, D)), "float32")
    xin, buf_of = moe.sort_dispatch(xt, torch.from_numpy(slots),
                                    torch.from_numpy(keep), n_slots, cap)
    jxin, jbuf = jmoe.sort_dispatch(jxt, jnp.asarray(slots),
                                    jnp.asarray(keep), n_slots, cap)
    assert np.array_equal(buf_of.numpy(), np.asarray(jbuf))
    assert np.array_equal(xin.numpy(), np.asarray(jxin))
    assert xin.shape == (n_slots, cap, D)
    dropped = (buf_of.numpy() == -1)
    if skew:
        assert (dropped & keep).any()      # over capacity: dropped
    assert dropped[~keep].all()


@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_slot_fills_count_the_rows_sort_dispatch_fills(case):
    """``slot_fills`` is, slot by slot, the number of buffer rows that a
    kept choice maps to in the JAX package's ``sort_dispatch``: dropped
    choices (not kept, or past the capacity) are not counted."""
    T, k, n_slots, cap, skew, keep_share = case
    rng = np.random.default_rng(T * 100 + k + 1)
    if skew:
        slots = rng.choice([0, 1, 1, 0, 2], size=(T, k))
    else:
        slots = rng.integers(0, n_slots, size=(T, k))
    keep = rng.random((T, k)) < keep_share
    _, jbuf = jmoe.sort_dispatch(jnp.zeros((T, 4), jnp.float32),
                                 jnp.asarray(slots), jnp.asarray(keep),
                                 n_slots, cap)
    rows = np.asarray(jbuf)
    rows = rows[rows >= 0]
    assert len(np.unique(rows)) == len(rows)       # one row per choice
    want = np.bincount(rows // cap, minlength=n_slots)
    got = moe.slot_fills(torch.from_numpy(slots), torch.from_numpy(keep),
                         n_slots, cap)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


# (slot of each of the 21 choices, capacity, block_rows): slot 0 empty,
# slot 1 over capacity (fill = C), slot 2 a fill that is not a multiple of
# the row block, slot 3 short of one block
FILL_CASES = [
    ([1] * 10 + [2] * 7 + [3] * 3 + [1], 8, 4),
    ([1] * 16 + [2] * 3 + [3] * 2, 16, 8),
]


def _dispatch_buffers(slots, cap, dtype, seed):
    """Dispatch buffers (4 slots of ``cap`` rows, D 16) and their fills
    from one choice per token; each package gets the same buffers."""
    rng = np.random.default_rng(seed)
    T = len(slots)
    sl = torch.tensor(slots, dtype=torch.int64)[:, None]
    keep = torch.ones_like(sl, dtype=torch.bool)
    xt = torch.from_numpy(rng.normal(size=(T, 16)).astype(np.float32))
    xin, _ = moe.sort_dispatch(xt, sl, keep, 4, cap)
    fills = moe.slot_fills(sl, keep, 4, cap)
    x, jx = _pair(xin.reshape(4 * cap, 16).numpy(), dtype)
    return x, jx, fills


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FILL_CASES)
def test_fill_aware_ref_matches_pallas_on_dispatch_buffers(case, dtype):
    """On dispatch buffers the fill-aware plain version equals the Pallas
    kernel (interpret mode) without fills: the rows past a fill are zero,
    and so are their products."""
    slots, cap, br = case
    x, jx, fills = _dispatch_buffers(slots, cap, dtype, seed=cap)
    assert fills.tolist()[0] == 0 and fills.tolist()[1] == cap
    assert fills.tolist()[2] % br and fills.tolist()[3] < br
    rng = np.random.default_rng(cap + 1)
    w, jw = _pair(rng.normal(size=(4, 16, 24)), dtype)
    want = pallas_gmm(jx, jw, cap, block_rows=br, block_cols=8, block_k=16,
                      interpret=True)
    got = ref.grouped_matmul_aligned_ref(x, w, cap, fills)
    assert got.dtype == x.dtype and got.shape == (4 * cap, 24)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fill_aware_ref_zeroes_rows_past_the_fill(dtype):
    """For any x the plain version with fills equals the Pallas kernel on
    x whose rows past the fills are zeroed, and those rows are exact
    zeros."""
    G, C, D, F = 4, 8, 16, 24
    rng = np.random.default_rng(21)
    xa = rng.normal(size=(G * C, D))
    fills = np.array([0, C, 5, 3], np.int32)
    past = np.arange(C)[None, :] >= fills[:, None]          # (G, C)
    xz = np.where(past.reshape(-1, 1), 0.0, xa)
    x, _ = _pair(xa, dtype)
    _, jxz = _pair(xz, dtype)
    w, jw = _pair(rng.normal(size=(G, D, F)), dtype)
    got = ref.grouped_matmul_aligned_ref(x, w, C, torch.from_numpy(fills))
    want = pallas_gmm(jxz, jw, C, block_rows=4, block_cols=8, block_k=16,
                      interpret=True)
    assert bool((got.reshape(G, C, F)[torch.from_numpy(past)] == 0).all())
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_grouped_matmul_fills_dispatch_on_cpu():
    """With fills a CPU tensor still takes the plain version, no route is
    counted, and ``reset_launches`` zeroes the route counts."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 8, 5)).astype(np.float32))
    fills = torch.tensor([1, 3], dtype=torch.int32)
    ops.gmm_route_launches["gmv"] = 5
    ops.reset_launches()
    got = ops.grouped_matmul_aligned(x, w, 3, fills)
    assert torch.equal(got, ref.grouped_matmul_aligned_ref(x, w, 3, fills))
    assert not any(ops.gmm_route_launches.values())
    assert ops.launches["grouped_matmul"] == 0
    assert bool((got[1:3] == 0).all()) and bool((got[0] != 0).all())


@pytest.mark.parametrize("dtype,C,D,F,want", [
    ("bfloat16", 1, 2048, 1024, "gmv"),          # olmoe decode gate/up
    ("bfloat16", 1, 1024, 2048, "gmv"),          # olmoe decode down
    ("float32", 1, 2048, 1024, "gmv"),
    ("bfloat16", 2560, 2048, 1024, "gmm_tc"),    # olmoe prefill gate/up
    ("bfloat16", 2560, 1024, 2048, "gmm_tc"),    # olmoe prefill down
    ("float32", 2560, 2048, 1024, "general"),    # f32 prefill
    ("bfloat16", 16, 64, 64, "gmv"),
    ("bfloat16", 17, 40, 24, "gmm_tc"),
    ("bfloat16", 37, 33, 80, "general"),         # D not a multiple of 8
    ("bfloat16", 37, 96, 7, "general"),          # F not a multiple of 8
])
def test_gmm_route_is_a_function_of_dtype_and_shapes(dtype, C, D, F, want):
    assert moe_gmm.route(getattr(torch, dtype), C, D, F) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_combine_from_buffers_matches_jax(dtype):
    rng = np.random.default_rng(15)
    rows, T, k, D = 12, 7, 3, 5
    y, jy = _pair(rng.normal(size=(rows, D)), dtype)
    w, jw = _pair(rng.random((T, k)), dtype)
    buf = rng.integers(-1, rows, size=(T, k))
    got = moe.combine_from_buffers(y, torch.from_numpy(buf), w)
    want = jmoe.combine_from_buffers(jy, jnp.asarray(buf, jnp.int32), jw)
    assert got.dtype == y.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_expert_ffn_matches_jax(dtype):
    cfg, _ = _cfgs(dtype)
    rng = np.random.default_rng(16)
    tp, jp = _moe_params(cfg, rng, dtype)
    xin, jxin = _pair(rng.normal(size=(cfg.n_experts, 5, cfg.d_model)),
                      dtype)
    got = moe._expert_ffn(tp["e_gate"], tp["e_up"], tp["e_down"], xin)
    want = jmoe._expert_ffn(jp["e_gate"], jp["e_up"], jp["e_down"], jxin)
    _close(got, want, dtype)


# ------------------------------------------------------------------ modes
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_dense_ref_matches_jax(dtype, shared):
    cfg, jcfg = _cfgs(dtype, n_shared_experts=int(shared))
    rng = np.random.default_rng(17)
    tp, jp = _moe_params(cfg, rng, dtype, shared=shared)
    x, jx = _pair(rng.normal(size=(2, 9, cfg.d_model)), dtype)
    y, aux = moe.moe_dense_ref(tp, x, cfg)
    jy, jaux = jmoe.moe_dense_ref(jp, jx, jcfg)
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("mode,S", [("a2a", 12), ("tp", 1), ("tp", 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_slot_paths_match_jax(one_device_mesh, mode, S, dtype):
    """``moe_apply`` in the slot modes against the JAX package's under a
    one-device mesh.  tp at S = 1 is decode: capacity 1 per expert, so
    colliding choices drop, the same ones in both."""
    cfg, jcfg = _cfgs(dtype)
    rng = np.random.default_rng(18)
    tp, jp = _moe_params(cfg, rng, dtype)
    x, jx = _pair(rng.normal(size=(4, S, cfg.d_model)), dtype)
    plan = moe.round_robin_plan(cfg.n_experts, 1)
    jplan = jmoe.round_robin_plan(cfg.n_experts, 1)
    y, aux = moe.moe_apply(tp, x, cfg, plan, mode)
    jy, jaux = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg, jplan,
                                                   mode))(jp, jx)
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_expert_ffn_with_fills_equals_without_on_dispatch_buffers():
    """f32: the three fill-aware products give exactly the products of
    the full buffers, the rows past each fill being zero either way."""
    cfg, _ = _cfgs()
    rng = np.random.default_rng(23)
    tp, _ = _moe_params(cfg, rng, "float32")
    E = cfg.n_experts
    slots = torch.from_numpy(rng.integers(0, E, size=(9, 2)))
    keep = torch.ones_like(slots, dtype=torch.bool)
    xt = torch.from_numpy(rng.normal(size=(9, cfg.d_model)).astype(
        np.float32))
    xin, _ = moe.sort_dispatch(xt, slots, keep, E, 3)
    fills = moe.slot_fills(slots, keep, E, 3)
    assert 0 < int(fills.sum()) < E * 3
    args = (tp["e_gate"], tp["e_up"], tp["e_down"], xin)
    assert torch.equal(moe._expert_ffn(*args, fills),
                       moe._expert_ffn(*args))


@pytest.mark.parametrize("mode,S", [("a2a", 12), ("tp", 1), ("tp", 3)])
def test_slot_paths_same_with_and_without_fills(monkeypatch, mode, S):
    """f32: the slot paths hand ``_expert_ffn`` each slot's fill; without
    it (every row computed) the outputs are exactly the same."""
    cfg, _ = _cfgs()
    rng = np.random.default_rng(24)
    tp, _ = _moe_params(cfg, rng, "float32")
    x = torch.from_numpy(rng.normal(size=(4, S, cfg.d_model)).astype(
        np.float32))
    plan = moe.round_robin_plan(cfg.n_experts, 1)
    seen = []
    real = moe._expert_ffn

    def record(*a):
        seen.append(a[-1])
        return real(*a)
    monkeypatch.setattr(moe, "_expert_ffn", record)
    y, aux = moe.moe_apply(tp, x, cfg, plan, mode)
    assert len(seen) == 1 and seen[0].dtype == torch.int32
    monkeypatch.setattr(moe, "_expert_ffn", lambda *a: real(*a[:4]))
    y0, aux0 = moe.moe_apply(tp, x, cfg, plan, mode)
    assert torch.equal(y, y0) and float(aux) == float(aux0)


def test_multi_shard_plans_wait_for_item_10():
    """Item 10 (distribution) is in: a plan over two shards runs over two
    gloo ranks of a mesh's model axis, both slot paths equal to the dense
    reference; without a mesh (a model axis of one) it is refused."""
    cfg, _ = _cfgs()
    rng = np.random.default_rng(19)
    tp, _ = _moe_params(cfg, rng, "float32")
    x = torch.from_numpy(rng.normal(size=(2, 4, cfg.d_model)).astype(
        np.float32))
    for mode in ("tp", "a2a"):
        with pytest.raises(ValueError, match="model axis of 1"):
            moe.moe_apply(tp, x, cfg, moe.round_robin_plan(8, 2), mode)
    with pytest.raises(ValueError, match="mode"):
        moe.moe_apply(tp, x, cfg, moe.round_robin_plan(8, 1), "ep")
    want, _ = moe.moe_dense_ref(tp, x, cfg)
    for y in run_ranks(_two_shard_rank, 2, cfg, tp, x, timeout=120):
        for mode in ("tp", "a2a"):
            torch.testing.assert_close(y[mode], want, rtol=0, atol=1e-5)


def _two_shard_rank(rank, cfg, p, x):
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    plan = moe.round_robin_plan(cfg.n_experts, 2, capacity_factor=8.0)
    with sharding_torch.use_mesh(mesh):
        return {mode: moe.moe_apply(p, x, cfg, plan, mode)[0]
                for mode in ("tp", "a2a")}


def test_one_shard_slots_alias_the_expert_weights():
    cfg, _ = _cfgs()
    tp, _ = _moe_params(cfg, np.random.default_rng(20), "float32")
    p = moe.materialize_slots(tp, moe.round_robin_plan(cfg.n_experts, 1))
    for name in ("e_gate", "e_up", "e_down"):
        assert p[f"{name}_slots"] is tp[name]
    masks = np.array([1, 3, 2, 2, 1, 3, 2, 1])  # two shards, replicated
    plan2 = moe.plan_from_masks(masks, 8, 2)
    p2 = moe.materialize_slots(tp, plan2)
    gather = np.maximum(np.array(plan2.slot_expert).reshape(-1), 0)
    assert torch.equal(p2["e_up_slots"], tp["e_up"][torch.from_numpy(gather)])


# ------------------------------------------------------------------- plans
def _plan_fields(plan):
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("E,P", [(8, 1), (64, 1), (64, 2), (10, 3)])
def test_plans_and_capacities_match_jax(E, P):
    rng = np.random.default_rng(E * 10 + P)
    assert _plan_fields(moe.round_robin_plan(E, P)) == _plan_fields(
        jmoe.round_robin_plan(E, P))
    masks = rng.integers(1, 1 << P, size=E)
    freq = rng.random(E) * 10
    plan = moe.plan_from_masks(masks, E, P, expert_freq=freq)
    jplan = jmoe.plan_from_masks(masks, E, P, expert_freq=freq)
    assert _plan_fields(plan) == _plan_fields(jplan)
    for T_loc in (1, 4, 37, 8192):
        for k in (1, 2, 8):
            assert moe.a2a_capacities(plan, T_loc, k) == \
                jmoe.a2a_capacities(jplan, T_loc, k)
    rr, jrr = moe.round_robin_plan(E, P), jmoe.round_robin_plan(E, P)
    assert moe.migration_bytes(rr, plan, 3 << 20) == \
        jmoe.migration_bytes(jrr, jplan, 3 << 20)


def test_olmoe_prefill_capacity():
    """olmoe's prefill (4 x 2048 tokens, top 8 of 64 experts) fills 2560
    rows per slot; its decode (4 tokens) one."""
    cfg = get_config("olmoe-1b-7b")
    plan = moe.round_robin_plan(cfg.n_experts, 1)
    assert moe.a2a_capacities(plan, 4 * 2048, cfg.top_k)[0] == 2560
    with pytest.raises(ValueError, match="different"):
        moe.migration_bytes(plan, moe.round_robin_plan(32, 1), 1)
