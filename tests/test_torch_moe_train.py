"""The MoE training path on the CPU: the grouped matmul's plain backward
and a reduced olmoe trained through the launcher.

``ref.grouped_matmul_aligned_bwd_ref`` spells out the arithmetic of
``csrc/moe_gmm_bwd.cu``; here it is held against autograd of the plain
forward (``grouped_matmul_aligned_ref``) on inputs drawn with numpy, with
slot fills of 0, C and a partial one: in f32 within 1e-6 of each
gradient's largest entry (the same sums in another order), bf16 inputs
within 2e-2 (the gradients are rounded to bf16, 8 bits).  Rows past a
fill must give exact-zero dx rows and send nothing into dw, whatever x
and dy hold there.  Then ``launch.train --device cpu --reduced`` takes
three steps of olmoe, its grouped products differentiated on the plain
versions.  The dispatch's and the combine's gathers (embedding lookups)
are held to the gradients the routing defines, with and without dropped
choices.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenStream  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import batch_to, build_train_step  # noqa: E402


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _fills(kind, G, C):
    """None, or per group a fill of 0, C and one inside, in turn."""
    if kind is None:
        return None
    cycle = [0, C, max(1, C // 2 + 1)]
    return torch.tensor([cycle[g % 3] for g in range(G)], dtype=torch.int32)


# (G, C, D, F): one group, several, capacities of 1 and more, D != F
GMM_CASES = [(1, 5, 8, 16), (3, 7, 16, 8), (4, 1, 24, 40), (5, 12, 32, 24)]


@pytest.mark.parametrize("fills", [None, "edges"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G,C,D,F", GMM_CASES)
def test_grouped_matmul_bwd_ref_matches_autograd(G, C, D, F, dtype, tol,
                                                 fills):
    rng = np.random.default_rng(G * 100 + C * 10 + D)
    x = _t(rng, G * C, D, dtype=dtype).requires_grad_()
    w = _t(rng, G, D, F, dtype=dtype).requires_grad_()
    dy = _t(rng, G * C, F, dtype=dtype)
    fl = _fills(fills, G, C)
    ref.grouped_matmul_aligned_ref(x, w, C, fl).backward(dy)
    dx, dw = ref.grouped_matmul_aligned_bwd_ref(x.detach(), w.detach(), dy,
                                                C, fl)
    for got, t in ((dx, x), (dw, w)):
        assert got.dtype == dtype and got.shape == t.shape
        assert _gap(got, t.grad) <= tol


@pytest.mark.parametrize("G,C,D,F", GMM_CASES[1:])
def test_rows_past_a_fill_send_nothing(G, C, D, F):
    """x and dy hold huge values and NaNs past the fills: dx is exactly 0
    there, and dw equals the f64 sum over the live rows alone."""
    rng = np.random.default_rng(C + D)
    x, w, dy = _t(rng, G * C, D), _t(rng, G, D, F), _t(rng, G * C, F)
    fl = _fills("edges", G, C)
    past = (torch.arange(C)[None, :] >= fl[:, None]).reshape(-1)
    x[past] = 1e30
    dy[past] = float("nan")
    dx, dw = ref.grouped_matmul_aligned_bwd_ref(x, w, dy, C, fl)
    assert bool((dx[past] == 0).all()) and torch.isfinite(dx).all()
    xs, dys = x.view(G, C, D).double(), dy.view(G, C, F).double()
    for g in range(G):
        n = int(fl[g])
        want = xs[g, :n].T @ dys[g, :n]
        assert torch.allclose(dw[g].double(), want, rtol=1e-6, atol=1e-6)


def _routing(capacity):
    """32 tokens routed top-4 over 8 slots: at capacity 6 most choices are
    dropped (16 a slot on average), at 40 none."""
    rng = np.random.default_rng(capacity)
    slots = torch.from_numpy(np.argsort(rng.random((32, 8)), axis=1)[:, :4])
    keep = torch.ones_like(slots, dtype=torch.bool)
    return slots, keep, 8, capacity


@pytest.mark.parametrize("capacity", [6, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_gradient_sums_each_tokens_kept_rows(dtype, capacity):
    """A token's gradient is the sum of the buffer rows of its kept
    choices; the empty rows (the padding row's reads) send nothing."""
    slots, keep, S, C = _routing(capacity)
    rng = np.random.default_rng(1)
    x = _t(rng, 32, 16, dtype=dtype).requires_grad_()
    dxin = _t(rng, S, C, 16, dtype=dtype)
    xin, buf_of = moe.sort_dispatch(x, slots, keep, S, C)
    xin.backward(dxin)
    kept = buf_of >= 0
    assert bool(kept.all()) == (capacity == 40)
    tok = torch.arange(32)[:, None].expand(32, 4)[kept]
    want = torch.zeros(32, 16, dtype=torch.float64).index_add_(
        0, tok, dxin.reshape(S * C, 16)[buf_of[kept]].double())
    assert _gap(x.grad, want) <= (1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("capacity", [6, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_gradient_reaches_only_kept_rows(dtype, capacity):
    """Buffer row r read by the kept choice (t, j) gets w[t, j] dy[t];
    every other row, row 0 included, which each dropped choice reads,
    gets only that."""
    slots, keep, S, C = _routing(capacity)
    rng = np.random.default_rng(2)
    _, buf_of = moe.sort_dispatch(_t(rng, 32, 16), slots, keep, S, C)
    yout = _t(rng, S * C, 16, dtype=dtype).requires_grad_()
    w = torch.from_numpy(rng.random((32, 4)).astype(np.float32)).to(dtype)
    dy = _t(rng, 32, 16, dtype=dtype)
    moe.combine_from_buffers(yout, buf_of, w).backward(dy)
    kept = buf_of >= 0
    t, j = kept.nonzero(as_tuple=True)
    want = torch.zeros(S * C, 16, dtype=torch.float64)
    want[buf_of[t, j]] = w[t, j, None].double() * dy[t].double()
    assert _gap(yout.grad, want) <= (1e-6 if dtype == torch.float32
                                     else 2e-2)


def test_reduced_olmoe_trains_through_the_launcher(tmp_path):
    hist = launch_train.main(["--arch", "olmoe-1b-7b", "--reduced",
                              "--device", "cpu", "--steps", "3", "--batch",
                              "2", "--seq", "16", "--ckpt-dir",
                              str(tmp_path)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_olmoe_step_reaches_every_expert_weight():
    """One reduced olmoe step on the CPU: the three expert weights and the
    router get gradients (the slot path's dispatch, products and combine
    all differentiate), and AdamW moves them."""
    cfg = reduce_config(get_config("olmoe-1b-7b")).with_(dtype="float32")
    ts = build_train_step(cfg, adamw.AdamWConfig(lr=1e-2, warmup_steps=1),
                          device="cpu")
    state = ts.init_state(0)
    before = {n: p.detach().clone() for n, p in state["params"].items()}
    batch = batch_to(SyntheticTokenStream(cfg, DataConfig(2, 16)).next_batch(),
                     "cpu")
    ops.reset_launches()
    params, met = ts.grads(state, batch)
    assert not any(ops.launches.values())        # the plain versions
    names = [n for n in params if n.rsplit(".", 1)[-1] in (
        "e_gate", "e_up", "e_down", "router")]
    assert len(names) == 4 * cfg.n_layers
    for n in names:
        assert params[n].grad.abs().sum() > 0, n
    ts.update(state, params)
    for n in names:
        assert not torch.equal(params[n].detach(), before[n]), n
