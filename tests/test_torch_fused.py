"""The fused elementwise ops (``kernels/fused.py``, ``csrc/fused.cu``) on
the CPU: rmsnorm, rope, the Mamba mixer's causal conv with its bias and
SiLU, and the SiLU gate.

- Each plain forward (``ref.*_ref``) against the JAX package's function:
  ``repro.models.layers.rmsnorm`` and ``rope``, ``jax.nn.silu(g) * u``, and
  the conv part of ``repro.models.layers.mamba_mixer`` (its lines, as
  ``_jax_conv`` below: the window gather, the einsum, the bias, SiLU), from
  zeros and from a state (decode).
- Each written-out backward (``ref.*_bwd_ref``) against ``jax.vjp`` of the
  same function and against autograd of the plain forward.
- Each autograd Function (``ops.force("cuda")``, the kernels' launches on
  their plain versions, ``PLAIN_FUSED``): its output equal to the plain
  forward's and its gradients to autograd's on the plain chain, one
  launch of the forward and one of the backward counted.
- Dispatch: a CPU tensor takes the plain version and launches nothing;
  forced onto the kernel it raises.  The meta path: shapes, one call
  counted, the bytes of the bound.
- The slice as a whole: reduced hymba-1.5b and olmoe-1b-7b (head dim 64)
  and hubert-xlarge (head dim 80), f32, remat "full", every kernel's
  launch on its plain version under ``ops.force("cuda")``: loss and every
  gradient leaf against ``jax.grad`` of ``repro``'s ``Model.loss``, and
  the fused kernels' calls of one step counted as the smoke run's
  ``expected_train_launches`` counts them.

Inputs come from numpy seeds, in f32 and bf16, at small widths including
the odd ones (D = 1600, hd = 80, 25/5 heads).  Tolerances, each against
the largest entry of the reference: 1e-5 in f32, as the port's model
parity tests hold; 6e-2 in bf16, the known one-unit gap between the two
frameworks' bf16 roundings (ROADMAP, known divergences); the whole
slice's loss and gradients 1e-5 too.
"""
import dataclasses
import itertools
import zlib

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
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import model_state_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused, ops, ref  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import moe_gmm  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train.step import batch_to  # noqa: E402

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 6e-2}
EPS = 1e-5
THETA = 1e4


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(sharding, "_ACTIVE_MESH", None)


def _gap(got, want) -> float:
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max() / scale)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        getattr(torch, dtype))
    return t, jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _jax_conv(u, w, b, state=None):
    """The conv part of ``repro.models.layers.mamba_mixer``: the padded or
    state-prefixed input, its windows, the einsum with the taps, the bias,
    SiLU; and the new state."""
    K, S = w.shape[0], u.shape[1]
    if state is None:
        u_pad = jnp.pad(u, ((0, 0), (K - 1, 0), (0, 0)))
    else:
        u_pad = jnp.concatenate([state, u], axis=1)
    new_conv = u_pad[:, -(K - 1):, :]
    idx = jnp.arange(S)[:, None] + jnp.arange(K)[None, :]
    windows = u_pad[:, idx, :]
    u_conv = jnp.einsum("bskn,kn->bsn", windows, w) + b
    return jax.nn.silu(u_conv), new_conv


def _jax_gate(g, u):
    return jax.nn.silu(g) * u


# ------------------------------------------------ plain forwards vs JAX
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,strided", [(64, False), (1600, False),
                                       (576, True)])
def test_rmsnorm_plain_matches_jax(D, strided, dtype):
    """Rows of D, one of them a column slice of a wider row (MLA's latent
    part of ``wkv_a``'s output)."""
    rng = _rng("norm", D, dtype)
    wide = rng.standard_normal((2, 5, D + 64 * strided)) * 3
    w = 1 + rng.standard_normal(D) / 4
    x, jx = _pair(wide, dtype)
    x, jx = x[..., :D], jx[..., :D]
    tw, jw = _pair(w, "float32")
    got = ref.rmsnorm_ref(x, tw, EPS)
    want = jlayers.rmsnorm(jx, jw, EPS)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    assert _gap(_np(got), _np(want)) <= TOL[dtype]
    assert torch.equal(layers.rmsnorm(x, tw, EPS), got)


def _positions(B: int, S: int, off: int = 0) -> np.ndarray:
    return np.broadcast_to(np.arange(S, dtype=np.int32) + off, (B, S))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd,H,off", [(64, 5, 0), (80, 25, 0), (128, 4, 7),
                                      (64, 25, 2048)])
def test_rope_plain_matches_jax(hd, H, off, dtype):
    """At positions from 0 and from an offset (the sequence split's
    ``q_off``, a decode step's)."""
    rng = _rng("rope", hd, H, off, dtype)
    B, S = 2, 6
    x, jx = _pair(rng.standard_normal((B, S, H, hd)), dtype)
    pos = _positions(B, S, off)
    got = ref.rope_ref(x, torch.from_numpy(pos.copy()), THETA)
    want = jlayers.rope(jx, jnp.asarray(pos), THETA)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert _gap(_np(got), _np(want)) <= TOL[dtype]
    # the layers' call: positions as ``_positions`` makes them, expanded
    tpos = layers._positions(B, S, "cpu", off)
    assert torch.equal(layers.rope(x, tpos, THETA), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 7, 24), (2, 4, 1600), (10, 64)])
def test_silu_gate_plain_matches_jax(shape, dtype):
    rng = _rng("gate", shape, dtype)
    g, jg = _pair(rng.standard_normal(shape) * 3, dtype)
    u, ju = _pair(rng.standard_normal(shape), dtype)
    got = ref.silu_gate_ref(g, u)
    assert got.dtype == g.dtype
    assert _gap(_np(got), _np(_jax_gate(jg, ju))) <= TOL[dtype]


def _conv_inputs(rng, B, S, di, K, dtype, slice_of_wider=True):
    """u as the mixer takes it (the first half of ``in_proj``'s output, a
    column slice), the taps, a nonzero bias."""
    xz, jxz = _pair(rng.standard_normal((B, S, 2 * di)), dtype)
    u, ju = (xz[..., :di], jxz[..., :di]) if slice_of_wider else (
        xz[..., :di].contiguous(), jxz[..., :di])
    w, jw = _pair(rng.standard_normal((K, di)) / K ** 0.5, dtype)
    b, jb = _pair(rng.standard_normal(di) / 4, dtype)
    return (u, w, b), (ju, jw, jb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,K", [(9, 4), (2, 4), (5, 3), (4, 2)])
def test_conv_plain_matches_jax(S, K, dtype):
    """From zeros, S shorter than the taps too: u_conv and the new state
    (the last d_conv - 1 inputs, zeros where the sequence is shorter)."""
    rng = _rng("conv", S, K, dtype)
    (u, w, b), (ju, jw, jb) = _conv_inputs(rng, 2, S, 40, K, dtype)
    got, new = ref.causal_conv_ref(u, w, b)
    want, jnew = _jax_conv(ju, jw, jb)
    assert got.dtype == u.dtype and got.shape == u.shape
    assert _gap(_np(got), _np(want)) <= TOL[dtype]
    assert np.array_equal(_np(new), _np(jnew))
    # the mixer's call: the same function, the state a view
    got_ops, new_ops = ops.causal_conv(u, w, b)
    assert torch.equal(got_ops, got) and torch.equal(new_ops, new)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_decode_from_state_matches_jax(dtype):
    """The decode step (S = 1) from a state, against the reference's
    ``state`` branch; ``ops.causal_conv`` writes the new state in place
    and returns it."""
    rng = _rng("conv_state", dtype)
    K, di = 4, 48
    (u, w, b), (ju, jw, jb) = _conv_inputs(rng, 3, 1, di, K, dtype)
    state, jstate = _pair(rng.standard_normal((3, K - 1, di)), dtype)
    want, jnew = _jax_conv(ju, jw, jb, jstate)
    got, new = ref.causal_conv_ref(u, w, b, state)
    assert _gap(_np(got), _np(want)) <= TOL[dtype]
    assert np.array_equal(_np(new), _np(jnew))
    held = state.clone()
    got_ops, new_ops = ops.causal_conv(u, w, b, held)
    assert new_ops is held and torch.equal(held, new)
    assert torch.equal(got_ops, got)


# ------------------------------------------- written-out backwards
def _vjp(fn, args, dy):
    _, pull = jax.vjp(fn, *args)
    return [_np(g) for g in pull(dy)]


def _autograd(fn, args, dy, grad=None):
    leaves = [a.detach().clone().requires_grad_(g)
              for a, g in zip(args, grad or [True] * len(args))]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    out.backward(dy)
    return [_np(a.grad) if a.requires_grad else None for a in leaves]


# the path's norm widths (MLA's kv_ln 512, smollm 576, hubert 1280, MLA's
# q_ln 1536, hymba 1600, olmoe 2048, deepseek-7b and llama-vision 4096,
# deepseek-v3 7168) and one off a multiple of four
NORM_WIDTHS = [512, 576, 1001, 1280, 1536, 1600, 2048, 4096, 7168]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, *NORM_WIDTHS])
def test_rmsnorm_backward_plain(D, dtype):
    rng = _rng("norm_bwd", D, dtype)
    x, jx = _pair(rng.standard_normal((3, 4, D)) * 2, dtype)
    w, jw = _pair(1 + rng.standard_normal(D) / 4, "float32")
    dy, jdy = _pair(rng.standard_normal((3, 4, D)), dtype)
    dx, dw = ref.rmsnorm_bwd_ref(x, w, dy, EPS)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    want = _vjp(lambda a, b: jlayers.rmsnorm(a, b, EPS), (jx, jw), jdy)
    plain = _autograd(lambda a, b: ref.rmsnorm_ref(a, b, EPS), (x, w), dy)
    for got, jw_, pw in zip((dx, dw), want, plain):
        assert _gap(_np(got), jw_) <= TOL[dtype]
        assert _gap(_np(got), pw) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd,H", [(64, 5), (80, 25)])
def test_rope_backward_plain(hd, H, dtype):
    """Rope's backward is rope at the negated angles."""
    rng = _rng("rope_bwd", hd, H, dtype)
    x, jx = _pair(rng.standard_normal((2, 5, H, hd)), dtype)
    dy, jdy = _pair(rng.standard_normal((2, 5, H, hd)), dtype)
    pos = _positions(2, 5, 3)
    tpos, jpos = torch.from_numpy(pos.copy()), jnp.asarray(pos)
    got = ref.rope_bwd_ref(dy, tpos, THETA)
    want, = _vjp(lambda a: jlayers.rope(a, jpos, THETA), (jx,), jdy)
    plain, = _autograd(lambda a: ref.rope_ref(a, tpos, THETA), (x,), dy)
    assert got.dtype == x.dtype
    assert _gap(_np(got), want) <= TOL[dtype]
    assert _gap(_np(got), plain) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,K", [(9, 4), (2, 4), (70, 4), (5, 3)])
def test_conv_backward_plain(S, K, dtype):
    """du (the correlation with the flipped taps), dw and db."""
    rng = _rng("conv_bwd", S, K, dtype)
    (u, w, b), (ju, jw, jb) = _conv_inputs(rng, 2, S, 24, K, dtype)
    dy, jdy = _pair(rng.standard_normal((2, S, 24)), dtype)
    got = ref.causal_conv_bwd_ref(u, w, b, dy)
    want = _vjp(lambda a, c, d: _jax_conv(a, c, d)[0], (ju, jw, jb), jdy)
    plain = _autograd(lambda a, c, d: ref.causal_conv_ref(a, c, d)[0],
                      (u, w, b), dy)
    for g, jg, pg in zip(got, want, plain):
        assert g.dtype == u.dtype
        assert _gap(_np(g), jg) <= TOL[dtype]
        assert _gap(_np(g), pg) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,di", [(9, 3200), (300, 1000), (3, 8192),
                                  (2, 4096), (40, 1001)])
def test_conv_backward_plain_path_widths(S, di, dtype):
    """The conv's backward at the path's channel counts (hymba's 3200,
    falcon's 8192 and a tp rank's 4096), a sequence longer than a tile of
    the kernel's plan, S shorter than the taps, and widths off the
    kernel's 64-channel tile and off a multiple of four; against
    ``jax.vjp`` of the mixer's conv."""
    rng = _rng("conv_bwd_w", S, di, dtype)
    (u, w, b), (ju, jw, jb) = _conv_inputs(rng, 2, S, di, 4, dtype)
    dy, jdy = _pair(rng.standard_normal((2, S, di)), dtype)
    got = ref.causal_conv_bwd_ref(u, w, b, dy)
    want = _vjp(lambda a, c, d: _jax_conv(a, c, d)[0], (ju, jw, jb), jdy)
    for g, jg in zip(got, want):
        assert g.dtype == u.dtype
        assert _gap(_np(g), jg) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 7, 24), (4, 1600)])
def test_silu_gate_backward_plain(shape, dtype):
    rng = _rng("gate_bwd", shape, dtype)
    g, jg = _pair(rng.standard_normal(shape) * 3, dtype)
    u, ju = _pair(rng.standard_normal(shape), dtype)
    dy, jdy = _pair(rng.standard_normal(shape), dtype)
    got = ref.silu_gate_bwd_ref(g, u, dy)
    want = _vjp(_jax_gate, (jg, ju), jdy)
    plain = _autograd(ref.silu_gate_ref, (g, u), dy)
    for x, jx, px in zip(got, want, plain):
        assert x.dtype == g.dtype
        assert _gap(_np(x), jx) <= TOL[dtype]
        assert _gap(_np(x), px) <= TOL[dtype]


# ------------------------------------------- the backwards' plans
SMEM_MAX = 232448      # shared memory a block may have on the H100 (227 KB)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("R", [1, 4, 37, 255, 256, 257, 8191, 8192, 12000,
                               32768, 65536])
@pytest.mark.parametrize("D", [*NORM_WIDTHS, 4, 8192])
def test_norm_bwd_plan_covers_every_row_once(D, R, elem):
    """rmsnorm's backward plan at the path's widths (and the one-element
    path's, the narrowest and the widest): threads a row a multiple of 32
    holding every element, at most ``NORM_MAX_TX`` a block; shared memory
    within the card's; the bands cover the rows once, each a whole number
    of the block's row groups but the last; the same plan on every call."""
    plan = fused.norm_bwd_plan(R, D, elem)
    assert plan == fused.norm_bwd_plan(R, D, elem)
    tx, ty = plan["threads_x"], plan["groups"]
    assert tx % 32 == 0 and tx * fused.NORM_H >= D
    assert tx * fused.NORM_H < D + 32 * fused.NORM_H
    assert plan["threads"] == tx * ty <= fused.NORM_MAX_TX
    assert plan["threads"] <= max(tx, fused.NORM_BLOCK[elem])
    assert plan["shared_bytes"] <= SMEM_MAX
    band, parts = plan["band"], plan["parts"]
    assert band % ty == 0 and parts <= max(fused.NORM_BANDS, 1)
    seen = np.zeros(R, dtype=np.int64)
    for p in range(parts):
        seen[p * band:min((p + 1) * band, R)] += 1
    assert (seen == 1).all()


def test_norm_bwd_plan_refuses_rows_wider_than_8192():
    fused.norm_bwd_plan(8, 8192)
    for elem in (2, 4):
        with pytest.raises(ValueError, match="8192"):
            fused.norm_bwd_plan(8, 8193, elem)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("B,S", [
    (4, 2048), (2, 2048), (4, 1), (2, 2), (4, 1000), (2, 300), (2, 70),
    (3, 9), (2, 5), (1, 255), (1, 256), (1, 257), (1, 512), (8, 1500),
    (1, 4096)])
def test_conv_bwd_plan_covers_every_step_once(B, S, elem):
    """The conv's backward plan: its chunks of ``steps`` (at least the
    taps' K - 1, whole slots of 2 KB of a 64-channel row: 16 bf16 or 8 f32
    steps) in tiles of ``CONV_CY`` cover every step of a sequence once;
    ``parts`` one a (sequence, tile); shared memory within the card's
    with two blocks an SM; the same plan on every call."""
    plan = fused.conv_bwd_plan(B, S, elem)
    assert plan == fused.conv_bwd_plan(B, S, elem)
    steps = plan["steps"]
    assert steps >= max(fused.CONV_TAPS) - 1
    assert steps % (2048 // (fused.CONV_CW * elem)) == 0
    assert plan["tile_steps"] == fused.CONV_CY * steps
    assert 2 * plan["shared_bytes"] <= SMEM_MAX
    tiles = plan["tiles"]
    assert plan["parts"] == B * tiles
    seen = np.zeros(S, dtype=np.int64)
    for t in range(tiles):
        for y in range(fused.CONV_CY):
            s0 = (t * fused.CONV_CY + y) * steps
            seen[s0:min(s0 + steps, S)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("B,S", [
    (4, 2048), (2, 2048), (4, 1), (2, 2), (3, 1001), (2, 300), (1, 255),
    (1, 257), (8, 1500), (1, 4096)])
def test_conv_fwd_plan_covers_every_step_once(B, S, elem):
    """The conv's forward plan from zeros (hymba's (4, 2048) and
    falcon's (2, 2048) training shapes, decode's S = 1, odd S): chunks of
    ``steps``, whole slots of 2 KB of a 64-channel row (16 bf16 or 8 f32
    steps) and at least the taps' K - 1, in tiles of ``CONV_CY``
    cover every step once; shared memory as the kernel counts it (a ring
    of two slots and three rows before the chunk, each warp), under the
    48 KB a block takes without raising its limit; the same plan on every
    call."""
    plan = fused.conv_fwd_plan(B, S, elem)
    assert plan == fused.conv_fwd_plan(B, S, elem)
    slot = 2048 // (fused.CONV_CW * elem)
    steps = plan["steps"]
    assert steps >= max(slot, max(fused.CONV_TAPS) - 1)
    assert steps % slot == 0
    assert plan["tile_steps"] == fused.CONV_CY * steps
    assert plan["shared_bytes"] == (fused.CONV_CY * fused.CONV_CW
                                    * (2 * slot + 3) * elem)
    assert plan["shared_bytes"] <= 48 * 1024
    seen = np.zeros(S, dtype=np.int64)
    for t in range(plan["tiles"]):
        for y in range(fused.CONV_CY):
            s0 = (t * fused.CONV_CY + y) * steps
            seen[s0:min(s0 + steps, S)] += 1
    assert (seen == 1).all()
    assert (plan["tiles"] - 1) * plan["tile_steps"] < S


def test_conv_forward_launch_follows_its_plan(monkeypatch):
    """``causal_conv`` from zeros hands its launch the plan's chunk;
    from a state (decode, in place) none: one thread walks the whole
    sequence."""
    seen = []
    monkeypatch.setattr(fused, "_launch_conv",
                        lambda *a: seen.append((a[3] is None, a[6])))
    for (B, S, di), dt in itertools.product(
            ((4, 2048, 3200), (2, 2048, 8192), (3, 1001, 1000), (4, 1, 3200)),
            (torch.float32, torch.bfloat16)):
        u = torch.zeros((B, S, 2 * di), dtype=dt)[..., :di]
        w, b = torch.zeros((4, di), dtype=dt), torch.zeros(di, dtype=dt)
        fused.causal_conv(u, w, b)
        assert seen.pop() == (
            True, fused.conv_fwd_plan(B, S, u.element_size())["steps"])
        fused.causal_conv(u, w, b, torch.zeros((B, 3, di), dtype=dt))
        assert seen.pop() == (False, 0)


def test_backward_scratch_follows_the_plans(monkeypatch):
    """The wrappers hand their launches scratch of the plans' sizes and the
    plans: part (parts, D) for rmsnorm (row-aligned strided x too), part
    (parts, K + 1, di) for the conv."""
    seen = {}
    monkeypatch.setattr(fused, "_launch_rmsnorm_bwd", lambda *a: seen.update(
        norm=(a[5].shape, a[6])))
    monkeypatch.setattr(fused, "_launch_conv_bwd", lambda *a: seen.update(
        conv=(a[7].shape, a[8])))
    for (R, D), dt in itertools.product(
            ((8192, 1600), (37, 1001), (4096, 512)),
            (torch.float32, torch.bfloat16)):
        x = torch.zeros((R, D + 64), dtype=dt)[:, :D]
        fused.rmsnorm_bwd(x, torch.ones(D), torch.zeros((R, D), dtype=dt),
                          EPS)
        plan = fused.norm_bwd_plan(R, D, x.element_size())
        assert seen["norm"] == ((plan["parts"], D), plan)
    for (B, S, di), dt in itertools.product(
            ((4, 2048, 3200), (2, 70, 1001)),
            (torch.float32, torch.bfloat16)):
        u = torch.zeros((B, S, 2 * di), dtype=dt)[..., :di]
        fused.causal_conv_bwd(u, torch.zeros((4, di), dtype=dt),
                              torch.zeros(di, dtype=dt),
                              torch.zeros((B, S, di), dtype=dt))
        plan = fused.conv_bwd_plan(B, S, u.element_size())
        assert seen["conv"] == ((plan["parts"], 5, di), plan)


# ------------------------------------ the Functions, launches on plain
def _outs(outs, values) -> None:
    for out, value in zip(outs, values):
        out.copy_(value)


def _plain_conv_launch(u, w, b, state_in, y, state_out, chunk):
    got, new = ref.causal_conv_ref(u, w, b, state_in)
    _outs((y, state_out), (got, new))


# the fused kernels' launches as their plain versions, each writing the
# outputs the wrapper allocated
PLAIN_FUSED = {
    "_launch_rmsnorm": lambda x2, w, y2, eps: y2.copy_(
        ref.rmsnorm_ref(x2, w, eps)),
    "_launch_rmsnorm_bwd": lambda x2, w, dy2, dx2, dw, part, plan, eps:
        _outs((dx2, dw), ref.rmsnorm_bwd_ref(x2, w, dy2, eps)),
    "_launch_rope": lambda x, pos, theta, out, negate: out.copy_(
        ref.rope_ref(x, pos, theta, negate)),
    "_launch_conv": _plain_conv_launch,
    "_launch_conv_bwd": lambda u, w, b, dy, du, dw, db, part, plan:
        _outs((du, dw, db), ref.causal_conv_bwd_ref(u, w, b, dy)),
    "_launch_gate": lambda g2, u2, y2: y2.copy_(ref.silu_gate_ref(g2, u2)),
    "_launch_gate_bwd": lambda g2, u2, dy2, dg2, du2:
        _outs((dg2, du2), ref.silu_gate_bwd_ref(g2, u2, dy2)),
}


def _patch_plain_fused(monkeypatch) -> None:
    for name, launch in PLAIN_FUSED.items():
        monkeypatch.setattr(fused, name, launch)


@pytest.fixture
def plain_fused(monkeypatch):
    """``ops.force("cuda")`` with the fused kernels' launches on their
    plain versions: the wrappers, Functions and counters run as on the
    card, on CPU tensors."""
    _patch_plain_fused(monkeypatch)
    ops.force("cuda")
    ops.reset_launches()
    yield
    ops.force(None)
    ops.reset_launches()


def _cases(dtype: str):
    """Per op: its ``ops`` call, its plain forward, its inputs (the last
    ones not differentiated) and its cotangent's shape."""
    rng = _rng("fn", dtype)
    dt = getattr(torch, dtype)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to(dt)
    xz = t(2, 70, 48)
    wide = t(2, 3, 1664)
    pos = torch.from_numpy(_positions(2, 6, 5).copy())
    w32 = (1 + torch.from_numpy(rng.standard_normal(1600).astype(
        np.float32)) / 4)
    return {
        "rmsnorm": (lambda x, w: ops.rmsnorm(x, w, EPS),
                    lambda x, w: ref.rmsnorm_ref(x, w, EPS),
                    [wide[..., :1600], w32]),
        "rope": (lambda x: ops.rope(x, pos, THETA),
                 lambda x: ref.rope_ref(x, pos, THETA),
                 [t(2, 6, 25, 80)[..., 16:]]),
        "causal_conv": (lambda u, w, b: ops.causal_conv(u, w, b)[0],
                        lambda u, w, b: ref.causal_conv_ref(u, w, b)[0],
                        [xz[..., :24], t(4, 24, scale=0.5), t(24)]),
        "silu_gate": (ops.silu_gate, ref.silu_gate_ref,
                      [t(2, 5, 192, scale=3)[..., 96:], t(2, 5, 96)]),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["rmsnorm", "rope", "causal_conv",
                                "silu_gate"])
def test_function_matches_plain_autograd(plain_fused, op, dtype):
    """The op's Function on views as the layers hand them: its output the
    plain forward's bit for bit (the launch is the plain version) and its
    gradients autograd's of the plain chain; one forward and one backward
    launch counted."""
    call, plain, args = _cases(dtype)[op]
    out = None
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    out = call(*leaves)
    dy = torch.from_numpy(_rng("dy", op, dtype).standard_normal(
        out.shape).astype(np.float32)).to(out.dtype)
    out.backward(dy)
    ops.force(None)
    want = _autograd(plain, args, dy)
    with torch.no_grad():
        assert torch.equal(out, plain(*args))
    ops.force("cuda")
    for a, g in zip(leaves, want):
        assert a.grad.dtype == a.dtype and a.grad.shape == a.shape
        assert _gap(_np(a.grad), g) <= TOL[dtype]
    assert {c: n for c, n in ops.launches.items() if n} == {
        op: 1, f"{op}_bwd": 1}


def test_conv_function_from_a_state_has_no_backward(plain_fused):
    """The conv from a state launches without a gradient (decode) and
    raises where one is needed; its in-place state through the kernel's
    wrapper equals the plain path's."""
    rng = _rng("conv_fn_state")
    (u, w, b), _ = _conv_inputs(rng, 2, 1, 16, 4, "float32")
    state = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(
        np.float32))
    held = state.clone()
    with torch.no_grad():
        got, new = ops.causal_conv(u, w, b, held)
    assert new is held
    want, want_new = ref.causal_conv_ref(u, w, b, state)
    assert torch.equal(got, want) and torch.equal(held, want_new)
    assert ops.launches["causal_conv"] == 1
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.causal_conv(u.requires_grad_(), w, b, state.clone())


# ---------------------------------------------------------- dispatch
def test_cpu_takes_the_plain_versions_and_forced_cuda_raises():
    rng = _rng("dispatch")
    x = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    x4 = x.reshape(1, 3, 2, 4)
    pos = torch.zeros((1, 3), dtype=torch.int32)
    w = torch.ones(8)
    u, cw, cb = x[None], torch.ones((4, 8)), torch.zeros(8)
    calls = {"rmsnorm": lambda: ops.rmsnorm(x, w, EPS),
             "rope": lambda: ops.rope(x4, pos, THETA),
             "causal_conv": lambda: ops.causal_conv(u, cw, cb)[0],
             "silu_gate": lambda: ops.silu_gate(x, x)}
    plain = {"rmsnorm": ref.rmsnorm_ref(x, w, EPS),
             "rope": ref.rope_ref(x4, pos, THETA),
             "causal_conv": ref.causal_conv_ref(u, cw, cb)[0],
             "silu_gate": ref.silu_gate_ref(x, x)}
    ops.reset_launches()
    for name, call in calls.items():
        assert torch.equal(call(), plain[name])
    assert not any(ops.launches[c] for c in ops.FUSED)
    ops.force("cuda")
    try:
        for call in calls.values():
            with pytest.raises(ValueError, match="CUDA"):
                call()
    finally:
        ops.force(None)


# ------------------------------------------------------------ meta path
def _meta(t: torch.Tensor, grad: bool = False) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype,
                       device="meta").requires_grad_(grad)


@pytest.mark.parametrize("dtype", DTYPES)
def test_meta_path_shapes_and_cost(dtype, monkeypatch):
    """Each op and its Function on meta tensors: the plain version's
    shapes and dtypes, gradients of the inputs' shapes, one forward and
    one backward call counted, the bytes of each bound, no launch, no
    plain version reached."""
    for name in ("rmsnorm_ref", "rope_ref", "causal_conv_ref",
                 "silu_gate_ref"):
        monkeypatch.setattr(ref, name, None)
    dt = getattr(torch, dtype)
    e = torch.empty((), dtype=dt).element_size()
    B, S, H, hd, D, di, K = 2, 70, 5, 64, 1600, 48, 4
    x = torch.empty((B, S, D), dtype=dt, device="meta")
    w = torch.empty((D,), device="meta")
    q = torch.empty((B, S, H, hd), dtype=dt, device="meta")
    pos = torch.empty((B, S), dtype=torch.int32, device="meta")
    u = torch.empty((B, S, di), dtype=dt, device="meta")
    cw = torch.empty((K, di), dtype=dt, device="meta")
    cb = torch.empty((di,), dtype=dt, device="meta")
    launches = dict(ops.launches)
    cases = [
        ("rmsnorm", lambda a, b: ops.rmsnorm(a, b, EPS), (x, w),
         2 * x.numel() * e + 4 * D, 3 * x.numel() * e + 8 * D),
        ("rope", lambda a: ops.rope(a, pos, THETA), (q,),
         2 * q.numel() * e + 4 * B * S + 2 * hd,
         2 * q.numel() * e + 4 * B * S + 2 * hd),
        ("causal_conv", lambda a, b, c: ops.causal_conv(a, b, c)[0],
         (u, cw, cb), 2 * u.numel() * e + B * (K - 1) * di * e
         + (K + 1) * di * e, 3 * u.numel() * e + 2 * (K + 1) * di * e),
        ("silu_gate", ops.silu_gate, (x, x), 3 * x.numel() * e,
         5 * x.numel() * e)]
    for name, call, args, fwd_B, bwd_B in cases:
        ops.reset_meta_cost()
        with torch.no_grad():
            out = call(*args)
        assert out.is_meta and out.dtype == args[0].dtype
        assert out.shape == args[0].shape
        assert ops.meta_cost == {"flops": 0.0, "bytes": fwd_B}
        ops.reset_meta_cost()
        leaves = [_meta(a, True) for a in args]
        out = call(*leaves)
        out.backward(torch.empty(out.shape, dtype=out.dtype, device="meta"))
        for a in leaves:
            assert a.grad.is_meta and a.grad.shape == a.shape
            assert a.grad.dtype == a.dtype
        assert {c: n for c, n in ops.meta_calls.items() if n} == {
            name: 1, f"{name}_bwd": 1}
        assert ops.meta_cost == {"flops": 0.0, "bytes": fwd_B + bwd_B}
    assert ops.launches == launches
    ops.reset_meta_cost()


# ---------------------------------------------------- the whole slice
def _fused_calls(cfg) -> dict:
    """One training step's fused kernel calls with remat "full" (each
    layer's forward twice, its backward once), the final norm once: each
    layer's norms (one before each sub-layer; MLA's q_ln and kv_ln), two
    ropes an attention layer, one conv a Mamba mixer, one gate an MLP, a
    mixer or an MoE layer's experts (one shard)."""
    n = {c: 0 for c in ops.FUSED}
    for seg in cfg.segments:
        L = seg.n_layers
        mamba = seg.kind in ("mamba", "hybrid")
        per = {"rmsnorm": 1 if seg.kind == "mamba" else 2,
               "rope": 2 if seg.attn in ("gqa", "mla")
               and seg.kind != "mamba" else 0,
               "causal_conv": int(mamba),
               "silu_gate": int(mamba) + int(seg.kind != "mamba")
               + int(seg.kind == "moe" and bool(cfg.n_shared_experts))}
        if seg.attn == "mla":
            per["rmsnorm"] += 2
        for c, k in per.items():
            n[c] += 2 * k * L
            n[f"{c}_bwd"] += k * L
    n["rmsnorm"] += 1
    n["rmsnorm_bwd"] += 1
    return n


def _plain_kernels(monkeypatch) -> None:
    """The attention, scan and grouped-matmul kernels' launches on their
    plain versions, as ``tests/test_torch_bwd_tc.py`` puts them."""
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
        return ref.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                     window=window, scale=scale, lse=lse,
                                     q_off=q_off)

    def gmm_launch(which, x, w, dy, C, fills, need_dx, need_dw):
        dx, dw = ref.grouped_matmul_aligned_bwd_ref(x, w, dy, C, fills)
        return dx if need_dx else None, dw if need_dw else None

    monkeypatch.setattr(fa, "flash_attention", forward)
    monkeypatch.setattr(fa, "_bwd_launch", attn_launch)
    monkeypatch.setattr(moe_gmm, "grouped_matmul",
                        lambda x, w, C, fills=None:
                        ref.grouped_matmul_aligned_ref(x, w, C, fills))
    monkeypatch.setattr(moe_gmm, "_bwd_launch", gmm_launch)
    monkeypatch.setattr(ms, "mamba_scan",
                        lambda u, dt, A, Bc, Cc, D, init_state=None:
                        ref.mamba_scan_ref(u, dt, A, Bc, Cc, D,
                                           init_state=init_state))
    monkeypatch.setattr(ms, "mamba_scan_bwd",
                        lambda u, dt, A, Bc, Cc, D, dy:
                        ref.mamba_scan_bwd_ref(u, dt, A, Bc, Cc, D, dy))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "olmoe-1b-7b",
                                  "hubert-xlarge"])
def test_slice_matches_jax(arch, monkeypatch):
    """Reduced f32 models, remat "full", every kernel's launch on its plain
    version under ``ops.force("cuda")``: the loss and every gradient leaf
    within 1e-5 of ``jax.grad`` of the JAX loss (olmoe under
    a one-device JAX mesh), the fused kernels' calls as ``_fused_calls``
    counts them."""
    # head dims the attention backward kernels take (hubert's own 80)
    kw = dict(dtype="float32", remat="full",
              head_dim=80 if arch == "hubert-xlarge" else 64)
    jcfg = jreduce_config(jget_config(arch)).with_(**kw)
    cfg = reduce_config(get_config(arch)).with_(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    B, S = 2, 16
    if cfg.frame_input:
        batch = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)}
    batch["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.n_experts:
        jsharding.set_active_mesh(jax.make_mesh(
            (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    try:
        jb = jax.tree.map(jnp.asarray, batch)
        jloss, _ = jax.jit(jm.loss)(params, jb)
        jgrads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(params, jb)
    finally:
        jsharding._ACTIVE_MESH = None
    want = model_state_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_jax(cfg, params), strict=True)
    model.requires_grad_(True)
    _plain_kernels(monkeypatch)
    _patch_plain_fused(monkeypatch)
    ops.force("cuda")
    ops.reset_launches()
    try:
        loss, _ = model.loss(batch_to(batch, "cpu"))
        loss.backward()
    finally:
        ops.force(None)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        if got[name].grad is None:    # unread by the loss: hubert's embed
            assert cfg.frame_input and name == "embed", name
            continue
        assert _gap(_np(got[name].grad), g.numpy()) <= 1e-5, name
    assert {c: ops.launches[c] for c in ops.FUSED} == _fused_calls(cfg)
    ops.reset_launches()
