"""The port's plain selective scan (``repro_torch.kernels.ref.mamba_scan_ref``)
against the JAX package's Pallas ``mamba_scan`` in interpret mode and
against its jnp reference with an initial state, on the same numpy inputs,
at the tolerances of ``tests/test_kernels.py``; and the plain version of
the scan's backward kernel, cut into segments, against ``jax.grad`` of the
jnp reference.  The CUDA kernels are held against these plain versions on
the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SHAPES_SCAN = [
    # (B, S, di, N, chunk), as tests/test_kernels.py; then N = 1 and N = 8,
    # and (a sixth entry True) large dt with the models' A, where the exps
    # of the larger states underflow
    (1, 8, 4, 2, 4),
    (2, 16, 8, 4, 8),
    (1, 32, 16, 4, 8),
    (2, 64, 8, 16, 16),
    (2, 16, 8, 1, 8),
    (1, 32, 16, 8, 8),
    (2, 32, 8, 16, 8, True),
]
_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _inputs(shape, dtype, seed):
    """u, dt, A, Bc, Cc, D as tests/test_kernels.py draws them, for JAX
    and (bit for bit) for torch; with ``shape[5]`` True, dt =
    softplus(normal) * 4 and the models' A = -(1, ..., N), so that
    exp(dt * A) reaches below 1e-38."""
    B, S, di, N = shape[:4]
    big_dt = len(shape) > 5 and shape[5]
    rng = np.random.default_rng(seed)

    def rand(s, dt):
        return jnp.asarray(rng.normal(size=s).astype(np.float32), dt)

    u = rand((B, S, di), dtype)
    if big_dt:
        x = rng.normal(size=(B, S, di)).astype(np.float32)
        dt = jnp.asarray(np.logaddexp(0, x).astype(np.float32) * 4, dtype)
        A = -jnp.broadcast_to(jnp.arange(1, N + 1, dtype=jnp.float32),
                              (di, N))
    else:
        dt = jnp.abs(rand((B, S, di), dtype)) * 0.1
        A = -jnp.abs(rand((di, N), jnp.float32)) - 0.1
    Bc = rand((B, S, N), dtype)
    Cc = rand((B, S, N), dtype)
    D = rand((di,), jnp.float32)
    jx = (u, dt, A, Bc, Cc, D)
    return jx, [_to_torch(a) for a in jx]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES_SCAN)
def test_mamba_scan_ref_matches_pallas_kernel(shape, dtype):
    jx, tx = _inputs(shape, getattr(jnp, dtype), abs(hash(shape)) % 2**31)
    y, last = mamba_scan(*jx, chunk=shape[4], interpret=True)
    ty, tlast = ref.mamba_scan_ref(*tx)
    assert ty.dtype == tx[0].dtype and tlast.dtype == torch.float32
    _close(ty, y, _TOL[dtype])
    _close(tlast, last, _TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 1, 8, 4), (1, 12, 16, 16),
                                   (2, 1, 8, 1), (1, 12, 16, 8),
                                   (2, 5, 8, 16, 0, True)])
def test_mamba_scan_ref_with_state_matches_reference(shape, dtype):
    """A decode step (S = 1) and a chunk, each from a given state; N = 1
    and 8, and large dt (``_inputs``)."""
    B, S, di, N = shape[:4]
    jx, tx = _inputs(shape, getattr(jnp, dtype), 7 + S)
    h0 = np.random.default_rng(S).normal(size=(B, di, N)).astype(np.float32)
    y, last = jref.mamba_scan_reference(*jx, init_state=jnp.asarray(h0))
    ops.reset_launches()
    ty, tlast = ops.mamba_scan(*tx, init_state=torch.from_numpy(h0))
    assert ops.launches["mamba_step"] == 0          # CPU: the plain version
    _close(ty, y, _TOL[dtype])
    _close(tlast, last, _TOL[dtype])


def test_scan_in_two_pieces_equals_one():
    """Carrying the last state into the next chunk is the whole scan: what
    the decode path relies on."""
    _, (u, dt, A, Bc, Cc, D) = _inputs((2, 20, 8, 4), jnp.float32, 3)
    y, last = ref.mamba_scan_ref(u, dt, A, Bc, Cc, D)
    y1, h1 = ref.mamba_scan_ref(u[:, :13], dt[:, :13], A, Bc[:, :13],
                                Cc[:, :13], D)
    y2, h2 = ref.mamba_scan_ref(u[:, 13:], dt[:, 13:], A, Bc[:, 13:],
                                Cc[:, 13:], D, init_state=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h2, last, rtol=1e-6, atol=1e-6)


def test_segmented_scan_bwd_ref_matches_jax_grad():
    """The scan backward's plain version, cut into segments as the kernel
    cuts it (segments of 24 steps, chunks of 16 inside, S not a multiple
    of either), against ``jax.grad`` of the JAX package's jnp reference:
    f32, A = -exp(A_log) as the model takes it, every gradient within 1e-5
    of its largest entry."""
    import jax
    B, S, di, N = 2, 61, 12, 16
    rng = np.random.default_rng(11)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)
    a_log = (np.log(np.arange(1, N + 1, dtype=np.float32))[None]
             + 0.1 * f32(di, N))
    ins = [f32(B, S, di), np.logaddexp(0, f32(B, S, di) - 1).astype(
        np.float32), -np.exp(a_log), f32(B, S, N), f32(B, S, N), f32(di)]
    dy = f32(B, S, di)

    def loss(*xs):
        return jnp.sum(jref.mamba_scan_reference(*xs)[0] * dy)
    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    got = ref.mamba_scan_bwd_ref(*map(torch.from_numpy, ins),
                                 torch.from_numpy(dy), chunk=16, segment=24)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
