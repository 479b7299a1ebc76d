"""The port's gain kernels (``repro_torch.kernels.gain``) against the JAX
package's Pallas kernels, run in interpret mode on the same numpy inputs.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
comparison is exact equality (every value is a small integer).  The CUDA
kernels are held against those plain versions in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs tiny ops here: extra threads per pytest worker only contend
torch.set_num_threads(1)
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.partition.engine import _tables  # noqa: E402
from repro.kernels import gain as jgain  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import gain, ops, ref  # noqa: E402


def _popcount_order(P):
    """The engine's popcount-ordered subsets and popcounts, then the
    column map with the empty subset first and the popcounts with the
    no-cover sentinel at column 0."""
    _, order, order_pc, _ = _tables(P)
    colmap = np.concatenate(([0], order)).astype(np.int64)
    pc = np.concatenate(([gain._NO_COVER], order_pc)).astype(np.int32)
    return order, order_pc, colmap, pc


def _rows(rng, R, M):
    """Uncov-like rows: mostly positive, a zero here and there, plus rows
    with no zero at all (lambda = sentinel) and rows with column 0 zero
    (no assigned pin)."""
    rows = (rng.random((R, M)) > 0.08).astype(np.int32) * rng.integers(
        1, 4, size=(R, M)).astype(np.int32)
    rows[3::11] = 0                                            # no pin
    rows[5::13, 0] = 0
    rows[::7] = rng.integers(1, 3, size=(len(rows[::7]), M))   # all nonzero
    return rows


@pytest.mark.parametrize("P,R", [(4, 512), (8, 1024), (3, 512)])
def test_front_dlam_matches_pallas(P, R):
    rng = np.random.default_rng(100 + P)
    M = 1 << P
    _, _, _, pc = _popcount_order(P)
    rows = _rows(rng, R, M)
    lam_old = rng.integers(0, P + 2, size=R).astype(np.int32)
    # the Pallas kernel takes columns padded to 128 lanes: pad with a
    # non-zero row value and the sentinel popcount, which never win the min
    Mp = -(-M // 128) * 128
    rows_p = np.ones((R, Mp), dtype=np.int32)
    rows_p[:, :M] = rows
    pc_p = np.full(Mp, gain._NO_COVER, dtype=np.int32)
    pc_p[:M] = pc
    want = np.asarray(jgain.front_dlam(jnp.asarray(rows_p), jnp.asarray(pc_p),
                                       jnp.asarray(lam_old), interpret=True))
    got = gain.front_dlam(torch.from_numpy(rows), torch.from_numpy(pc),
                          torch.from_numpy(lam_old))
    assert got.dtype == torch.int32 and got.shape == (R,)
    assert np.array_equal(got.numpy(), want)
    # all-nonzero rows price lambda at the sentinel
    lam = ref.min_cover_ref(torch.from_numpy(rows), torch.from_numpy(pc))
    assert np.all(lam.numpy()[::7] == gain._NO_COVER)


@pytest.mark.parametrize("P,R", [(4, 700), (8, 4100), (6, 1)])
def test_min_cover_lambdas_matches_pallas(P, R):
    rng = np.random.default_rng(200 + P)
    order, order_pc, _, _ = _popcount_order(P)
    rows = _rows(rng, R, 1 << P)
    jops.force("pallas")
    try:
        want = jgain.min_cover_lambdas(rows, order, order_pc, interpret=True)
    finally:
        jops.force(None)
    got = gain.min_cover_lambdas(rows, order, order_pc, device="cpu")
    assert got.dtype == want.dtype == np.int16
    assert np.array_equal(got, want)
    assert np.all(got[rows[:, 0] == 0] == 0)      # no assigned pin: 0


def test_min_cover_lambdas_empty_front():
    order, order_pc, _, _ = _popcount_order(4)
    got = gain.min_cover_lambdas(np.zeros((0, 16), dtype=np.int64), order,
                                 order_pc, device="cpu")
    assert got.shape == (0,) and got.dtype == np.int16


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    rng = np.random.default_rng(3)
    _, _, _, pc = _popcount_order(4)
    rows = torch.from_numpy(_rows(rng, 64, 16))
    ops.reset_launches()
    gain.min_cover(rows, torch.from_numpy(pc))
    assert "min_cover_lambdas" in ops.launches
    assert not any(ops.launches.values())


def test_forced_kernel_rejects_cpu_tensors():
    """``force("cuda")`` sends every call to the kernel's wrapper, whose
    checks refuse a CPU tensor: no quiet fallback to the plain version."""
    _, _, _, pc = _popcount_order(4)
    rows = torch.ones((8, 16), dtype=torch.int32)
    ops.force("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensor"):
            gain.front_dlam(rows, torch.from_numpy(pc),
                            torch.zeros(8, dtype=torch.int32))
    finally:
        ops.force(None)
    with pytest.raises(ValueError):
        ops.force("pallas")
