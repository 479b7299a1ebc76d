"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the device-resident pass on CUDA against the host path.

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
from repro_torch.kernels import front_pass, gain, ops, ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _pc(P):
    _, _, order_pc, _ = _tables(P)
    return np.concatenate(([gain._NO_COVER], order_pc)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("P,R", [(4, 2048), (8, 2048 * 9 + 5), (2, 1)])
def test_kernels_match_plain_versions(cuda, P, R):
    rng = np.random.default_rng(300 + P)
    M = 1 << P
    rows = (rng.random((R, M)) > 0.1).astype(np.int32) * rng.integers(
        1, 4, size=(R, M)).astype(np.int32)
    rows[::7] = 1                                  # no zero: the sentinel
    rows_t = torch.from_numpy(rows).to(cuda)
    pc_t = torch.from_numpy(_pc(P)).to(cuda)
    lam_old = torch.from_numpy(
        rng.integers(0, P + 2, size=R).astype(np.int32)).to(cuda)
    ops.reset_launches()
    lam = gain.min_cover(rows_t, pc_t)
    dl = gain.front_dlam(rows_t, pc_t, lam_old)
    torch.cuda.synchronize()
    assert ops.launches == {"front_dlam": 1, "min_cover_lambdas": 1,
                            "min_cover_apply": 0}
    assert torch.equal(lam, ref.min_cover_ref(rows_t, pc_t))
    assert torch.equal(dl, ref.front_dlam_ref(rows_t, pc_t, lam_old))
    assert bool((lam[::7] == gain._NO_COVER).all())


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
    hg = large_row_net(1024, seed=1024)
    ops.reset_launches()
    a = th.partition_with_replication(hg, 4, 0.05, frontier="torch",
                                      device=cuda)
    assert ops.launches["front_dlam"] > 0
    assert ops.launches["min_cover_apply"] > 0
    b = th.partition_with_replication(hg, 4, 0.05, frontier="numpy")
    for ra, rb in zip(a, b):
        assert np.array_equal(ra.masks, rb.masks) and ra.cost == rb.cost
