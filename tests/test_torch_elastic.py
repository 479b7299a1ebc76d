"""Elastic re-scaling in the port: a checkpoint written under one mesh
restores under another (other rank count, other axis split), and training
goes on as if it had not stopped.  Mirrors ``tests/test_elastic.py``: the
writer trains 4 steps and checkpoints, each resume restores and trains to
step 8.  The resumed losses are held within 1e-5 (relative) of an
uninterrupted run on one device without a mesh, in f32 (in bf16 each
rank's gradient rounds before the ranks' sum, so the meshes part by bf16
rounding).

Each world is spawned over gloo on 127.0.0.1 (``launch.mesh.run_ranks``)
with a join timeout that fails the test when it expires.  smollm-135m is
the reference test's model (its ``dp_seq`` strategy keeps its parameters
whole on every rank); reduced olmoe (strategy ``tp``: experts over the
model axis, capacity factor 8 so that no mesh drops a choice) goes from
(1, 2) to (2, 1) and (1, 1), as the card's phase 18c does at full width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

TIMEOUT = 120
CASES = {"smollm-135m": ((2, 2), [(4, 1), (1, 1)]),
         "olmoe-1b-7b": ((1, 2), [(2, 1), (1, 1)])}


def _cfg(arch: str):
    cfg = reduce_config(get_config(arch), layers_per_segment=1).with_(
        dtype="float32")
    if arch == "olmoe-1b-7b":
        cfg = cfg.with_(strategy="tp")
    return cfg


def _trainer(arch: str, steps: int, ckpt_dir: str, mesh=None) -> Trainer:
    return Trainer(_cfg(arch), DataConfig(8, 16),
                   TrainerConfig(steps=steps, ckpt_every=4,
                                 ckpt_dir=ckpt_dir, log_every=100),
                   adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=8),
                   device="cpu", mesh=mesh, capacity_factor=8.0)


def _rank(rank, arch, shape, steps, ckpt_dir):
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    _, hist = _trainer(arch, steps, ckpt_dir, mesh).run()
    return [(h["step"], h["loss"]) for h in hist]


@pytest.fixture(scope="module", params=list(CASES))
def elastic(request, tmp_path_factory):
    arch = request.param
    write, resumes = CASES[arch]
    torch.set_num_threads(1)
    _, whole = _trainer(arch, 8, str(tmp_path_factory.mktemp("whole"))).run()
    runs = {}
    for shape in resumes:
        ckpt = str(tmp_path_factory.mktemp("ckpt"))
        w = run_ranks(_rank, write[0] * write[1], arch, write, 4, ckpt,
                      timeout=TIMEOUT)
        r = run_ranks(_rank, shape[0] * shape[1], arch, shape, 8, ckpt,
                      timeout=TIMEOUT)
        runs[shape] = (w, r)
    return arch, [(h["step"], h["loss"]) for h in whole], runs


def test_writer_trains_from_step_0(elastic):
    arch, whole, runs = elastic
    for w, _ in runs.values():
        for hist in w:       # every rank of the writer's mesh
            assert [s for s, _ in hist] == [0, 1, 2, 3]
            np.testing.assert_allclose([x for _, x in hist],
                                       [x for _, x in whole[:4]],
                                       rtol=1e-5)


@pytest.mark.parametrize("which", [0, 1])
def test_resume_under_another_mesh(elastic, which):
    arch, whole, runs = elastic
    shape = CASES[arch][1][which]
    _, r = runs[shape]
    assert len(r) == shape[0] * shape[1]
    for hist in r:
        assert [s for s, _ in hist] == [4, 5, 6, 7]   # resumed, not restarted
        np.testing.assert_allclose([x for _, x in hist],
                                   [x for _, x in whole[4:]], rtol=1e-5)
