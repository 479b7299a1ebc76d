"""Meshes of ranks: the JAX package's ``launch/mesh.py``.

Single pod: 16x16 = 256 ranks ('data', 'model').  Across pods:
2x16x16 = 512 ranks ('pod', 'data', 'model'); the 'pod' axis carries only
data parallelism (the gradient all-reduce), as multi-pod training is
deployed.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, one process per rank.  ``init_distributed`` starts that
group over ``tcp://127.0.0.1:<port>`` with an explicit transport
(``backend``: ``"nccl"`` or ``"gloo"``; gloo takes CUDA tensors too, which
lets several ranks share one card, as NCCL does not); ``run_ranks`` spawns
the processes of a world and collects what each returns.  These are
functions, so importing this module starts nothing.
"""
from __future__ import annotations

import math
import pickle
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device: str | torch.device, world_size: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed(rank: int, world_size: int, *, backend: str,
                     port: int, device: str | torch.device = "cuda") -> None:
    """Start the default process group of rank ``rank``.  On a CUDA device
    the rank takes card ``rank % device_count`` first, so ranks beyond the
    cards share them."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a rank on 'cuda', but no CUDA device is "
                               "available; pass device='cpu'")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world_size)


def make_mesh(shape: tuple, axes: tuple, *,
              device: str | torch.device = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group, whose size must be the mesh's."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on 'cuda', but no CUDA device is "
                           "available; pass device='cpu'")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group started first "
                           "(launch.mesh.init_distributed, or torchrun)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda"):
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data', 'model')
    across pods; raises unless the process group has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model_axis: int = 1, *,
                   device: str | torch.device = "cuda"):
    """A ('data', 'model') mesh over every rank of the process group, the
    model axis ``model_axis`` wide (at most the world)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model_axis = min(model_axis, n)
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     device=device)


def _rank_main(rank, world_size, port, backend, device, fn, args, out):
    try:
        init_distributed(rank, world_size, backend=backend, port=port,
                         device=device)
        # pickled here: a tensor put on the queue as it is would be shared
        # through a file descriptor that dies with this process
        out.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, backend: str = "gloo",
              device: str = "cpu", timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes, one
    per rank of a fresh process group over ``backend``, and return their
    results in rank order.  ``fn`` and its results must pickle.  Raises
    with every failing rank's traceback, or ``TimeoutError`` (the
    processes killed) when they have not all returned in ``timeout``
    seconds."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, port, backend, device, fn, args, out), daemon=True)
        for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            try:
                rank, ok, res = out.get(timeout=max(left, 0.01))
            except queue_mod.Empty:
                raise TimeoutError(
                    f"{world_size} ranks over {backend}: "
                    f"{world_size - len(got)} had not returned after "
                    f"{timeout:.0f} s") from None
            got[rank] = (ok, res)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [f"rank {r}:\n{res}" for r, (ok, res) in sorted(got.items())
           if not ok]
    if bad:
        raise RuntimeError("\n".join(bad))
    return [pickle.loads(got[r][1]) for r in range(world_size)]
