"""Atomic checkpoints of a tree of tensors: the JAX package's
``checkpoint/checkpointer.py`` for the port's training state.

Layout:
    <dir>/step_000123.tmp/   -> written, then renamed to
    <dir>/step_000123/
        manifest.json        -- leaf paths, shapes, dtypes, ``extra``
        <leaf-hash>.npy      -- one file per leaf (the full tensor)

A tree is nested dicts (and lists) of tensors; a leaf's path joins its
keys with ``/``.  bfloat16 leaves are stored as their 16-bit patterns
(``uint16``), as the reference stores them, without ``ml_dtypes``.  The
rename makes a checkpoint visible atomically, so a writer cut short never
leaves a readable but corrupt step; the ``keep`` newest steps stay.
``save_async`` copies every tensor to the host before it returns -- the
optimizer updates the state in place, so a writer thread that read the
device tensors later would save a later step -- and writes the files on a
worker thread.  ``restore`` loads onto the device and dtype of each leaf
of a tree of the same structure.

Under a mesh the layout stays the same, one full tensor per leaf: given
the state's tree of ``parallel.sharding.Sharding`` (``shardings``), every
rank gathers each leaf whole and rank 0 writes it; ``restore`` cuts each
full leaf to this rank's block under the shardings it is given, which may
be another mesh's (an elastic restart).
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist


def _leaf_name(path: str) -> str:
    h = hashlib.sha1(path.encode()).hexdigest()[:16]
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", path)[-80:]
    return f"{safe}__{h}.npy"


def _flatten(tree, prefix: str = "") -> list:
    """[(path, tensor)] in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, sub in items:
        out.extend(_flatten(sub, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves, in order, from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later device updates do not reach."""
    t = t.detach()
    return t.to("cpu", copy=True) if t.is_cuda else t.clone()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread: threading.Thread | None = None

    def _write(self, step: int, host: list, extra: dict | None
               ) -> pathlib.Path:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for name, t in host:
            fn = _leaf_name(name)
            np.save(tmp / fn, _to_numpy(t))
            manifest["leaves"].append(
                {"path": name, "file": fn, "shape": list(t.shape),
                 "dtype": str(t.dtype).removeprefix("torch.")})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        tmp.rename(final)  # atomic publish
        self._gc()
        return final

    @staticmethod
    def _host_leaves(tree, shardings) -> list | None:
        """[(path, host copy of the full leaf)], or None on a rank that
        does not write (every rank takes part in the gathers)."""
        if shardings is None:
            return [(n, _to_host(t)) for n, t in _flatten(tree)]
        by_path = dict(_flatten(shardings))
        out = []
        for n, t in _flatten(tree):
            sh = by_path[n]
            full = t if sh is None else sh.full(t.detach())
            out.append((n, _to_host(full)))
        return out if dist.get_rank() == 0 else None

    def save(self, step: int, tree, extra: dict | None = None,
             shardings=None) -> pathlib.Path | None:
        """Write step ``step`` (under a mesh: rank 0, the leaves gathered
        by ``shardings``, a tree like ``tree``)."""
        self.wait()
        host = self._host_leaves(tree, shardings)
        return None if host is None else self._write(step, host, extra)

    def save_async(self, step: int, tree, extra: dict | None = None,
                   shardings=None) -> None:
        """Copy every leaf to the host now (gathered, under a mesh), write
        the files on a worker thread (``wait`` joins it)."""
        self.wait()
        host = self._host_leaves(tree, shardings)
        if host is None:
            return
        self._async_thread = threading.Thread(
            target=self._write, args=(step, host, extra), daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def latest_step(self) -> int | None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        return steps[-1] if steps else None

    def restore(self, step: int, like, shardings=None):
        """Load step ``step`` into the structure of ``like`` (a tree of
        tensors), each leaf on its ``like`` leaf's device and dtype, cut to
        this rank's block where ``shardings`` (a tree like ``like``) has
        one; returns (tree, extra)."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        shs = dict(_flatten(shardings)) if shardings is not None else {}
        out = []
        for name, ref in _flatten(like):
            meta = by_path[name]
            t = _from_numpy(np.load(d / meta["file"]), meta["dtype"])
            sh = shs.get(name)
            if sh is not None:
                t = sh.local(t)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)}"
                                 f" != {tuple(ref.shape)}")
            out.append(t.to(device=ref.device, dtype=ref.dtype))
        return _unflatten(like, iter(out)), manifest["extra"]

    def _gc(self) -> None:
        steps = sorted((int(p.name.split("_")[1]), p)
                       for p in self.dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for _, p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
