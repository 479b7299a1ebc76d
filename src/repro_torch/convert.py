"""Carry the JAX package's state across to the port.

The partitioner's and the scheduler's "weights" are their instances: a
hypergraph's CSR arrays and weights, a DAG's edge arrays and weights.  Partitions need no conversion: both packages take them as
int64 numpy arrays of processor-subset masks (bit p set = a replica on
processor p).  The serving model's weights are a JAX parameter pytree,
handed over with numpy leaves (``model_state_from_jax``); a training
state adds the JAX package's AdamW state (``train_state_from_jax``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.hypergraph import Dag, Hypergraph
from .models.config import ModelConfig


def hypergraph_from_arrays(n: int, xpins, pins, omega, mu,
                           name: str | None = None) -> Hypergraph:
    """The port's ``Hypergraph`` from CSR arrays (``xpins``/``pins`` as
    the reference's ``Hypergraph.xpins``/``.pins`` give them: each edge's
    pins sorted and distinct) and the node/edge weights ``omega``/``mu``.

    The arrays are copied, so the two packages never share a buffer.
    """
    xpins = np.array(xpins, dtype=np.int64)
    pins = np.array(pins, dtype=np.int64)
    omega = np.array(omega, dtype=np.float64)
    mu = np.array(mu, dtype=np.float64)
    m = len(xpins) - 1
    if m < 0 or xpins[0] != 0 or xpins[-1] != len(pins) \
            or np.any(np.diff(xpins) < 0):
        raise ValueError("xpins is not a CSR offset array over pins")
    if omega.shape != (n,) or mu.shape != (m,):
        raise ValueError(f"omega must be ({n},) and mu ({m},), got "
                         f"{omega.shape} and {mu.shape}")
    if len(pins) and (pins.min() < 0 or pins.max() >= n):
        raise ValueError("pin id out of range")
    # within an edge, pins strictly ascend (sorted and distinct)
    step = np.diff(pins)
    inner = np.ones(len(step), dtype=bool)
    inner[xpins[1:-1][(xpins[1:-1] > 0) & (xpins[1:-1] < len(pins))] - 1] = False
    if np.any(step[inner] <= 0):
        raise ValueError("an edge's pins are not sorted and distinct")
    return Hypergraph.from_csr(n, xpins, pins, omega=omega, mu=mu,
                               name=name or "hypergraph")


def dag_from_arrays(n: int, src, dst, omega, mu,
                    name: str | None = None) -> Dag:
    """The port's ``Dag`` from flat edge arrays (``src``/``dst`` as the
    reference's ``Dag.edge_src``/``.edge_dst`` give them) and the node
    weights ``omega``/``mu``.  Edges are range-checked and deduplicated
    by ``Dag.from_arrays``; the arrays are copied, so the two packages
    never share a buffer.  Raises on a cycle."""
    omega = np.array(omega, dtype=np.float64)
    mu = np.array(mu, dtype=np.float64)
    if omega.shape != (n,) or mu.shape != (n,):
        raise ValueError(f"omega and mu must be ({n},), got {omega.shape} "
                         f"and {mu.shape}")
    dag = Dag.from_arrays(n, np.array(src, dtype=np.int64),
                          np.array(dst, dtype=np.int64), omega=omega, mu=mu,
                          name=name or "dag")
    dag.topo_order()   # raises ValueError on a directed cycle
    return dag


def _tensor(a) -> torch.Tensor:
    """A copy of numpy array ``a`` as a tensor.  A bfloat16 array (the
    ``ml_dtypes`` dtype that ``np.asarray`` gives a JAX bf16 array, which
    ``torch.from_numpy`` refuses) goes through its bits, so it is exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaves(tree: dict, prefix: str = ""):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", sub


def model_state_from_jax(cfg: ModelConfig, params: dict) -> dict:
    """A state dict for ``models.model.Model(cfg)`` from the JAX package's
    ``Model(cfg).init`` pytree with numpy leaves.

    Each segment's stacked ``(n_layers, ...)`` leaves are cut into one
    tensor per layer (``segments.<i>.<j>.<path>``), MLA's weights and a
    vision group's ``cross`` leaves among them; a vision group's ``self``
    leaves, ``(n_layers, sub_layers - 1, ...)``, are cut on both axes into
    ``segments.<i>.<j>.self.<k>.<path>``.  Each multi-token prediction
    depth d (the ``mtp`` list) becomes ``mtp.<d>.<path>``, its one-layer
    ``block`` unstacked.  Dtypes are kept, and
    ``Model.load_state_dict(..., strict=True)`` takes the result."""
    state = {name: _tensor(params[name])
             for name in ("embed", "final_ln", "lm_head") if name in params}
    if len(params["segments"]) != len(cfg.segments):
        raise ValueError(f"{len(params['segments'])} parameter segments for "
                         f"{len(cfg.segments)} config segments")
    for i, (seg, sp) in enumerate(zip(cfg.segments, params["segments"])):
        for path, leaf in _leaves(sp):
            arr = np.asarray(leaf)
            sub = (seg.kind == "vision_group" and path.startswith("self."))
            lead = (seg.n_layers,) + ((seg.sub_layers - 1,) if sub else ())
            if arr.shape[:len(lead)] != lead:
                want = ", ".join(map(str, lead))
                raise ValueError(f"segments[{i}].{path} has shape "
                                 f"{arr.shape}, not ({want}, ...)")
            for j in range(seg.n_layers):
                if not sub:
                    state[f"segments.{i}.{j}.{path}"] = _tensor(arr[j])
                    continue
                rest = path.removeprefix("self.")
                for k in range(lead[1]):
                    state[f"segments.{i}.{j}.self.{k}.{rest}"] = \
                        _tensor(arr[j, k])
    mtp = params.get("mtp", [])
    if len(mtp) != cfg.mtp_depth:
        raise ValueError(f"{len(mtp)} mtp depths for mtp_depth "
                         f"{cfg.mtp_depth}")
    for d, mp in enumerate(mtp):
        for path, leaf in _leaves(mp):
            arr = np.asarray(leaf)
            if path.startswith("block."):
                if arr.shape[:1] != (1,):
                    raise ValueError(f"mtp[{d}].{path} has shape "
                                     f"{arr.shape}, not (1, ...)")
                arr = arr[0]
            state[f"mtp.{d}.{path}"] = _tensor(arr)
    return state


def train_state_from_jax(cfg: ModelConfig, params: dict, opt_state: dict,
                         device: str | torch.device = "cpu") -> dict:
    """A training state for ``train.step`` from the JAX package's
    parameters and its ``optim.adamw`` state (step, master, m, v), all
    with numpy leaves: ``{"params": ..., "opt": {"step", "master", "m",
    "v"}}``, each tree keyed like ``Model(cfg).named_parameters()``
    (``model_state_from_jax``), dtypes kept, on ``device``.  A JAX run
    continues in the port from its step."""
    def tree(t):
        return {n: x.to(device) for n, x in model_state_from_jax(cfg,
                                                                 t).items()}
    return {"params": tree(params),
            "opt": {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                         dtype=torch.int32, device=device),
                    **{k: tree(opt_state[k]) for k in ("master", "m", "v")}}}
