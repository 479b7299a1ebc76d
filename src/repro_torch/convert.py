"""Carry the JAX package's state across to the port.

This system's "weights" are its instances: a hypergraph's CSR arrays and
weights.  Partitions need no conversion: both packages take them as int64
numpy arrays of processor-subset masks (bit p set = a replica on
processor p).
"""
from __future__ import annotations

import numpy as np

from .core.hypergraph import Hypergraph


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

