"""PyTorch/CUDA port of the replicated partitioning system.

Layout and names follow the JAX package ``repro``: each module sits at the
same path as its counterpart there.  The port imports ``torch`` and numpy
only.  Its kernels are hand-written CUDA for Hopper (``kernels/csrc``),
built with ``nvcc`` at first use; on CPU tensors each kernel's wrapper runs
its plain PyTorch version instead.
"""
