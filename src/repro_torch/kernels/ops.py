"""Kernel dispatch by the device of the input tensor, and launch counts.

A CUDA tensor goes to the hand-written kernel and a CPU tensor to the
plain PyTorch version (``ref``); there is no fallback from one to the
other.  ``force`` overrides the choice for tests only: ``"cuda"`` sends
every call to the kernel (a CPU tensor then raises), ``"ref"`` every call
to the plain version.

``launches`` counts, per kernel, the launches its wrapper made; a run sets
the counts to 0 with ``reset_launches`` and reads them afterwards to show
which kernels its path went through.  A CUDA graph's replay runs no
wrapper: ``Captured``, which records the port's captured steps
(``launch.serve.GreedyStep``, ``train.step.TrainStep``), takes back the
launches counted while recording and books them once a replay
(``launch_counts``, ``launch_delta``, ``set_launch_counts``,
``add_launch_counts``).
``front_find`` counts the device pass's finds (``front_find.cu``, the
queued applies folded in) and
``front_apply`` that kernel's launches that only apply the queue
(``DevicePartitionPass.flush``, off the partitioning path);
``min_cover_lambdas`` the min-cover kernel's, which price a front.  A
kernel that also serves calls the JAX package sends to its jnp reference
counts those apart: ``attention_masked`` the attention kernel's launches with a window or
explicit positions, ``flash_attention`` the plain (causal) ones;
``mamba_step`` the scan's launches from a given state (decode),
``mamba_scan`` those from zeros; ``grouped_matmul`` the expert-FFN
products.  ``route_launches`` counts the attention calls again by the
kernel that took them (``flash_attention.route``), ``gmm_route_launches``
the grouped products by theirs (``moe_gmm.route``); ``reset_launches``
zeroes these and ``bwd_route_launches`` below.  ``attention_bwd`` and
``mamba_scan_bwd`` count the launches of the attention and scan backward
kernels (the training path's gradients), ``grouped_matmul_bwd`` the
grouped matmul's backward calls (one per call, whichever of its two
products it launches); ``bwd_route_launches`` counts the attention and
grouped-matmul backward calls again by the route that took them
(``flash_attention.bwd_route``, ``moe_gmm.bwd_route``):
``attention_tc``/``gmm_tc`` the bf16 wgmma kernels,
``attention_general``/``gmm_general`` the f32 ones.  ``adamw`` counts
the fused optimizer update's launches (``kernels.adamw``, one a leaf a
step), a kernel with no TPU counterpart.  ``rmsnorm``, ``rope``,
``causal_conv`` and ``silu_gate`` count the layers' fused elementwise
kernels (``kernels.fused``: XLA's fusions of the JAX package's jnp, no
TPU counterpart either), ``rmsnorm_bwd``, ``rope_bwd``,
``causal_conv_bwd`` and ``silu_gate_bwd`` their backward kernels.

``attention``, ``mamba_scan`` and ``grouped_matmul_aligned`` are the
model's entry points to the three model kernels, with the signatures of
the JAX package's ``ops``; ``grouped_matmul`` (ragged groups) is always
the plain version, as there.  ``rmsnorm``, ``rope``, ``causal_conv`` and
``silu_gate`` are the layers' entry points to the fused elementwise
kernels, with the signatures of the JAX package's layer functions.

Gradients: a kernel call that needs one (grad mode on and an input that
requires grad) goes through the autograd Function of its kernel, whose
backward is a kernel too: attention without explicit positions
(``flash_attention.attention_train``), the scan from zeros
(``mamba_scan.mamba_scan_train``), the block-aligned grouped matmul
(``moe_gmm.grouped_matmul_train``) and the four fused elementwise ops
(``fused.*_train``; the conv from zeros).  Every other kernel call that
needs a gradient raises (``no_backward``) before its inputs are checked: its
launcher writes outputs that autograd cannot see, which would silently
send no gradient into its inputs.  The plain versions are differentiated
by autograd as they stand.

The meta device (``launch/dryrun.py``): a meta tensor takes the kernel
path -- its wrapper, and each autograd Function's forward and backward --
which checks the shapes, allocates on the meta device exactly the outputs,
saved tensors and scratch that the CUDA launcher would, and launches
nothing.  Instead of a launch count each such call adds one to
``meta_calls`` under its counter's name and the FLOPs and bytes of its
kernel's bound (the formulas of PERF.md's kernel table: ``attention_cost``,
``scan_cost``, ``gmm_cost``, ``fused``'s ``*_cost`` in the kernels'
modules) to ``meta_cost``;
``reset_meta_cost`` zeroes both.  A meta tensor never reaches a plain
version, a CUDA tensor never reaches one either, a CPU tensor always does,
and a tensor on any other device raises.
"""
from __future__ import annotations

import torch

from . import ref

_FORCE: str | None = None  # None = by device, 'cuda' | 'ref'
# the fused elementwise kernels' counters: each forward, then its backward
FUSED = ("rmsnorm", "rmsnorm_bwd", "rope", "rope_bwd", "causal_conv",
         "causal_conv_bwd", "silu_gate", "silu_gate_bwd")

launches: dict[str, int] = {"front_find": 0, "front_apply": 0,
                             "min_cover_lambdas": 0, "flash_attention": 0,
                             "attention_masked": 0, "mamba_scan": 0,
                             "mamba_step": 0, "grouped_matmul": 0,
                             "attention_bwd": 0, "mamba_scan_bwd": 0,
                             "grouped_matmul_bwd": 0, "adamw": 0,
                             **{name: 0 for name in FUSED}}
route_launches: dict[str, int] = {"decode_split": 0, "prefill_tc": 0,
                                  "general": 0}
gmm_route_launches: dict[str, int] = {"gmv": 0, "gmm_tc": 0, "general": 0}
bwd_route_launches: dict[str, int] = {"attention_tc": 0,
                                      "attention_general": 0, "gmm_tc": 0,
                                      "gmm_general": 0}


# the dry run's counts of the kernel calls made on meta tensors
meta_calls: dict[str, int] = {name: 0 for name in (
    "flash_attention", "attention_masked", "mamba_scan", "mamba_step",
    "grouped_matmul", "attention_bwd", "mamba_scan_bwd",
    "grouped_matmul_bwd", "adamw") + FUSED}
meta_cost: dict[str, float] = {"flops": 0.0, "bytes": 0.0}


def force(which: str | None) -> None:
    if which not in (None, "cuda", "ref"):
        raise ValueError(f"force({which!r}): expected None, 'cuda' or 'ref'")
    global _FORCE
    _FORCE = which


def use_kernel(t: torch.Tensor) -> bool:
    """The kernel path for a CUDA or meta tensor, the plain version for a
    CPU one (``force`` aside); raises for any other device."""
    if _FORCE is not None:
        return _FORCE == "cuda"
    if t.is_cuda or t.is_meta:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version takes a tensor on "
                     f"{t.device}")


def add_meta_cost(name: str, flops: float, nbytes: float) -> None:
    """Count one kernel call ``name`` made on meta tensors, and its
    FLOPs and bytes."""
    meta_calls[name] += 1
    meta_cost["flops"] += flops
    meta_cost["bytes"] += nbytes


def reset_meta_cost() -> None:
    for name in meta_calls:
        meta_calls[name] = 0
    meta_cost.update(flops=0.0, bytes=0.0)


# every launch counter: ``launches`` and the route tables
_COUNTERS = (launches, route_launches, gmm_route_launches,
             bwd_route_launches)


def reset_launches() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


def launch_counts() -> tuple:
    """A copy of every launch counter, in ``_COUNTERS``' order."""
    return tuple(dict(counts) for counts in _COUNTERS)


def launch_delta(before: tuple) -> tuple:
    """The launches counted since ``before`` (a ``launch_counts``)."""
    return tuple({name: counts[name] - was[name] for name in counts}
                 for counts, was in zip(_COUNTERS, before))


def set_launch_counts(counts: tuple) -> None:
    """Set every launch counter to ``counts`` (a ``launch_counts``)."""
    for mine, saved in zip(_COUNTERS, counts):
        mine.update(saved)


def add_launch_counts(delta: tuple, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a ``launch_delta``) to the counters."""
    for mine, more in zip(_COUNTERS, delta):
        for name, n in more.items():
            mine[name] += times * n


class Captured:
    """A step recorded in a ``torch.cuda.CUDAGraph`` on a side stream of
    its own (``device``'s).  ``warm(fn)`` runs ``fn`` eagerly on that
    stream, so that every lazy set-up (the kernels' builds, cuBLAS's
    workspaces, cached tables) is done before the capture; ``record(fn)``
    records ``fn`` without running it and returns what it returned (the
    graph's static outputs), takes back the launches counted meanwhile and
    leaves the bytes the allocator reserved for the graph's private pool in
    ``pool_B``; a call replays the graph and books those launches once.  A
    capture that fails raises."""

    def __init__(self, device) -> None:
        self.stream = torch.cuda.Stream(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.pool_B: int | None = None
        self._launches: tuple | None = None

    def warm(self, fn):
        here = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = fn()
        here.wait_stream(self.stream)
        return out

    def record(self, fn):
        dev = self.stream.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()      # the eager steps' cache, for the pool
        reserved = torch.cuda.memory_reserved(dev)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            out = fn()
        torch.cuda.synchronize(dev)
        self.pool_B = torch.cuda.memory_reserved(dev) - reserved
        self._launches = launch_delta(before)
        set_launch_counts(before)
        self.graph = graph
        return out

    def __call__(self) -> None:
        self.graph.replay()
        add_launch_counts(self._launches)


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of ``tensors`` (None skipped) requires
    grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_backward(name: str, *tensors) -> None:
    """Raise where a call of kernel ``name`` would need a gradient: it has
    no backward kernel."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: no backward kernel for this call, and an input "
            f"requires grad; run it under torch.no_grad(), or on the plain "
            f"versions (CPU tensors, or ops.force('ref'))")


def check(name: str, t: torch.Tensor, shape: tuple, dtypes, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` with
    one of ``dtypes`` and the given shape: what a kernel's launcher takes
    (or a meta tensor, where ``device`` is the meta device)."""
    if not (t.is_cuda or t.is_meta) or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{name} must be {names}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              q_pos: torch.Tensor | None = None,
              k_pos: torch.Tensor | None = None,
              scale: float | None = None, q_off: int = 0) -> torch.Tensor:
    """GQA attention, (B, Sq, H, hd) x (B, Sk, KV, hd[_v]) -> (B, Sq, H,
    hd_v): the CUDA kernel for a CUDA (or meta) ``q``, else
    ``ref.attention_ref``;
    where a gradient is needed, the kernel's autograd Function.  Without
    ``q_pos`` the queries sit at ``q_off`` (>= 0) on, the keys at 0 on."""
    kw = dict(causal=causal, window=window, q_pos=q_pos, k_pos=k_pos,
              scale=scale, q_off=q_off)
    if use_kernel(q):
        from . import flash_attention as fa  # imports ops
        if needs_grad(q, k, v):
            return fa.attention_train(q, k, v, **kw)
        return fa.flash_attention(q, k, v, **kw)
    return ref.attention_ref(q, k, v, **kw)


def mamba_scan(u, dt, A, Bc, Cc, D, init_state=None):
    """Mamba-1 selective scan -> (y, last state): the CUDA kernel for a
    CUDA (or meta) ``u``, else ``ref.mamba_scan_ref``; where a gradient
    is needed (from zeros only), the kernel's autograd Function."""
    if use_kernel(u):
        from . import mamba_scan as ms  # imports ops
        if needs_grad(u, dt, A, Bc, Cc, D, init_state):
            if init_state is not None:
                no_backward("mamba_scan from a state", u, dt, A, Bc, Cc, D,
                            init_state)
            return ms.mamba_scan_train(u, dt, A, Bc, Cc, D)
        return ms.mamba_scan(u, dt, A, Bc, Cc, D, init_state=init_state)
    return ref.mamba_scan_ref(u, dt, A, Bc, Cc, D, init_state=init_state)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Ragged groups: always ``ref.grouped_matmul_ref``."""
    return ref.grouped_matmul_ref(x, w, group_sizes)


def grouped_matmul_aligned(x: torch.Tensor, w: torch.Tensor,
                           capacity: int,
                           fills: torch.Tensor | None = None) -> torch.Tensor:
    """Block-aligned groups, x (G * capacity, D) x w (G, D, F): the CUDA
    kernel for a CUDA (or meta) ``x``, else
    ``ref.grouped_matmul_aligned_ref``;
    where a gradient is needed, the kernel's autograd Function.  ``fills``
    (G,) int32: rows at or past ``fills[g]`` of group g come out as exact
    zeros (and the kernel skips their work)."""
    if use_kernel(x):
        from . import moe_gmm  # imports ops
        if needs_grad(x, w):
            return moe_gmm.grouped_matmul_train(x, w, capacity, fills)
        return moe_gmm.grouped_matmul(x, w, capacity, fills)
    return ref.grouped_matmul_aligned_ref(x, w, capacity, fills)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D) normed by its rows' root mean square, times w (D,), in
    f32, rounded to x's dtype: the fused kernel for a CUDA (or meta) ``x``,
    else ``ref.rmsnorm_ref``; where a gradient is needed, its autograd
    Function."""
    if use_kernel(x):
        from . import fused  # imports ops
        if needs_grad(x, w):
            return fused.rmsnorm_train(x, w, eps)
        return fused.rmsnorm(x, w, eps)
    return ref.rmsnorm_ref(x, w, eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, hd) at positions ``pos`` (B, S)
    int32: the fused kernel for a CUDA (or meta) ``x``, else
    ``ref.rope_ref``; where a gradient is needed, its autograd
    Function."""
    if use_kernel(x):
        from . import fused  # imports ops
        if needs_grad(x):
            return fused.rope_train(x, pos, theta)
        return fused.rope(x, pos, theta)
    return ref.rope_ref(x, pos, theta)


def causal_conv(u: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The Mamba mixer's causal depthwise conv, bias and SiLU -> (u_conv,
    the new state): the fused kernel for a CUDA (or meta) ``u``, else
    ``ref.causal_conv_ref``.  ``state`` (B, d_conv - 1, di), the inputs
    before u (decode), is written in place with the new state and
    returned; without it the new state is a new tensor (a view on the plain
    path; None there for d_conv 1).  Where a gradient is needed (from
    zeros only), the kernel's autograd Function."""
    if use_kernel(u):
        from . import fused  # imports ops
        if needs_grad(u, conv_w, conv_b, state):
            if state is not None:
                no_backward("causal_conv from a state", u, conv_w, conv_b,
                            state)
            return fused.causal_conv_train(u, conv_w, conv_b)
        return fused.causal_conv(u, conv_w, conv_b, state)
    y, new = ref.causal_conv_ref(u, conv_w, conv_b, state)
    if state is not None:
        state.copy_(new)
        new = state
    return y, new


def silu_gate(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) * u``: the fused kernel for a CUDA (or meta) ``g``, else
    ``ref.silu_gate_ref``; where a gradient is needed, its autograd
    Function."""
    if use_kernel(g):
        from . import fused  # imports ops
        if needs_grad(g, u):
            return fused.silu_gate_train(g, u)
        return fused.silu_gate(g, u)
    return ref.silu_gate_ref(g, u)
