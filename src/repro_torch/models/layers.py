"""Transformer / SSM layers of the serving path, as functions over
parameter dictionaries (name -> tensor, one layer's worth).

The twins of the JAX package's ``models/layers.py`` for GQA attention,
multi-head latent attention (MLA), cross-attention and the Mamba-1 mixer,
with its numerics: norms and rotary embeddings in f32, cast back to the
working dtype at the same places.  Prefill attention, the scan and the
elementwise ops that XLA fuses in the reference's jitted steps -- rmsnorm,
rope, the mixer's causal conv with its bias and SiLU, and the SiLU gate of
SwiGLU and of the mixer -- go through ``kernels.ops`` (the CUDA kernels for
CUDA tensors, the plain versions for CPU ones); their numerics live in the
plain versions, ``kernels/ref.py`` (``rmsnorm_ref``, ``rope_ref``,
``causal_conv_ref``, ``silu_gate_ref``), which the fused kernels of
``kernels/csrc/fused.cu`` repeat.  MLA's decode step is plain PyTorch, as
the JAX package's is jnp outside its attention op.

Decode writes its caches in place, as XLA does the JAX package's
``dynamic_update_slice`` under ``jit``: a step's position comes from the
device (``StepPos``), never from a Python int that would reach a kernel's
arguments or a shape, so one step can be captured in a CUDA graph and
replayed (``launch.serve.GreedyStep``).  A linear cache holds position i
at row i.  A sliding window's cache is a ring of W rows holding position
p at row p mod W; its keys' positions are those of the JAX package's
shifted window, ``pos - W + 1 + j``, negative for the rows a short
prompt left zero, so the attention sees the same keys at the same
positions (visited in ring order: f32 sums may differ in the last bits).

Tensor parallelism (``parallel.sharding.tp_split``): the attention layers
and ``swiglu`` take their head and channel counts from the weights they
are given, so they run alike on whole leaves and on one rank's blocks
(column blocks of the input products, row blocks of the output one); so
does the Mamba mixer, whose ``x_proj`` product is row-parallel too.
Given ``tp`` (the mesh axis the blocks are over, 'model'), the output
product's partial sums are added over that axis (``psum``), or with
``scatter`` reduce-scattered along the sequence (each rank keeps its block
of the positions: ``seq_shard_activations``), and a padded model's head
mask is cut to the rank's heads.

The sequence split (``parallel.sharding.seq_split``): given ``seq`` (a
``SeqSplit``), ``gqa_attention`` runs on the rank's block of the sequence,
its rope at the block's positions, against the keys and values gathered
over the split's axis, through the attention kernels' query offset.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import sharding as shd
from .config import ModelConfig, Segment


rmsnorm = ops.rmsnorm
rope = ops.rope


def _reduce(y: torch.Tensor, tp: str | None,
            scatter: bool = False) -> torch.Tensor:
    """A row-parallel product's output (B, S, D): its partial sums added
    over the mesh axis ``tp`` (None: whole already), on every rank, or with
    ``scatter`` only for the rank's block of the sequence."""
    if tp is None:
        return y
    return shd.reduce_scatter(y, tp, 1) if scatter else shd.psum(y, tp)


def swiglu(p: dict, x: torch.Tensor, tp: str | None = None,
           scatter: bool = False) -> torch.Tensor:
    h = ops.silu_gate(x @ p["w_gate"], x @ p["w_up"])
    return _reduce(h @ p["w_down"], tp, scatter)


# ---------------------------------------------------------------- attention

def _positions(B: int, S: int, device, offset: int = 0) -> torch.Tensor:
    """(B, S) int32 positions ``offset`` .. ``offset + S - 1``."""
    return (torch.arange(S, dtype=torch.int32, device=device)
            + offset).expand(B, S)


def n_q_heads(cfg: ModelConfig) -> int:
    """Physical q-head count (optionally padded per kv group; pad heads
    are masked to zero)."""
    return cfg.n_heads_padded or cfg.n_heads


def head_mask(cfg: ModelConfig, dtype, device=None) -> torch.Tensor | None:
    Hp = n_q_heads(cfg)
    if Hp == cfg.n_heads:
        return None
    g_pad = Hp // cfg.n_kv_heads
    g_real = cfg.n_heads // cfg.n_kv_heads
    mask = (torch.arange(Hp, device=device) % g_pad) < g_real
    return mask.to(dtype)[None, None, :, None]


def gqa_project(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """q (B, S, Hq, hd), k and v (B, S, KV, hd): the heads of the columns
    given (every head, or one rank's block of them)."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(B, S, -1, hd)
    k = (x @ p["wk"]).reshape(B, S, -1, hd)
    v = (x @ p["wv"]).reshape(B, S, -1, hd)
    return q, k, v


def _attend_out(p: dict, out: torch.Tensor, cfg: ModelConfig,
                tp: str | None = None, scatter: bool = False
                ) -> torch.Tensor:
    B, S, Hq, hd = out.shape
    hm = head_mask(cfg, out.dtype, out.device)
    if hm is not None:
        if tp is not None:     # the rank's heads of the padded ones
            hm = hm.narrow(2, shd.axis_index(tp) * Hq, Hq)
        out = out * hm
    return _reduce(out.reshape(B, S, Hq * hd) @ p["wo"], tp, scatter)


def gqa_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, seg: Segment,
                  tp: str | None = None, seq: "shd.SeqSplit | None" = None,
                  scatter: bool = False):
    """Full-sequence attention (prefill): on every head, or under ``tp``
    on the rank's heads (its blocks of wq, wk, wv and wo), the output
    summed over ``tp`` (``scatter``: reduce-scattered along the sequence).
    Under ``seq`` ``x`` is the rank's block of the sequence: its queries,
    roped at the block's positions, attend to the roped keys and the
    values gathered over ``seq.axis`` from every block, the queries at
    ``seq.offset`` (the kernels' ``q_off``)."""
    B, S, _ = x.shape
    q, k, v = gqa_project(p, x, cfg)
    off = 0 if seq is None else seq.offset
    pos = _positions(B, S, x.device, off)
    q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
    if seq is not None:
        k, v = seq.gather(k), seq.gather(v)
    out = ops.attention(q, k, v, causal=seg.causal,
                        window=seg.sliding_window, q_off=off)
    return _attend_out(p, out, cfg, tp, scatter)


def gqa_init_cache(cfg: ModelConfig, seg: Segment, B: int, max_len: int,
                   dtype, device=None) -> dict:
    L = max_len if not seg.sliding_window else min(seg.sliding_window, max_len)
    shape = (B, L, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill_cache(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      seg: Segment, max_len: int) -> dict:
    """The decode cache of a prefilled sequence: for a sliding window the
    ring of the last W keys, position p at row p mod W (the JAX package's
    shifted window -- the last W, left-padded with zeros while shorter --
    rolled by S mod W), else a linear cache where position i lives at
    index i."""
    B, S, _ = x.shape
    _, k, v = gqa_project(p, x, cfg)
    k = rope(k, _positions(B, S, x.device), cfg.rope_theta)
    if seg.sliding_window:
        W = min(seg.sliding_window, max_len)

        def fit(t):
            t = (t[:, -W:] if S >= W
                 else F.pad(t, (0, 0, 0, 0, W - S, 0)))
            return torch.roll(t, S % W, dims=1)
    else:
        def fit(t):
            return F.pad(t, (0, 0, 0, 0, 0, max_len - S))
    return {"k": fit(k).contiguous(), "v": fit(v).contiguous()}


class StepPos:
    """The position of a decode step's new token, on the device -- the JAX
    package's traced ``pos`` -- and what the layers derive from it, each
    made once a step: ``at`` (B, 1) int32, rope's and the attention's
    query positions; ``index`` (1,) int64, the row a linear cache writes;
    ``keys(L)``, a linear cache's key positions, and ``ring(W)``, a
    window's row and key positions.  ``pos``: a 0-d (or (1,)) int32
    tensor on ``device``, which is read in place (a captured step that
    adds one to it moves every later replay on), or a Python int, filled
    in on the device (no upload)."""

    def __init__(self, pos, B: int, device):
        if isinstance(pos, torch.Tensor):
            value = pos.reshape(1).to(device=device, dtype=torch.int32)
        else:
            value = torch.full((1,), int(pos), dtype=torch.int32,
                               device=device)
        self.value = value                             # (1,) int32
        self.at = value.expand(B, 1).contiguous()
        self.index = value.long()
        self._B, self._device = B, device
        self._keys: dict = {}
        self._rings: dict = {}

    def keys(self, L: int) -> torch.Tensor:
        """(B, L) int32 ``0 .. L - 1``: a linear cache's key positions."""
        if L not in self._keys:
            self._keys[L] = torch.arange(
                L, dtype=torch.int32, device=self._device).expand(
                    self._B, L).contiguous()
        return self._keys[L]

    def ring(self, W: int) -> tuple[torch.Tensor, torch.Tensor]:
        """A ring of W rows: the row the new token writes, (1,) int64
        ``pos mod W``, and the (B, W) int32 key positions, row r holding
        ``pos - ((pos - r) mod W)``: the JAX package's window ``pos - W +
        1 .. pos``, negative for rows no token has written."""
        if W not in self._rings:
            rows = torch.arange(W, dtype=torch.int32, device=self._device)
            k_pos = self.value - torch.remainder(self.value - rows, W)
            self._rings[W] = (torch.remainder(self.index, W),
                              k_pos.expand(self._B, W).contiguous())
        return self._rings[W]


def step_pos(pos, B: int, device) -> StepPos:
    """``pos`` as a ``StepPos`` (one given is returned as it is)."""
    return pos if isinstance(pos, StepPos) else StepPos(pos, B, device)


def gqa_attention_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                         seg: Segment, cache: dict, pos):
    """x: (B, 1, D); ``pos`` the new token's position (``StepPos``, or
    what it takes).  Writes the new key and value into ``cache`` in place
    -- a linear cache at row ``pos``, a window's ring at ``pos mod W`` --
    and attends over the whole cache; returns (output, ``cache``)."""
    B = x.shape[0]
    pos = step_pos(pos, B, x.device)
    q, k_new, v_new = gqa_project(p, x, cfg)
    q = rope(q, pos.at, cfg.rope_theta)
    k_new = rope(k_new, pos.at, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    if seg.sliding_window:
        row, k_pos = pos.ring(k.shape[1])
    else:
        row, k_pos = pos.index, pos.keys(k.shape[1])
    k.index_copy_(1, row, k_new)
    v.index_copy_(1, row, v_new)
    out = ops.attention(q, k, v, causal=True, window=0, q_pos=pos.at,
                        k_pos=k_pos)
    return _attend_out(p, out, cfg), cache


# ---------------------------------------------------------------------- MLA

def _mla_dims(cfg: ModelConfig):
    return (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim)


def mla_project_q(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The queries through their low-rank path: (q_nope, q_rope), each
    (B, S, H, ...)."""
    B, S, _ = x.shape
    _, _, nope, rp, _ = _mla_dims(cfg)
    ql = rmsnorm(x @ p["wq_a"], p["q_ln"], cfg.norm_eps)
    q = (ql @ p["wq_b"]).reshape(B, S, -1, nope + rp)
    return q[..., :nope], q[..., nope:]


def mla_latent(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The compressed kv latent (normed) and the decoupled rope key before
    rotation: the cached quantities."""
    kvr = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    ckv = rmsnorm(kv[..., :kvr], p["kv_ln"], cfg.norm_eps)
    return ckv, kv[..., kvr:]


def mla_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  seg: Segment, tp: str | None = None,
                  scatter: bool = False) -> torch.Tensor:
    """Full-sequence MLA (prefill): the latent expanded to per-head keys
    (nope part, plus the one rope key shared by every head) and values,
    then one attention call at head dims (nope + rope, v) with the scale
    of the q/k head dim.  q, k and v are made contiguous, as the kernels
    take them.  Under ``tp`` the heads are the rank's (its column blocks
    of wq_b and wkv_b, its row block of mla_wo; wq_a, wkv_a and the norms
    whole) and the output is summed over ``tp`` (``scatter``:
    reduce-scattered along the sequence)."""
    B, S, _ = x.shape
    _, _, nope, rp, vh = _mla_dims(cfg)
    H = p["wkv_b"].shape[-1] // (nope + vh)
    q_nope, q_rope = mla_project_q(p, x, cfg)
    ckv, k_rope = mla_latent(p, x, cfg)
    pos = _positions(B, S, x.device)
    q_rope = rope(q_rope, pos, cfg.rope_theta)
    k_rope = rope(k_rope[:, :, None, :], pos, cfg.rope_theta)  # one head
    kv = (ckv @ p["wkv_b"]).reshape(B, S, H, nope + vh)
    k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rp)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = kv[..., nope:].contiguous()
    out = ops.attention(q, k, v, causal=seg.causal,
                        scale=(nope + rp) ** -0.5)
    return _reduce(out.reshape(B, S, H * vh) @ p["mla_wo"], tp, scatter)


def mla_init_cache(cfg: ModelConfig, B: int, max_len: int, dtype,
                   device=None) -> dict:
    return {"ckv": torch.zeros((B, max_len, cfg.kv_lora_rank), dtype=dtype,
                               device=device),
            "kr": torch.zeros((B, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device)}


def mla_prefill_cache(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      max_len: int) -> dict:
    """The decode cache of a prefilled sequence: the latent and the rotated
    rope key, position i at index i, zero past the prompt."""
    B, S, _ = x.shape
    ckv, k_rope = mla_latent(p, x, cfg)
    k_rope = rope(k_rope[:, :, None, :], _positions(B, S, x.device),
                  cfg.rope_theta)[:, :, 0, :]
    pad = (0, 0, 0, max_len - S)
    return {"ckv": F.pad(ckv, pad).contiguous(),
            "kr": F.pad(k_rope, pad).contiguous()}


def mla_attention_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                         cache: dict, pos, absorb: bool = True):
    """x: (B, 1, D); ``pos`` the new token's position (``StepPos``, or
    what it takes).  Writes the latent and the rope key into ``cache`` in
    place at row ``pos``, as ``gqa_attention_decode`` does; returns
    (output, ``cache``).  Scores are f32 (bf16 products, f32 sums), the
    softmax weights go back to x's dtype before the value product.
    ``absorb`` folds the key up-projection into the query and attends in
    the latent space; else every cached latent is expanded to full keys
    and values."""
    B = x.shape[0]
    _, kvr, nope, rp, vh = _mla_dims(cfg)
    H = cfg.n_heads
    pos = step_pos(pos, B, x.device)
    q_nope, q_rope = mla_project_q(p, x, cfg)                  # (B, 1, H, *)
    q_rope = rope(q_rope, pos.at, cfg.rope_theta)
    ckv_new, kr_new = mla_latent(p, x, cfg)
    kr_new = rope(kr_new[:, :, None, :], pos.at, cfg.rope_theta)[:, :, 0, :]
    ckv, kr = cache["ckv"], cache["kr"]
    ckv.index_copy_(1, pos.index, ckv_new)
    kr.index_copy_(1, pos.index, kr_new)
    Sk = ckv.shape[1]
    live = torch.arange(Sk, device=x.device) <= pos.value
    scale = (nope + rp) ** -0.5
    wkv_b = p["wkv_b"].reshape(kvr, H, nope + vh)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    if absorb:
        q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)  # (B, 1, H, kvr)
        s = torch.einsum("bqhr,bsr->bhqs", q_eff.float(), ckv.float())
        s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())
        s = torch.where(live, s * scale, -1e30)
        pattn = torch.softmax(s, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", pattn, ckv)        # latent ctx
        out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    else:
        kv = (ckv @ p["wkv_b"]).reshape(B, Sk, H, nope + vh)
        k = torch.cat([kv[..., :nope],
                       kr[:, :, None, :].expand(B, Sk, H, rp)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        s = torch.einsum("bqhn,bshn->bhqs", q.float(), k.float())
        s = torch.where(live, s * scale, -1e30)
        pattn = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bhqs,bshv->bqhv", pattn, kv[..., nope:])
    out = out.reshape(B, 1, H * vh)
    return out @ p["mla_wo"], cache


# ---------------------------------------------------------------- cross-attn

def cross_kv(p: dict, img: torch.Tensor, cfg: ModelConfig):
    """The keys and values of the (stub) image embeddings img (B, N, D):
    each (B, N, KV, hd) -- the KV heads of the columns given -- without
    rope; the decode cache of a vision group's cross-attention."""
    B, N, _ = img.shape
    k = (img @ p["cross_wk"]).reshape(B, N, -1, cfg.hd)
    v = (img @ p["cross_wv"]).reshape(B, N, -1, cfg.hd)
    return k, v


def cross_attend(p: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: ModelConfig, tp: str | None = None,
                 scatter: bool = False) -> torch.Tensor:
    """Text queries x (B, S, D) against image keys and values, no mask and
    no positions (the ``n_heads`` query heads, or under ``tp`` the rank's:
    no head mask); the output, summed over ``tp`` (``scatter``:
    reduce-scattered along the sequence), scaled by ``tanh(gate)`` in x's
    dtype."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["cross_wq"]).reshape(B, S, -1, hd)
    out = ops.attention(q, k, v, causal=False)
    out = _reduce(out.reshape(B, S, q.shape[2] * hd) @ p["cross_wo"], tp,
                  scatter)
    return torch.tanh(p["gate"]).to(out.dtype) * out


def cross_attention(p: dict, x: torch.Tensor, img: torch.Tensor,
                    cfg: ModelConfig, tp: str | None = None,
                    scatter: bool = False) -> torch.Tensor:
    """Text queries attend to (stub) image embeddings; tanh-gated
    residual."""
    return cross_attend(p, x, *cross_kv(p, img, cfg), cfg, tp, scatter)


# --------------------------------------------------------------------- mamba

def mamba_mixer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: dict | None = None, tp: str | None = None,
                scatter: bool = False):
    """Mamba-1 mixer.  x: (B, S, D).  state: {'conv': (B, d_conv-1, di),
    'ssm': (B, di, N)} for stepwise decode (S == 1), written in place
    with the new state and returned; without it a new state is returned.

    Under ``tp`` (the mesh axis, 'model') the leaves are this rank's
    blocks of di / n channels (``parallel.sharding.held_specs``):
    ``in_proj`` column-parallel as ``[x block | z block]`` on the
    replicated input; the conv, SiLU, dt's projection and softplus, the
    scan (its A, D and state rows) and the gate on the rank's channels;
    ``x_proj`` row-parallel, its partial (B, S, r + 2N) summed by one psum
    over ``tp`` before dt's input, B and C are cut from it; ``out_proj``
    row-parallel, its output summed over ``tp`` (``scatter``:
    reduce-scattered along the sequence).  ``conv_b`` and ``dt_bias`` are
    held whole, as the reference has them, and narrowed here to the
    rank's channels: each rank's gradient of them is its channels' part,
    zero elsewhere, which the step's psum of replicated leaves over
    'model' (``train.step``) puts together."""
    N, r = cfg.ssm_state, cfg.dt_rank_
    xz = x @ p["in_proj"]
    di = xz.shape[-1] // 2                 # every channel, or the rank's
    u, z = xz[..., :di], xz[..., di:]
    conv_b, dt_bias = p["conv_b"], p["dt_bias"]
    if tp is not None:
        conv_b = conv_b.narrow(0, shd.axis_index(tp) * di, di)
        dt_bias = dt_bias.narrow(0, shd.axis_index(tp) * di, di)
    # depthwise causal conv along S, its bias and SiLU (a state is written
    # in place with the new one)
    u_conv, new_conv = ops.causal_conv(
        u, p["conv_w"], conv_b, None if state is None else state["conv"])
    # input-dependent SSM parameters
    xproj = u_conv @ p["x_proj"]
    if tp is not None:
        xproj = shd.psum(xproj, tp)
    dt = F.softplus(xproj[..., :r] @ p["dt_proj"] + dt_bias)
    Bc = xproj[..., r:r + N].contiguous()
    Cc = xproj[..., r + N:].contiguous()
    A = -torch.exp(p["A_log"].float())
    init = state["ssm"] if state is not None else None
    y, last = ops.mamba_scan(u_conv, dt, A, Bc, Cc, p["ssm_D"],
                             init_state=init)
    y = ops.silu_gate(z, y)
    out = _reduce(y @ p["out_proj"], tp, scatter)
    if state is not None:
        state["ssm"].copy_(last)
        return out, state
    new_conv = None if new_conv is None else new_conv.contiguous()
    return out, {"conv": new_conv, "ssm": last}


def mamba_init_cache(cfg: ModelConfig, B: int, dtype, device=None) -> dict:
    return {
        "conv": torch.zeros((B, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((B, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }
