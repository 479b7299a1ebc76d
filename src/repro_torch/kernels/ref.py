"""Plain PyTorch versions of the CUDA kernels.

They define what each kernel computes.  The dispatchers (``gain``'s
wrappers, ``ops.attention``, ``ops.mamba_scan``,
``ops.grouped_matmul_aligned``) take them for tensors that lie on the CPU
(the tests), and the smoke run on the card holds each kernel against them
on the same inputs.  The attention, scan and grouped-matmul versions are
the twins of the JAX package's jnp references, argument for argument.
``attention_bwd_ref``, ``mamba_scan_bwd_ref`` and
``grouped_matmul_aligned_bwd_ref`` spell out the backward kernels'
arithmetic for the tests, ``attention_lse_ref`` the row log-sum-exp the
attention forward hands its backward (no path runs them: the plain
versions' gradients come from autograd).

``rmsnorm_ref``, ``rope_ref``, ``causal_conv_ref`` and ``silu_gate_ref``
are the layers' elementwise ops (``kernels/fused.py``), moved here as they
stood in ``models/layers.py``: the JAX package's jnp, which XLA fuses.
Their ``*_bwd_ref`` write the fused backward kernels' arithmetic out, in
f32 with one rounding at each output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_NO_COVER = 127  # > any popcount for P <= 12; also pc[0], the empty subset
_LOG2E = 1.4426950408889634   # the LSE the attention kernels exchange: log2


def min_cover_ref(rows_perm: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """(R,) int32 masked min: per row, the least ``pc[c]`` over the columns
    where ``rows_perm[r, c] == 0``, or ``_NO_COVER`` if there is none."""
    return torch.where(rows_perm == 0, pc[None, :],
                       _NO_COVER).amin(dim=1).to(torch.int32)


def front_dlam_ref(rows_perm: torch.Tensor, pc: torch.Tensor,
                   lam_old: torch.Tensor) -> torch.Tensor:
    """(R,) int32 ``relu(lam_new - 1) - relu(lam_old - 1)`` with ``lam_new``
    the masked min of ``min_cover_ref``."""
    lam = min_cover_ref(rows_perm, pc)
    return (lam - 1).clamp_min(0) - (lam_old - 1).clamp_min(0)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_pos: torch.Tensor | None = None,
                  k_pos: torch.Tensor | None = None,
                  scale: float | None = None,
                  q_off: int = 0) -> torch.Tensor:
    """GQA attention: q (B, Sq, H, hd), k (B, Sk, KV, hd), v (B, Sk, KV,
    hd_v) -> (B, Sq, H, hd_v) in q's dtype.

    ``q_pos``/``k_pos`` are (B, Sq)/(B, Sk) absolute positions (default
    ``q_off + arange`` and ``arange``: ``q_off`` places a block of queries
    of a longer sequence); ``k_pos < 0`` is padding, ``causal`` keeps
    ``q_pos >= k_pos`` and ``window > 0`` keeps ``q_pos - k_pos < window``.
    Masked scores are -1e30, the softmax is f32, and ``p`` is cast to v's
    dtype before the PV product, as in the JAX reference."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    if q_pos is None:
        q_pos = (torch.arange(Sq, device=q.device) + q_off).expand(B, Sq)
    elif q_off:
        raise ValueError("q_off and q_pos both place the queries: pass one")
    if k_pos is None:
        k_pos = torch.arange(Sk, device=q.device).expand(B, Sk)
    qf = q.reshape(B, Sq, KV, G, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * scale
    qp = q_pos[:, None, None, :, None]
    kp = k_pos[:, None, None, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (qp >= kp)
    if window:
        mask = mask & ((qp - kp) < window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, splits: int, chunk: int, causal: bool = True,
                        window: int = 0, q_pos: torch.Tensor | None = None,
                        k_pos: torch.Tensor | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """The split-and-combine arithmetic of the ``decode_split`` kernel in
    plain PyTorch, for the tests only (never on a path): split s of each
    (batch, kv head) takes keys ``[s * chunk, (s + 1) * chunk)``; a split
    where no row of its (batch, kv head) has a live key gives m = -inf,
    l = 0; else, per row, m its largest score (masked -1e30), l and acc the
    sums of exp(score - m) and of their products with v.  The combine
    weighs split s by exp(m_s - M), M the largest m, and divides by the
    weighed l clamped at 1e-30 (0 where every split is dead).  Arguments
    as ``attention_ref``; f32 arithmetic, the result in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV, hdv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device).expand(B, Sq)
    if k_pos is None:
        k_pos = torch.arange(Sk, device=q.device).expand(B, Sk)
    qf = q.reshape(B, Sq, KV, G, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * scale
    qp = q_pos[:, None, None, :, None]
    kp = k_pos[:, None, None, None, :]
    live = kp >= 0
    if causal:
        live = live & (qp >= kp)
    if window:
        live = live & ((qp - kp) < window)
    live = live.expand_as(logits)
    logits = torch.where(live, logits, torch.full_like(logits, -1e30))
    vf = v.float()
    ms, ls, accs = [], [], []
    for s in range(splits):
        sl = slice(s * chunk, min((s + 1) * chunk, Sk))
        lg = logits[..., sl]
        any_live = live[..., sl].flatten(2).any(dim=2)[..., None, None]
        m = torch.where(any_live, lg.amax(dim=-1),
                        torch.full_like(lg[..., 0], -torch.inf))
        p = torch.where(any_live[..., None], torch.exp(lg - m[..., None]),
                        torch.zeros_like(lg))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgqs,bskh->bkgqh", p, vf[:, sl]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    M = m.amax(dim=0)
    dead = M == -torch.inf
    w = torch.where(m == -torch.inf, torch.zeros_like(m),
                    torch.exp(m - torch.where(dead, 0.0, M)))
    den = (w * l).sum(dim=0).clamp_min(1e-30)
    out = (w[..., None] * acc).sum(dim=0) / den[..., None]
    out = torch.where(dead[..., None], torch.zeros_like(out), out)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hdv).to(q.dtype)


def mamba_scan_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                   init_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan, ``h <- exp(dt*A) h + (dt*u) B_t`` and
    ``y_t = h.C_t + D*u_t`` in f32.  u/dt (B, S, di), A (di, N) f32, Bc/Cc
    (B, S, N), D (di,) f32, ``init_state`` (B, di, N) f32 or zeros.
    Returns y (B, S, di) in u's dtype and the last state (B, di, N) f32."""
    B, S, di = u.shape
    N = A.shape[1]
    h = (torch.zeros((B, di, N), dtype=torch.float32, device=u.device)
         if init_state is None else init_state.float())
    uf, dtf = u.float(), dt.float()
    dA = torch.exp(dtf[..., None] * A[None, None])                # (B,S,di,N)
    dBu = (dtf * uf)[..., None] * Bc.float()[:, :, None, :]       # (B,S,di,N)
    # per-step views by unbind: under autograd their gradients gather in
    # one stack, where indexing step t would scatter each into a zero
    # tensor of the full (B, S, di, N) shape
    dAs, dBus, Cs = dA.unbind(1), dBu.unbind(1), Cc.float().unbind(1)
    ys = []
    for t in range(S):
        h = dAs[t] * h + dBus[t]
        ys.append(torch.einsum("bdn,bn->bd", h, Cs[t]))
    y = torch.stack(ys, dim=1) + uf * D[None, None]
    return y.to(u.dtype), h


def _live(Sq: int, Sk: int, causal: bool, window: int,
          device, q_off: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: the (query, key) pairs that attention without
    positions keeps, query i at position i + ``q_off``."""
    qp = torch.arange(Sq, device=device)[:, None] + q_off
    kp = torch.arange(Sk, device=device)[None, :]
    live = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        live = live & (qp >= kp)
    if window:
        live = live & (qp - kp < window)
    return live


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                      window: int, scale: float,
                      q_off: int = 0) -> torch.Tensor:
    """The row log-sum-exp that ``csrc/attention_prefill_tc.cu`` writes
    beside its output and ``csrc/attention_bwd_tc.cu`` takes, for the tests
    only: (B, H, Sq) f32, ``log2(sum_k 2^(s_qk * scale * log2(e)))`` over
    the unmasked keys of each row -- the natural log-sum-exp of the scaled
    scores times log2(e), **in log2 units**, so that ``P = 2^(S * scale *
    log2(e) - lse)``.  q (B, Sq, H, hd), k (B, Sk, KV, hd), no positions
    (the queries at ``q_off`` on); masked scores are -1e30, as in
    ``attention_ref``."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qf = q.reshape(B, Sq, KV, H // KV, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * scale
    s = torch.where(_live(Sq, Sk, causal, window, q.device, q_off), s,
                    torch.full_like(s, -1e30))
    return (torch.logsumexp(s, dim=-1) * _LOG2E).reshape(B, H, Sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                      window: int, scale: float,
                      lse: torch.Tensor | None = None, q_off: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arithmetic of the attention backward kernels
    (``csrc/attention_bwd.cu``, ``csrc/attention_bwd_tc.cu``) in plain
    PyTorch, for the tests only: (dq, dk, dv) of ``attention_ref`` without
    positions (the queries at ``q_off`` on: a key that no query reaches
    gets zeros), from its output ``o`` and the output's gradient ``do``.  In
    f32: ``P = exp(S - lse)`` (masked pairs exactly 0), the row
    log-sum-exp of the masked scores recomputed, or ``lse`` (B, H, Sq) as
    ``attention_lse_ref`` gives it (log2 units) where given; ``delta =
    rowsum(do * o)``, ``dS = P * (dP - delta)``; dK and dV summed over each
    kv head's G query heads.  The gradients come out in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.reshape(B, Sq, KV, G, hd).float()
    dof = do.reshape(B, Sq, KV, G, -1).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) * scale
    live = _live(Sq, Sk, causal, window, q.device, q_off)
    s = torch.where(live, s, -torch.inf)
    if lse is None:
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    else:
        ln = lse.float().reshape(B, KV, G, Sq)[..., None] / _LOG2E
        p = torch.exp(s - ln)
    delta = (dof * o.reshape(B, Sq, KV, G, -1).float()).sum(-1)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def mamba_scan_bwd_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                       dy: torch.Tensor, chunk: int = 8,
                       segment: int | None = None) -> tuple:
    """The arithmetic of ``csrc/mamba_scan_bwd.cu`` in plain PyTorch, for
    the tests only: the gradients (du, ddt, dA, dBc, dCc, dD) of
    ``mamba_scan_ref`` from zeros given ``dy``, in f32.

    The sequence is cut into segments of ``segment`` steps (None: one
    segment, the whole sequence), each into chunks of ``chunk`` steps from
    its start.  Pass 1 runs every segment from zeros with ``a_t =
    exp(dt_t A)``, keeping the local state and the dt summed so far at
    each chunk's start, and the segment's summaries: its local end state
    ``hend``, its dt summed ``dtsum`` (``exp(A dtsum)`` is the product of
    its decays) and ``gsum = sum_t (prod_{k<=t} a_k) dy_t C_t``, the carry
    it sends back when nothing comes from behind it.  The combine folds the
    summaries in order: a segment's start state from those before it
    (``h <- exp(A dtsum_j) h + hend_j``), its carry from those after it
    (``G <- exp(A dtsum_j) G + gsum_j``).  Pass 2 walks each segment's
    chunks last first: the chunk's start state is its local one plus
    ``exp(A cumdt)`` times the segment's start state; its states are
    recomputed, then its steps walked backwards carrying ``a_t g_t`` (G
    into the segment's last step), ``g_t = dy_t C_t + a_{t+1} g_{t+1}``,
    ``g_t exp(dt_t A) h_{t-1}`` taken as ``(a_t g_t) h_{t-1}``.  du, ddt,
    dBc, dCc come out in u's dtype, dA and dD in f32."""
    Bn, S, di = u.shape
    L = S if segment is None else segment
    uf, dtf, dyf = u.float(), dt.float(), dy.float()
    Bf, Cf = Bc.float(), Cc.float()
    x = dtf * uf                                               # (B, S, di)
    zero = torch.zeros((Bn, di, A.shape[1]), dtype=torch.float32,
                       device=u.device)

    def decay(t):
        return torch.exp(dtf[:, t, :, None] * A)

    def over(s):                      # exp(A * summed dt), (B, di) -> state
        return torch.exp(s[..., None] * A)

    def xb(t):
        return x[:, t, :, None] * Bf[:, t, None, :]
    segs = [(s0, min(s0 + L, S)) for s0 in range(0, S, L)]
    local, summ = [], []              # pass 1
    for s0, s1 in segs:
        h, q, gs = zero, torch.ones_like(zero), zero
        cum = torch.zeros_like(dtf[:, 0])
        ck = []
        for c0 in range(s0, s1, chunk):
            ck.append((c0, h, cum))
            for t in range(c0, min(c0 + chunk, s1)):
                a = decay(t)
                h = a * h + xb(t)
                q = q * a
                gs = gs + q * (dyf[:, t, :, None] * Cf[:, t, None, :])
                cum = cum + dtf[:, t]
        local.append(ck)
        summ.append((h, gs, cum))
    dA = torch.zeros_like(A)
    du, ddt = torch.zeros_like(uf), torch.zeros_like(uf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    for si, (s0, s1) in enumerate(segs):          # combine, then pass 2
        h0 = zero
        for hend, _, dtsum in summ[:si]:
            h0 = over(dtsum) * h0 + hend
        ag = zero
        for _, gsum, dtsum in reversed(summ[si + 1:]):
            ag = over(dtsum) * ag + gsum
        for c0, h_loc, cum in reversed(local[si]):
            h = h_loc + over(cum) * h0
            steps = range(c0, min(c0 + chunk, s1))
            hs, decays = [h], []
            for t in steps:
                decays.append(decay(t))
                hs.append(decays[-1] * hs[-1] + xb(t))
            for t in reversed(steps):
                i = t - c0
                g = dyf[:, t, :, None] * Cf[:, t, None, :] + ag
                dC[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], hs[i + 1])
                dB[:, t] = torch.einsum("bdn,bd->bn", g, x[:, t])
                s1_t = (g * Bf[:, t, None, :]).sum(-1)
                ag = decays[i] * g
                gha = ag * hs[i]                  # g_t (a_t h_{t-1})
                du[:, t] = dyf[:, t] * D + s1_t * dtf[:, t]
                ddt[:, t] = s1_t * uf[:, t] + (gha * A).sum(-1)
                dA = dA + (gha * dtf[:, t, :, None]).sum(0)
    dD = (dyf * uf).sum((0, 1))
    return (du.to(u.dtype), ddt.to(u.dtype), dA, dB.to(u.dtype),
            dC.to(u.dtype), dD)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """Block-diagonal product: x (T, D) rows sorted by group, w (G, D, F),
    ``group_sizes`` (G,) summing to T; row t multiplies the weight of its
    group.  f32 accumulation, the result in x's dtype."""
    T = x.shape[0]
    ends = torch.cumsum(group_sizes, dim=0)
    row = torch.arange(T, device=x.device)
    gid = (row[:, None] >= ends[None, :]).sum(dim=1)      # group of each row
    return torch.einsum("td,tdf->tf", x.float(),
                        w[gid].float()).to(x.dtype)


def grouped_matmul_aligned_ref(x: torch.Tensor, w: torch.Tensor,
                               capacity: int,
                               fills: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The block-aligned layout of the MoE dispatch buffers: x (G *
    capacity, D), group g's rows times w[g] (D, F) -> (G * capacity, F),
    as the einsum ``scd,sdf->scf`` with f32 accumulation, cast to x's
    dtype.  With ``fills`` (G,) integer, row r of group g is an exact zero
    where ``r >= fills[g]``, whatever x holds there; the other rows are
    unchanged."""
    G, D, F = w.shape
    xs = x.reshape(G, capacity, D).float()
    y = torch.einsum("scd,sdf->scf", xs, w.float())
    if fills is not None:
        rows = torch.arange(capacity, device=x.device)
        live = rows[None, :] < fills[:, None]
        y = torch.where(live[..., None], y, 0.0)
    return y.reshape(G * capacity, F).to(x.dtype)


def grouped_matmul_aligned_bwd_ref(x: torch.Tensor, w: torch.Tensor,
                                   dy: torch.Tensor, capacity: int,
                                   fills: torch.Tensor | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``grouped_matmul_aligned_ref`` for the output gradient
    dy (G * capacity, F): ``dx[g, r] = dy[g, r] @ w[g]^T`` and ``dw[g] =
    sum_r x[g, r]^T dy[g, r]``, two einsums in f32 cast to x's dtype.  With
    ``fills``, the rows at or past ``fills[g]`` send nothing into dw,
    whatever x and dy hold there, and their dx rows are exact zeros (the
    forward's output there is a constant zero)."""
    G, D, F = w.shape
    dys = dy.reshape(G, capacity, F).float()
    xs = x.reshape(G, capacity, D).float()
    if fills is not None:       # dead rows zeroed in both: nothing at all
        rows = torch.arange(capacity, device=dy.device)
        live = (rows[None, :] < fills[:, None])[..., None]
        dys = torch.where(live, dys, 0.0)
        xs = torch.where(live, xs, 0.0)
    dx = torch.einsum("scf,sdf->scd", dys, w.float())
    dw = torch.einsum("scd,scf->sdf", xs, dys)
    return dx.reshape(G * capacity, D).to(x.dtype), dw.to(x.dtype)


# ------------------------------------------------- the fused elementwise ops

def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rmsnorm_ref`` given ``dy``: with ``r = rsqrt(mean(x^2)
    + eps)`` per row, ``dx = r (w dy) - x r^3 mean(x w dy)`` and ``dw`` the
    sum over rows of ``dy x r``, in f32, rounded to x's and w's dtypes."""
    xf, dyf, wf = x.float(), dy.float(), w.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    wdy = wf * dyf
    dot = (xf * wdy).mean(dim=-1, keepdim=True)
    dx = r * wdy - xf * (r * r * r * dot)
    dw = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rope_freqs(half: int, theta: float, device=None) -> torch.Tensor:
    """(half,) f32 ``1 / theta^(i / half)``: rope's frequencies."""
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_ref(x: torch.Tensor, pos: torch.Tensor, theta: float,
             negate: bool = False) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); pos: (B, S) absolute positions.
    ``negate`` rotates by the negated angles: rope's backward, ``dy`` in
    place of ``x``."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(half, theta, x.device)
    ang = pos[..., None].float() * freqs                  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    if negate:
        sin = -sin
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_bwd_ref(dy: torch.Tensor, pos: torch.Tensor,
                 theta: float) -> torch.Tensor:
    """dx of ``rope_ref`` given ``dy``: the rotation by the negated
    angles."""
    return rope_ref(dy, pos, theta, negate=True)


def causal_conv_ref(u: torch.Tensor, conv_w: torch.Tensor,
                    conv_b: torch.Tensor, state: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The Mamba mixer's depthwise causal conv along S, its bias and SiLU:
    u (B, S, di), conv_w (d_conv, di), conv_b (di,), ``state`` (B, d_conv -
    1, di) the inputs before u (decode) or zeros.  The JAX window-gather
    einsum, as a sum of shifted slices with f32 products and sums, rounded
    once; returns (u_conv, the new state: the last d_conv - 1 inputs, a
    view; None for d_conv 1 without a state)."""
    K, S = conv_w.shape[0], u.shape[1]
    if state is None:
        u_pad = F.pad(u, (0, 0, K - 1, 0))
        new_conv = u_pad[:, -(K - 1):] if K > 1 else None
    else:
        u_pad = torch.cat([state, u], dim=1)
        new_conv = u_pad[:, -(K - 1):]
    w = conv_w.float()
    acc = u_pad[:, 0:S].float() * w[0]
    for j in range(1, K):
        acc = acc + u_pad[:, j:j + S].float() * w[j]
    return F.silu(acc.to(u.dtype) + conv_b), new_conv


def causal_conv_bwd_ref(u: torch.Tensor, conv_w: torch.Tensor,
                        conv_b: torch.Tensor, dy: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(du, dw, db) of ``causal_conv_ref`` from zeros given ``dy``: SiLU's
    derivative at its input ``v`` as the forward rounds it, ``dv = dy
    silu'(v)``; ``db`` its sum over (B, S), ``dw[j]`` the sum of ``dv``
    times tap j's inputs, ``du`` the correlation of ``dv`` with the flipped
    taps; in f32, rounded to each input's dtype."""
    K, (B, S, di) = conv_w.shape[0], u.shape
    u_pad = F.pad(u, (0, 0, K - 1, 0)).float()
    w = conv_w.float()
    acc = u_pad[:, 0:S] * w[0]
    for j in range(1, K):
        acc = acc + u_pad[:, j:j + S] * w[j]
    v = (acc.to(u.dtype) + conv_b).float()
    s = torch.sigmoid(v)
    dv = dy.float() * (s * (1 + v * (1 - s)))
    db = dv.sum((0, 1))
    dw = torch.stack([(dv * u_pad[:, j:j + S]).sum((0, 1))
                      for j in range(K)])
    du_pad = torch.zeros((B, S + K - 1, di), dtype=torch.float32,
                         device=u.device)
    for j in range(K):
        du_pad[:, j:j + S] += dv * w[j]
    return (du_pad[:, K - 1:].to(u.dtype), dw.to(conv_w.dtype),
            db.to(conv_b.dtype))


def silu_gate_ref(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g) * u``: SwiGLU's gate, the experts' and Mamba's."""
    return F.silu(g) * u


def silu_gate_bwd_ref(g: torch.Tensor, u: torch.Tensor, dy: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dg, du) of ``silu_gate_ref`` given ``dy``: ``du = dy silu(g)``,
    ``dg = dy u silu'(g)``, in f32, rounded to g's and u's dtypes."""
    gf, dyf = g.float(), dy.float()
    s = torch.sigmoid(gf)
    du = dyf * (gf * s)
    dg = dyf * u.float() * (s * (1 + gf * (1 - s)))
    return dg.to(g.dtype), du.to(u.dtype)
