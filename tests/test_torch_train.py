"""The port's training path against the JAX package's, on the CPU.

Reduced ``hymba-1.5b`` (attention + SSM) and ``smollm-135m`` (tied
embeddings, attention only) in f32, the same weights in both packages (the
JAX ``Model.init`` pytree through ``convert.model_state_from_jax``),
batches from ``SyntheticTokenStream``.  On the CPU the port's kernels are
their plain versions, which autograd differentiates; the JAX side is
``jax.value_and_grad`` of ``Model.loss`` (its ``ops`` send every call to
the jnp references on the CPU).

Tolerances: the loss within 1e-5 (relative), every gradient leaf within
1e-4 of its largest entry (f32 sums in another order through a deep
backward pass), AdamW within 1e-6 of the largest entry of each state leaf
(one bf16 unit in the last place where a leaf is bf16: the same f32 value
on either side of a rounding boundary), three train steps' losses within
1e-4.  The JAX ``Trainer`` is not used (ROADMAP Queue 3 b); the port's
trainer tests mirror ``tests/test_substrate.py``'s.  Reduced
falcon-mamba-7b (the ``ssm`` kind, Mamba layers alone): its loss, every
gradient leaf (remat none/full/dots) and three steps from a JAX state
(AdamW's two JAX steps carried over by ``train_state_from_jax``).
hubert-xlarge
(frame classification, non-causal) runs at reduced width but its head dim
80, the one the card trains it at, on frames and labels drawn with numpy
(neither package's stream draws frames, reference fault h): its gradients
and three steps from a JAX state.  deepseek-v3's
training cut on the card (its dense MLA layer and the MTP block) runs at
reduced width but MLA's head dims, so every attention call is (hd, hd_v)
= (192, 128), through the attention Function (``ops.force("cuda")``, the
kernels' launches, the fused AdamW's too, on their plain versions): the
loss, every gradient leaf and two AdamW steps against JAX, each call's
backward route and the step's launches as the smoke run expects them.
Last, reference fault g: ``jax.grad`` cannot differentiate the JAX
package's Pallas kernels.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_config as jreduce_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokenStream as JStream  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import sharding  # noqa: E402
from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                                 _flatten)
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import (model_state_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenStream  # noqa: E402
from repro_torch.kernels import adamw as kadamw  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.step import batch_to, build_train_step  # noqa: E402

ARCHS = ["hymba-1.5b", "smollm-135m"]
# the ``ssm`` kind: Mamba layers alone (the oracle's scan is its jnp path,
# which ``jax.grad`` differentiates; Queue 3 g)
SSM = "falcon-mamba-7b"


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """A ``Trainer`` run earlier in this worker leaves a mesh active in
    the JAX package; the reference model must run without one."""
    monkeypatch.setattr(sharding, "_ACTIVE_MESH", None)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _pair(arch: str, remat: str = "none", seed: int = 0, **kw):
    """The reduced f32 config in both packages, the JAX model and params
    (numpy leaves), and the port's model holding the same weights with
    gradients on."""
    jcfg = jreduce_config(jget_config(arch)).with_(dtype="float32",
                                                   remat=remat, **kw)
    cfg = reduce_config(get_config(arch)).with_(dtype="float32", remat=remat,
                                                **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_jax(cfg, params), strict=True)
    return cfg, jm, params, model.requires_grad_(True)


def _batches(cfg, n: int, B: int = 2, S: int = 16, seed: int = 0,
             step: int = 0):
    stream = JStream(cfg, JDataConfig(B, S, seed), step=step)
    return [stream.next_batch() for _ in range(n)]


def _gap(got, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, dtype=np.float32) - want).max()
                 / scale)


# hubert's head dim, which the card's attention kernels take at (80, 80)
HUBERT_HD = 80


def _frame_batches(cfg, n: int, B: int = 2, S: int = 16, seed: int = 4):
    """``n`` batches of frames (B, S, d_model) f32 and labels (B, S) int32
    drawn with numpy: the pipelines of both packages cannot draw frames
    (reference fault h)."""
    rng = np.random.default_rng(seed)
    return [{"frames": rng.standard_normal((B, S, cfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _one_device_mesh():
    sharding.set_active_mesh(jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("arch", ARCHS + ["hubert-xlarge", "olmoe-1b-7b",
                                          "deepseek-v3-671b", SSM])
def test_model_loss_matches_jax(arch):
    """The loss and its metrics: next-token cross-entropy (hymba, smollm),
    frame classification (hubert, non-causal), the router aux term
    (olmoe, deepseek: the slot path, which JAX runs under a one-device
    mesh) and the MTP term (deepseek)."""
    cfg, jm, params, model = _pair(arch)
    if cfg.frame_input:     # the pipeline cannot draw frames (fault h)
        batch = _frame_batches(cfg, 1)[0]
    else:
        batch = _batches(cfg, 1)[0]
    moe = bool(cfg.n_experts)
    if moe:
        _one_device_mesh()
    try:
        jloss, jmet = jax.jit(jm.loss)(params, jax.tree.map(jnp.asarray,
                                                            batch))
    finally:
        sharding._ACTIVE_MESH = None
    loss, met = model.loss(batch_to(batch, "cpu"))
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    if moe:
        assert float(met["aux"].detach()) > 0


# ------------------------------------------------------------- gradients
MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + ["hubert-xlarge",
                                                     SSM])
def test_gradients_match_jax(arch, remat):
    """Every gradient leaf against ``jax.grad`` of the JAX loss, with the
    layers recomputed in the backward pass or not; the MoE models through
    the slot path (the grouped matmul's gradient), which JAX runs under a
    one-device mesh; hubert (frame classification, non-causal) at head dim
    80 on numpy-drawn frames."""
    if arch == "hubert-xlarge":
        cfg, jm, params, model = _pair(arch, remat, head_dim=HUBERT_HD)
        assert cfg.hd == HUBERT_HD and cfg.frame_input
        batch = _frame_batches(cfg, 1, seed=3)[0]
    else:
        cfg, jm, params, model = _pair(arch, remat)
        batch = _batches(cfg, 1, seed=3)[0]
    if cfg.n_experts:
        _one_device_mesh()
    try:
        jgrads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
            params, jax.tree.map(jnp.asarray, batch))
    finally:
        sharding._ACTIVE_MESH = None
    want = model_state_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    loss, _ = model.loss(batch_to(batch, "cpu"))
    loss.backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        if got[name].grad is None:    # unread by the loss: hubert's embed
            assert cfg.frame_input and name == "embed", name
            assert not g.numpy().any(), name
            continue
        assert _gap(_np(got[name].grad), g.numpy()) <= 1e-4, name


def test_remat_recomputes_and_keeps_serving_gradient_free():
    """With remat the forward of every layer runs again in the backward
    pass; a serving model has no parameter that requires grad."""
    cfg = reduce_config(get_config("hymba-1.5b")).with_(dtype="float32")
    model = Model(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    calls = []
    orig = Model._block

    def counting(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)
    batch = batch_to(_batches(cfg, 1)[0], "cpu")
    for remat, want in (("none", 1), ("full", 2)):
        m = Model(cfg.with_(remat=remat), device="cpu").requires_grad_(True)
        Model._block = counting
        try:
            calls.clear()
            m.loss(batch)[0].backward()
        finally:
            Model._block = orig
        assert len(calls) == want * cfg.n_layers, remat
    with torch.no_grad():                 # no gradient: no recompute
        model.loss(batch)


# ----------------------------------------------------------------- adamw
def _jax_tree(params_np: dict):
    return {k: jnp.asarray(v) for k, v in params_np.items()}


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_matches_jax(compress):
    """Three updates from the same gradients, warm-up over two steps and
    the global-norm clip active: params, master, m, v and the metrics."""
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "b": (5,), "e": (4, 3)}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    jp = _jax_tree(p_np)
    jp["e"] = jp["e"].astype(jnp.bfloat16)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5,
                compress_moments=compress)
    jcfg, cfg = jadamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    jstate = jadamw.init_state(jcfg, jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    tp["e"] = tp["e"].to(torch.bfloat16)
    tstate = adamw.init_state(cfg, tp)
    for _ in range(3):
        g_np = {k: (3 * rng.standard_normal(s)).astype(np.float32)
                for k, s in shapes.items()}
        jp, jstate, jmet = jadamw.apply_updates(jcfg, jstate,
                                                _jax_tree(g_np), jp)
        tmet = adamw.apply_updates(cfg, tstate,
                                   {k: torch.from_numpy(v)
                                    for k, v in g_np.items()}, tp)
        assert float(jmet["grad_norm"]) > cfg.clip_norm      # clipped
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"])
        pairs = [(tp[k], jp[k]) for k in shapes]
        for part in ("master", "m", "v"):
            pairs += [(tstate[part][k], jstate[part][k]) for k in shapes]
        for got, want in pairs:
            w = np.asarray(want).astype(np.float32)
            tol = 1e-6 * np.abs(w).max()
            if got.dtype == torch.bfloat16:     # one unit in the last place
                tol += 2.0 ** -8 * np.abs(w).max()
            assert np.abs(_np(got) - w).max() <= tol
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                            weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_state(cfg, params)
    for _ in range(150):
        adamw.apply_updates(cfg, state, {"w": 2 * state["master"]["w"]},
                            params)
    assert float(params["w"].abs().max()) < 0.1


# --------------------------------------------------- steps against JAX
def _jax_step(jm, jcfg):
    def step(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jm.loss(p, batch), has_aux=True)(params)
        params, opt, _ = jadamw.apply_updates(jcfg, opt, grads, params)
        return params, opt, loss
    return jax.jit(step)


@pytest.mark.parametrize("arch", ARCHS + ["olmoe-1b-7b", "hubert-xlarge",
                                          SSM])
def test_three_steps_from_a_jax_state_track_jax(arch):
    """JAX trains two steps; its state (parameters and AdamW's step,
    master, m, v) crosses over with ``train_state_from_jax``, and both
    packages take three more steps on the same batches (olmoe's JAX steps
    under a one-device mesh, as its slot path needs; hubert at head dim
    80 on the same numpy-drawn frames, which neither stream draws)."""
    frames = arch == "hubert-xlarge"
    cfg, jm, params, _ = _pair(arch, **(
        {"head_dim": HUBERT_HD} if frames else {}))
    if cfg.n_experts:
        _one_device_mesh()
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jcfg = jadamw.AdamWConfig(**ocfg)
    step = _jax_step(jm, jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    opt = jadamw.init_state(jcfg, jp)
    batches = (_frame_batches(cfg, 5, seed=1) if frames
               else _batches(cfg, 5, seed=1))
    for b in batches[:2]:
        jp, opt, _ = step(jp, opt, jax.tree.map(jnp.asarray, b))
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                 jax.tree.map(np.asarray, opt))
    assert int(state["opt"]["step"]) == 2
    ts = build_train_step(cfg, adamw.AdamWConfig(**ocfg), device="cpu")
    port_stream = SyntheticTokenStream(cfg, DataConfig(2, 16, 1), step=2)
    for b in batches[2:]:
        jp, opt, jloss = step(jp, opt, jax.tree.map(jnp.asarray, b))
        pb = b if frames else port_stream.next_batch()
        assert all(np.array_equal(pb[k], b[k]) for k in b)
        state, met = ts.step_fn(state, batch_to(pb, "cpu"))
        np.testing.assert_allclose(float(met["loss"]), float(jloss),
                                   rtol=1e-4)
    assert int(state["opt"]["step"]) == 5


# ------------------------------------ MLA training: the card's depth cut
def _mla_cut_pair(remat: str = "full"):
    """deepseek-v3-671b cut as the smoke run trains it -- one dense MLA
    layer and the MTP block, no MoE layer -- at reduced width with MLA's
    head dims (nope 128, rope 64, v 128), f32, in both packages: the
    configs, the JAX model and its params (numpy leaves)."""
    from repro.models.config import Segment as JSegment
    from repro_torch.models.config import Segment
    dims = dict(dtype="float32", remat=remat, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128)
    jcfg = jreduce_config(jget_config("deepseek-v3-671b")).with_(
        segments=(JSegment("dense", 1, attn="mla"),), **dims)
    cfg = reduce_config(get_config("deepseek-v3-671b")).with_(
        segments=(Segment("dense", 1, attn="mla"),), **dims)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.mtp_depth == 1
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return cfg, jm, params


def plain_adamw_launch(g, m, v, master, p, scalars, consts) -> None:
    """The fused AdamW kernel's launch as its plain version: the per-leaf
    update of ``optim.adamw`` with the wrapper's constants and the step's
    scalars read from their device tensor."""
    b1, _, b2, _, eps, wd = consts
    adamw.update_leaf(adamw.AdamWConfig(b1=b1, b2=b2, eps=eps,
                                        weight_decay=wd),
                      g, m, v, master, p, *scalars.unbind())


def _outs(outs, values) -> None:
    for out, value in zip(outs, values):
        out.copy_(value)


def _plain_conv_launch(u, w, b, state_in, y, state_out, chunk):
    got, new = ref.causal_conv_ref(u, w, b, state_in)
    _outs((y, state_out), (got, new))


# the fused elementwise kernels' launches as their plain versions, each
# writing the outputs the wrapper allocated
PLAIN_FUSED = {
    "_launch_rmsnorm": lambda x2, w, y2, eps: y2.copy_(
        ref.rmsnorm_ref(x2, w, eps)),
    "_launch_rmsnorm_bwd": lambda x2, w, dy2, dx2, dw, part, plan, eps:
        _outs((dx2, dw), ref.rmsnorm_bwd_ref(x2, w, dy2, eps)),
    "_launch_rope": lambda x, pos, theta, out, negate: out.copy_(
        ref.rope_ref(x, pos, theta, negate)),
    "_launch_conv": _plain_conv_launch,
    "_launch_conv_bwd": lambda u, w, b, dy, du, dw, db, part, plan:
        _outs((du, dw, db), ref.causal_conv_bwd_ref(u, w, b, dy)),
    "_launch_gate": lambda g2, u2, y2: y2.copy_(ref.silu_gate_ref(g2, u2)),
    "_launch_gate_bwd": lambda g2, u2, dy2, dg2, du2:
        _outs((dg2, du2), ref.silu_gate_bwd_ref(g2, u2, dy2)),
}


@pytest.fixture
def plain_attention(monkeypatch):
    """``ops.force("cuda")`` with the attention forward and backward
    launches, the fused elementwise kernels' launches and the fused AdamW
    launch on their plain versions (CPU tensors): the attention Function
    and its routes, the elementwise ops' Functions and the optimizer's
    wrapper run as on the card, and the forward counts as the kernel's
    wrapper does.  Records each backward launch's route, head dims and
    whether it was handed the forward's LSE."""
    seen = []

    def forward(q, k, v, *, causal, window, scale, return_lse=False,
                q_pos=None, k_pos=None, q_off=0):
        assert q_pos is None and k_pos is None
        B, Sq, H, hd = q.shape
        which = fa.route(q.dtype, B, Sq, k.shape[1], H, k.shape[2], hd,
                         v.shape[3], window, False, return_lse, q_off)
        ops.launches["attention_masked" if window else
                     "flash_attention"] += 1
        ops.route_launches[which] += 1
        o = ref.attention_ref(q, k, v, causal=causal, window=window,
                              scale=scale, q_off=q_off)
        if return_lse:
            return o, ref.attention_lse_ref(q, k, causal=causal,
                                            window=window, scale=scale,
                                            q_off=q_off)
        return o

    def bwd_launch(which, q, k, v, o, do, lse, causal, window, scale,
                    q_off=0):
        seen.append((which, tuple(q.shape[-1:]) + tuple(v.shape[-1:]),
                     lse is not None))
        return ref.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                     window=window, scale=scale, lse=lse,
                                     q_off=q_off)

    monkeypatch.setattr(fa, "flash_attention", forward)
    monkeypatch.setattr(fa, "_bwd_launch", bwd_launch)
    monkeypatch.setattr(kadamw, "_launch", plain_adamw_launch)
    for name, launch in PLAIN_FUSED.items():
        monkeypatch.setattr(fused, name, launch)
    ops.force("cuda")
    ops.reset_launches()
    yield seen
    ops.force(None)
    ops.reset_launches()


def test_mla_training_cut_loss_and_gradients_match_jax(plain_attention):
    """The loss (with its MTP term) and every gradient leaf of the cut,
    remat "full", against ``jax.grad``; per step 3 attention forwards (the
    dense layer's and its recompute, the MTP block's, which is not
    recomputed) and 2 backward calls, both at (192, 128) on ``general``
    (f32), each handed the forward's LSE; the fused elementwise kernels'
    calls likewise."""
    cfg, jm, params = _mla_cut_pair()
    batch = _batches(cfg, 1, seed=5)[0]
    jb = jax.tree.map(jnp.asarray, batch)
    jloss, jmet = jax.jit(jm.loss)(params, jb)
    jgrads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(params, jb)
    want = model_state_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_jax(cfg, params), strict=True)
    model.requires_grad_(True)
    loss, met = model.loss(batch_to(batch, "cpu"))
    loss.backward()
    assert set(met) == set(jmet) and "mtp_ce" in met
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name].grad is not None, name
        assert _gap(_np(got[name].grad), g.numpy()) <= 1e-4, name
    assert plain_attention == [("general", (192, 128), True)] * 2
    # the fused elementwise kernels: the dense layer's four norms (two of
    # them MLA's q_ln and kv_ln), two ropes and gate twice, the MTP
    # block's once with its own norm, the final norm before each head; one
    # backward each
    assert {c: n for c, n in ops.launches.items() if n} == {
        "flash_attention": 3, "attention_bwd": 2, "rmsnorm": 15,
        "rmsnorm_bwd": 11, "rope": 6, "rope_bwd": 4, "silu_gate": 3,
        "silu_gate_bwd": 2}
    assert {c: n for c, n in ops.route_launches.items() if n} == {
        "general": 3}
    assert {c: n for c, n in ops.bwd_route_launches.items() if n} == {
        "attention_general": 2}


def test_mla_training_cut_two_adamw_steps_track_jax(plain_attention):
    """Two AdamW steps of the cut through ``train.step`` from the JAX
    model's initial state, against JAX's on the same batches: each step's
    loss (1e-4 relative), the parameters after both (at most 1e-3 of them
    more than lr / 10 apart: a first AdamW step moves each parameter by
    about lr times its gradient's sign, which the two packages share but
    where a gradient is near 0), and a third batch's loss at them."""
    cfg, jm, params = _mla_cut_pair()
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jcfg = jadamw.AdamWConfig(**ocfg)
    step = _jax_step(jm, jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    opt = jadamw.init_state(jcfg, jp)
    state = train_state_from_jax(cfg, params,
                                 jax.tree.map(np.asarray, opt))
    ts = build_train_step(cfg, adamw.AdamWConfig(**ocfg), device="cpu")
    batches = _batches(cfg, 3, seed=2)
    for b in batches[:2]:
        jp, opt, jloss = step(jp, opt, jax.tree.map(jnp.asarray, b))
        state, met = ts.step_fn(state, batch_to(b, "cpu"))
        np.testing.assert_allclose(float(met["loss"]), float(jloss),
                                   rtol=1e-4)
    assert int(state["opt"]["step"]) == 2
    want = model_state_from_jax(cfg, jax.tree.map(np.asarray, jp))
    off = total = 0
    for name, w in want.items():
        d = np.abs(_np(state["params"][name]) - w.numpy())
        off += int((d > ocfg["lr"] / 10).sum())
        total += d.size
    assert off <= 1e-3 * total, (off, total)
    jloss, _ = jax.jit(jm.loss)(jp, jax.tree.map(jnp.asarray, batches[2]))
    with torch.no_grad():
        loss, _ = ts.model.loss(batch_to(batches[2], "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert [s[0] for s in plain_attention] == ["general"] * 4
    assert ops.launches["adamw"] == 2 * len(state["params"])


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b",
                                  "llama-3.2-vision-11b"])
def test_data_batches_bit_equal(arch):
    """Tokens, labels and stub image embeddings are bit-equal to the
    reference's, step after step and after a restore."""
    cfg = reduce_config(get_config(arch))
    jcfg = jreduce_config(jget_config(arch))
    a = SyntheticTokenStream(cfg, DataConfig(3, 24, 5))
    b = JStream(jcfg, JDataConfig(3, 24, 5))
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    c = SyntheticTokenStream(cfg, DataConfig(3, 24, 5))
    c.restore({"step": 2})
    b2 = JStream(jcfg, JDataConfig(3, 24, 5), step=2).next_batch()
    c2 = c.next_batch()
    assert all(np.array_equal(c2[k], b2[k]) for k in b2)


def test_frame_batches_fail_as_the_reference_does():
    """Reference fault h (ROADMAP Queue 3): for a frame-input config the
    pipeline reshapes B * (S + 1) hashes into (B, S, 4) frames, so every
    draw raises; the port's copy keeps the reference's behaviour."""
    cfg = reduce_config(get_config("hubert-xlarge"))
    jcfg = jreduce_config(jget_config("hubert-xlarge"))
    for stream in (SyntheticTokenStream(cfg, DataConfig(2, 16)),
                   JStream(jcfg, JDataConfig(2, 16))):
        with pytest.raises(ValueError, match="cannot reshape"):
            stream.next_batch()


# ------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.randn(4).to(torch.bfloat16),
                  torch.zeros((), dtype=torch.int32)]}
    for step in (1, 2, 3):
        ck.save(step, tree, extra={"step": step, "data": {"step": step}})
    assert ck.latest_step() == 3
    assert not (pathlib.Path(tmp_path) / "step_00000001").exists()
    like = {"a": torch.empty(2, 3), "b": [torch.empty(4, dtype=torch.bfloat16),
                                          torch.empty((), dtype=torch.int32)]}
    restored, extra = ck.restore(3, like)
    assert extra["step"] == 3
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"][0].dtype == torch.bfloat16
    assert torch.equal(restored["b"][0], tree["b"][0])     # bits kept
    assert restored["b"][1].dtype == torch.int32


def test_checkpoint_async_copies_before_returning(tmp_path):
    """The state is copied to the host inside ``save_async``: an in-place
    update right after it does not reach the checkpoint."""
    ck = Checkpointer(tmp_path, keep=3)
    w = torch.ones((64, 64))
    ck.save_async(5, {"w": w}, extra={"step": 5, "data": {"step": 5}})
    w.add_(1.0)                          # the optimizer's in-place step
    ck.wait()
    assert ck.latest_step() == 5
    assert not list(pathlib.Path(tmp_path).glob("*.tmp"))
    restored, _ = ck.restore(5, {"w": w})
    assert bool((restored["w"] == 1).all())


# --------------------------------------------------------------- trainer
def _small(layers: int = 1):
    return reduce_config(get_config("smollm-135m"), layers_per_segment=layers)


def test_trainer_loss_decreases(tmp_path):
    tcfg = TrainerConfig(steps=12, ckpt_every=6, ckpt_dir=str(tmp_path),
                         log_every=100)
    tr = Trainer(_small(2), DataConfig(4, 32), tcfg,
                 adamw.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=12),
                 device="cpu")
    _, hist = tr.run()
    assert len(hist) == 12
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_trainer_restart_after_failure(tmp_path):
    boom = {"armed": True}

    def failure_hook(step):
        if step == 8 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected chip failure")

    tcfg = TrainerConfig(steps=10, ckpt_every=4, ckpt_dir=str(tmp_path),
                         max_failures=2, log_every=100)
    tr = Trainer(_small(), DataConfig(2, 16), tcfg,
                 adamw.AdamWConfig(lr=1e-3, total_steps=10),
                 device="cpu", failure_hook=failure_hook)
    _, hist = tr.run()
    assert not boom["armed"]
    steps = [h["step"] for h in hist]
    assert steps[-1] == 9 and 8 in steps
    assert 0 not in steps[steps.index(8):]


def test_trainer_resume_from_disk_is_byte_identical(tmp_path):
    """A new trainer resumes from the last checkpoint; its steps and final
    state equal those of one uninterrupted run bit for bit."""
    dc, ocfg = DataConfig(2, 16), adamw.AdamWConfig(total_steps=12)

    def trainer(steps, d):
        return Trainer(_small(), dc, TrainerConfig(
            steps=steps, ckpt_every=3, ckpt_dir=str(d), log_every=100),
            ocfg, device="cpu")
    whole, whole_hist = trainer(10, tmp_path / "a").run()
    trainer(6, tmp_path / "b").run()
    resumed, hist = trainer(10, tmp_path / "b").run()
    assert hist[0]["step"] == 6
    assert [h["loss"] for h in hist] == [h["loss"] for h in whole_hist[6:]]
    for part in ("params", "opt"):
        flat_a = _flatten(whole[part])
        flat_b = _flatten(resumed[part])
        assert [n for n, _ in flat_a] == [n for n, _ in flat_b]
        for (n, a), (_, b) in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and torch.equal(a, b), n


def test_straggler_detection(tmp_path):
    tr = Trainer(_small(), DataConfig(2, 16),
                 TrainerConfig(steps=1, ckpt_dir=str(tmp_path)),
                 adamw.AdamWConfig(), device="cpu")
    tr.step_times = [0.1] * 10
    tr._watch_straggler(0.5, 11)      # 5x the median
    assert tr.stragglers == 1
    tr._watch_straggler(0.11, 12)
    assert tr.stragglers == 1


def test_launch_train_on_the_cpu(tmp_path):
    hist = launch_train.main(["--arch", "hymba-1.5b", "--reduced",
                              "--device", "cpu", "--steps", "3", "--batch",
                              "2", "--seq", "16", "--ckpt-dir",
                              str(tmp_path)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_train_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(_small(), adamw.AdamWConfig())


# ------------------------------------------- reference fault g (pinned)
def test_reference_cannot_differentiate_its_pallas_kernels():
    """ROADMAP Queue 3 g: ``jax.grad`` through the JAX package's Pallas
    attention and scan (interpret mode, as its tests run them on the CPU)
    raises: ``repro`` defines no ``custom_vjp`` around its kernels, so its
    training path cannot take a gradient where ``ops`` picks Pallas."""
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.mamba_scan import mamba_scan
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((1, 16, 2, 16)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((1, 16, 1, 16)), jnp.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda q: flash_attention(q, k, k, interpret=True).sum())(q)
    u = jnp.asarray(rng.standard_normal((1, 8, 4)), jnp.float32)
    Bc = jnp.asarray(rng.standard_normal((1, 8, 2)), jnp.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda u: mamba_scan(u, jnp.abs(u), -jnp.ones((4, 2)), Bc,
                                      Bc, jnp.ones(4),
                                      interpret=True)[0].sum())(u)
