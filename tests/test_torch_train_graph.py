"""The training step as one captured step runs it, held on the CPU.

On one card the port's step is captured in a CUDA graph and replayed
(``train.step``), its loss's head multiplies bf16 by bf16 into f32
(``models.model._HeadProduct``) and AdamW is one fused kernel a leaf
(``kernels.adamw``).  What of that the CPU can hold:

(a) the head's Function (its plain version, which the CPU runs) against
    ``jax.vjp`` of the JAX package's einsum with
    ``preferred_element_type=f32`` on the same bf16 values.  The forward is
    held within f32 rounding of the sums' order (1e-5 of the largest
    logit: the products are exact in f32).  The backward is held within
    1e-2 of each gradient's largest entry: the port rounds the f32
    cotangent to bf16 once (as the TPU does at default precision, see the
    Function's docstring), which JAX on the CPU does not, and each
    gradient is then rounded to bf16 (half an ulp, 2^-9 relative) on both
    sides; the port's backward is pinned exactly to that arithmetic.  An
    f32 model's logits and gradients stay bit-equal to the f32 product.
(b) the fused update through its wrapper under ``ops.force("cuda")``, the
    launch on its plain version (``optim.adamw.update_leaf`` with the
    wrapper's constants and the scalars read from their device tensor):
    within 1e-6 of ``repro.optim.adamw.apply_updates`` (one bf16 ulp more
    where a leaf is bf16), f32 and bf16 moments, one launch a leaf a step;
    the wrapper's checks and its meta cost.
(c) no host reads: a step of reduced hymba, olmoe, deepseek-v3 (MLA +
    MTP) and hubert with ``Tensor.item``, ``tolist``, ``__bool__``,
    ``__float__``, ``__int__``, ``__index__`` and ``numpy`` made to raise,
    which a capture needs.
(d) three steps through the static-buffer step -- ``TrainStep`` in its
    captured form with the replay run eagerly (``_eager_graph``) -- from a
    JAX state, against JAX's jitted step (losses within 1e-4, as
    ``tests/test_torch_train.py``).
(e) the graph owns its state: a restored checkpoint is copied into the
    step's own tensors (their storage unchanged) and the step repeats bit
    for bit; ``init_state`` drops the graph; a batch of another shape
    raises; a trainer run with an injected failure ends as an
    uninterrupted one does, the capture after each start booked apart.

The captured step itself needs the card: ``tests/test_torch_cuda.py``
(``-k captured_train``).
"""
import contextlib
import dataclasses

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
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import (model_state_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.kernels import adamw as kadamw  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model, _HeadProduct  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.step import batch_to, build_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """A ``Trainer`` run earlier in this worker leaves a mesh active in
    the JAX package (reference fault b); the reference runs without one
    unless a case sets it."""
    monkeypatch.setattr(sharding, "_ACTIVE_MESH", None)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _gap(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class _EagerCaptured:
    """``ops.Captured`` as the CPU can run it: ``warm`` runs the step,
    ``record`` keeps it (running nothing) and returns one dict, which
    each call, the "replay", fills with the step's metrics."""
    pool_B = 0

    def __init__(self, device) -> None:
        self.graph = None

    def warm(self, fn):
        return fn()

    def record(self, fn):
        self.graph, self._static = fn, {}
        return self._static

    def __call__(self) -> None:
        self._static.update(self.graph())


def _eager_graph(ts, monkeypatch):
    """``ts`` in its captured form (static batch, the graph's own state,
    the capture booked apart) with the recording and its replay done
    eagerly (``_EagerCaptured``): the first step runs as it is, the
    "replay" runs the step on the graph's state and static batch."""
    ts.graph = True
    monkeypatch.setattr(ops, "Captured", _EagerCaptured)
    return ts


# --------------------------------------------------- (a) the head's product
def test_head_product_matches_jax_einsum_vjp():
    rng = np.random.default_rng(0)
    B, S, D, V = 2, 12, 64, 96
    xj = jnp.asarray(rng.standard_normal((B, S, D)), jnp.bfloat16)
    hj = jnp.asarray(0.05 * rng.standard_normal((D, V)), jnp.bfloat16)
    g = rng.standard_normal((B, S, V)).astype(np.float32)
    y, vjp = jax.vjp(lambda x, h: jnp.einsum(
        "bsd,dv->bsv", x, h, preferred_element_type=jnp.float32), xj, hj)
    dxj, dhj = vjp(jnp.asarray(g))
    x = torch.from_numpy(np.asarray(xj, np.float32)).bfloat16()
    h = torch.from_numpy(np.asarray(hj, np.float32)).bfloat16()
    x.requires_grad_(True)
    h.requires_grad_(True)
    out = _HeadProduct.apply(x.reshape(B * S, D), h).reshape(B, S, V)
    assert out.dtype == torch.float32
    assert _gap(_np(out), y) <= 1e-5
    gt = torch.from_numpy(g)
    out.backward(gt)
    assert x.grad.dtype == h.grad.dtype == torch.bfloat16
    assert _gap(_np(x.grad), np.asarray(dxj, np.float32)) <= 1e-2
    assert _gap(_np(h.grad), np.asarray(dhj, np.float32)) <= 1e-2
    # the arithmetic itself: the cotangent rounded to bf16 once, f32 sums
    g16 = gt.bfloat16().float().reshape(B * S, V)
    xf, hf = x.detach().float().reshape(B * S, D), h.detach().float()
    assert torch.equal(x.grad.reshape(B * S, D),
                       (g16 @ hf.T).bfloat16())
    assert torch.equal(h.grad, (xf.T @ g16).bfloat16())


@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b"])
def test_f32_model_head_is_the_f32_product(arch):
    """Tied (smollm) and untied (hymba): an f32 model's logits and the
    gradients of a loss on them are bit-equal to those of the f32
    product written out."""
    cfg = reduce_config(get_config(arch)).with_(dtype="float32")
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(
        3)).requires_grad_(True)
    head_name = "embed" if cfg.tie_embeddings else "lm_head"
    head_p = getattr(model, head_name)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = model.logits_fn(x1)
    got.square().sum().backward()
    g_head, g_x = head_p.grad.clone(), x1.grad
    head_p.grad = None
    head = head_p.T if cfg.tie_embeddings else head_p
    want = L.rmsnorm(x2, model.final_ln, cfg.norm_eps).float() \
        @ head.float()
    want.square().sum().backward()
    assert torch.equal(got, want)
    assert torch.equal(g_x, x2.grad) and torch.equal(g_head, head_p.grad)


def test_bf16_model_logits_are_the_product_of_its_values():
    """A bf16 model's head (the plain version on the CPU): the f32
    product of its bf16 values, no f32 copy saved."""
    cfg = reduce_config(get_config("hymba-1.5b"))
    assert cfg.dtype == "bfloat16"
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(
        3)).requires_grad_(True)
    x = torch.randn((2, 5, cfg.d_model)).bfloat16()
    got = model.logits_fn(x)
    want = L.rmsnorm(x, model.final_ln, cfg.norm_eps).float() \
        @ model.lm_head.float()
    assert torch.equal(got, want)
    head_fn = got.grad_fn.next_functions[0][0]        # under the reshape
    assert head_fn.name() == "_HeadProductBackward"
    assert [t.dtype for t in head_fn.saved_tensors] == [torch.bfloat16] * 2


# -------------------------------------------- (b) the fused AdamW update
def _plain_launch(g, m, v, master, p, scalars, consts) -> None:
    b1, _, b2, _, eps, wd = consts
    adamw.update_leaf(adamw.AdamWConfig(b1=b1, b2=b2, eps=eps,
                                        weight_decay=wd),
                      g, m, v, master, p, *scalars.unbind())


@pytest.fixture
def plain_adamw(monkeypatch):
    """``ops.force("cuda")`` with the fused kernel's launch on its plain
    version: the wrapper, its checks and its count run as on the card."""
    monkeypatch.setattr(kadamw, "_launch", _plain_launch)
    ops.force("cuda")
    ops.reset_launches()
    yield
    ops.force(None)
    ops.reset_launches()


@pytest.mark.parametrize("compress", [False, True])
def test_fused_adamw_matches_jax(plain_adamw, compress):
    """Three updates, warm-up over two steps and the clip active, a bf16
    leaf with a bf16 gradient among f32 ones: params, master, m, v and
    the metrics against the reference's, one launch a leaf a step."""
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "b": (5,), "e": (4, 3), "big": (1031,)}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jp["e"] = jp["e"].astype(jnp.bfloat16)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5,
                compress_moments=compress)
    jcfg, cfg = jadamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    jstate = jadamw.init_state(jcfg, jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    tp["e"] = tp["e"].to(torch.bfloat16)
    tstate = adamw.init_state(cfg, tp)
    for step in range(3):
        g_np = {k: (3 * rng.standard_normal(s)).astype(np.float32)
                for k, s in shapes.items()}
        jg = {k: jnp.asarray(v) for k, v in g_np.items()}
        jg["e"] = jg["e"].astype(jnp.bfloat16)
        tg = {k: torch.from_numpy(v) for k, v in g_np.items()}
        tg["e"] = tg["e"].to(torch.bfloat16)
        jp, jstate, jmet = jadamw.apply_updates(jcfg, jstate, jg, jp)
        tmet = adamw.apply_updates(cfg, tstate, tg, tp)
        assert ops.launches["adamw"] == (step + 1) * len(shapes)
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


def test_fused_adamw_equals_the_plain_loop(plain_adamw):
    """Through the wrapper, a view as the parameter (written through) and
    a gradient that is not contiguous: bit-equal to the plain loop."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    params = {"t": torch.randn(6, 8).T, "r": torch.randn(9).bfloat16()}
    assert not params["t"].is_contiguous()
    twins = {k: v.clone() for k, v in params.items()}
    states = [adamw.init_state(cfg, params), adamw.init_state(cfg, twins)]
    for _ in range(2):
        grads = {"t": torch.randn(6, 8).T, "r": torch.randn(9).bfloat16()}
        adamw.apply_updates(cfg, states[0], grads, params)
        ops.force(None)
        adamw.apply_updates(cfg, states[1], grads, twins)
        ops.force("cuda")
    assert ops.launches["adamw"] == 4
    for k in params:
        assert torch.equal(params[k], twins[k])
        for part in ("master", "m", "v"):
            assert torch.equal(states[0][part][k], states[1][part][k])


def test_fused_adamw_checks_and_meta_cost():
    n = 1000
    g = torch.empty(n, dtype=torch.bfloat16, device="meta")
    f32 = [torch.empty(n, device="meta") for _ in range(3)]
    p = torch.empty(n, dtype=torch.bfloat16, device="meta")
    sc = torch.empty(4, device="meta")
    ops.reset_meta_cost()
    kadamw.fused_update(g, *f32, p, sc, 0.9, 0.95, 1e-8, 0.1)
    assert ops.meta_calls["adamw"] == 1
    assert ops.meta_cost == {"flops": 0.0, "bytes": 28.0 * n}
    ops.reset_meta_cost()
    cpu = [torch.zeros(5) for _ in range(5)] + [torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kadamw.fused_update(*cpu, 0.9, 0.95, 1e-8, 0.1)
    bad = list(cpu)
    bad[2] = torch.zeros(5, dtype=torch.bfloat16)          # v must be f32
    with pytest.raises(ValueError, match="v must be"):
        kadamw.fused_update(*bad, 0.9, 0.95, 1e-8, 0.1)
    bad = list(cpu)
    bad[0] = torch.zeros(6)
    with pytest.raises(ValueError, match="shape"):
        kadamw.fused_update(*bad, 0.9, 0.95, 1e-8, 0.1)
    assert ops.launches["adamw"] == 0


# ------------------------------------------------------ (c) no host reads
_HOST_READS = ("item", "tolist", "__bool__", "__float__", "__int__",
               "__index__", "numpy")


@contextlib.contextmanager
def _no_host_reads():
    saved = {n: getattr(torch.Tensor, n) for n in _HOST_READS}

    def refuse(name):
        def read(self, *a, **k):
            raise AssertionError(f"Tensor.{name}: a host read in the step")
        return read
    try:
        for n in _HOST_READS:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "olmoe-1b-7b",
                                  "deepseek-v3-671b", "hubert-xlarge"])
def test_step_reads_nothing_back(arch):
    """A whole step -- loss, backward with remat "full", AdamW -- on the
    card's dtype (bf16) makes no device-to-host read and no host branch
    on a tensor's value."""
    cfg = reduce_config(get_config(arch)).with_(remat="full")
    ts = build_train_step(cfg, device="cpu")
    state = ts.init_state(0)
    rng = np.random.default_rng(0)
    if cfg.frame_input:
        batch = {"frames": rng.standard_normal((2, 16, cfg.d_model)).astype(
                     np.float32),
                 "labels": rng.integers(0, cfg.vocab, (2, 16)).astype(
                     np.int32)}
    else:
        tokens = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    batch = batch_to(batch, "cpu")
    with _no_host_reads():
        state, met = ts.step_fn(state, batch)
    assert np.isfinite(float(met["loss"]))
    assert int(state["opt"]["step"]) == 1
    if cfg.mtp_depth:
        assert "mtp_ce" in met


# --------------------------------- (d) the static-buffer step against JAX
def _jax_step(jm, jcfg):
    def step(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jm.loss(p, batch), has_aux=True)(params)
        params, opt, _ = jadamw.apply_updates(jcfg, opt, grads, params)
        return params, opt, loss
    return jax.jit(step)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "olmoe-1b-7b"])
def test_static_step_from_a_jax_state_tracks_jax(arch, monkeypatch):
    """JAX trains two steps; its state crosses over and both packages
    take three more on the same batches, the port's through the captured
    form of its step (olmoe's JAX steps under a one-device mesh)."""
    jcfg = jreduce_config(jget_config(arch)).with_(dtype="float32")
    cfg = reduce_config(get_config(arch)).with_(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if cfg.n_experts:
        sharding.set_active_mesh(jax.make_mesh(
            (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    jm = JModel(jcfg)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep = _jax_step(jm, jadamw.AdamWConfig(**ocfg))
    jp = jm.init(jax.random.PRNGKey(0))
    opt = jadamw.init_state(jadamw.AdamWConfig(**ocfg), jp)
    stream = JStream(jcfg, JDataConfig(2, 16, 1))
    batches = [stream.next_batch() for _ in range(5)]
    for b in batches[:2]:
        jp, opt, _ = jstep(jp, opt, jax.tree.map(jnp.asarray, b))
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                 jax.tree.map(np.asarray, opt))
    ts = _eager_graph(build_train_step(cfg, adamw.AdamWConfig(**ocfg),
                                       device="cpu"), monkeypatch)
    kinds, owned = [], None
    for b in batches[2:]:
        jp, opt, jloss = jstep(jp, opt, jax.tree.map(jnp.asarray, b))
        state, met = ts.step_fn(state, batch_to(b, "cpu"))
        kinds.append(ts.last_kind)
        owned = owned or state
        assert state["opt"] is owned["opt"]
        np.testing.assert_allclose(float(met["loss"]), float(jloss),
                                   rtol=1e-4)
    assert kinds == ["capture", "replay", "replay"]
    assert int(state["opt"]["step"]) == 5
    want = model_state_from_jax(cfg, jax.tree.map(np.asarray, jp))
    for name, w in want.items():
        assert _gap(_np(state["params"][name]), w.numpy()) <= 1e-3, name


# ----------------------------------------- (e) the graph owns its state
def _small(layers: int = 1):
    return reduce_config(get_config("smollm-135m"), layers_per_segment=layers)


def _tensors(state: dict) -> dict:
    out = {f"params/{n}": t for n, t in state["params"].items()}
    out["opt/step"] = state["opt"]["step"]
    for part in ("master", "m", "v"):
        out.update({f"{part}/{n}": t for n, t in state["opt"][part].items()})
    return out


def test_restored_state_is_copied_into_the_graph(tmp_path, monkeypatch):
    cfg = _small()
    ts = _eager_graph(build_train_step(
        cfg, adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=8),
        device="cpu"), monkeypatch)
    state = ts.init_state(0)
    stream = JStream(cfg, JDataConfig(2, 16, 3))
    batches = [batch_to(stream.next_batch(), "cpu") for _ in range(3)]
    for b in batches[:2]:
        state, _ = ts.step_fn(state, b)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state)
    ptrs = {k: t.data_ptr() for k, t in _tensors(state).items()}
    state, met = ts.step_fn(state, batches[2])
    loss3 = float(met["loss"])
    after3 = {k: t.clone() for k, t in _tensors(state).items()}
    restored, _ = ck.restore(2, state)
    mine = _tensors(state)
    assert not any(t is mine[k] for k, t in _tensors(restored).items())
    state, met = ts.step_fn(restored, batches[2])
    assert ts.last_kind == "replay"
    assert {k: t.data_ptr() for k, t in _tensors(state).items()} == ptrs
    assert float(met["loss"]) == loss3
    for k, t in _tensors(state).items():
        assert torch.equal(t, after3[k]), k
    with pytest.raises(ValueError, match="shapes"):
        ts.step_fn(state, {k: v[:, :8] for k, v in batches[0].items()})
    ts.init_state(1)
    assert ts._graph is None and ts._state is None
    state, _ = ts.step_fn(ts.init_state(1), batches[0])
    assert ts.last_kind == "capture"


def test_graph_only_on_one_card():
    with pytest.raises(ValueError, match="one CUDA card"):
        build_train_step(_small(), device="cpu", graph=True)
    assert build_train_step(_small(), device="cpu").mode == "eager"
    assert build_train_step(_small(), device="meta").mode == "eager"


def test_trainer_restart_with_a_captured_step(tmp_path, monkeypatch):
    """A failure at step 5 restores step 3's checkpoint and captures
    again; the run ends with the losses and state of an uninterrupted
    one, and each capture is booked apart from the replays."""
    boom = {"armed": True}

    def failure_hook(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected chip failure")

    def run(d, hook=None):
        tr = Trainer(_small(), DataConfig(2, 16), TrainerConfig(
            steps=8, ckpt_every=3, ckpt_dir=str(d), log_every=100),
            adamw.AdamWConfig(lr=1e-3, total_steps=8), device="cpu",
            failure_hook=hook)
        _eager_graph(tr.ts, monkeypatch)
        state, hist = tr.run()
        return tr, state, hist
    tr_a, whole, hist_a = run(tmp_path / "a")
    tr_b, state, hist_b = run(tmp_path / "b", failure_hook)
    assert not boom["armed"]
    assert [h["kind"] for h in hist_a] == ["capture"] + ["replay"] * 7
    assert [h["step"] for h in hist_b] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    assert [h["kind"] for h in hist_b][5] == "capture"
    assert len(tr_a.capture_times) == 1 and len(tr_b.capture_times) == 2
    assert len(tr_a.step_times) == 7 and len(tr_b.step_times) == 8
    assert [h["loss"] for h in hist_b[5:]] == [h["loss"]
                                               for h in hist_a[3:]]
    for k, t in _tensors(whole).items():
        assert torch.equal(t, _tensors(state)[k]), k
