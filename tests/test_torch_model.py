"""The port's serving model (``repro_torch.models``) against the JAX
package's ``Model`` on reduced configs, on the CPU.

Both run the same weights: the JAX ``Model.init`` pytree, carried across by
``repro_torch.convert.model_state_from_jax``.  In f32, prefill logits,
every layer's cache, one decode step and its caches agree within 1e-5:
the algorithms are the same.  In bf16 the two frameworks round at other
places (JAX's ``silu`` of a bf16 tensor differs from PyTorch's by one ulp
in 39 % of the elements, ``softplus`` in 16 %), and the one-ulp steps
(2^-8) compound over the layers, so bf16 holds the logits of prefill and
of the decode step within 6e-2 of the largest logit: the looser of the
bf16 tolerances of ``tests/test_models_smoke.py`` (the worst measured here
is 2.2 %, reduced hymba).  Then the port's own checks: decode matches a
teacher-forced forward, and the serve loop.

The MoE model (reduced olmoe) serves through the slot paths, which the
JAX package runs only under a mesh: its prefill and decode step are held
against the JAX ``Model`` under a one-device mesh with Auto axes, its
``forward(mode="dense")`` against the JAX forward without a mesh (the
dense reference), and its router trace id for id.
"""
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
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import model_state_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCHS = ["hymba-1.5b", "falcon-mamba-7b", "smollm-135m"]
B = 2


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """A ``Trainer`` run earlier in this worker leaves a mesh active in
    the JAX package; the reference model must run without one."""
    monkeypatch.setattr(sharding, "_ACTIVE_MESH", None)


def _to_np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _pair(arch: str, dtype: str, seed: int = 0):
    """The reduced config in both packages, the JAX model and params, and
    the port's model holding the same weights."""
    jcfg = jreduce_config(jget_config(arch)).with_(dtype=dtype)
    cfg = reduce_config(get_config(arch)).with_(dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_jax(cfg, params), strict=True)
    return cfg, jm, params, model


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _to_np(want), rtol=tol, atol=tol)


def _window_order(ring: torch.Tensor, last: int) -> torch.Tensor:
    """A sliding window's ring (position p at row p mod W, ``last`` the
    newest) in the JAX package's shifted order (the newest last)."""
    return torch.roll(ring, -((last + 1) % ring.shape[1]), dims=1)


def _check_caches(tcaches, jcaches, cfg, tol, last=None):
    """``last``: the newest position written, which orders a window's
    ring as the JAX package's shifted window."""
    assert len(tcaches) == len(jcaches) == len(cfg.segments)
    for seg, tseg, jseg in zip(cfg.segments, tcaches, jcaches):
        assert len(tseg) == seg.n_layers
        for j, tc in enumerate(tseg):
            names = sorted(tc)
            assert names == sorted(jseg)
            for name in names:
                if name == "mamba":
                    for part in ("conv", "ssm"):
                        _close(tc["mamba"][part], jseg["mamba"][part][j], tol)
                elif seg.sliding_window:
                    _close(_window_order(tc[name], last), jseg[name][j], tol)
                else:
                    _close(tc[name], jseg[name][j], tol)


def _check_logits(got, want, dtype):
    want = _to_np(want)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(_np(got) - want).max()
        assert err <= 6e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,S", [(a, 20) for a in ARCHS]
                         + [("hymba-1.5b", 10)])
def test_prefill_and_decode_match_jax(arch, S, dtype):
    """hymba's reduced window is 16: S = 20 fills the ring cache, S = 10
    leaves it left-padded (k_pos < 0 in decode)."""
    cfg, jm, params, model = _pair(arch, dtype)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    max_len = S + 4
    jlogits, jcaches = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                                       max_len))(
        params, jnp.asarray(tokens[:, :S]))
    with torch.no_grad():
        logits, caches = model.prefill(
            {"tokens": torch.from_numpy(tokens[:, :S])}, max_len)
    assert logits.shape == (B, 1, cfg.vocab) and logits.dtype == torch.float32
    _check_logits(logits, jlogits, dtype)
    if dtype == "float32":
        _check_caches(caches, jcaches, cfg, 1e-5, last=S - 1)

    jstep, jnew = jax.jit(lambda p, t, c: jm.decode_step(
        p, t, c, jnp.int32(S)))(params, jnp.asarray(tokens[:, S:]), jcaches)
    with torch.no_grad():
        step, new = model.decode_step(torch.from_numpy(tokens[:, S:]),
                                      caches, S)
    assert new is caches                       # written in place
    _check_logits(step, jstep, dtype)
    if dtype == "float32":
        _check_caches(new, jnew, cfg, 1e-5, last=S)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Greedy decode over the same tokens equals teacher-forced logits
    (the port alone, as ``test_models_smoke.test_decode_matches_prefill``
    checks the JAX model)."""
    S = 32
    cfg = reduce_config(get_config(arch))
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        x, aux = model({"tokens": tokens})
        full = model.logits_fn(x)
        last, caches = model.prefill({"tokens": tokens[:, :S - 1]}, S + 4)
        step, _ = model.decode_step(tokens[:, S - 1:], caches, S - 1)
    assert float(aux) == 0.0
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, S - 2].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, S - 1].numpy(),
                               rtol=6e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hubert_encoder_matches_jax(dtype):
    """hubert-xlarge, reduced (one non-causal layer of 4 heads of 16,
    d_model 64): ``forward`` then ``logits_fn`` over the same numpy frames
    (the feature extractor is a stub in both packages) against the JAX
    ``Model``, within 1e-5 of the largest logit in f32 and 6e-2 in bf16."""
    cfg, jm, params, model = _pair("hubert-xlarge", dtype)
    assert cfg.frame_input and not cfg.segments[0].causal
    S = 24
    frames = np.random.default_rng(8).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jx, _ = jm.forward(params, {"frames": jnp.asarray(frames)})
    want = _to_np(jm.logits_fn(params, jx))
    with torch.no_grad():
        x, aux = model({"frames": torch.from_numpy(frames)})
        got = model.logits_fn(x)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    tol = 1e-5 if dtype == "float32" else 6e-2
    err = np.abs(_np(got) - want).max()
    assert err <= tol * np.abs(want).max(), err


def test_converter_is_bit_exact_in_bf16():
    cfg, _, params, model = _pair("hymba-1.5b", "bfloat16")
    state = model.state_dict()
    want = params["segments"][1]["mamba"]["in_proj"][0]
    got = state["segments.1.0.mamba.in_proj"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))
    assert state["segments.0.0.mamba.A_log"].dtype == torch.float32
    assert np.array_equal(state["embed"].view(torch.int16).numpy(),
                          params["embed"].view(np.int16))


def test_port_init_has_the_reference_constants():
    cfg = reduce_config(get_config("hymba-1.5b"))
    model = Model(cfg, device="cpu")
    lp = model.segments[0][0]
    N = cfg.ssm_state
    assert torch.equal(lp["mamba"]["A_log"][3],
                       torch.log(torch.arange(1, N + 1, dtype=torch.float32)))
    for t in (lp["mamba"]["ssm_D"], lp["ln1"], lp["ln2"], model.final_ln):
        assert t.dtype == torch.float32 and bool((t == 1).all())
    for t in (lp["mamba"]["conv_b"], lp["mamba"]["dt_bias"]):
        assert t.dtype == torch.bfloat16 and bool((t == 0).all())
    assert lp["attn"]["wq"].dtype == torch.bfloat16
    assert hasattr(model, "lm_head")                  # hymba: no tied head
    assert not any(p.requires_grad for p in model.parameters())


def test_serve_on_cpu_reduced_hymba():
    cfg = reduce_config(get_config("hymba-1.5b"))
    a = serve(cfg, 2, 20, 4, device="cpu", seed=3)
    b = serve(cfg, 2, 20, 4, device="cpu", seed=3)
    assert a.tokens.shape == (2, 4)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()
    assert np.array_equal(a.tokens, b.tokens)
    assert a.prefill_s > 0 and a.decode_s > 0
    assert set(a.launches) == set(ops.launches)
    assert not any(a.launches.values())               # CPU: plain versions


def test_unknown_segment_kind_raises():
    """Every registry model builds; a segment kind the JAX model does not
    have raises ``ValueError``."""
    cfg = reduce_config(get_config("smollm-135m"))
    bad = cfg.with_(segments=(dataclasses.replace(cfg.segments[0],
                                                  kind="conv"),))
    with pytest.raises(ValueError, match="unknown segment kind 'conv'"):
        Model(bad, device="cpu")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(reduce_config(get_config("smollm-135m")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(reduce_config(get_config("smollm-135m")), 1, 4, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_count(arch):
    """The port holds every parameter of the JAX ``Model.init``; the
    config's ``param_count`` (a copy of the JAX one) leaves out each Mamba
    layer's ``conv_b`` and ``dt_bias`` (ROADMAP Queue 3 c)."""
    cfg = reduce_config(get_config(arch))
    model = Model(cfg, device="cpu")
    n_ssm = sum(s.n_layers for s in cfg.segments
                if s.kind in ("mamba", "hybrid"))
    assert sum(p.numel() for p in model.parameters()) == (
        cfg.param_count() + 2 * cfg.d_inner * n_ssm)
    full = get_config("hymba-1.5b")
    assert full.param_count() + 2 * full.d_inner * full.n_layers == \
        1_662_161_600


# ---------------------------------------------------------------- MoE model
def _one_device_mesh():
    sharding.set_active_mesh(jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_olmoe_prefill_and_decode_match_jax_slot_path(dtype):
    """Prefill (a2a) and two decode steps (tp, capacity 1 per expert at
    B = 2: colliding choices drop) against the JAX model on a one-device
    mesh."""
    cfg, jm, params, model = _pair("olmoe-1b-7b", dtype)
    S = 16
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab, (B, S + 2)).astype(np.int32)
    max_len = S + 4
    _one_device_mesh()
    try:
        jlogits, jcaches = jax.jit(lambda p, t: jm.prefill(
            p, {"tokens": t}, max_len))(params, jnp.asarray(tokens[:, :S]))
        jsteps = []
        for i in range(2):
            jstep, jcaches = jax.jit(lambda p, t, c, i=i: jm.decode_step(
                p, t, c, jnp.int32(S + i)))(
                params, jnp.asarray(tokens[:, S + i:S + i + 1]), jcaches)
            jsteps.append(jstep)
    finally:
        sharding._ACTIVE_MESH = None
    with torch.no_grad():
        logits, caches = model.prefill(
            {"tokens": torch.from_numpy(tokens[:, :S])}, max_len)
        _check_logits(logits, jlogits, dtype)
        for i in range(2):
            step, caches = model.decode_step(
                torch.from_numpy(tokens[:, S + i:S + i + 1]), caches, S + i)
            _check_logits(step, jsteps[i], dtype)
    if dtype == "float32":
        _check_caches(caches, jcaches, cfg, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_olmoe_dense_forward_and_route_trace_match_jax(dtype):
    cfg, jm, params, model = _pair("olmoe-1b-7b", dtype, seed=2)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (B, 24)).astype(np.int32)
    jx, jaux = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    jtrace = jm.route_trace(params, {"tokens": jnp.asarray(tokens)})
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        x, aux = model(batch, mode="dense")
        trace = model.route_trace(batch)
    _check_logits(x, jx, dtype)
    np.testing.assert_allclose(float(aux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 6e-2)
    assert len(trace) == len(jtrace) == 1
    assert trace[0].shape == (1, B * 24, cfg.top_k)
    assert np.array_equal(trace[0].numpy(), np.asarray(jtrace[0]))


def test_converter_carries_the_moe_weights():
    cfg, _, params, model = _pair("olmoe-1b-7b", "bfloat16")
    state = model.state_dict()
    jmoe = params["segments"][0]["moe"]
    for name in ("router", "e_gate", "e_up", "e_down"):
        got = state[f"segments.0.0.moe.{name}"]
        want = jmoe[name][0]
        assert tuple(got.shape) == want.shape
        if name == "router":
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want)
        else:
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    assert not any(k.endswith("mlp.w_gate") for k in state)


def test_olmoe_parameter_count_and_default_plan():
    cfg = reduce_config(get_config("olmoe-1b-7b"))
    model = Model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert model.plan.n_shards == 1
    assert model.plan.slot_expert == (tuple(range(cfg.n_experts)),)
    full = get_config("olmoe-1b-7b")
    assert full.param_count() == 6_919_096_320     # 13.8 GB in bf16


@pytest.mark.parametrize("placement", ["replicated", "online"])
def test_serve_on_cpu_reduced_olmoe_with_placement(placement):
    cfg = reduce_config(get_config("olmoe-1b-7b"))
    a = serve(cfg, 2, 20, 4, device="cpu", seed=3, placement=placement,
              epochs=3)
    b = serve(cfg, 2, 20, 4, device="cpu", seed=3)
    assert np.array_equal(a.tokens, b.tokens)   # serving keeps one shard
    assert a.tokens.shape == (2, 4) and b.placement is None
    assert not any(a.launches.values())          # CPU: plain versions
    rep = a.placement
    assert rep["kind"] == placement and rep["n_shards"] == 2
    assert not any(rep["launches"].values())
    if placement == "replicated":
        assert rep["lambda_cost_repl"] <= rep["lambda_cost_no_repl"]
        assert rep["local_fraction_repl"] >= rep["local_fraction_no_repl"]
    else:
        assert [e["planned"] for e in rep["epochs"]] == [False, True, True]
        assert rep["commits"] == 0 and rep["migration_bytes"] == 0
