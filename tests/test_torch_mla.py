"""The port's multi-head latent attention (MLA) and multi-token prediction
(MTP) against the JAX package's, on ``reduce_config("deepseek-v3-671b")``
(one dense and one MoE layer, both MLA, MTP depth 1), on the CPU.

Both packages run the same weights: the JAX ``Model.init`` pytree, carried
across by ``repro_torch.convert.model_state_from_jax``; inputs are drawn
with numpy.  The JAX side runs its jnp reference (``repro.kernels.ops`` on
the CPU), the port its plain versions (CPU tensors).  Tolerances are those
of ``tests/test_torch_model.py``: 1e-5 of the largest value in f32 (the
algorithms are the same), 6e-2 in bf16 (the frameworks round at other
places).  The MoE layer serves through the slot paths, which the JAX
package runs only under a mesh: the model's prefill and decode steps are
held against the JAX ``Model`` under a one-device mesh, its dense forward
against the JAX forward without one.
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
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import model_state_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import Segment  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH = "deepseek-v3-671b"
DTYPES = ["float32", "bfloat16"]
B, S = 2, 12


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """A ``Trainer`` run earlier in this worker leaves a mesh active in
    the JAX package; the reference runs without one unless a test sets
    it."""
    monkeypatch.setattr(sharding, "_ACTIVE_MESH", None)


def _tol(dtype: str) -> float:
    return 1e-5 if dtype == "float32" else 6e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(got, want, dtype: str) -> None:
    """Within the dtype's tolerance of the largest |want| (elementwise
    too in f32)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = _tol(dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _pair(dtype: str, seed: int = 0, **kw):
    """The reduced config in both packages, the JAX model and params, and
    the port's model holding the same weights."""
    jcfg = jreduce_config(jget_config(ARCH)).with_(dtype=dtype, **kw)
    cfg = reduce_config(get_config(ARCH)).with_(dtype=dtype, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_jax(cfg, params), strict=True)
    return cfg, jm, params, model


def _attn_weights(params, model, seg: int = 1):
    """One MLA layer's weights: the JAX dict (first layer of segment
    ``seg``) and the port's."""
    jp = jax.tree.map(lambda w: jnp.asarray(w[0]),
                      params["segments"][seg]["attn"])
    return jp, model.segments[seg][0]["attn"]


def _hidden(cfg, n: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((B, n, cfg.d_model))
    return x.astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    """``x`` as a JAX array and a tensor, both in ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attention_matches_jax(dtype):
    cfg, jm, params, model = _pair(dtype)
    jp, tp = _attn_weights(params, model)
    seg = cfg.segments[1]
    jx, tx = _both(_hidden(cfg, S, 1), dtype)
    want = JL.mla_attention(jp, jx, jm.cfg, seg)
    with torch.no_grad():
        got = L.mla_attention(tp, tx, cfg, seg)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_prefill_cache_matches_jax(dtype):
    cfg, jm, params, model = _pair(dtype)
    jp, tp = _attn_weights(params, model)
    jx, tx = _both(_hidden(cfg, S, 2), dtype)
    max_len = S + 5
    want = JL.mla_prefill_cache(jp, jx, jm.cfg, max_len)
    with torch.no_grad():
        got = L.mla_prefill_cache(tp, tx, cfg, max_len)
    assert sorted(got) == sorted(want) == ["ckv", "kr"]
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name][:, S:].any()        # zero past the prompt
        _close(got[name], want[name], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("absorb", [True, False])
def test_mla_attention_decode_matches_jax(absorb, dtype):
    """One decode step at position S on a cache prefilled from S tokens,
    absorbed (latent-space) and naive: the output and the new cache."""
    cfg, jm, params, model = _pair(dtype)
    jp, tp = _attn_weights(params, model)
    jx, tx = _both(_hidden(cfg, S, 3), dtype)
    jn, tn = _both(_hidden(cfg, 1, 4), dtype)
    max_len = S + 4
    jcache = JL.mla_prefill_cache(jp, jx, jm.cfg, max_len)
    want, jnew = JL.mla_attention_decode(jp, jn, jm.cfg, jcache,
                                         jnp.int32(S), absorb=absorb)
    with torch.no_grad():
        cache = L.mla_prefill_cache(tp, tx, cfg, max_len)
        before = {k: v.clone() for k, v in cache.items()}
        got, new = L.mla_attention_decode(tp, tn, cfg, cache, S,
                                          absorb=absorb)
    assert got.shape == (B, 1, cfg.d_model) and got.dtype == tn.dtype
    _close(got, want, dtype)
    for name in ("ckv", "kr"):
        _close(new[name], jnew[name], dtype)
        assert new[name] is cache[name]                 # written in place
        assert torch.equal(cache[name][:, :S], before[name][:, :S])


def _one_device_mesh():
    sharding.set_active_mesh(jax.make_mesh(
        (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))


def _check_caches(tcaches, jcaches, cfg, dtype):
    assert len(tcaches) == len(jcaches) == len(cfg.segments)
    for seg, tseg, jseg in zip(cfg.segments, tcaches, jcaches):
        assert len(tseg) == seg.n_layers
        for j, tc in enumerate(tseg):
            assert sorted(tc) == sorted(jseg) == ["ckv", "kr"]
            for name in tc:
                _close(tc[name], jseg[name][j], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("absorb", [True, False])
def test_deepseek_prefill_and_decode_match_jax(absorb, dtype):
    """The whole model: prefill (MoE on the a2a slot path) and three
    teacher-forced decode steps (tp slot path), logits and caches, against
    the JAX model on a one-device mesh."""
    cfg, jm, params, model = _pair(dtype, mla_absorb=absorb)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S + 3)).astype(np.int32)
    max_len = S + 4
    _one_device_mesh()
    try:
        jlogits, jcaches = jax.jit(lambda p, t: jm.prefill(
            p, {"tokens": t}, max_len))(params, jnp.asarray(tokens[:, :S]))
        jsteps = [jlogits]
        for i in range(3):
            jstep, jcaches = jax.jit(lambda p, t, c, i=i: jm.decode_step(
                p, t, c, jnp.int32(S + i)))(
                params, jnp.asarray(tokens[:, S + i:S + i + 1]), jcaches)
            jsteps.append(jstep)
    finally:
        sharding._ACTIVE_MESH = None
    with torch.no_grad():
        logits, caches = model.prefill(
            {"tokens": torch.from_numpy(tokens[:, :S])}, max_len)
        steps = [logits]
        for i in range(3):
            logits, caches = model.decode_step(
                torch.from_numpy(tokens[:, S + i:S + i + 1]), caches, S + i)
            steps.append(logits)
    for got, want in zip(steps, jsteps):
        assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.float32
        _close(got, want, dtype)
    _check_caches(caches, jcaches, cfg, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_forward_logits_match_jax(dtype):
    """``forward`` (dense MoE reference) then ``logits_fn`` against the JAX
    model without a mesh, and the router aux loss."""
    cfg, jm, params, model = _pair(dtype, seed=1)
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    jx, jaux = jm.forward(params, {"tokens": jnp.asarray(tokens)})
    want = jm.logits_fn(params, jx)
    with torch.no_grad():
        x, aux = model({"tokens": torch.from_numpy(tokens)}, mode="dense")
        got = model.logits_fn(x)
    assert got.shape == (B, S, cfg.vocab)
    _close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mtp_loss_matches_jax(dtype):
    """``_mtp_loss`` on the same final hidden states and tokens: the MTP
    projection, its one-layer MLA block and the shifted cross-entropy."""
    cfg, jm, params, model = _pair(dtype, seed=2)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jx, tx = _both(_hidden(cfg, S, 10), dtype)
    want = jm._mtp_loss(params, jx, {"tokens": jnp.asarray(tokens),
                                     "labels": jnp.asarray(labels)})
    with torch.no_grad():
        got = model._mtp_loss(tx, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)})
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=_tol(dtype))


@pytest.mark.parametrize("absorb", [True, False])
def test_mla_decode_matches_forward(absorb):
    """Prefill then decode equals the teacher-forced forward (the port
    alone, f32), on two dense MLA layers: the MoE slot paths drop choices
    past their capacity, which the forward's dense reference does not."""
    cfg = reduce_config(get_config(ARCH)).with_(
        dtype="float32", mla_absorb=absorb,
        segments=(Segment("dense", 2, attn="mla"),))
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    n = 16
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (B, n)).astype(np.int32))
    with torch.no_grad():
        full = model.logits_fn(model({"tokens": tokens})[0])
        last, caches = model.prefill({"tokens": tokens[:, :n - 1]}, n + 2)
        step, _ = model.decode_step(tokens[:, n - 1:], caches, n - 1)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, n - 2].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, n - 1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_converter_carries_mla_and_mtp_bit_exact():
    cfg, _, params, model = _pair("bfloat16")
    state = model.state_dict()
    jattn = params["segments"][1]["attn"]
    for name in ("wq_a", "q_ln", "wq_b", "wkv_a", "kv_ln", "wkv_b",
                 "mla_wo"):
        got, want = state[f"segments.1.0.attn.{name}"], jattn[name][0]
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
        assert np.array_equal(_np(got), _np(want))
    mtp = params["mtp"][0]
    for name in ("proj", "ln"):
        assert np.array_equal(_np(state[f"mtp.0.{name}"]), _np(mtp[name]))
    assert np.array_equal(_np(state["mtp.0.block.attn.wkv_b"]),
                          _np(mtp["block"]["attn"]["wkv_b"][0]))
    assert state["mtp.0.block.attn.q_ln"].dtype == torch.float32


def test_deepseek_parameter_count():
    """The port holds every parameter of the JAX ``Model.init``, whose MTP
    block has the last segment's (MLA) attention; the config's
    ``param_count`` (a copy of the JAX one) counts that block with GQA
    attention instead.  The smoke's cut of the full model (3 dense + 2 MoE
    layers, MTP 1) has 27,304,638,464 parameters."""
    cfg = reduce_config(get_config(ARCH))
    model = Model(cfg, device="cpu")
    gap = cfg._attn_params("mla") - cfg._attn_params("gqa")
    assert sum(p.numel() for p in model.parameters()) == (
        cfg.param_count() + cfg.mtp_depth * gap)
    full = get_config(ARCH)
    cut = full.with_(segments=tuple(
        dataclasses.replace(s, n_layers=n)
        for s, n in zip(full.segments, (3, 2))))
    assert cut.param_count() + full._attn_params("mla") - \
        full._attn_params("gqa") == 27_304_638_464


def test_serve_on_cpu_reduced_deepseek():
    """``serve`` takes deepseek-v3 as the smoke builds it (the registry
    config with its segments cut; here reduced, with deepseek's own MLA
    head dims): greedy tokens in range, equal from equal seeds, no kernel
    launch on the CPU."""
    cfg = reduce_config(get_config(ARCH)).with_(
        d_model=256, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, q_lora_rank=96, kv_lora_rank=64,
        segments=(Segment("dense", 2, attn="mla"),
                  Segment("moe", 1, attn="mla")))
    a = serve(cfg, 2, 20, 4, device="cpu", seed=3)
    b = serve(cfg, 2, 20, 4, device="cpu", seed=3)
    assert a.tokens.shape == (2, 4)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()
    assert np.array_equal(a.tokens, b.tokens)
    assert set(a.launches) == set(ops.launches)
    assert not any(a.launches.values())
