"""The port's cross-attention and ``vision_group`` segment against the JAX
package's, on ``reduce_config("llama-3.2-vision-11b",
layers_per_segment=2)`` (two groups of one cross-attention and two
self-attention sub-layers, 8 image tokens, 4/2 heads of 16), on the CPU.

Both packages run the same weights: the JAX ``Model.init`` pytree, carried
across by ``repro_torch.convert.model_state_from_jax``; inputs are drawn
with numpy.  A fresh model's gates are zero, and ``tanh(0) = 0`` hides
every cross-attention output, so each test sets the gates to nonzero
values, the same in both packages (in the numpy pytree, before either
package sees it).  The JAX side runs its jnp reference (``repro.kernels.ops``
on the CPU), the port its plain versions (CPU tensors).  Tolerances are
those of ``tests/test_torch_mla.py``: 1e-5 of the largest value in f32,
6e-2 in bf16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_config as jreduce_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import model_state_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import draw_batch, serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

ARCH = "llama-3.2-vision-11b"
DTYPES = ["float32", "bfloat16"]
B, S = 2, 12
GATES = (0.7, -0.45)           # one per group: |tanh| 0.60 and 0.42


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """A ``Trainer`` run earlier in this worker leaves a mesh active in
    the JAX package; the reference runs without one."""
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


def _pair(dtype: str, seed: int = 0):
    """The reduced config, the JAX model and its params with nonzero gates,
    and the port's model holding the same weights."""
    jcfg = jreduce_config(jget_config(ARCH), layers_per_segment=2).with_(
        dtype=dtype)
    cfg = reduce_config(get_config(ARCH), layers_per_segment=2).with_(
        dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = JModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    params["segments"][0]["cross"]["gate"] = np.asarray(GATES, np.float32)
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_state_from_jax(cfg, params), strict=True)
    return cfg, jm, params, model


def _inputs(cfg, n: int, seed: int):
    """Tokens (B, n) and image embeddings (B, N, D) f32, drawn with
    numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    img = rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model))
    return tokens, img.astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(dtype):
    cfg, jm, params, model = _pair(dtype)
    jp = jax.tree.map(lambda w: jnp.asarray(w[1]),
                      params["segments"][0]["cross"])
    tp = model.segments[0][1]["cross"]
    assert float(tp["gate"]) == np.float32(GATES[1])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    img = rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model))
    jx, tx = _both(x, dtype)
    jimg, timg = _both(img.astype(np.float32), dtype)
    want = JL.cross_attention(jp, jx, jimg, jm.cfg)
    with torch.no_grad():
        got = L.cross_attention(tp, tx, timg, cfg)
    assert got.dtype == tx.dtype
    assert np.abs(_np(want)).max() > 0           # the gate lets it through
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_converter_keys_shapes_and_dtypes_match_jax(dtype):
    """Every leaf of the JAX pytree becomes one tensor per group (per sub-
    layer for ``self``) with its shape, dtype (the gate f32) and bits, and
    the port's own init has the same keys, shapes and dtypes."""
    cfg, _, params, model = _pair(dtype)
    state = model_state_from_jax(cfg, params)
    own = Model(cfg, device="cpu").state_dict()
    assert sorted(state) == sorted(own)
    seg = cfg.segments[0]
    sub = seg.sub_layers - 1
    n_leaves = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            params["segments"][0])[0]:
        names = [k.key for k in path]
        for j in range(seg.n_layers):
            if names[0] == "self":
                pairs = [(f"segments.0.{j}.self.{k}." + ".".join(names[1:]),
                          leaf[j, k]) for k in range(sub)]
            else:
                pairs = [(f"segments.0.{j}." + ".".join(names), leaf[j])]
            for key, want in pairs:
                n_leaves += 1
                for got in (state[key], own[key]):
                    assert tuple(got.shape) == want.shape, key
                    assert str(got.dtype).removeprefix("torch.") == \
                        want.dtype.name, key
                assert np.array_equal(_np(state[key]), _np(want)), key
    assert n_leaves == len(state) - 3           # embed, final_ln, lm_head
    for j in range(seg.n_layers):
        gate = own[f"segments.0.{j}.cross.gate"]
        assert gate.dtype == torch.float32 and gate.shape == ()
        assert float(gate) == 0.0 and float(state[
            f"segments.0.{j}.cross.gate"]) == np.float32(GATES[j])


def test_converter_rejects_misshapen_self_leaves():
    cfg, _, params, _ = _pair("float32")
    params["segments"][0]["self"]["ln1"] = params["segments"][0]["self"][
        "ln1"][:, :1]
    with pytest.raises(ValueError, match=r"self\.ln1 .*not \(2, 2, \.\.\.\)"):
        model_state_from_jax(cfg, params)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype):
    """``forward`` (image embeddings cast to the model dtype) and
    ``logits_fn``: hidden states and logits."""
    cfg, jm, params, model = _pair(dtype, seed=1)
    tokens, img = _inputs(cfg, S, 2)
    jx, _ = jm.forward(params, {"tokens": jnp.asarray(tokens),
                                "image_embeds": jnp.asarray(img)})
    want = jm.logits_fn(params, jx)
    with torch.no_grad():
        x, aux = model({"tokens": torch.from_numpy(tokens),
                        "image_embeds": torch.from_numpy(img)})
        got = model.logits_fn(x)
    assert x.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(x, jx, dtype)
    assert got.shape == (B, S, cfg.vocab)
    _close(got, want, dtype)


def _clone(caches):
    """A copy of the caches as they stand (decode writes them in place)."""
    return tree_map(torch.clone, caches)


def _check_caches(tcaches, jcaches, cfg, dtype):
    (seg,) = cfg.segments
    (tseg,), (jseg,) = tcaches, jcaches
    assert len(tseg) == seg.n_layers
    for j, tc in enumerate(tseg):
        assert sorted(tc) == ["cross", "self"]
        for name in ("ck", "cv"):
            assert tuple(tc["cross"][name].shape) == (
                B, cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd)
            _close(tc["cross"][name], jseg["cross"][name][j], dtype)
        assert len(tc["self"]) == seg.sub_layers - 1
        for k, sc in enumerate(tc["self"]):
            assert sorted(sc) == ["k", "v"]
            for name in ("k", "v"):
                _close(sc[name], jseg["self"][name][j, k], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_jax(dtype):
    """Prefill (logits, the image keys and values, every sub-layer's k/v
    cache) and three teacher-forced decode steps (logits and caches)."""
    cfg, jm, params, model = _pair(dtype, seed=2)
    tokens, img = _inputs(cfg, S + 3, 3)
    max_len = S + 4
    jlogits, jcaches = jax.jit(lambda p, t, i: jm.prefill(
        p, {"tokens": t, "image_embeds": i}, max_len))(
        params, jnp.asarray(tokens[:, :S]), jnp.asarray(img))
    jsteps, jseen = [jlogits], [jcaches]
    for i in range(3):
        jstep, jcaches = jax.jit(lambda p, t, c, i=i: jm.decode_step(
            p, t, c, jnp.int32(S + i)))(
            params, jnp.asarray(tokens[:, S + i:S + i + 1]), jcaches)
        jsteps.append(jstep)
        jseen.append(jcaches)
    with torch.no_grad():
        logits, caches = model.prefill(
            {"tokens": torch.from_numpy(tokens[:, :S]),
             "image_embeds": torch.from_numpy(img)}, max_len)
        steps, seen = [logits], [_clone(caches)]
        cross = caches[0][0]["cross"]
        for i in range(3):
            logits, new = model.decode_step(
                torch.from_numpy(tokens[:, S + i:S + i + 1]), caches, S + i)
            assert new is caches                       # written in place
            steps.append(logits)
            seen.append(_clone(caches))
            # the image keys and values are carried, not rewritten
            assert caches[0][0]["cross"] is cross
            for name in ("ck", "cv"):
                assert torch.equal(cross[name], seen[0][0][0]["cross"][name])
    for got, want in zip(steps, jsteps):
        assert got.shape == (B, 1, cfg.vocab) and got.dtype == torch.float32
        _close(got, want, dtype)
    for got, want in zip(seen, jseen):
        _check_caches(got, want, cfg, dtype)


def _gated_model(dtype: str, seed: int) -> Model:
    cfg = reduce_config(get_config(ARCH), layers_per_segment=2).with_(
        dtype=dtype)
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for lp, g in zip(model.segments[0], GATES):
            lp["cross"]["gate"].fill_(g)
    return model


def test_decode_matches_forward():
    """Prefill then decode equals the teacher-forced forward (the port
    alone, f32, nonzero gates)."""
    model = _gated_model("float32", 3)
    cfg = model.cfg
    n = 16
    tokens, img = (torch.from_numpy(a) for a in _inputs(cfg, n, 11))
    with torch.no_grad():
        full = model.logits_fn(model({"tokens": tokens,
                                      "image_embeds": img})[0])
        last, caches = model.prefill({"tokens": tokens[:, :n - 1],
                                      "image_embeds": img}, n + 2)
        step, _ = model.decode_step(tokens[:, n - 1:], caches, n - 1)
        # without the image the logits differ: cross-attention counts
        bare = model.logits_fn(model({"tokens": tokens, "image_embeds":
                                      torch.zeros_like(img)})[0])
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, n - 2].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, n - 1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert (bare - full).abs().max() > 1e-2 * full.abs().max()


def test_serve_image_embeds_match_jax_launcher():
    """``draw_batch`` draws what the JAX launcher draws for the same seed:
    the prompts, then the stub image embeddings (f64 normals to f32), and
    both models' casts to bf16 give the same bits."""
    cfg = reduce_config(get_config(ARCH))
    for seed in (0, 5):
        got = draw_batch(cfg, np.random.default_rng(seed), 3, 7)
        rng = np.random.default_rng(seed)          # the JAX launcher's order
        prompts = rng.integers(0, cfg.vocab, (3, 7)).astype(np.int32)
        img = jnp.asarray(rng.normal(size=(3, cfg.n_image_tokens,
                                           cfg.d_model)), jnp.float32)
        assert np.array_equal(got["tokens"], prompts)
        assert got["image_embeds"].dtype == np.float32
        assert np.array_equal(got["image_embeds"], np.asarray(img))
        ours = torch.from_numpy(got["image_embeds"]).to(torch.bfloat16)
        theirs = np.asarray(img.astype(jnp.bfloat16)).view(np.uint16)
        assert np.array_equal(ours.view(torch.int16).numpy().view(np.uint16),
                              theirs)
    assert "image_embeds" not in draw_batch(
        reduce_config(get_config("smollm-135m")),
        np.random.default_rng(0), 2, 4)


def test_serve_on_cpu_reduced_vision():
    """``serve`` takes the vision model with its stub image embeddings:
    greedy tokens in range, equal from equal seeds, apart from another
    seed's, and no kernel launch on the CPU."""
    cfg = reduce_config(get_config(ARCH), layers_per_segment=2)
    a = serve(cfg, 2, 20, 4, device="cpu", seed=3)
    b = serve(cfg, 2, 20, 4, device="cpu", seed=3)
    assert a.tokens.shape == (2, 4)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()
    assert np.array_equal(a.tokens, b.tokens)
    assert a.prefill_s > 0 and a.decode_s > 0
    assert set(a.launches) == set(ops.launches)
    assert not any(a.launches.values())


def test_vision_parameter_count():
    """The port holds every parameter of the JAX ``Model.init`` at the
    full config: 9,775,157,256.  ``param_count`` (a copy of the JAX one)
    prices each group's cross sub-layer with two norms too many (the group
    has no outer ``ln1``/``ln2``): 8 x 2 x 4096 more."""
    full = get_config(ARCH)
    model = Model(full, device="meta", generator=torch.Generator())
    ours = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(JModel(jget_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    theirs = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert ours == theirs == 9_775_157_256
    assert full.param_count() == jget_config(ARCH).param_count() \
        == 9_775_222_792 == ours + 8 * 2 * full.d_model
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["segments.0.7.cross.gate"] == torch.float32
    assert dtypes["segments.0.7.self.3.attn.wq"] == torch.bfloat16
    assert "segments.0.7.self.4.ln1" not in dtypes


def test_vision_model_needs_image_embeds():
    model = _gated_model("float32", 4)
    tokens, _ = _inputs(model.cfg, 6, 12)
    with pytest.raises(ValueError, match="image_embeds"):
        model.prefill({"tokens": torch.from_numpy(tokens)}, 8)
