"""The port's decode step as one captured step runs it -- caches written in
place, the position a tensor on the device, the serving head -- held to
the JAX package's ``decode_step`` under ``jax.jit`` with a traced ``pos``,
as its launcher runs it, on the CPU.

Both packages run the same weights (``convert.model_state_from_jax``) on
reduced configs: prefill, then 8 teacher-forced decode steps, each step's
logits within 1e-5 (f32) or 6e-2 (bf16) of the JAX step's largest logit
(the tolerances of ``tests/test_torch_model.py``).  Covered: hymba's
sliding window (16 rows) from a prompt shorter than it, from one longer,
and across the ring's wrap; falcon-mamba (the SSM state); olmoe on a plan
whose slots are not the identity (the JAX MoE path under a one-device
mesh); deepseek-v3's MLA in both decode forms; llama-vision with nonzero
gates.  Then the port alone: the caches keep their storage across steps,
an int ``pos`` and a 0-d tensor give bit-equal logits, the plan's lookup
tables are built once, ``GreedyStep`` equals the plain loop, and
``serve`` decodes eagerly on the CPU and under a gloo mesh (two ranks),
with the one-device tokens.  The captured step itself needs the card:
``tests/test_torch_cuda.py``.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import model_state_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.launch.serve import GreedyStep, serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import sharding as tshd  # noqa: E402

B = 2
STEPS = 8
GATES = (0.7, -0.45)           # llama-vision's two groups, |tanh| 0.60, 0.42


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """A ``Trainer`` run earlier in this worker leaves a mesh active in
    the JAX package; the reference runs without one unless a case sets
    it."""
    monkeypatch.setattr(sharding, "_ACTIVE_MESH", None)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _perm_plans(E: int):
    """A one-shard plan whose slot s holds expert (3 s + 1) mod E (E = 8:
    not the identity), in both packages."""
    slots = [[(3 * s + 1) % E for s in range(E)]]
    return (jmoe._finalize_plan(slots, E, 1, None, 1.25),
            moe._finalize_plan(slots, E, 1, None, 1.25))


# case -> (arch, prompt length, overrides); hymba's reduced window is 16
CASES = {
    "hymba-short-wrap": ("hymba-1.5b", 10, {}),    # S < W; wraps at 16
    "hymba-full": ("hymba-1.5b", 20, {}),          # S >= W
    "hymba-full-wrap": ("hymba-1.5b", 28, {}),     # wraps at 32
    "falcon-mamba": ("falcon-mamba-7b", 12, {}),
    "olmoe-perm-plan": ("olmoe-1b-7b", 12, {}),
    "deepseek-absorb": ("deepseek-v3-671b", 12, {"mla_absorb": True}),
    "deepseek-naive": ("deepseek-v3-671b", 12, {"mla_absorb": False}),
    "vision-gated": ("llama-3.2-vision-11b", 12, {}),
}


def _pair(arch: str, dtype: str, **kw):
    """The reduced config in both packages, the JAX model and params, and
    the port's model holding the same weights (llama-vision: 2 groups,
    ``GATES``; olmoe: ``_perm_plans``)."""
    lps = 2 if arch == "llama-3.2-vision-11b" else 1
    jcfg = jreduce_config(jget_config(arch), layers_per_segment=lps).with_(
        dtype=dtype, **kw)
    cfg = reduce_config(get_config(arch), layers_per_segment=lps).with_(
        dtype=dtype, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jplan = plan = None
    if cfg.n_experts:
        jplan, plan = _perm_plans(cfg.n_experts)
    jm = JModel(jcfg, plan=jplan)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if cfg.n_image_tokens:
        params["segments"][0]["cross"]["gate"] = np.asarray(GATES,
                                                            np.float32)
    model = Model(cfg, plan=plan, device="cpu")
    model.load_state_dict(model_state_from_jax(cfg, params), strict=True)
    return cfg, jm, params, model


def _inputs(cfg, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)}
    if cfg.n_image_tokens:
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jax_steps(cfg, jm, params, inputs, S: int, max_len: int) -> list:
    """JAX: prefill, then ``STEPS`` forced steps of the jitted
    ``decode_step``, ``pos`` a traced int32 (one compile)."""
    tokens = inputs["tokens"]
    batch = {k: jnp.asarray(v[:, :S] if k == "tokens" else v)
             for k, v in inputs.items()}
    if cfg.n_experts:        # the slot paths run under a mesh in JAX
        sharding.set_active_mesh(jax.make_mesh(
            (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    try:
        logits, caches = jax.jit(lambda p, b: jm.prefill(p, b, max_len))(
            params, batch)
        decode = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos))
        out = [logits]
        for i in range(STEPS):
            logits, caches = decode(params, jnp.asarray(
                tokens[:, S + i:S + i + 1]), caches, jnp.int32(S + i))
            out.append(logits)
    finally:
        sharding._ACTIVE_MESH = None
    return [_np(x) for x in out]


def _cache_ptrs(caches) -> list:
    return [t.data_ptr() for t in _tensors(caches)]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for name in sorted(tree):
            yield from _tensors(tree[name])
    else:
        for item in tree:
            yield from _tensors(item)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_jitted_jax(case, dtype):
    """Prefill and 8 forced steps, each with the position a 0-d int32
    tensor advanced in place, as ``GreedyStep`` holds it: every step's
    logits within the dtype's tolerance of the JAX step's largest logit;
    the caches written in place, their storage kept."""
    arch, S, kw = CASES[case]
    cfg, jm, params, model = _pair(arch, dtype, **kw)
    max_len = S + STEPS + 2
    inputs = _inputs(cfg, S + STEPS, 3)
    want = _jax_steps(cfg, jm, params, inputs, S, max_len)
    tokens = torch.from_numpy(inputs["tokens"])
    batch = {"tokens": tokens[:, :S]}
    if cfg.n_image_tokens:
        batch["image_embeds"] = torch.from_numpy(inputs["image_embeds"])
    pos = torch.tensor(S, dtype=torch.int32)
    with torch.inference_mode():
        logits, caches = model.prefill(batch, max_len)
        got = [logits]
        ptrs = _cache_ptrs(caches)
        for i in range(STEPS):
            logits, new = model.decode_step(tokens[:, S + i:S + i + 1],
                                            caches, pos)
            pos.add_(1)
            assert new is caches and _cache_ptrs(caches) == ptrs
            got.append(logits)
    tol = 1e-5 if dtype == "float32" else 6e-2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = float(np.abs(_np(g) - w).max())
        assert err <= tol * float(np.abs(w).max()), (i, err)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "deepseek-v3-671b",
                                  "llama-3.2-vision-11b"])
def test_int_and_tensor_pos_bit_equal(arch):
    """The same steps from the same prefill, ``pos`` a Python int or a
    0-d int32 tensor: bit-equal logits and caches."""
    cfg = reduce_config(get_config(arch))
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(2))
    inputs = _inputs(cfg, 20, 4)
    tokens = torch.from_numpy(inputs["tokens"])
    batch = {"tokens": tokens[:, :16]}
    if cfg.n_image_tokens:
        batch["image_embeds"] = torch.from_numpy(inputs["image_embeds"])
    runs = []
    for as_tensor in (False, True):
        with torch.inference_mode():
            _, caches = model.prefill(batch, 24)
            out = []
            for i in range(4):
                pos = torch.tensor(16 + i, dtype=torch.int32) \
                    if as_tensor else 16 + i
                out.append(model.decode_step(tokens[:, 16 + i:17 + i],
                                             caches, pos)[0])
        runs.append((torch.cat(out, dim=1), list(_tensors(caches))))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_plan_tables_built_once_per_plan():
    """The MoE decode reads its plan's lookup tables and slot gather from
    caches filled once per plan: no upload a step."""
    cfg = reduce_config(get_config("olmoe-1b-7b"))
    _, plan = _perm_plans(cfg.n_experts)
    model = Model(cfg, plan=plan, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(_inputs(cfg, 12, 5)["tokens"])
    moe._tables.cache_clear()
    moe._slot_gather.cache_clear()
    with torch.inference_mode():
        _, caches = model.prefill({"tokens": tokens[:, :8]}, 16)
        for i in range(4):
            model.decode_step(tokens[:, 8 + i:9 + i], caches, 8 + i)
    assert moe._tables.cache_info().misses == 1
    assert moe._tables.cache_info().hits == 4      # prefill's a2a + 4 steps
    assert moe._slot_gather.cache_info().misses == 1
    assert moe._slot_gather.cache_info().currsize == 1


@pytest.mark.parametrize("arch", ["hymba-1.5b", "olmoe-1b-7b"])
def test_serve_on_cpu_decodes_eagerly(arch):
    """``serve`` on the CPU runs ``GreedyStep`` eagerly: ``decode ==
    "eager"``, no capture, and the tokens of a plain greedy loop over
    ``decode_step`` from the same prefill."""
    cfg = reduce_config(get_config(arch))
    B_, S, G = 2, 20, 6
    res = serve(cfg, B_, S, G, device="cpu", seed=3)
    assert res.decode == "eager" and res.capture_s == 0.0
    assert res.tokens.shape == (B_, G)
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(3))
    if cfg.n_experts:
        model.place_slots_(model.plan)         # as serve holds the slots
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (B_, S))
    with torch.inference_mode():
        logits, caches = model.prefill(
            {"tokens": torch.from_numpy(prompts.astype(np.int32))}, S + G)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        want = [tok]
        for i in range(G - 1):
            logits, caches = model.decode_step(tok, caches, S + i)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            want.append(tok)
    assert np.array_equal(res.tokens, torch.cat(want, dim=1).numpy())


def test_greedy_step_load_and_refusals():
    """``GreedyStep.load`` puts a step back to a prefill's state in place
    (the same tokens again, the same storage); a captured step needs
    CUDA, and ``capture`` needs ``graph=True``."""
    cfg = reduce_config(get_config("hymba-1.5b"))
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    tokens = torch.from_numpy(_inputs(cfg, 12, 6)["tokens"])
    with torch.inference_mode():
        logits, caches0 = model.prefill({"tokens": tokens}, 20)
        tok0 = logits[:, -1].argmax(dim=-1, keepdim=True)
        caches = _clone(caches0)
        step = GreedyStep(model, tok0, caches, 12)
        ptrs = _cache_ptrs(caches)
        runs = []
        for _ in range(2):
            out = []
            for _ in range(5):
                step()
                out.append(step.token.clone())
            runs.append(torch.cat(out, dim=1))
            step.load(tok0, caches0, 12)
        assert int(step.pos) == 12 and _cache_ptrs(caches) == ptrs
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="CUDA"):
        GreedyStep(model, tok0, caches, 12, graph=True)
    with pytest.raises(RuntimeError, match="graph=True"):
        step.capture()


def _mesh_rank(rank: int, shape: tuple, arch: str, G: int):
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    with tshd.use_mesh(mesh):
        r = serve(reduce_config(get_config(arch)), 2, 20, G, device="cpu",
                  seed=5)
    return {"decode": r.decode, "tokens": r.tokens}


def test_mesh_serve_decodes_eagerly_with_one_device_tokens():
    """hymba (ring caches, SSM state) served by two gloo ranks of a (1, 2)
    mesh: each rank decodes eagerly and returns the one-device tokens."""
    arch, G = "hymba-1.5b", 6
    one = serve(reduce_config(get_config(arch)), 2, 20, G, device="cpu",
                seed=5)
    ranks = run_ranks(_mesh_rank, 2, (1, 2), arch, G, timeout=240)
    for r in ranks:
        assert r["decode"] == "eager"
        assert np.array_equal(r["tokens"], one.tokens)
