"""Tensor-parallel products under a mesh (``parallel.sharding.tp_split``)
on the CPU.

* ``tp_split`` as a table on the registry's full configs: the route of
  each family by the reference cost model's condition (hymba's 25 / 5
  heads at n = 2 and yi-34b's 56 / 8 at n = 16 stay gathered; a Mamba
  mixer splits where n divides d_inner, hymba's 3200 not at n = 3), and
  for every config at n = 2, 4 and 16 the leaves of each ``tp`` family
  held as the blocks its products read (``held_specs`` on an
  ``AbstractMesh``: ``param_spec``'s, the Mamba mixer's in channel
  blocks).
* One training step's loss and gradients of the reduced dense
  (deepseek-7b, two layers), MoE (olmoe-1b-7b: GQA attention beside the
  experts), MLA (deepseek-v3: MLA, the shared experts and the MTP block)
  and vision (llama-3.2-vision, nonzero gates) models in f32, on gloo
  worlds of (1, 2) and (2, 2) (``launch.mesh.run_ranks``), every family on
  route ``tp``: the loss within 1e-5 relative of the JAX package's
  one-device loss on the same numpy-seeded weights and batch (the MoE
  plans with capacity factor 8, so no choice is dropped on either side);
  each gradient, gathered, within 1e-5 of its leaf's largest entry against
  the port's own no-mesh gradients (a scalar leaf's within 1e-4 of
  itself: ``SCALAR_TOL``); every replicated leaf's gradient
  bit-equal on the model ranks of a data rank.
* The collectives of the dense step at (1, 2) (``CollectiveCounter``):
  no all-gather, and the all-reduces that the step makes, counted and
  sized: four a layer (the attention's and the MLP's psums and their
  backwards), five around the layers (the embedding's psum and its
  backward, the cross-entropy's max and its psum of two, and that psum's
  backward), and one psum of each replicated leaf's gradient over
  'model' (the batch axis, of one rank, takes none).  olmoe's gathered
  family is its router: one all-gather a layer, beside the one that puts
  the MoE output's sequence blocks together.
* The dry run (``launch.dryrun``) at (1, 2) on the meta device holds
  deepseek-7b's tp blocks: at the smoke run's cut (8 layers, full width)
  its per-rank parameter bytes are those that a gloo rank of (1, 2)
  holds, and the hand count of half of every split leaf; it counts
  all-reduces and no all-gather.

The JAX package's mesh path fails under jax 0.9.0 (ROADMAP Queue 3 b):
its loss is taken on one device, ``repro.parallel.sharding._ACTIVE_MESH``
reset first, under a one-device Auto mesh for the MoE kinds.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_config as jreduce_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduce_config  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.convert import model_state_from_jax  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import Segment  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.roofline.hlo import CollectiveCounter  # noqa: E402
from repro_torch.train.step import batch_to, build_train_step  # noqa: E402

TIMEOUT = 120
ARCHS = ["deepseek-7b", "olmoe-1b-7b", "deepseek-v3-671b",
         "llama-3.2-vision-11b"]
SHAPES = [(1, 2), (2, 2)]
GATES = (0.7, -0.45)        # the vision groups' gates: |tanh| 0.60, 0.42
B, S = 4, 16
LAYERS = {"deepseek-7b": 2}
# a scalar leaf (a vision gate) has one entry, its gradient the sum of
# every product of its sub-layer's output and that output's cotangent
# (B x S x D of them), which cancel to a thousandth of their size: the
# psum's other order of f32 sums moved it by 3.7e-5 of itself here
SCALAR_TOL = 1e-4


# ------------------------------------------------------------- the routes
G, T = "gathered", "tp"
ROUTE_CASES = [
    # (arch, n, routes of the embedding and head, of each segment)
    ("hymba-1.5b", 2, {"embed": G, "head": G},        # vocab 32001
     [{"gqa": G, "mamba": T, "mlp": T}] * 5),         # d_inner 3200
    ("hymba-1.5b", 3, {"embed": T, "head": T},        # 3 divides 32001,
     [{"gqa": G, "mamba": G, "mlp": G}] * 5),         # not 3200 or 5504
    ("deepseek-7b", 2, {"embed": T, "head": T}, [{"gqa": T, "mlp": T}]),
    ("olmoe-1b-7b", 2, {"embed": T, "head": T},
     [{"gqa": T, "router": G}]),
    ("yi-34b", 16, {"embed": T, "head": T}, [{"gqa": G, "mlp": T}]),
    ("deepseek-v3-671b", 16, {"embed": T, "head": T},
     [{"mla": T, "mlp": T}, {"mla": T, "router": G, "mlp": T}]),
    ("llama-3.2-vision-11b", 16, {"embed": T, "head": T},
     [{"gqa": G, "cross": G, "mlp": T}]),
    ("falcon-mamba-7b", 2, {"embed": T, "head": T}, [{"mamba": T}]),
    ("falcon-mamba-7b", 16, {"embed": T, "head": T}, [{"mamba": T}]),
    ("hubert-xlarge", 2, {"head": T}, [{"gqa": T, "mlp": T}]),
    ("smollm-135m", 2, {"embed": G, "head": G},       # dp_seq: whole
     [{"gqa": G, "mlp": G}]),
]


@pytest.mark.parametrize("arch, n, top, segs", ROUTE_CASES,
                         ids=[f"{c[0]}@{c[1]}" for c in ROUTE_CASES])
def test_tp_split_table(arch, n, top, segs):
    cfg = get_config(arch)
    assert shd.tp_split(cfg, None, n) == top
    assert [shd.tp_split(cfg, seg, n) for seg in cfg.segments] == segs


@functools.lru_cache(maxsize=None)
def _shapes(arch: str) -> dict:
    return {k: tuple(p.shape) for k, p in
            Model(get_config(arch), device="meta").named_parameters()}


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("arch", list_archs())
def test_tp_families_hold_their_blocks(arch, n):
    """Each leaf of a ``tp`` family is held as its block over 'model' on
    the dimension its product reads (``TP_DIMS``, in groups where
    ``TP_GROUPS`` says), on the full config."""
    cfg = get_config(arch)
    mesh = shd.AbstractMesh((1, n), ("data", "model"))
    shapes = _shapes(arch)
    specs = shd.held_specs(shapes, cfg, mesh)

    def check(prefix, family):
        for leaf, dim in shd.TP_DIMS[family].items():
            name = prefix + leaf
            assert specs[name] == shd.tp_spec(
                len(shapes[name]), dim, shd.TP_GROUPS.get(leaf, 1)), name

    for family, route in shd.tp_split(cfg, None, n).items():
        if route == T:
            check("", family)
    for i, seg in enumerate(cfg.segments):
        prefix = {"gqa": "attn.", "mla": "attn.", "mlp": "mlp.",
                  "cross": "cross.", "mamba": "mamba."}
        if seg.kind == "moe":
            prefix["mlp"] = "moe."
        if seg.kind == "vision_group":
            prefix = {"cross": "cross.", "mlp": "cross.mlp.",
                      "gqa": "self.0.attn."}
        for family, route in shd.tp_split(cfg, seg, n).items():
            if route == T:
                check(f"segments.{i}.0.{prefix[family]}", family)


# --------------------------------------------------- losses and gradients
def _cfgs(arch: str):
    layers = LAYERS.get(arch, 1)
    jcfg = jreduce_config(jget_config(arch), layers).with_(dtype="float32")
    cfg = reduce_config(get_config(arch), layers).with_(dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _plan(cfg, n: int):
    return (moe.round_robin_plan(cfg.n_experts, n, 8.0) if cfg.n_experts
            else None)


def _inputs(arch: str):
    """Weights in the JAX package's tree and shapes, drawn with numpy (a
    matrix's entries normal / sqrt(fan-in), a vector's 1 + normal / 10,
    the vision gates as ``GATES``), and a batch drawn with numpy."""
    cfg, jcfg = _cfgs(arch)
    rng = np.random.default_rng(11)

    def draw(leaf):
        shape = leaf.shape
        x = rng.normal(size=shape)
        x = x / np.sqrt(shape[-2]) if len(shape) >= 2 else 1 + x / 10
        return x.astype(np.float32)

    params = jax.tree.map(draw, jax.eval_shape(JModel(jcfg).init,
                                               jax.random.PRNGKey(0)))
    if cfg.n_image_tokens:
        params["segments"][0]["cross"]["gate"] = np.asarray(
            GATES[:cfg.segments[0].n_layers], np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_image_tokens:
        batch["image_embeds"] = rng.normal(
            size=(B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return params, batch


def _jax_loss(arch: str, params, batch) -> float:
    cfg, jcfg = _cfgs(arch)
    jm = JModel(jcfg, plan=(jmoe.round_robin_plan(cfg.n_experts, 1, 8.0)
                            if cfg.n_experts else None))
    jsharding._ACTIVE_MESH = None
    if cfg.n_experts:       # the slot path runs under a mesh there
        jsharding.set_active_mesh(jax.make_mesh(
            (1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2))
    try:
        loss, _ = jax.jit(jm.loss)(params, jax.tree.map(jnp.asarray, batch))
    finally:
        jsharding._ACTIVE_MESH = None
    return float(loss)


def _step(arch: str, state: dict, batch: dict, mesh) -> dict:
    """One step's loss and gradients of the port (this rank's under
    ``mesh``) from the full ``state`` (numpy), with the collectives and
    routes it took; the gradients gathered whole."""
    cfg, _ = _cfgs(arch)
    n = shd.axis_sizes(mesh)["model"] if mesh is not None else 1
    ts = build_train_step(cfg, mesh=mesh, plan=_plan(cfg, n), device="cpu")
    st = ts.init_state(0)
    held = ts.model.shardings()
    with torch.no_grad():
        for name, p in st["params"].items():
            full = torch.from_numpy(state[name])
            p.copy_(full if held[name] is None else held[name].local(full))
    shd.reset_tp_routes()
    cc = CollectiveCounter()
    with cc:
        params, metrics = ts.grads(st, ts.local_batch(batch_to(batch,
                                                               "cpu")))
    out = {"loss": float(metrics["loss"]), "coll": cc.result(),
           "routes": {k: dict(v) for k, v in shd.tp_route_launches.items()},
           "grads": {}, "replicated": []}
    with shd.use_mesh(mesh):
        for name, p in params.items():
            sh = held[name]
            out["grads"][name] = (p.grad if sh is None
                                  else sh.full(p.grad)).numpy()
            if mesh is not None and sh is None:
                out["replicated"].append(name)
        if mesh is not None:
            try:
                ts.model.prefill(batch_to(batch, "cpu"), S + 1)
            except RuntimeError as e:
                out["prefill_refused"] = str(e)
    return out


def _rank(rank, shape, cases):
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    return {"coord": tuple(mesh.get_coordinate()),
            "out": {arch: _step(arch, state, batch, mesh)
                    for arch, (state, batch) in cases.items()}}


@pytest.fixture(scope="module")
def runs():
    """The JAX losses and the port's no-mesh steps here, beside the port's
    worlds (spawned from threads, which wait on them)."""
    torch.set_num_threads(1)
    inputs, cases = {}, {}
    for arch in ARCHS:
        params, batch = inputs[arch] = _inputs(arch)
        cfg, _ = _cfgs(arch)
        cases[arch] = ({k: v.numpy() for k, v in
                        model_state_from_jax(cfg, params).items()}, batch)
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        worlds = {shape: pool.submit(run_ranks, _rank, shape[0] * shape[1],
                                     shape, cases, timeout=TIMEOUT)
                  for shape in SHAPES}
        want = {arch: _jax_loss(arch, *inputs[arch]) for arch in ARCHS}
        one = {arch: _step(arch, *cases[arch], None) for arch in ARCHS}
        got = {shape: f.result() for shape, f in worlds.items()}
    return want, one, got


def _gap(got, want) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_loss_matches_jax(runs, arch, shape):
    want, one, got = runs
    np.testing.assert_allclose(one[arch]["loss"], want[arch], rtol=1e-5)
    for r in got[shape]:
        np.testing.assert_allclose(r["out"][arch]["loss"], want[arch],
                                   rtol=1e-5)
        routes = r["out"][arch]["routes"]
        assert routes and all(
            c["gathered"] == 0 for f, c in routes.items()
            if f != "router"), routes
        assert "gather_dense_" in r["out"][arch]["prefill_refused"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_gradients_match_one_device(runs, arch, shape):
    _, one, got = runs
    ranks = got[shape]
    for r in ranks:
        grads = r["out"][arch]["grads"]
        assert grads.keys() == one[arch]["grads"].keys()
        for name, g in grads.items():
            want = one[arch]["grads"][name]
            assert g.shape == want.shape, name
            tol = 1e-5 if want.ndim else SCALAR_TOL
            assert _gap(g, want) <= tol, (name, _gap(g, want))
    # the replicated leaves' gradients: once, the same on every model rank
    # of a data rank (and, summed over 'data' too, on every rank)
    base = ranks[0]["out"][arch]
    assert base["replicated"]
    for r in ranks[1:]:
        for name in base["replicated"]:
            assert np.array_equal(r["out"][arch]["grads"][name],
                                  base["grads"][name]), name


def test_tp_collectives_of_the_dense_step(runs):
    """deepseek-7b at (1, 2): the all-reduces by count and bytes."""
    _, _, got = runs
    cfg, _ = _cfgs("deepseek-7b")
    L, D = cfg.n_layers, cfg.d_model
    rows = B * S                           # every rank holds every row
    act = rows * D * 4                     # one f32 psum of the stream
    xent = (B * (S - 1)) * 4               # the shifted targets' rows
    replicated = 2 * L + 1                 # ln1, ln2 a layer; final_ln
    for r in got[(1, 2)]:
        c = r["out"]["deepseek-7b"]["coll"]
        assert c["counts"]["all-gather"] == 0
        assert c["counts"]["reduce-scatter"] == 0
        assert c["counts"]["all-to-all"] == 0
        assert c["counts"]["all-reduce"] == 4 * L + 5 + replicated
        want = (4 * L * act + 2 * act + xent + 2 * 2 * xent
                + replicated * D * 4)
        assert c["per_kind_bytes"]["all-reduce"] == want
    for r in got[(1, 2)]:                  # olmoe: its router gathered
        cfg, _ = _cfgs("olmoe-1b-7b")
        c = r["out"]["olmoe-1b-7b"]
        assert c["routes"]["router"] == {"tp": 0, "gathered": cfg.n_layers}
        assert c["coll"]["counts"]["all-gather"] == 2 * cfg.n_layers


# ------------------------------------------------------------ the dry run
DRY_LAYERS = 8


def _held_bytes_rank(rank, layers):
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    cfg = get_config("deepseek-7b").with_(
        segments=(Segment("dense", layers),))
    with shd.use_mesh(mesh):
        model = Model(cfg, device="meta")
    return sum(p.numel() * p.element_size() for p in model.parameters())


def test_dryrun_holds_tp_blocks_at_1x2():
    import torch.distributed as dist
    try:
        cell = dryrun.run_cell(
            "deepseek-7b", Shape("smoke_train_2x2048", 2048, 2, "train"),
            overrides={"segments": (Segment("dense", DRY_LAYERS),)},
            mesh=dryrun.fake_mesh((1, 2)))
    finally:
        dist.destroy_process_group()
    cfg = get_config("deepseek-7b")
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, DRY_LAYERS
    split = 2 * V * D + L * (4 * D * D + 3 * D * F)    # bf16, halved
    want = split // 2 * 2 + (2 * L + 1) * D * 4        # + f32 norms
    assert cell["param_bytes"] == want
    assert run_ranks(_held_bytes_rank, 2, DRY_LAYERS,
                     timeout=TIMEOUT) == [want, want]
    counts = cell["collectives"]["counts"]
    assert counts["all-gather"] == 0 and counts["all-reduce"] > 0
