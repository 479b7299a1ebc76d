"""The sequence split under a mesh (``parallel.sharding.seq_split``) on the
CPU: ``dp_seq`` (the batch's sequence over 'model') and
``seq_shard_activations`` (the residual stream over 'model' between the
sub-layers).

* ``seq_split`` as a table on the registry's configs: GQA self-attention
  with whole weights on route ``seq``, the families that mix positions
  (Mamba, MLA, MoE, MTP, a ``tp`` GQA) and every ``tp`` family under
  ``seq_shard_activations`` on ``gathered``, per-token work on ``token``;
  ``seq_split_of`` splits only where 'model' divides the sequence, and
  ``TrainStep.local_batch`` hands each rank its block with the next
  block's first label.
* The plain attention with a query offset (``ref.attention_ref``,
  ``attention_lse_ref``, ``attention_bwd_ref`` with ``q_off``) against the
  JAX package's attention at explicit query positions ``q_off + arange``
  (its masked path, forward and ``jax.grad``) and against autograd, with a
  key block that no query reaches (zero dK and dV).
* One training step in f32 of reduced smollm-135m (``dp_seq``, remat
  "none" and "full"), reduced hymba-1.5b under ``dp_seq``
  (``dataclasses.replace``: its Mamba mixer on ``gathered`` beside a
  windowed GQA on ``seq``; 32 positions, so its window of 16 cuts),
  reduced olmoe-1b-7b and deepseek-v3 under ``dp_seq`` (their MoE layers,
  MLA and MTP block on ``gathered``; the plans with capacity factor 8, so
  no choice is dropped) and reduced deepseek-7b under
  ``seq_shard_activations``, on gloo worlds of
  (1, 2) and (2, 2) (``launch.mesh.run_ranks``): the loss within 1e-5
  relative of the JAX package's one-device loss on the same numpy-drawn
  weights and batch, each gradient within 1e-5 of its leaf's largest
  entry against the port's own no-mesh step, the replicated leaves'
  gradients bit-equal on every rank; the collectives of a layer counted
  and sized; a sequence that the model axis does not divide stays whole.

The JAX package's mesh path fails under jax 0.9.0 (ROADMAP Queue 3 b): its
loss is taken on one device, ``repro.parallel.sharding._ACTIVE_MESH``
reset first, under a one-device Auto mesh for the MoE kinds.
"""
import dataclasses
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduce_config  # noqa: E402
from repro_torch.convert import model_state_from_jax  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.roofline.hlo import CollectiveCounter  # noqa: E402
from repro_torch.train.step import batch_to, build_train_step  # noqa: E402

TIMEOUT = 120
SHAPES = [(1, 2), (2, 2)]
B = 4
# case -> (arch, config fields set on both packages' reduced configs,
# positions); two layers a segment
CASES = {"smollm": ("smollm-135m", {}, 16),
         "smollm_full": ("smollm-135m", {"remat": "full"}, 16),
         "hymba": ("hymba-1.5b", {"strategy": "dp_seq"}, 32),
         "olmoe": ("olmoe-1b-7b", {"strategy": "dp_seq"}, 16),
         "deepseek_v3": ("deepseek-v3-671b", {"strategy": "dp_seq"}, 16),
         "deepseek_sp": ("deepseek-7b", {"seq_shard_activations": True},
                         16)}
ODD_S = 15          # no model axis of 2 divides it: the sequence stays whole


# --------------------------------------------------------------- the routes
S_, T_, G_ = "seq", "token", "gathered"
ROUTE_CASES = [
    # (arch, config fields, n, routes of the embedding/head/MTP, of each
    # segment)
    ("smollm-135m", {}, 2, {"embed": T_, "head": T_},
     [{"gqa": S_, "mlp": T_}]),
    ("hymba-1.5b", {"strategy": "dp_seq"}, 2, {"embed": T_, "head": T_},
     [{"gqa": S_, "mamba": G_, "mlp": T_}] * 5),
    ("olmoe-1b-7b", {"strategy": "dp_seq"}, 2, {"embed": T_, "head": T_},
     [{"gqa": S_, "moe": G_}]),
    ("deepseek-v3-671b", {"strategy": "dp_seq"}, 2,
     {"embed": T_, "head": T_, "mtp": G_},
     [{"mla": G_, "mlp": T_}, {"mla": G_, "moe": G_}]),
    ("llama-3.2-vision-11b", {"strategy": "dp_seq"}, 2,
     {"embed": T_, "head": T_},
     [{"gqa": S_, "cross": T_, "mlp": T_}]),
    ("falcon-mamba-7b", {"strategy": "dp_seq"}, 2,
     {"embed": T_, "head": T_}, [{"mamba": G_}]),
    ("deepseek-7b", {"seq_shard_activations": True}, 2,
     {"embed": G_, "head": G_}, [{"gqa": G_, "mlp": G_}]),
    # the mixer on its channel blocks (tp), its input gathered over the
    # sequence and its output reduce-scattered
    ("falcon-mamba-7b", {"seq_shard_activations": True}, 2,
     {"embed": G_, "head": G_}, [{"mamba": G_}]),
    # hymba's 25 heads do not split over 2: its GQA reads whole weights
    ("hymba-1.5b", {"seq_shard_activations": True}, 2,
     {"embed": T_, "head": G_}, [{"gqa": S_, "mamba": G_, "mlp": G_}] * 5),
]


@pytest.mark.parametrize("arch, fields, n, top, segs", ROUTE_CASES,
                         ids=[f"{c[0]}-{'-'.join(c[1]) or 'as-is'}"
                              for c in ROUTE_CASES])
def test_seq_split_table(arch, fields, n, top, segs):
    cfg = dataclasses.replace(get_config(arch), **fields)
    assert shd.seq_split(cfg, None, n) == top
    assert [shd.seq_split(cfg, seg, n) for seg in cfg.segments] == segs


@pytest.mark.parametrize("arch", list_archs())
def test_seq_split_routes_every_family(arch):
    """Every family of ``tp_split`` has a sequence route (a MoE layer's
    router and shared experts as ``moe``), and ``seq`` only where the
    attention's weights are whole."""
    for fields in ({"strategy": "dp_seq"}, {"strategy": "tp",
                                            "seq_shard_activations": True}):
        cfg = dataclasses.replace(get_config(arch), **fields)
        for seg in cfg.segments:
            tp, sq = shd.tp_split(cfg, seg, 2), shd.seq_split(cfg, seg, 2)
            want = {("moe" if f == "router" else f) for f in tp
                    if not (seg.kind == "moe" and f == "mlp")}
            assert set(sq) == want
            assert all(r in shd.SEQ_ROUTES for r in sq.values())
            if sq.get("gqa") == "seq":
                assert tp["gqa"] == "gathered"


def test_seq_split_of():
    cfg = get_config("smollm-135m")
    mesh = shd.AbstractMesh((1, 2), ("data", "model"))

    class Rank1(shd.AbstractMesh):
        def get_local_rank(self, axis):
            return 1
    m1 = Rank1((1, 2), ("data", "model"))
    assert shd.seq_split_of(cfg, 4096, m1) == shd.SeqSplit("model", 1, 2,
                                                           2048)
    assert shd.seq_split_of(cfg, 4096, m1).offset == 2048
    assert shd.seq_split_of(cfg, 4095, mesh) is None       # not divided
    assert shd.seq_split_of(cfg, 1, mesh) is None          # one token
    assert shd.seq_split_of(cfg, 4096, shd.AbstractMesh(
        (2, 1), ("data", "model"))) is None                # one model rank
    assert shd.seq_split_of(cfg, 4096, None) is None       # no mesh
    tp = get_config("deepseek-7b")
    assert shd.seq_split_of(tp, 4096, mesh) is None        # no split
    assert shd.seq_split_of(tp.with_(seq_shard_activations=True), 4096,
                            m1).block == 2048


# ---------------------------------------------- attention with an offset
def _qkv(seed, Bq, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((Bq, Sq, H, hd), (Bq, Sk, KV, hd), (Bq, Sk, KV, hd),
                      (Bq, Sq, H, hd))]


# (Sq, Sk, q_off, causal, window): a block inside the sequence, the last
# block, a window, keys that no query reaches (past q_off + Sq - 1)
OFF_CASES = [(8, 32, 8, True, 0), (8, 32, 24, True, 0),
             (8, 32, 16, True, 12), (16, 40, 8, True, 0),
             (8, 24, 8, False, 0)]


@pytest.mark.parametrize("Sq, Sk, q_off, causal, window", OFF_CASES)
def test_attention_ref_q_off_matches_jax(Sq, Sk, q_off, causal, window):
    q, k, v, _ = _qkv(1, 2, Sq, Sk, 6, 2, 16)
    qp = np.tile(np.arange(Sq, dtype=np.int32) + q_off, (2, 1))
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, q_pos=jnp.asarray(qp)))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = ref.attention_ref(*t, causal=causal, window=window, q_off=q_off)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="q_off"):
        ref.attention_ref(*t, q_off=q_off, q_pos=torch.from_numpy(qp))


@pytest.mark.parametrize("Sq, Sk, q_off, causal, window", OFF_CASES)
def test_attention_bwd_ref_q_off(Sq, Sk, q_off, causal, window):
    """The backward's plain arithmetic with an offset against autograd of
    the plain forward and against ``jax.grad`` of the JAX attention at
    those query positions; keys that no query reaches get exact zeros."""
    q, k, v, do = _qkv(2, 2, Sq, Sk, 6, 2, 16)
    scale = 16 ** -0.5
    kw = dict(causal=causal, window=window, scale=scale)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = ref.attention_ref(*t, q_off=q_off, **kw)
    o.backward(torch.from_numpy(do))
    want = [x.grad.numpy() for x in t]
    lse = ref.attention_lse_ref(t[0].detach(), t[1].detach(), q_off=q_off,
                                **kw)
    for lse_in in (None, lse):
        got = ref.attention_bwd_ref(*(x.detach() for x in t), o.detach(),
                                    torch.from_numpy(do), lse=lse_in,
                                    q_off=q_off, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)
    qp = np.tile(np.arange(Sq, dtype=np.int32) + q_off, (2, 1))

    def f(q, k, v):
        return jnp.sum(jops.attention(q, k, v, q_pos=jnp.asarray(qp), **kw)
                       * do)
    jg = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    if causal and q_off + Sq < Sk:          # keys past the last query
        for g in got[1:]:
            assert not g[:, q_off + Sq:].any()


# ------------------------------------------------------ the training step
def _cfgs(case: str, **extra):
    arch, fields, _ = CASES[case]
    jcfg = dataclasses.replace(jreduce_config(jget_config(arch), 2),
                               dtype="float32", **fields, **extra)
    cfg = dataclasses.replace(reduce_config(get_config(arch), 2),
                              dtype="float32", **fields, **extra)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _inputs(case: str, S: int):
    """Weights in the JAX package's tree, drawn with numpy (a matrix's
    entries normal / sqrt(fan-in), a vector's 1 + normal / 10), and a batch
    of ``S`` positions."""
    cfg, jcfg = _cfgs(case)
    rng = np.random.default_rng(5)

    def draw(leaf):
        shape = leaf.shape
        x = rng.normal(size=shape)
        x = x / np.sqrt(shape[-2]) if len(shape) >= 2 else 1 + x / 10
        return x.astype(np.float32)

    params = jax.tree.map(draw, jax.eval_shape(JModel(jcfg).init,
                                               jax.random.PRNGKey(0)))
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_loss(case: str, params, batch) -> float:
    cfg, jcfg = _cfgs(case)
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


def _step(case: str, state: dict, batch: dict, mesh) -> dict:
    """One step's loss and gradients of the port (this rank's under
    ``mesh``) from the full ``state`` (numpy), with the collectives and
    sequence routes it took; the gradients gathered whole."""
    cfg, _ = _cfgs(case)
    n = shd.axis_sizes(mesh)["model"] if mesh is not None else 1
    plan = (moe.round_robin_plan(cfg.n_experts, n, 8.0) if cfg.n_experts
            else None)
    ts = build_train_step(cfg, mesh=mesh, plan=plan, device="cpu")
    st = ts.init_state(0)
    held = ts.model.shardings()
    with torch.no_grad():
        for name, p in st["params"].items():
            full = torch.from_numpy(state[name])
            p.copy_(full if held[name] is None else held[name].local(full))
    local = ts.local_batch(batch_to(batch, "cpu"))
    shd.reset_seq_routes()
    cc = CollectiveCounter()
    with cc:
        params, metrics = ts.grads(st, local)
    out = {"loss": float(metrics["loss"]), "coll": cc.result(),
           "routes": {k: dict(v) for k, v in shd.seq_route_launches.items()},
           "split": local.get("seq_split"),
           "lengths": {k: int(v.shape[1]) for k, v in local.items()
                       if k in ("tokens", "labels")},
           "grads": {}, "replicated": []}
    with shd.use_mesh(mesh):
        for name, p in params.items():
            sh = held[name]
            out["grads"][name] = (p.grad if sh is None
                                  else sh.full(p.grad)).numpy()
            if mesh is not None and sh is None:
                out["replicated"].append(name)
    return out


def _rank(rank, shape, cases):
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    return {"coord": tuple(mesh.get_coordinate()),
            "out": {key: _step(key.split("@")[0], state, batch, mesh)
                    for key, (state, batch) in cases.items()}}


@pytest.fixture(scope="module")
def runs():
    """The JAX losses and the port's no-mesh steps here, beside the port's
    worlds (spawned from threads, which wait on them)."""
    torch.set_num_threads(1)
    inputs, cases = {}, {}
    for case, (_, _, S) in CASES.items():
        inputs[case] = _inputs(case, S)
    inputs[f"smollm@{ODD_S}"] = _inputs("smollm", ODD_S)
    for key, (params, batch) in inputs.items():
        cfg, _ = _cfgs(key.split("@")[0])
        cases[key] = ({k: v.numpy() for k, v in
                       model_state_from_jax(cfg, params).items()}, batch)
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        worlds = {shape: pool.submit(run_ranks, _rank, shape[0] * shape[1],
                                     shape, cases, timeout=TIMEOUT)
                  for shape in SHAPES}
        want = {key: _jax_loss(key.split("@")[0], *inputs[key])
                for key in inputs}
        one = {key: _step(key.split("@")[0], *cases[key], None)
               for key in inputs}
        got = {shape: f.result() for shape, f in worlds.items()}
    return want, one, got


def _gap(got, want) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_seq_loss_matches_jax(runs, case, shape):
    want, one, got = runs
    np.testing.assert_allclose(one[case]["loss"], want[case], rtol=1e-5)
    for r in got[shape]:
        out = r["out"][case]
        np.testing.assert_allclose(out["loss"], want[case], rtol=1e-5)
        split = out["split"]
        S = CASES[case][2]
        if CASES[case][1].get("seq_shard_activations"):
            assert split is None and out["lengths"]["tokens"] == S
        else:            # dp_seq: this rank's block, its label halo
            assert split == shd.SeqSplit("model", r["coord"][1], 2, S // 2)
            last = split.index == split.n - 1
            assert out["lengths"] == {"tokens": S // 2,
                                      "labels": S // 2 + (not last)}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_seq_gradients_match_one_device(runs, case, shape):
    _, one, got = runs
    ranks = got[shape]
    for r in ranks:
        grads = r["out"][case]["grads"]
        assert grads.keys() == one[case]["grads"].keys()
        for name, g in grads.items():
            want = one[case]["grads"][name]
            assert g.shape == want.shape, name
            assert _gap(g, want) <= 1e-5, (name, _gap(g, want))
    # the replicated leaves' gradients: the same bits on every rank
    base = ranks[0]["out"][case]
    assert base["replicated"]
    for r in ranks[1:]:
        for name in base["replicated"]:
            assert np.array_equal(r["out"][case]["grads"][name],
                                  base["grads"][name]), name


def test_seq_routes_counted(runs):
    """Every GQA layer of smollm on ``seq``, once more a layer under remat
    "full" (its replay); hymba's Mamba mixers on ``gathered`` beside its
    GQA on ``seq``; olmoe's MoE layers, deepseek-v3's MLA and MTP block on
    ``gathered``; deepseek-7b's tp families on ``gathered``."""
    _, one, got = runs
    for key in CASES:
        assert one[key]["routes"] == {}       # no mesh, no split
    for r in got[(1, 2)]:
        L = 2
        sm = r["out"]["smollm"]["routes"]
        assert sm == {"embed": {"seq": 0, "token": 1, "gathered": 0},
                      "gqa": {"seq": L, "token": 0, "gathered": 0},
                      "mlp": {"seq": 0, "token": L, "gathered": 0},
                      "head": {"seq": 0, "token": 1, "gathered": 0}}
        assert r["out"]["smollm_full"]["routes"]["gqa"]["seq"] == 2 * L
        hy = r["out"]["hymba"]["routes"]
        n = _cfgs("hymba")[0].n_layers
        assert hy["gqa"] == {"seq": n, "token": 0, "gathered": 0}
        assert hy["mamba"] == {"seq": 0, "token": 0, "gathered": n}
        assert r["out"]["olmoe"]["routes"]["moe"]["gathered"] == \
            _cfgs("olmoe")[0].n_layers
        v3 = r["out"]["deepseek_v3"]["routes"]
        assert v3["mtp"] == {"seq": 0, "token": 0, "gathered": 1}
        assert v3["mla"]["gathered"] == _cfgs("deepseek_v3")[0].n_layers
        ds = r["out"]["deepseek_sp"]["routes"]
        assert ds["gqa"] == ds["mlp"] == {"seq": 0, "token": 0,
                                          "gathered": L}
        assert ds["embed"]["gathered"] == ds["head"]["gathered"] == 1


def test_seq_collectives_per_layer(runs):
    """At (1, 2), per layer: smollm's K and V gathered over the sequence
    (an all-gather each, of the whole sequence's K or V in f32), their
    backwards a reduce-scatter each, a third more under remat "full" (the
    replay gathers again); the loss's psum and its backward, and one psum
    of each leaf's gradient over 'model'.  deepseek-7b under
    ``seq_shard_activations``: no psum of the stream -- per layer an
    all-gather of the attention's and of the MLP's input and a
    reduce_scatter of each output, the same again in the backward -- the
    embedding's reduce_scatter and the gather before the head."""
    _, _, got = runs
    L = 2
    cfg, _ = _cfgs("smollm")
    S = CASES["smollm"][2]
    kv = B * S * cfg.n_kv_heads * cfg.hd * 4          # a gathered K or V
    leaves = 2 + 9 * L
    cfg_d, _ = _cfgs("deepseek_sp")
    act = B * CASES["deepseek_sp"][2] * cfg_d.d_model * 4
    for r in got[(1, 2)]:
        c = r["out"]["smollm"]["coll"]
        assert c["counts"]["all-gather"] == 2 * L
        assert c["counts"]["reduce-scatter"] == 2 * L
        assert c["counts"]["all-reduce"] == 2 + leaves
        assert c["counts"]["all-to-all"] == 0
        assert c["per_kind_bytes"]["all-gather"] == 2 * L * kv
        c = r["out"]["smollm_full"]["coll"]
        assert c["counts"]["all-gather"] == 2 * 2 * L
        assert c["counts"]["reduce-scatter"] == 2 * L
        c = r["out"]["deepseek_sp"]["coll"]
        assert c["counts"]["all-gather"] == 4 * L + 2
        assert c["counts"]["reduce-scatter"] == 4 * L + 2
        assert c["per_kind_bytes"]["all-gather"] == (4 * L + 2) * act
        # the cross-entropy's max, its psum and that psum's backward; the
        # replicated leaves' gradients (ln1, ln2 a layer, final_ln)
        assert c["counts"]["all-reduce"] == 3 + 2 * L + 1


def test_undivided_sequence_stays_whole(runs):
    """A sequence of ``ODD_S`` positions at (1, 2) under ``dp_seq``: no
    split, no sequence route, no all-gather; the loss and gradients those
    of one device."""
    want, one, got = runs
    key = f"smollm@{ODD_S}"
    for r in got[(1, 2)]:
        out = r["out"][key]
        assert out["split"] is None and out["routes"] == {}
        assert out["lengths"] == {"tokens": ODD_S, "labels": ODD_S}
        assert out["coll"]["counts"]["all-gather"] == 0
        np.testing.assert_allclose(out["loss"], want[key], rtol=1e-5)
        for name, g in out["grads"].items():
            assert _gap(g, one[key]["grads"][name]) <= 1e-5, name
