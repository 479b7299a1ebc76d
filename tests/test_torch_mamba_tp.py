"""The Mamba mixer on its channel blocks under a mesh
(``parallel.sharding.tp_split`` route ``tp`` for the ``mamba`` family,
``held_specs``), on the CPU.

* ``Sharding`` with a ``Blocks`` entry (``in_proj`` (D, 2·di) held as the
  rank's ``[x block | z block]``) and ``conv_w`` on its channels: ``local``
  cuts the blocks of both groups, ``full`` puts the whole tensor back bit
  for bit, at (1, 2) and (2, 2).
* One f32 training step of reduced falcon-mamba-7b (two layers, the
  ``ssm`` kind) and reduced hymba-1.5b (its mixer beside GQA), with remat
  "none" and "full", with and without ``seq_shard_activations``, on gloo
  worlds of (1, 2) and (2, 2) (``launch.mesh.run_ranks``), every mixer on
  route ``tp``: the loss within 1e-5 relative of the JAX package's
  one-device loss on the same numpy-seeded weights and batch; each
  gradient, gathered, within 1e-5 of its leaf's largest entry against the
  port's own no-mesh gradients; every replicated leaf's gradient
  (``conv_b`` and ``dt_bias`` among them) bit-equal on the model ranks.
* The collectives: one mixer's forward at (1, 2) makes two psums (the
  ``x_proj`` partial, B x S x (r + 2N), and the output, B x S x D) and no
  gather; falcon's step makes no all-gather, its all-reduces counted and
  sized.
* A checkpoint of reduced falcon-mamba-7b written at (1, 2) restores at
  (1, 1) and (2, 1) bit for bit, the blocks cut anew.
* Serving under a mesh (``gather_dense_``, the reference's whole
  tensors) gives the no-mesh serve's tokens.
* The dry run (``launch.dryrun``) at (1, 2) on the meta device holds
  falcon-mamba-7b's blocks at full width (two layers): the parameter
  bytes a gloo rank holds, and its step's all-reduces counted, no gather.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduce_config as jreduce_config  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                                 _flatten)
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.convert import model_state_from_jax  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.roofline.hlo import CollectiveCounter  # noqa: E402
from repro_torch.train.step import batch_to, build_train_step  # noqa: E402

TIMEOUT = 120
SHAPES = [(1, 2), (2, 2)]
B, S = 4, 16
LAYERS = {"falcon-mamba-7b": 2, "hymba-1.5b": 1}
# case -> (arch, config fields set on both packages' reduced configs)
CASES = {f"{name}{sp}{full}": (arch, {**({"seq_shard_activations": True}
                                         if sp else {}),
                                      **({"remat": "full"} if full
                                         else {})})
         for name, arch in (("falcon", "falcon-mamba-7b"),
                            ("hymba", "hymba-1.5b"))
         for sp in ("", "_sp") for full in ("", "_full")}
MIXER = ("in_proj", "conv_w", "A_log", "ssm_D", "x_proj", "dt_proj",
         "out_proj")


def _cfgs(case: str):
    arch, fields = CASES[case]
    layers = LAYERS[arch]
    jcfg = jreduce_config(jget_config(arch), layers).with_(dtype="float32",
                                                           **fields)
    cfg = reduce_config(get_config(arch), layers).with_(dtype="float32",
                                                        **fields)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _inputs(case: str):
    """Weights in the JAX package's tree and shapes, drawn with numpy (a
    matrix's entries normal / sqrt(fan-in), a vector's 1 + normal / 10),
    and a batch drawn with numpy."""
    cfg, jcfg = _cfgs(case)
    rng = np.random.default_rng(13)

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
    _, jcfg = _cfgs(case)
    jsharding._ACTIVE_MESH = None
    loss, _ = jax.jit(JModel(jcfg).loss)(params,
                                         jax.tree.map(jnp.asarray, batch))
    return float(loss)


def _load(ts, state: dict) -> dict:
    """A fresh training state of ``ts`` holding the full ``state`` (numpy)
    as this rank's blocks."""
    st = ts.init_state(0)
    held = ts.model.shardings()
    with torch.no_grad():
        for name, p in st["params"].items():
            full = torch.from_numpy(state[name])
            p.copy_(full if held[name] is None else held[name].local(full))
    return st


def _step(case: str, state: dict, batch: dict, mesh) -> dict:
    """One step's loss and gradients of the port (this rank's under
    ``mesh``) from the full ``state``, with the collectives and routes it
    took; the gradients gathered whole."""
    cfg, _ = _cfgs(case)
    ts = build_train_step(cfg, mesh=mesh, device="cpu")
    st = _load(ts, state)
    held = ts.model.shardings()
    shd.reset_tp_routes()
    cc = CollectiveCounter()
    with cc:
        params, metrics = ts.grads(st, ts.local_batch(batch_to(batch,
                                                               "cpu")))
    out = {"loss": float(metrics["loss"]), "coll": cc.result(),
           "routes": {k: dict(v) for k, v in shd.tp_route_launches.items()},
           "specs": {n: None if sh is None else sh.spec
                     for n, sh in held.items()},
           "grads": {}, "replicated": []}
    with shd.use_mesh(mesh):
        for name, p in params.items():
            sh = held[name]
            out["grads"][name] = (p.grad if sh is None
                                  else sh.full(p.grad)).numpy()
            if mesh is not None and sh is None:
                out["replicated"].append(name)
    return out


def _blocks(mesh) -> dict:
    """``in_proj``'s and ``conv_w``'s held blocks of a numbered tensor, and
    the tensors ``full`` puts back from them."""
    D, di = 3, 8
    in_proj = torch.arange(D * 2 * di, dtype=torch.float32).reshape(D,
                                                                    2 * di)
    conv_w = torch.arange(4 * di, dtype=torch.float32).reshape(4, di)
    out = {}
    for name, t in (("in_proj", in_proj), ("conv_w", conv_w)):
        sh = shd.Sharding(mesh, shd.tp_spec(2, -1, shd.TP_GROUPS.get(name,
                                                                     1)))
        local = sh.local(t)
        out[name] = (local, sh.full(local.clone()), t)
    return out


def _mixer_collectives(mesh) -> dict:
    """The collectives of one forward of reduced falcon's mixer at the
    rank's blocks, no gradient."""
    cfg, _ = _cfgs("falcon")
    ts = build_train_step(cfg, mesh=mesh, device="cpu")
    ts.init_state(0)
    p = ts.model.segments[0][0]["mamba"].tp_blocks(shd.TP_DIMS["mamba"])
    h = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    cc = CollectiveCounter()
    with torch.no_grad(), shd.use_mesh(mesh), cc:
        L.mamba_mixer(p, h, cfg, tp="model")
    return cc.result()


def _ckpt_rank(rank, shape, state, batch, ckpt_dir, write):
    """Reduced falcon at ``shape``: the writer loads ``state``, takes one
    step and checkpoints it; a reader restores it.  Either returns every
    leaf of its state gathered whole."""
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    cfg, _ = _cfgs("falcon")
    ts = build_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=4),
                          mesh=mesh, device="cpu")
    ck = Checkpointer(ckpt_dir)
    if write:
        st = _load(ts, state)
        st, _ = ts.step_fn(st, ts.local_batch(batch_to(batch, "cpu")))
        tree = {"params": {n: p.detach() for n, p in st["params"].items()},
                "opt": st["opt"]}
        ck.save(1, tree, shardings=ts.state_shardings())
    else:
        st = ts.init_state(0)
        like = {"params": {n: p.detach() for n, p in st["params"].items()},
                "opt": st["opt"]}
        tree, _ = ck.restore(1, like, shardings=ts.state_shardings())
    shs = dict(_flatten(ts.state_shardings()))
    with shd.use_mesh(mesh):
        return {n: (t if shs[n] is None else shs[n].full(t)).numpy()
                for n, t in _flatten(tree)}


def _serve_tokens(arch: str):
    cfg = reduce_config(get_config(arch), LAYERS[arch]).with_(
        dtype="float32")
    return serve(cfg, B, S, 5, device="cpu").tokens


def _rank(rank, shape, cases):
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {"coord": tuple(mesh.get_coordinate()),
           "blocks": _blocks(mesh), "mixer": _mixer_collectives(mesh),
           "out": {case: _step(case, state, batch, mesh)
                   for case, (state, batch) in cases.items()}}
    with shd.use_mesh(mesh):
        out["serve"] = {arch: _serve_tokens(arch) for arch in LAYERS}
    return out


@pytest.fixture(scope="module")
def runs():
    """The JAX losses and the port's no-mesh steps here, beside the port's
    worlds (spawned from threads, which wait on them)."""
    torch.set_num_threads(1)
    inputs, cases = {}, {}
    for case in CASES:
        params, batch = inputs[case] = _inputs(case)
        cfg, _ = _cfgs(case)
        cases[case] = ({k: v.numpy() for k, v in
                        model_state_from_jax(cfg, params).items()}, batch)
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        worlds = {shape: pool.submit(run_ranks, _rank, shape[0] * shape[1],
                                     shape, cases, timeout=TIMEOUT)
                  for shape in SHAPES}
        want = {case: _jax_loss(case, *inputs[case]) for case in CASES}
        one = {case: _step(case, *cases[case], None) for case in CASES}
        one_serve = {arch: _serve_tokens(arch) for arch in LAYERS}
        got = {shape: f.result() for shape, f in worlds.items()}
    return want, one, got, one_serve, cases


def _gap(got, want) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_blocks_cut_and_gather_bit_equal(runs, shape):
    """``in_proj``'s rank block is its x block beside its z block, and
    ``conv_w``'s its channels (every tap); ``full`` puts both back."""
    _, _, got, _, _ = runs
    for r in got[shape]:
        m, n = r["coord"][1], shape[1]
        for name, (local, whole, t) in r["blocks"].items():
            assert torch.equal(whole, t), name
        local, _, t = r["blocks"]["in_proj"]
        di = t.shape[1] // 2
        k = di // n
        assert torch.equal(local, torch.cat(
            [t[:, m * k:(m + 1) * k], t[:, di + m * k:di + (m + 1) * k]],
            dim=1))
        local, _, t = r["blocks"]["conv_w"]
        assert torch.equal(local, t[:, m * (t.shape[1] // n):
                                    (m + 1) * (t.shape[1] // n)])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_mamba_tp_loss_matches_jax(runs, case, shape):
    want, one, got, _, _ = runs
    cfg, _ = _cfgs(case)
    np.testing.assert_allclose(one[case]["loss"], want[case], rtol=1e-5)
    passes = 2 if cfg.remat == "full" else 1
    for r in got[shape]:
        res = r["out"][case]
        np.testing.assert_allclose(res["loss"], want[case], rtol=1e-5)
        assert res["routes"]["mamba"] == {"tp": passes * cfg.n_layers,
                                          "gathered": 0}, res["routes"]
        for name, spec in res["specs"].items():   # the mixer's blocks held
            leaf = name.split(".")[-1]
            if ".mamba." in name and leaf in MIXER:
                assert spec == shd.tp_spec(
                    len(res["grads"][name].shape),
                    shd.TP_DIMS["mamba"][leaf],
                    shd.TP_GROUPS.get(leaf, 1)), name
            elif ".mamba." in name:               # conv_b, dt_bias
                assert spec is None, name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_mamba_tp_gradients_match_one_device(runs, case, shape):
    _, one, got, _, _ = runs
    ranks = got[shape]
    for r in ranks:
        grads = r["out"][case]["grads"]
        assert grads.keys() == one[case]["grads"].keys()
        for name, g in grads.items():
            want = one[case]["grads"][name]
            assert g.shape == want.shape, name
            assert _gap(g, want) <= 1e-5, (name, _gap(g, want))
    # the replicated leaves' gradients: the same on every rank
    base = ranks[0]["out"][case]
    assert any(n.endswith("conv_b") for n in base["replicated"])
    for r in ranks[1:]:
        for name in base["replicated"]:
            assert np.array_equal(r["out"][case]["grads"][name],
                                  base["grads"][name]), name


def test_mixer_forward_makes_two_psums(runs):
    """One mixer's forward on its blocks: the ``x_proj`` psum and the
    output's, no gather."""
    _, _, got, _, _ = runs
    cfg, _ = _cfgs("falcon")
    xproj = B * S * (cfg.dt_rank_ + 2 * cfg.ssm_state) * 4
    for r in got[(1, 2)]:
        c = r["mixer"]
        assert c["counts"] == {**dict.fromkeys(c["counts"], 0),
                               "all-reduce": 2}, c
        assert c["per_kind_bytes"]["all-reduce"] == xproj + B * S \
            * cfg.d_model * 4


@pytest.mark.parametrize("case", ["falcon", "falcon_full"])
def test_mamba_tp_step_collectives(runs, case):
    """falcon at (1, 2): no all-gather, no reduce-scatter; with remat
    "none" the all-reduces by count and bytes -- four a layer (the two
    psums and their backwards), five around the layers (the embedding's
    psum and its backward, the cross-entropy's max, its psum of two and
    that psum's backward), and one psum a replicated leaf's gradient over
    'model' (ln1, conv_b and dt_bias a layer; final_ln); remat "full"
    replays each layer's ``x_proj`` psum and stops before the output's
    (the checkpoint's early stop: nothing the backward saves comes after
    it)."""
    _, _, got, _, _ = runs
    cfg, _ = _cfgs(case)
    Lr, D, di = cfg.n_layers, cfg.d_model, cfg.d_inner
    act, xent = B * S * D * 4, B * (S - 1) * 4
    xproj = B * S * (cfg.dt_rank_ + 2 * cfg.ssm_state) * 4
    replicated = Lr * (D + 2 * di) * 4 + D * 4
    replay = (1, xproj) if cfg.remat == "full" else (0, 0)
    for r in got[(1, 2)]:
        c = r["out"][case]["coll"]
        assert c["counts"]["all-gather"] == 0
        assert c["counts"]["reduce-scatter"] == 0
        assert c["counts"]["all-to-all"] == 0
        assert c["counts"]["all-reduce"] == \
            (4 + replay[0]) * Lr + 5 + 3 * Lr + 1
        assert c["per_kind_bytes"]["all-reduce"] == (
            Lr * (2 * (act + xproj) + replay[1]) + 2 * act + xent
            + 2 * 2 * xent + replicated)


@pytest.mark.parametrize("arch", list(LAYERS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gathered_serve_matches_no_mesh(runs, shape, arch):
    """``serve`` under a mesh holds the leaves whole (``gather_dense_``)
    and decodes the no-mesh serve's tokens, each data rank its rows."""
    _, _, got, one_serve, _ = runs
    rows = B // shape[0]
    for r in got[shape]:
        d = r["coord"][0]
        assert np.array_equal(r["serve"][arch],
                              one_serve[arch][d * rows:(d + 1) * rows])


@pytest.fixture(scope="module")
def ckpt_runs(runs, tmp_path_factory):
    _, _, _, _, cases = runs
    state, batch = cases["falcon"]
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    written = run_ranks(_ckpt_rank, 2, (1, 2), state, batch, ckpt, True,
                        timeout=TIMEOUT)
    read = {shape: run_ranks(_ckpt_rank, shape[0] * shape[1], shape, state,
                             batch, ckpt, False, timeout=TIMEOUT)
            for shape in ((1, 1), (2, 1))}
    return written, read


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_checkpoint_restores_across_meshes_bit_equal(ckpt_runs, shape):
    written, read = ckpt_runs
    want = written[0]
    assert any(".mamba.in_proj" in n for n in want)
    for r in written[1:] + read[shape]:
        assert r.keys() == want.keys()
        for name, t in r.items():
            assert np.array_equal(t, want[name]), name


# ------------------------------------------------------------ the dry run
DRY_LAYERS = 2


def _held_bytes_rank(rank, layers):
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    cfg = get_config("falcon-mamba-7b")
    cfg = cfg.with_(segments=(dataclasses.replace(cfg.segments[0],
                                                  n_layers=layers),))
    with shd.use_mesh(mesh):
        model = Model(cfg, device="meta")
    return sum(p.numel() * p.element_size() for p in model.parameters())


def test_dryrun_holds_mixer_blocks_at_1x2():
    """falcon-mamba-7b at full width, two layers, rank 0 of (1, 2) on the
    meta device: the parameter bytes a gloo rank holds (half of every
    split leaf; ``conv_b``, ``dt_bias`` and the norms whole), and the
    step's collectives -- no gather, 8 all-reduces a layer (the mixer's
    two psums, the ``x_proj`` one's remat replay, both backwards, the
    gradients of ln1, conv_b and dt_bias over 'model') and 7 besides."""
    import torch.distributed as dist
    cfg = get_config("falcon-mamba-7b")
    try:
        cell = dryrun.run_cell(
            "falcon-mamba-7b", Shape("smoke_train_2x2048", 2048, 2, "train"),
            overrides={"segments": (dataclasses.replace(
                cfg.segments[0], n_layers=DRY_LAYERS),)},
            mesh=dryrun.fake_mesh((1, 2)))
    finally:
        dist.destroy_process_group()
    D, di, V, Lr = cfg.d_model, cfg.d_inner, cfg.vocab, DRY_LAYERS
    r, N, k = cfg.dt_rank_, cfg.ssm_state, cfg.d_conv
    split = 2 * V * D + Lr * (2 * D * di + k * di + di * (r + 2 * N)
                              + r * di + di * D)           # bf16, halved
    f32 = Lr * (di * N + di)                               # A_log, ssm_D
    whole = Lr * (D * 4 + 2 * di * 2) + D * 4   # ln1, conv_b, dt_bias; final
    want = split + f32 * 2 + whole
    assert cell["param_bytes"] == want
    assert run_ranks(_held_bytes_rank, 2, DRY_LAYERS,
                     timeout=TIMEOUT) == [want, want]
    counts = cell["collectives"]["counts"]
    assert counts["all-gather"] == counts["reduce-scatter"] == 0
    assert counts["all-reduce"] == 8 * Lr + 7
