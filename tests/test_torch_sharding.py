"""The port's distribution (``repro_torch.parallel``, ``launch.mesh``, the
multi-shard MoE paths, the sharded serve and train step) on the CPU.

* The sharding rules against the JAX package's, in-process: both read
  only a mesh's names and sizes (``jax.sharding.AbstractMesh`` there, the
  port's ``AbstractMesh`` here), at (2, 4), (16, 16) and (2, 16, 16), for
  every registry config at full width (JAX shapes from ``jax.eval_shape``,
  the port's from the meta device).  The reference's leaves are stacked
  over layers; its specs are compared with the port's per-layer leaves
  with those leading entries dropped.
* The multi-shard MoE paths against the JAX package's, within 1e-5 in
  f32: the JAX oracle runs in a subprocess with 8 forced host devices,
  calling ``moe_apply`` under ``set_active_mesh`` (not ``use_mesh``) on a
  mesh with Auto axes (``jax.make_mesh``'s default Explicit axes fail
  there, ROADMAP Queue 3 b); the
  port runs gloo worlds of 2 and 4 ranks on the same numpy inputs.  The
  plans have capacity factor 8, so no choice is dropped and the dense
  reference is exact.  The port's ``moe_tp`` counts a replicated expert's
  choice once; the reference's counts it once per replica (ROADMAP Queue 3
  i), which ``test_reference_moe_tp_double_counts_replicas`` pins.  The
  port's aux loss is the global batch's (``models.moe.router_topk``), held
  to the reference's dense aux.
* The sharded serve and train step against the port's own one-device
  path (the reference's mesh path fails under this jax, ROADMAP Queue 3
  b): reduced olmoe and smollm-135m (strategy ``tp``, so its dense leaves
  are sharded), greedy tokens equal, three losses within 1e-5 relative.

Every world is spawned over gloo on 127.0.0.1 with a join timeout
(``launch.mesh.run_ranks``) that fails the test when it expires.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduce_config  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,  # noqa: E402
                                     make_production_mesh, run_ranks)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
TIMEOUT = 120
MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


# ------------------------------------------------------------------- rules
def _norm(entry):
    """A spec entry as both packages mean it: a lone axis by its name."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(p, ndim: int, lead: int = 0) -> tuple:
    """A JAX PartitionSpec padded to ``ndim`` entries, ``lead`` dropped."""
    full = tuple(_norm(e) for e in p) + (None,) * (ndim - len(p))
    return full[lead:]


def _port_name(keys: list, cfg) -> tuple[str, int]:
    """The port's name of a reference leaf (its first layer) and the
    leading stacked dimensions to drop."""
    if keys[0] == "segments":
        i, rest = int(keys[1]), keys[2:]
        if cfg.segments[i].kind == "vision_group" and rest[0] == "self":
            return ".".join([f"segments.{i}.0.self.0"] + rest[1:]), 2
        return ".".join([f"segments.{i}.0"] + rest), 1
    if keys[0] == "mtp":
        lead = 1 if keys[2] == "block" else 0
        return ".".join(keys), lead
    return ".".join(keys), 0


def _first_layer(name: str) -> bool:
    """Whether a port leaf is of a segment's first layer (and a vision
    group's first self sub-layer), or outside the segments."""
    m = re.match(r"segments\.\d+\.(\d+)\.", name)
    k = re.search(r"\.self\.(\d+)\.", name)
    return (m is None or m.group(1) == "0") and (k is None
                                                  or k.group(1) == "0")


def _keys(path) -> list:
    return [str(k.key) if hasattr(k, "key") else str(k.idx) for k in path]


def _jax_param_specs(arch: str, mesh_shape, names, strategy: str) -> dict:
    jcfg = jget_config(arch)
    params = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    jshd.set_active_mesh(JAbstractMesh(mesh_shape, names))
    try:
        specs = jshd.tree_param_specs(params, strategy)
    finally:
        jshd.set_active_mesh(None)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, JP))
    out = {}
    for (path, leaf), sp in zip(leaves, spec_leaves):
        name, lead = _port_name(_keys(path), jcfg)
        out[name] = (_spec(sp, len(leaf.shape), lead),
                     tuple(leaf.shape[lead:]))
    return out


@pytest.mark.parametrize("strategy", ["tp", "tp+ep_data"])
@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch, mesh_shape, strategy):
    names = MESHES[mesh_shape]
    cfg = get_config(arch)
    shapes = {n: tuple(p.shape) for n, p in
              Model(cfg, device="meta").named_parameters()}
    mesh = shd.AbstractMesh(mesh_shape, names)
    got = shd.tree_param_specs(shapes, strategy, mesh)
    want = _jax_param_specs(arch, mesh_shape, names, strategy)
    assert set(want) == {n for n in shapes if _first_layer(n)}
    for name, (spec, shape) in want.items():
        assert shapes[name] == shape, name
        assert got[name] == spec, (name, got[name], spec)
    if cfg.strategy == "tp" and "model" in names:   # the rules do shard
        assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b",
                                  "llama-3.2-vision-11b", "hymba-1.5b",
                                  "deepseek-v3-671b"])
def test_batch_cache_and_state_specs_match_the_reference(arch, mesh_shape):
    names = MESHES[mesh_shape]
    jmesh = JAbstractMesh(mesh_shape, names)
    mesh = shd.AbstractMesh(mesh_shape, names)
    for zero in (False, True):
        cfg = get_config(arch).with_(zero_opt_state=zero)
        jcfg = jget_config(arch).with_(zero_opt_state=zero)
        # the batch, a decode step's and a prompt's
        for S in (1, 4096):
            shapes = {"tokens": (32, S), "labels": (32, S)}
            if cfg.n_image_tokens:
                shapes["image_embeds"] = (32, cfg.n_image_tokens,
                                          cfg.d_model)
            want = jstep.batch_specs(jcfg, jmesh, {
                k: jax.ShapeDtypeStruct(v, np.int32)
                for k, v in shapes.items()})
            got = step_lib.batch_specs(cfg, mesh, shapes)
            for k, shape in shapes.items():
                assert got[k] == _spec(want[k].spec, len(shape)), k
        # the caches, stacked there and per layer here
        jcaches = jax.eval_shape(
            lambda: JModel(jcfg).init_cache(32, 4096))
        jspecs = jstep.cache_specs(jcfg, jmesh, jcaches)
        caches = Model(cfg, device="meta").init_cache(32, 4096)
        got = step_lib.cache_specs(cfg, mesh, caches)
        for i, seg in enumerate(cfg.segments):
            lead = 2 if seg.kind == "vision_group" else 1
            flat = jax.tree_util.tree_flatten_with_path(jcaches[i])[0]
            sflat = jax.tree_util.tree_leaves(
                jspecs[i], is_leaf=lambda s: hasattr(s, "spec"))
            for (path, leaf), sh in zip(flat, sflat):
                keys = _keys(path)
                node = got[i][0]
                for k in keys:
                    node = node[k]
                    if isinstance(node, list):
                        node = node[0]
                k_lead = lead if "self" in keys else 1
                assert node == _spec(sh.spec, len(leaf.shape), k_lead), \
                    (i, keys)
        # the training state: parameters and optimizer
        jparams = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
        jstate = {"params": jparams, "opt": jax.eval_shape(
            lambda p: jadamw.init_state(jadamw.AdamWConfig(), p), jparams)}
        jshd.set_active_mesh(jmesh)
        try:
            jsh = jstep.state_shardings(jcfg, jmesh, jstate)
        finally:
            jshd.set_active_mesh(None)
        shapes = {n: tuple(p.shape) for n, p in
                  Model(cfg, device="meta").named_parameters()}
        got = step_lib.state_shardings(cfg, mesh, shapes)
        assert got["opt"]["step"] == ()
        for part, tree in (("params", jsh["params"]),
                           ("master", jsh["opt"]["master"]),
                           ("m", jsh["opt"]["m"]), ("v", jsh["opt"]["v"])):
            flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
            sflat = jax.tree_util.tree_leaves(
                tree, is_leaf=lambda s: hasattr(s, "spec"))
            mine = got["params"] if part == "params" else got["opt"][part]
            for (path, leaf), sh in zip(flat, sflat):
                name, lead = _port_name(_keys(path), jcfg)
                spec = _spec(sh.spec, len(leaf.shape), lead)
                if any(e is not None for e in
                       _spec(sh.spec, len(leaf.shape))[:lead]):
                    continue      # ZeRO chose the stacked layer dim
                assert mine[name] == spec, (part, name, mine[name], spec)


def test_sharding_cuts_and_gathers_blocks():
    """``Sharding.local`` takes a rank's block (the major axis first on a
    dimension split over two axes) and ``full`` puts the blocks back."""
    full = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    out = run_ranks(_blocks_rank, 4, full, timeout=TIMEOUT)
    for (coord, a, b, whole_a, whole_b) in out:
        d, m = coord
        assert torch.equal(a, full[2 * d:2 * d + 2, 3 * m:3 * m + 3])
        k = d * 2 + m
        assert torch.equal(b, full[k:k + 1])
        assert torch.equal(whole_a, full) and torch.equal(whole_b, full)


def _blocks_rank(rank, full):
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    a = shd.Sharding(mesh, ("data", "model"))
    b = shd.Sharding(mesh, (("data", "model"), None))
    la, lb = a.local(full), b.local(full)
    return (tuple(mesh.get_coordinate()), la, lb, a.full(la.clone()),
            b.full(lb.clone()))


# ------------------------------------------------------------- MoE paths
ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, reduce_config
from repro.models import moe
from repro.parallel import sharding as shd

inputs = np.load(sys.argv[1])
cases = json.loads(sys.argv[2])
cfg = reduce_config(get_config("olmoe-1b-7b")).with_(dtype="float32")
p = {k: jnp.asarray(inputs[k]) for k in ("router", "e_gate", "e_up",
                                          "e_down")}
x = jnp.asarray(inputs["x"])
out = {}
y, aux = moe.moe_dense_ref(p, x, cfg)
out["dense"], out["dense_aux"] = np.asarray(y), np.asarray(aux)
for c in cases:
    shape, masks, key = tuple(c["mesh"]), c["masks"], c["key"]
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
    plan = (moe.round_robin_plan(cfg.n_experts, shape[1], 8.0)
            if masks is None else
            moe.plan_from_masks(np.array(masks), cfg.n_experts, shape[1],
                                capacity_factor=8.0))
    shd.set_active_mesh(mesh)
    for mode in ("a2a", "tp"):
        y, aux = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg, plan, mode))(
            p, x)
        out[f"{key}_{mode}"] = np.asarray(y)
        out[f"{key}_{mode}_aux"] = np.asarray(aux)
    shd.set_active_mesh(None)
np.savez(sys.argv[3], **out)
"""


def _replicated_masks(n_sh: int, E: int) -> list:
    """Experts 0 and 1 on every shard, the rest round robin."""
    return [(1 << n_sh) - 1] * 2 + [1 << (e % n_sh) for e in range(2, E)]


def _moe_cfg():
    return reduce_config(get_config("olmoe-1b-7b")).with_(dtype="float32")


MOE_CASES = [{"mesh": list(shape), "masks": masks, "key": f"{kind}{shape}"}
             for shape in ((1, 2), (2, 2), (1, 4))
             for kind, masks in (
                 ("rr", None),
                 ("rep", _replicated_masks(shape[1], 8)))]


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The JAX oracle's outputs and the port's, per case."""
    cfg = _moe_cfg()
    rng = np.random.default_rng(29)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    inputs = {"router": rng.normal(size=(D, E)) / D ** 0.5,
              "e_gate": rng.normal(size=(E, D, F)) / D ** 0.5,
              "e_up": rng.normal(size=(E, D, F)) / D ** 0.5,
              "e_down": rng.normal(size=(E, F, D)) / F ** 0.5,
              "x": rng.normal(size=(4, 8, D))}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    d = tmp_path_factory.mktemp("moe_oracle")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    oracle = subprocess.Popen(      # beside the port's worlds
        [sys.executable, "-c", ORACLE, str(d / "in.npz"),
         json.dumps(MOE_CASES), str(d / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = {}
    try:
        for shape in ((1, 2), (2, 2), (1, 4)):
            cases = [c for c in MOE_CASES if tuple(c["mesh"]) == shape]
            ranks = run_ranks(_moe_rank, shape[0] * shape[1], shape, inputs,
                              cases, timeout=TIMEOUT)
            for c in cases:
                for mode in ("a2a", "tp"):
                    key = f"{c['key']}_{mode}"
                    # the global output from each data rank's rows (model
                    # rank 0 of each), and every rank's aux
                    rows = [r["y"][key] for r in ranks if r["coord"][1] == 0]
                    got[key] = np.concatenate(rows)
                    got[f"{key}_aux"] = [r["y"][f"{key}_aux"] for r in ranks]
                    got[f"{key}_ranks"] = [r["y"][key] for r in ranks]
        _, err = oracle.communicate(timeout=300)
    finally:
        oracle.kill()
    assert oracle.returncode == 0, err[-3000:]
    want = dict(np.load(d / "out.npz"))
    return want, got


def _moe_rank(rank, shape, inputs, cases):
    torch.set_num_threads(1)
    cfg = _moe_cfg()
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    p = {k: torch.from_numpy(inputs[k]) for k in ("router", "e_gate",
                                                  "e_up", "e_down")}
    d = mesh.get_local_rank("data")
    B = inputs["x"].shape[0] // shape[0]
    x = torch.from_numpy(inputs["x"][d * B:(d + 1) * B])
    out = {}
    with shd.use_mesh(mesh):
        for c in cases:
            plan = (moe.round_robin_plan(cfg.n_experts, shape[1], 8.0)
                    if c["masks"] is None else
                    moe.plan_from_masks(np.array(c["masks"]), cfg.n_experts,
                                        shape[1], capacity_factor=8.0))
            for mode in ("a2a", "tp"):
                y, aux = moe.moe_apply(p, x, cfg, plan, mode)
                out[f"{c['key']}_{mode}"] = y.numpy()
                out[f"{c['key']}_{mode}_aux"] = float(aux)
    return {"coord": tuple(mesh.get_coordinate()), "y": out}


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: c["key"])
def test_moe_a2a_matches_the_reference(moe_runs, case):
    want, got = moe_runs
    key = f"{case['key']}_a2a"
    assert _gap(got[key], want[key]) <= 1e-5
    assert _gap(got[key], want["dense"]) <= 1e-5
    # every rank holds the whole of its rows (the sequence gathered back)
    for r in got[f"{key}_ranks"]:
        assert r.shape == (4 // case["mesh"][0], 8, 64)
    for aux in got[f"{key}_aux"]:
        assert abs(aux - float(want["dense_aux"])) <= 1e-5


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: c["key"])
def test_moe_tp_counts_each_choice_once(moe_runs, case):
    want, got = moe_runs
    key = f"{case['key']}_tp"
    if case["masks"] is None:
        assert _gap(got[key], want[key]) <= 1e-5
    assert _gap(got[key], want["dense"]) <= 1e-5
    assert _gap(got[key], want[f"{case['key']}_a2a"]) <= 1e-5
    for aux in got[f"{key}_aux"]:
        assert abs(aux - float(want["dense_aux"])) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_reference_moe_tp_double_counts_replicas(moe_runs, shape):
    """ROADMAP Queue 3 i: the reference's ``moe_tp`` adds a replicated
    expert's output once per replica (``src/repro/models/moe.py:276``), so
    it is far off the dense reference under the replicated plan and exact
    under round robin."""
    want, _ = moe_runs
    assert _gap(want[f"rep{shape}_tp"], want["dense"]) > 1e-3
    assert _gap(want[f"rr{shape}_tp"], want["dense"]) <= 1e-5
    assert _gap(want[f"rep{shape}_a2a"], want["dense"]) <= 1e-5


# ---------------------------------------------- sharded serve and training
def _cfg(arch: str):
    return reduce_config(get_config(arch)).with_(dtype="float32",
                                                 strategy="tp")


def _train(arch: str, mesh, steps: int = 3, zero: bool = False) -> list:
    cfg = _cfg(arch).with_(zero_opt_state=zero)
    plan = (moe.round_robin_plan(
        cfg.n_experts, shd.axis_sizes(mesh)["model"] if mesh else 1, 8.0)
        if cfg.n_experts else None)
    ts = step_lib.build_train_step(
        cfg, adamw.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=8),
        mesh=mesh, plan=plan, device="cpu")
    state = ts.init_state(0)
    rng = np.random.default_rng(5)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab, (4, 17))
        batch = ts.local_batch(step_lib.batch_to(
            {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, "cpu"))
        state, m = ts.step_fn(state, batch)
        out.append(float(m["loss"]))
    return out


def _serve(arch: str, placement):
    return serve(_cfg(arch), 4, 16, 5, device="cpu", placement=placement,
                 capacity_factor=8.0)


def _sharded_rank(rank, shape):
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    with shd.use_mesh(mesh):
        for arch in ("olmoe-1b-7b", "smollm-135m"):
            r = _serve(arch, "replicated" if arch == "olmoe-1b-7b" else None)
            out[("serve", arch)] = (r.tokens, r.a2a_bytes, r.placement)
    for arch in ("olmoe-1b-7b", "smollm-135m"):
        out[("train", arch)] = _train(arch, mesh)
    out[("zero", "smollm-135m")] = _train("smollm-135m", mesh, zero=True)
    return {"coord": tuple(mesh.get_coordinate()), "out": out}


@pytest.fixture(scope="module")
def sharded_runs():
    torch.set_num_threads(1)
    one = {}
    for arch in ("olmoe-1b-7b", "smollm-135m"):
        one[("serve", arch)] = _serve(arch, None).tokens
        one[("train", arch)] = _train(arch, None)
    one[("zero", "smollm-135m")] = one[("train", "smollm-135m")]
    got = {shape: run_ranks(_sharded_rank, shape[0] * shape[1], shape,
                            timeout=TIMEOUT)
           for shape in ((1, 2), (2, 2))}
    return one, got


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "smollm-135m"])
def test_sharded_serve_matches_one_device(sharded_runs, arch, shape):
    one, got = sharded_runs
    ranks = got[shape]
    tokens = np.concatenate([r["out"][("serve", arch)][0] for r in ranks
                             if r["coord"][1] == 0])
    assert np.array_equal(tokens, one[("serve", arch)])
    for r in ranks:     # the model ranks of a data rank agree
        d = r["coord"][0]
        assert np.array_equal(r["out"][("serve", arch)][0],
                              tokens[2 * d:2 * d + 2] if shape[0] == 2
                              else tokens)
    if arch == "olmoe-1b-7b":   # the replicated plan was adopted
        _, a2a, rep = ranks[0]["out"][("serve", arch)]
        assert rep["plan"].n_shards == shape[1] == 2
        rr = moe.round_robin_plan(8, 2, 8.0)
        T = 4 // shape[0] * 16 // 2
        served = dataclasses.replace(rep["plan"], capacity_factor=8.0)
        assert a2a == moe.a2a_bytes(served, T, 2, 64, 4)
        assert a2a["sent"] < moe.a2a_bytes(rr, T, 2, 64, 4)["sent"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch, kind", [("olmoe-1b-7b", "train"),
                                        ("smollm-135m", "train"),
                                        ("smollm-135m", "zero")])
def test_sharded_train_step_matches_one_device(sharded_runs, arch, kind,
                                               shape):
    """Three steps' losses; ``zero``: with ``zero_opt_state`` (the
    optimizer state over 'data', the new parameters gathered)."""
    one, got = sharded_runs
    want = one[(kind, arch)]
    for r in got[shape]:
        np.testing.assert_allclose(r["out"][(kind, arch)], want, rtol=1e-5)


# ------------------------------------------------------- meshes, launchers
def _meshes_rank(rank):
    out = {"host": tuple(make_host_mesh(2, device="cpu").shape),
           "host_capped": tuple(make_host_mesh(8, device="cpu").shape)}
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device="cpu")
        except ValueError as e:
            out[multi_pod] = str(e)
    return out


def test_meshes_over_the_process_group():
    """``make_host_mesh`` spans the world with at most the world on the
    model axis; the production meshes build only on 256 (512) ranks."""
    for r in run_ranks(_meshes_rank, 2, timeout=TIMEOUT):
        assert r["host"] == (1, 2) and r["host_capped"] == (1, 2)
        assert "(16, 16) mesh needs 256 ranks" in r[False]
        assert "(2, 16, 16) mesh needs 512 ranks" in r[True]
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), ("data", "model"), device="cpu")


def test_train_launcher_over_a_mesh(tmp_path):
    """``launch.train --mesh 1x2 --device cpu``: two gloo ranks, the
    reduced olmoe's experts over the model axis, three steps."""
    hist = train_launcher.main([
        "--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
        "--steps", "3", "--batch", "4", "--seq", "16", "--mesh", "1x2",
        "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert (tmp_path / "step_00000003" / "manifest.json").exists()


def test_serve_launcher_over_a_mesh(capsys):
    """``launch.serve --mesh 1x2 --replicated-placement``: the plan for two
    shards adopted, its all_to_all bytes printed."""
    res = serve_launcher.main([
        "--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
        "--requests", "2", "--prompt-len", "8", "--gen", "3",
        "--mesh", "1x2", "--replicated-placement"])
    assert res.tokens.shape == (2, 3)
    assert res.placement["plan"].n_shards == 2 and res.a2a_bytes["sent"]
    out = capsys.readouterr().out
    assert "mesh (1, 2)" in out and "all_to_all bytes" in out
