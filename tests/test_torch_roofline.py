"""The port's planning tools against the JAX package's, on the CPU.

``configs.shapes`` (``SHAPES``, ``cell_is_applicable``, ``input_specs``:
meta tensors against ``ShapeDtypeStruct``s, the same keys, shapes and
dtypes), ``roofline.model.step_cost`` (every key within 1e-12 relative of
JAX's for every registry config, applicable shape and (dp, tp) in {(1,
1), (16, 16), (32, 16)}, with olmoe's expert placement and deepseek's
ZeRO knob; the roofline terms against ``benchmarks/roofline.py::analyze``
at the H100's constants), ``core.placement.plan_remat`` (the same
decision and numbers once the JAX module's two rates are the H100's), the
JAX knob-direction and monotonicity checks repeated on the port, and the
collective counter of ``roofline.hlo`` on a one-rank gloo group against
JAX's HLO parser on the matching lines.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import cell_is_applicable as j_applicable  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import input_specs as j_input_specs  # noqa: E402
from repro.core.placement import remat_policy as j_remat  # noqa: E402
from repro.roofline.hlo import collective_bytes_from_text  # noqa: E402
from repro.roofline.model import step_cost as j_step_cost  # noqa: E402
from repro_torch.configs import (SHAPES, cell_is_applicable,  # noqa: E402
                                 get_config, input_specs, list_archs,
                                 reduce_config)
from repro_torch.core.placement import plan_remat  # noqa: E402
from repro_torch.roofline import model as rm  # noqa: E402
from repro_torch.roofline.model import step_cost  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list_archs()
MESHES = [(1, 1), (16, 16), (32, 16)]
# (arch, config fields) beyond the registry's: the knobs step_cost reads
VARIANTS = ([(a, {}) for a in ARCHS]
            + [("olmoe-1b-7b", {"expert_placement": 0.3}),
               ("olmoe-1b-7b", {"expert_placement": (0.3, 1.25)}),
               ("deepseek-v3-671b", {"zero_opt_state": True}),
               ("hymba-1.5b", {"remat": "none"})])
REL = 1e-12


def _args(shape):
    """(B, S, K) of a shape, as ``benchmarks/roofline.py::analyze``
    takes them."""
    if shape.kind == "decode":
        return shape.global_batch, 1, shape.seq_len
    return shape.global_batch, shape.seq_len, shape.seq_len


def test_shapes_are_the_reference_shapes():
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(J_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_applicability_match(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in SHAPES:
        assert cell_is_applicable(cfg, name) == j_applicable(jcfg, name)
        for batch in (None, 3):
            got = input_specs(cfg, name, batch)
            want = j_input_specs(jcfg, name, batch)
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (name, k)
                assert str(t.dtype).removeprefix("torch.") == str(
                    want[k].dtype), (name, k)


@pytest.mark.parametrize("arch,fields", VARIANTS,
                         ids=[f"{a}-{'-'.join(map(str, f.values()))}"
                              for a, f in VARIANTS])
def test_step_cost_matches_reference(arch, fields):
    cfg = get_config(arch).with_(**fields)
    jcfg = j_get_config(arch).with_(**fields)
    n = 0
    for name, shape in SHAPES.items():
        if not cell_is_applicable(cfg, name)[0]:
            continue
        for dp, tp in MESHES:
            got = step_cost(cfg, *_args(shape), dp, tp, shape.kind)
            want = j_step_cost(jcfg, *_args(shape), dp, tp, shape.kind)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=REL, abs=0), \
                    (name, dp, tp, k)
            n += 1
    assert n >= 6


def _analyze():
    """``benchmarks/roofline.py`` loaded from its file (the benchmarks
    folder is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "bench_roofline", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["hymba-1.5b", "olmoe-1b-7b",
                                  "deepseek-v3-671b", "hubert-xlarge"])
def test_roofline_terms_are_analyze_at_h100_rates(arch, monkeypatch):
    bench = _analyze()
    monkeypatch.setattr(bench, "PEAK_FLOPS", rm.PEAK_FLOPS)
    monkeypatch.setattr(bench, "HBM_BW", rm.HBM_BW)
    monkeypatch.setattr(bench, "LINK_BW", rm.LINK_BW)
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        if not cell_is_applicable(cfg, name)[0]:
            continue
        for dp, tp in MESHES:
            chips = dp * tp
            cell = {"status": "ok", "cell": name, "arch": arch,
                    "shape": name, "mesh": {"data": dp, "model": tp},
                    "chips": chips, "memory": {"peak_bytes": 0}}
            want = bench.analyze(cell)
            got = rm.roofline_terms(cfg, *_args(shape), dp, tp, shape.kind,
                                    chips)
            for k in ("compute_s", "memory_s", "collective_s",
                      "model_flops", "useful_ratio", "roofline_fraction"):
                assert got[k] == pytest.approx(want[k], rel=REL), (name, k)
            assert got["bottleneck"] == want["bottleneck"]


def test_h100_constants():
    assert (rm.PEAK_FLOPS, rm.HBM_BW, rm.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    assert (rm.SMS, rm.SM_CLOCK_HZ) == (132, 1980e6)


# the JAX knob checks (tests/test_perf_knobs.py) on the port
def test_analytic_cost_model_knob_directions():
    cfg = get_config("yi-34b")
    base = step_cost(cfg, 256, 4096, 4096, 16, 16, "train")
    padded = step_cost(cfg.with_(n_heads_padded=64), 256, 4096, 4096,
                       16, 16, "train")
    assert padded["flops"] < base["flops"] * 0.5

    v3 = get_config("deepseek-v3-671b")
    b = step_cost(v3, 256, 4096, 4096, 32, 16, "train")
    z = step_cost(v3.with_(zero_opt_state=True), 256, 4096, 4096,
                  32, 16, "train")
    assert z["coll_bytes"] < b["coll_bytes"]
    assert z["hbm_bytes"] < b["hbm_bytes"]

    moe = get_config("olmoe-1b-7b")
    b = step_cost(moe, 256, 4096, 4096, 16, 16, "train")
    pl = step_cost(moe.with_(expert_placement=(0.3, 1.25)), 256, 4096, 4096,
                   16, 16, "train")
    assert pl["coll_bytes"] < b["coll_bytes"]


def test_cost_model_monotonicity_properties():
    cfg = get_config("deepseek-7b")
    seg = cfg.segments[0]
    c30 = step_cost(cfg, 64, 1024, 1024, 8, 8, "prefill")
    c60 = step_cost(cfg.with_(segments=(
        dataclasses.replace(seg, n_layers=60),)), 64, 1024, 1024, 8, 8,
        "prefill")
    assert c60["flops"] > 1.8 * c30["flops"]
    t = step_cost(cfg, 64, 1024, 1024, 8, 8, "train")
    p = step_cost(cfg, 64, 1024, 1024, 8, 8, "prefill")
    assert t["flops"] >= 3 * p["flops"]
    d = step_cost(cfg, 64, 1, 1024, 8, 8, "decode")
    assert d["flops"] < p["flops"] / 100
    half = step_cost(cfg, 64, 1024, 1024, 16, 8, "prefill")
    assert half["flops"] < p["flops"]
    hy = get_config("hymba-1.5b")
    full = step_cost(hy.with_(segments=tuple(
        dataclasses.replace(s, sliding_window=0) for s in hy.segments)),
        8, 32768, 32768, 8, 8, "prefill")
    swa = step_cost(hy, 8, 32768, 32768, 8, 8, "prefill")
    assert swa["flops"] < full["flops"]


# plan_remat: (B, S, dp, tp) cells and budgets
REMAT_CELLS = [(256, 4096, 16, 16), (4, 2048, 1, 1), (8, 1500, 1, 1),
               (2, 64, 1, 1), (32, 32768, 32, 16)]
BUDGETS = [8e9, 56.7e9, 1e12]


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_remat_matches_reference_at_h100_rates(arch, monkeypatch):
    monkeypatch.setattr(j_remat, "PEAK_FLOPS", rm.PEAK_FLOPS)
    monkeypatch.setattr(j_remat, "HBM_BW", rm.HBM_BW)
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (reduce_config(get_config(arch)), None)):
        if jcfg is None:
            from repro.configs import reduce_config as j_reduce
            jcfg = j_reduce(j_get_config(arch))
        for cell in REMAT_CELLS:
            for budget in BUDGETS:
                got = plan_remat(cfg, *cell, hbm_budget_bytes=budget)
                want = j_remat.plan_remat(jcfg, *cell,
                                          hbm_budget_bytes=budget)
                assert got.policy == want.policy, (cell, budget)
                assert got.save_bytes == want.save_bytes
                assert got.fits_budget == want.fits_budget
                assert got.recompute_seconds == pytest.approx(
                    want.recompute_seconds, rel=REL)
                assert got.save_seconds == pytest.approx(
                    want.save_seconds, rel=REL)
    assert plan_remat.__defaults__ == (8e9,)


def test_plan_remat_directions():
    """The JAX test (tests/test_substrate.py) on the port: big models at
    long sequences recompute; tiny ones with headroom do not.  The tiny
    model is smollm-135m at its own widths: the reduced one (d_model 64)
    at B = 2, S = 64 sits on the edge, 1.11e-8 s of recompute against
    1.22e-8 s of saving at the H100's 295 FLOP a byte (a TPU v5e's 240
    kept it on the other side), and picks "full" there, as the JAX
    formula does at the same rates (``test_plan_remat_matches_reference_
    at_h100_rates``)."""
    big = plan_remat(get_config("yi-34b"), B=256, S=4096, dp=16, tp=16)
    assert big.policy == "full"
    assert big.save_bytes > 8e9 or big.recompute_seconds < big.save_seconds
    small = plan_remat(get_config("smollm-135m"), B=2, S=64, dp=1, tp=1)
    assert small.policy == "none"
    assert small.fits_budget
    edge = plan_remat(reduce_config(get_config("smollm-135m")),
                      B=2, S=64, dp=1, tp=1)
    assert edge.policy == "full" and edge.fits_budget
    assert edge.recompute_seconds < edge.save_seconds


_GLOO = """
import json, os, sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
from repro_torch.roofline.hlo import CollectiveCounter
dist.init_process_group("gloo", init_method="tcp://localhost:" + sys.argv[1],
                        world_size=1, rank=0)
g = dist.group.WORLD
x = torch.ones(16, 1024)
y = torch.ones(8, 96, dtype=torch.bfloat16)
with CollectiveCounter() as c:
    outs = [fc.all_reduce(x, "sum", g), fc.all_gather_tensor(y, 0, g),
            fc.reduce_scatter_tensor(x, "sum", 0, g),
            fc.all_to_all_single(y, None, None, g),
            fc.all_reduce(y, "max", g)]
    shapes = [[str(t.dtype).removeprefix("torch."), list(t.shape)]
              for t in (fc.wait_tensor(o) for o in outs)]
dist.destroy_process_group()
print(json.dumps({"result": c.result(), "shapes": shapes}))
"""
_HLO_DT = {"float32": "f32", "bfloat16": "bf16"}


def test_collective_counter_matches_hlo_parser(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "gloo_probe.py"
    script.write_text(_GLOO)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script), str(port)], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    kinds = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "all-reduce"]
    lines = [f"  %{k}.{i} = {_HLO_DT[dt]}[{','.join(map(str, shape))}]"
             f"{{1,0}} {k}(%p.{i}), replica_groups={{{{0}}}}"
             for i, (k, (dt, shape)) in enumerate(zip(kinds,
                                                      got["shapes"]))]
    want = collective_bytes_from_text("\n".join(lines))
    assert got["result"] == want
    assert want["total_bytes"] > 0 and want["counts"]["all-reduce"] == 2


def test_one_card_step_counts_no_collective():
    from repro_torch.roofline.hlo import CollectiveCounter
    with CollectiveCounter() as c:
        torch.ones(4, 4) @ torch.ones(4, 4)
    res = c.result()
    assert res["total_bytes"] == 0 and not any(res["counts"].values())
    assert np.array_equal(sorted(res["per_kind_bytes"]),
                          sorted(collective_bytes_from_text("")[
                              "per_kind_bytes"]))
