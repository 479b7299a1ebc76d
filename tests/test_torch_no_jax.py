"""``repro_torch`` imports neither JAX nor anything of the JAX package,
and neither do the worker processes of its shared-memory pool.

Other test files load jax into the pytest workers, so the checks run in a
fresh interpreter: it imports every module of the port (or runs the pool
under ``fork`` and ``spawn``) and then looks at ``sys.modules``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    for name in ("kernels.front_pass", "kernels.front_find",
                 "kernels.flash_attention",
                 "kernels.mamba_scan", "kernels.moe_gmm", "models.model",
                 "models.moe", "launch.serve", "configs.registry",
                 "core.placement.expert_placement", "core.placement.online",
                 "core.placement.replay", "core.partition.multilevel",
                 "core.partition.parallel", "core.schedule.bsp",
                 "core.schedule.engine", "core.schedule.reference",
                 "core.schedule.exact", "core.schedule.list_sched",
                 "core.schedule.replication", "core.schedule.multilevel",
                 "core.frontier.schedule_front", "datagen.dags"):
        assert f"repro_torch.{name}" in got["modules"]
    assert len(got["modules"]) >= 26          # every module was imported
    assert got["bad"] == [], f"the port pulled in {got['bad']}"


_POOL_PROBE = """
import json


def bad_modules(_):
    import sys
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))
                  or m == "repro" or m.startswith("repro."))


if __name__ == "__main__":
    import numpy as np
    from repro_torch.core.partition import (ParallelContext, PartitionState,
                                            parallel_refine)
    from repro_torch.core.partition.heuristic import partition_heuristic
    from repro_torch.core.partition.multilevel import heavy_pin_matching
    from repro_torch.datagen import large_row_net
    hg = large_row_net(600, seed=1)
    res = partition_heuristic(hg, 4, 0.1, seed=0, frontier="numpy")
    out = {}
    for method in ("fork", "spawn"):
        st = PartitionState(hg, 4, masks=res.masks.copy())
        with ParallelContext(2, start_method=method, min_nodes=64) as ctx:
            heavy_pin_matching(hg, 50.0, np.random.default_rng(7), ctx=ctx)
            parallel_refine(hg, st, 4, 0.1, ctx, "rep", 1, seed=3)
            bad = sorted(set().union(*ctx.run(bad_modules, [0] * 4)))
            out[method] = {"failed": ctx.failed, "bad": bad}
    print(json.dumps(out))
"""


def test_pool_workers_import_no_jax_and_no_reference(tmp_path):
    """Workers that have run the pool's matching and refinement tasks hold
    no ``jax`` and no ``repro.`` module, under both start methods."""
    script = tmp_path / "pool_probe.py"
    script.write_text(_POOL_PROBE)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert set(got) == {"fork", "spawn"}
    for method, row in got.items():
        assert row == {"failed": False, "bad": []}, method
