"""``repro_torch`` imports neither JAX nor anything of the JAX package.

Other test files load jax into the pytest workers, so the check runs in a
fresh interpreter: it imports every module of the port and then looks at
``sys.modules``.
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
                 "core.placement.replay"):
        assert f"repro_torch.{name}" in got["modules"]
    assert len(got["modules"]) >= 15          # every module was imported
    assert got["bad"] == [], f"the port pulled in {got['bad']}"
