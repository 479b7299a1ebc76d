"""Test-suite bootstrap.

``hypothesis`` is an optional dependency: when it is absent (the container
does not ship it) we install a minimal, deterministic fallback that covers
the subset of the API the tests use -- ``given``, ``settings`` and the
``integers`` / ``booleans`` / ``lists`` / ``data`` strategies.  Examples are
drawn from a fixed-seed ``numpy`` generator, so the fallback behaves like
hypothesis with ``derandomize=True`` (fewer examples, but the property tests
still collect and exercise the code instead of erroring the whole suite).
"""
from __future__ import annotations

import functools
import inspect
import sys
import types


def _install_hypothesis_fallback() -> None:
    import numpy as np

    class _Strategy:
        def __init__(self, draw_fn, name="strategy"):
            self._draw = draw_fn
            self._name = name

        def draw(self, rng):
            return self._draw(rng)

        def __repr__(self):
            return f"<fallback {self._name}>"

    def integers(min_value=None, max_value=None):
        lo = -(2 ** 31) if min_value is None else int(min_value)
        hi = 2 ** 31 - 1 if max_value is None else int(max_value)
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)),
                         f"integers({lo},{hi})")

    def booleans():
        return _Strategy(lambda rng: bool(rng.integers(0, 2)), "booleans")

    def floats(min_value=0.0, max_value=1.0, **_kw):
        lo, hi = float(min_value), float(max_value)
        return _Strategy(lambda rng: float(lo + (hi - lo) * rng.random()),
                         f"floats({lo},{hi})")

    def lists(elements, min_size=0, max_size=10, **_kw):
        def draw(rng):
            size = int(rng.integers(min_size, max_size + 1))
            return [elements.draw(rng) for _ in range(size)]
        return _Strategy(draw, f"lists[{min_size},{max_size}]")

    def sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rng: seq[int(rng.integers(0, len(seq)))],
                         "sampled_from")

    class _DataObject:
        def __init__(self, rng):
            self._rng = rng

        def draw(self, strategy, label=None):
            return strategy.draw(self._rng)

    _DATA = object()  # sentinel: "pass a DataObject for this argument"

    def data():
        return _DATA

    def settings(**kw):
        def deco(fn):
            fn._fallback_settings = kw
            return fn
        return deco

    def given(*gargs, **gkwargs):
        def deco(fn):
            cfg = getattr(fn, "_fallback_settings", {})
            n_examples = min(int(cfg.get("max_examples", 100) or 100), 25)

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                for i in range(n_examples):
                    rng = np.random.default_rng(0xC0FFEE + 7919 * i)
                    drawn = [
                        _DataObject(rng) if s is _DATA else s.draw(rng)
                        for s in gargs
                    ]
                    kw_drawn = {
                        k: (_DataObject(rng) if s is _DATA else s.draw(rng))
                        for k, s in gkwargs.items()
                    }
                    fn(*args, *drawn, **kwargs, **kw_drawn)

            # Hide the drawn parameters from pytest's fixture resolution
            # (they are filled by the wrapper, last positionals first).
            sig = inspect.signature(fn)
            params = list(sig.parameters.values())
            if gargs:
                params = params[:-len(gargs)]
            params = [p for p in params if p.name not in gkwargs]
            wrapper.__signature__ = sig.replace(parameters=params)
            wrapper.hypothesis_fallback = True
            return wrapper
        return deco

    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.booleans = booleans
    st.floats = floats
    st.lists = lists
    st.sampled_from = sampled_from
    st.data = data

    hyp = types.ModuleType("hypothesis")
    hyp.given = given
    hyp.settings = settings
    hyp.strategies = st
    hyp.HealthCheck = types.SimpleNamespace(too_slow=None, filter_too_much=None)
    hyp.__is_fallback__ = True

    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


try:  # pragma: no cover - exercised implicitly by collection
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_fallback()


# Environments without the jax toolchain (e.g. the CI runner) still test the
# pure-python core; the accelerator-facing modules need jax at import time.
try:  # pragma: no cover
    import jax  # noqa: F401
except ImportError:
    collect_ignore = [
        "test_elastic.py",
        "test_front_pass.py",
        "test_kernels.py",
        "test_models_smoke.py",
        "test_perf_knobs.py",
        "test_sharding.py",
        "test_substrate.py",
    ]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")
