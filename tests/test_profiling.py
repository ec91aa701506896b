"""Profiling utilities, the compile-cache location, and a solver smoke test."""

import numpy as np

import jax.numpy as jnp

from super_resolution_tpu.utils.profiling import WallClock, device_time


def test_wall_clock():
    with WallClock("test", verbose=False) as t:
        _ = jnp.arange(10).sum()
    assert t.elapsed >= 0.0


def test_device_time():
    import jax

    f = jax.jit(lambda x: (x * 2).sum())
    secs = device_time(f, jnp.arange(1000.0), iterations=5, warmup=1)
    assert secs > 0


def test_solver_default_options_smoke():
    """IRLS solver with default options runs end to end on a tiny problem."""
    from super_resolution_tpu.models import ImageModel, ImageModelParameters
    from super_resolution_tpu.motion import MotionShift, MotionShiftSequence
    from super_resolution_tpu.solvers import IRLSMapSolver, IRLSMapSolverOptions

    seq = MotionShiftSequence([MotionShift(0, 0), MotionShift(-1, -1)])
    model = ImageModel.create(ImageModelParameters(scale=2, motion_sequence=seq))
    rng = np.random.default_rng(0)
    hr = rng.random((1, 8, 8))
    obs = [np.asarray(model.apply(jnp.asarray(hr), k)) for k in range(2)]
    solver = IRLSMapSolver(IRLSMapSolverOptions(), model, obs)
    out = solver.solve(np.zeros((1, 8, 8)))
    assert np.isfinite(np.asarray(out)).all()


def test_compile_cache_follows_environment(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, no other cache directory is set."""
    import jax

    from super_resolution_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.configure_compile_cache() == "/some/where"
    assert calls == []


def test_compile_cache_default_inside_checkout(monkeypatch):
    """Without the variable, the cache is one fixed, git-ignored directory
    at the root of the checkout."""
    import os

    import jax

    from super_resolution_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = compile_cache.configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
