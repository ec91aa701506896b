"""Production-path routing: which objective a solve builds, mesh-fallback
warnings, the LRU executable cache, and the registration unit convention.

The reference's binary IS its production solver (one code path,
``super_resolution.cpp:126-199``); these tests pin the rules that make the
same true here — one XLA objective per placement, chosen from the mesh the
caller passes, shift values out of the executable cache key unless the
caller asks for static shifts, and any mesh fallback audible.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel, ImageModelParameters
from super_resolution_tpu.motion import MotionShift, MotionShiftSequence
from super_resolution_tpu.ops.tv import TotalVariationRegularizer
from super_resolution_tpu.solvers import IRLSMapSolver, IRLSMapSolverOptions


def _tiny_problem(shifts=((0, 0), (1, 1), (-1, 0), (0, -1)), scale=2, n=12,
                  channels=1):
    rng = np.random.default_rng(7)
    hr = jnp.asarray(rng.random((channels, n, n)))
    seq = MotionShiftSequence([MotionShift(dx, dy) for dx, dy in shifts])
    model = ImageModel.create(
        ImageModelParameters(scale=scale, blur_radius=3, blur_sigma=1.0,
                             motion_sequence=seq)
    )
    obs = [model.apply(hr, k) for k in range(len(shifts))]
    return hr, model, obs


def test_solver_records_resolved_options():
    """A default-options solve exposes the options it ran with, and
    fractional motion solves through the same traced-shift objective."""
    hr, model, obs = _tiny_problem()
    solver = IRLSMapSolver(IRLSMapSolverOptions(max_num_irls_iterations=1),
                           model, obs)
    solver.add_regularizer(TotalVariationRegularizer(), 0.01)
    solver.solve(jnp.zeros_like(hr))
    assert isinstance(solver.last_resolved_options, IRLSMapSolverOptions)
    assert solver.last_resolved_options.use_static_shifts is False
    assert solver.last_inner_iterations > 0

    hr2, model2, obs2 = _tiny_problem(shifts=((0, 0), (0.5, -0.75)))
    solver2 = IRLSMapSolver(
        IRLSMapSolverOptions(max_num_irls_iterations=1), model2, obs2,
    )
    solver2.add_regularizer(TotalVariationRegularizer(), 0.01)
    out = solver2.solve(jnp.zeros_like(hr2))
    assert np.isfinite(np.asarray(out)).all()


def _solver_cache_entries(monkeypatch, options, shift_sets):
    import super_resolution_tpu.solvers.irls as irls_mod

    monkeypatch.setattr(irls_mod, "_BUILT_SOLVER_CACHE", type(irls_mod._BUILT_SOLVER_CACHE)())
    for shifts in shift_sets:
        hr, model, obs = _tiny_problem(shifts=shifts)
        solver = IRLSMapSolver(options, model, obs)
        solver.add_regularizer(TotalVariationRegularizer(), 0.01)
        solver.solve(jnp.zeros_like(hr))
    return len(irls_mod._BUILT_SOLVER_CACHE)


SHIFT_SETS = (((0, 0), (1, 1), (-1, 0)), ((0, 0), (1, -1), (0, 1)))


def test_traced_shifts_share_one_executable(monkeypatch):
    """By default shifts are traced arguments: new motion reuses the built
    solver (video sliding windows depend on it)."""
    opts = IRLSMapSolverOptions(max_num_irls_iterations=1)
    assert _solver_cache_entries(monkeypatch, opts, SHIFT_SETS) == 1


def test_static_shifts_specialize_per_motion(monkeypatch):
    """use_static_shifts bakes the motion into the trace, so each shift set
    builds its own solver."""
    opts = IRLSMapSolverOptions(max_num_irls_iterations=1,
                                use_static_shifts=True)
    assert _solver_cache_entries(monkeypatch, opts, SHIFT_SETS) == 2


def test_static_and_traced_shifts_agree():
    """The static-shift objective is the traced one, specialized: the two
    solves agree."""
    hr, model, obs = _tiny_problem(shifts=((0, 0), (1, 1), (0.5, -0.5)))
    outs = []
    for static in (False, True):
        solver = IRLSMapSolver(
            IRLSMapSolverOptions(max_num_irls_iterations=2,
                                 use_static_shifts=static),
            model, obs,
        )
        solver.add_regularizer(TotalVariationRegularizer(), 0.01)
        outs.append(np.asarray(solver.solve(jnp.zeros_like(hr))))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-8)


@pytest.mark.parametrize("axes,spatial", [
    ({"frame": 2}, False), ({"band": 2}, False), ({"row": 2}, True),
    ({"col": 2}, True), ({"row": 2, "col": 2}, True),
])
def test_mesh_routes_to_its_objective(axes, spatial):
    """Row/col meshes get the halo-exchange tiled objective; frame and band
    meshes the GSPMD-partitioned single-program objective."""
    from super_resolution_tpu.parallel import make_mesh

    n = int(np.prod(list(axes.values())))
    hr, model, obs = _tiny_problem(channels=2, n=16)
    mesh = make_mesh(axes, jax.devices()[:n])
    solver = IRLSMapSolver(IRLSMapSolverOptions(), model, obs, mesh=mesh)
    solver.add_regularizer(TotalVariationRegularizer(), 0.01)
    built = solver._spatial_objective(IRLSMapSolverOptions(), 2)
    assert (built is not None) == spatial


def test_spatial_mesh_fallback_warns():
    """A spatial mesh the halo path cannot serve (3D TV couples bands) says
    so and solves through the GSPMD objective."""
    from super_resolution_tpu.parallel import ROW_AXIS, make_mesh

    hr, model, obs = _tiny_problem(channels=2, n=16)
    mesh = make_mesh({ROW_AXIS: 2}, jax.devices()[:2])
    solver = IRLSMapSolver(
        IRLSMapSolverOptions(max_num_irls_iterations=1), model, obs, mesh=mesh,
    )
    solver.add_regularizer(TotalVariationRegularizer(use_3d_total_variation=True), 0.01)
    with pytest.warns(RuntimeWarning, match="spatial halo-exchange"):
        out = solver.solve(jnp.zeros_like(hr))
    assert np.isfinite(np.asarray(out)).all()


def test_built_solver_cache_lru_capped(monkeypatch):
    import super_resolution_tpu.solvers.irls as irls_mod

    irls_mod._BUILT_SOLVER_CACHE.clear()
    monkeypatch.setattr(irls_mod, "_BUILT_SOLVER_CACHE_MAX", 2)
    hr, model, obs = _tiny_problem()
    for iters in (1, 2, 3):
        solver = IRLSMapSolver(
            IRLSMapSolverOptions(max_num_irls_iterations=1,
                                 max_num_solver_iterations=iters),
            model, obs,
        )
        solver.add_regularizer(TotalVariationRegularizer(), 0.01)
        solver.solve(jnp.zeros_like(hr))
    assert len(irls_mod._BUILT_SOLVER_CACHE) == 2
    irls_mod._BUILT_SOLVER_CACHE.clear()


def test_registration_lr_to_hr_scale():
    """Registration sees LR frames -> LR-pixel shifts; the image model warps
    HR pixels. estimated * scale must recover the true HR motion (the CLI
    and video resolver apply this conversion)."""
    import cv2

    from super_resolution_tpu.motion.registration import translational_registration

    gt = cv2.imread("/root/reference/test_data/dallas_half.jpg",
                    cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
    gt = jnp.asarray(gt[None, :192, :192])
    true_hr = [(0.0, 0.0), (2.0, 1.0), (-1.5, 0.5)]
    seq = MotionShiftSequence([MotionShift(dx, dy) for dx, dy in true_hr])
    scale = 2
    model = ImageModel.create(
        ImageModelParameters(scale=scale, blur_radius=3, blur_sigma=1.0,
                             motion_sequence=seq)
    )
    obs = [model.apply(gt, k) for k in range(3)]
    est = translational_registration(obs)
    for (dx_t, dy_t), sh in zip(true_hr, est):
        assert abs(sh.dx * scale - dx_t) < 0.2, (sh.dx * scale, dx_t)
        assert abs(sh.dy * scale - dy_t) < 0.2, (sh.dy * scale, dy_t)
