"""Fully in-graph IRLS solve matches the host-loop solver."""

import numpy as np

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel, ImageModelParameters
from super_resolution_tpu.motion import MotionShift, MotionShiftSequence
from super_resolution_tpu.ops.tv import TotalVariationRegularizer
from super_resolution_tpu.solvers import IRLSMapSolver, IRLSMapSolverOptions
from super_resolution_tpu.solvers.irls import irls_solve_fused
from super_resolution_tpu.solvers.objective import make_map_value_and_grad
from super_resolution_tpu.utils.testing import matrices_equal


def test_fused_irls_matches_host_loop():
    rng = np.random.default_rng(91)
    hr = jnp.asarray(rng.random((1, 12, 12)))
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1, 1), MotionShift(-1, 0), MotionShift(0, -1)]
    )
    model = ImageModel.create(
        ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq)
    )
    obs = jnp.stack([model.apply(hr, k) for k in range(4)])
    shifts = jnp.asarray(seq.as_array())
    kernel = jnp.asarray(model.blur_operator.kernel)
    tv = TotalVariationRegularizer()
    regs = [(tv, 0.01)]

    import dataclasses

    options = IRLSMapSolverOptions()
    scaled = dataclasses.replace(options)
    scaled.adjust_thresholds_adaptively(hr.size, 0.01)

    # Host-loop solver.
    solver = IRLSMapSolver(options, model, list(obs))
    solver.add_regularizer(tv, 0.01)
    host_result = np.asarray(solver.solve(jnp.zeros_like(hr)))

    # Fused in-graph solve with the same (scaled) thresholds and the same
    # (traced-shift) objective path -> bitwise-identical trajectory.
    def builder(weights):
        vg = make_map_value_and_grad(obs, shifts, kernel, 2, regs, max_shift=3)
        return lambda x: vg(x, weights)

    x, cost = jax.jit(
        lambda x0: irls_solve_fused(builder, regs, x0, scaled)
    )(jnp.zeros_like(hr))
    assert matrices_equal(np.asarray(x), host_result, 1e-12)
    assert np.isfinite(float(cost))


def test_fused_irls_no_regularizers():
    rng = np.random.default_rng(92)
    hr = jnp.asarray(rng.random((1, 8, 8)))
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(-1, 0), MotionShift(0, -1), MotionShift(-1, -1)]
    )
    model = ImageModel.create(ImageModelParameters(scale=2, motion_sequence=seq))
    obs = jnp.stack([model.apply(hr, k) for k in range(4)])
    shifts = jnp.asarray(seq.as_array())

    def builder(weights):
        vg = make_map_value_and_grad(obs, shifts, None, 2, max_shift=3)
        return lambda x: vg(x, ())

    x, cost = irls_solve_fused(builder, [], jnp.zeros_like(hr), IRLSMapSolverOptions())
    assert matrices_equal(np.asarray(x), np.asarray(hr), 0.001)


def test_fused_irls_solver_toggle():
    """IRLSMapSolverOptions.fused_irls routes IRLSMapSolver.solve through the
    all-in-graph IRLS and matches the host-loop result; checkpointing is
    rejected (no seam in a single XLA program)."""
    import pytest

    rng = np.random.default_rng(93)
    hr = jnp.asarray(rng.random((1, 12, 12)))
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1, 1), MotionShift(-1, 0), MotionShift(0, -1)]
    )
    model = ImageModel.create(
        ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq)
    )
    obs = [model.apply(hr, k) for k in range(4)]
    tv = TotalVariationRegularizer()

    def run(**extra):
        opts = IRLSMapSolverOptions(**extra)
        solver = IRLSMapSolver(opts, model, obs)
        solver.add_regularizer(tv, 0.01)
        return solver, np.asarray(solver.solve(jnp.zeros_like(hr)))

    _, host = run()
    _, fused = run(fused_irls=True)
    assert matrices_equal(fused, host, 1e-8)

    # The static-shift objective under the fused loop == its own host loop.
    _, host_static = run(use_static_shifts=True)
    _, fused_static = run(fused_irls=True, use_static_shifts=True)
    assert matrices_equal(fused_static, host_static, 1e-8)

    solver, _ = run(fused_irls=True)
    with pytest.raises(ValueError, match="checkpoint"):
        solver.solve(jnp.zeros_like(hr), checkpoint_path="/tmp/nope")


class TestFusedIrlsOnMeshes:
    """fused_irls x mesh: the all-in-graph IRLS loop around the sharded
    objectives (GSPMD on frame/band meshes, the halo-exchange tiled
    objective on row/col meshes). Each case compares against the host-loop
    solver on the SAME sharded objective path — near-bitwise agreement
    expected; single-device parity is covered by test_mesh_paths.py."""

    def _problem(self, channels=2, frames=4, fractional=False, seed=77):
        rng = np.random.default_rng(seed)
        hr = jnp.asarray(rng.random((channels, 16, 16)))
        base = [(0, 0), (1, 1), (-1, 0), (0, -1)]
        if fractional:
            base = [(0, 0), (1.5, 0.5), (-0.75, 1.0), (0.5, -1.25)]
        seq = MotionShiftSequence([MotionShift(dx, dy) for dx, dy in base][:frames])
        model = ImageModel.create(
            ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0,
                                 motion_sequence=seq)
        )
        obs = [np.asarray(model.apply(hr, k)) for k in range(frames)]
        return hr, model, obs

    def _run(self, model, obs, hr, mesh, **extra):
        opts = IRLSMapSolverOptions(
            max_num_irls_iterations=2, max_num_solver_iterations=5, **extra,
        )
        solver = IRLSMapSolver(opts, model, obs, mesh=mesh)
        solver.add_regularizer(TotalVariationRegularizer(), 0.01)
        return np.asarray(solver.solve(jnp.zeros_like(hr)))

    def test_band_mesh(self):
        import pytest

        from super_resolution_tpu.parallel import BAND_AXIS, make_mesh

        if len(jax.devices()) < 2:
            pytest.skip("needs 2 virtual devices")
        hr, model, obs = self._problem(channels=2)
        mesh = make_mesh({BAND_AXIS: 2}, jax.devices()[:2])
        host = self._run(model, obs, hr, mesh)
        fused = self._run(model, obs, hr, mesh, fused_irls=True)
        assert matrices_equal(fused, host, 1e-8)

    def test_frame_mesh(self):
        import pytest

        from super_resolution_tpu.parallel import FRAME_AXIS, make_mesh

        if len(jax.devices()) < 4:
            pytest.skip("needs 4 virtual devices")
        hr, model, obs = self._problem(fractional=True)
        mesh = make_mesh({FRAME_AXIS: 4}, jax.devices()[:4])
        host = self._run(model, obs, hr, mesh)
        fused = self._run(model, obs, hr, mesh, fused_irls=True)
        assert matrices_equal(fused, host, 1e-8)

    def test_two_regularizer_band_mesh_runs(self):
        """Every mesh has a fused-IRLS route: a band mesh with a 2D and a
        3D TV term runs and matches its host loop."""
        import pytest

        from super_resolution_tpu.parallel import BAND_AXIS, make_mesh

        if len(jax.devices()) < 2:
            pytest.skip("needs 2 virtual devices")
        hr, model, obs = self._problem(channels=2)
        mesh = make_mesh({BAND_AXIS: 2}, jax.devices()[:2])

        def run(**extra):
            opts = IRLSMapSolverOptions(
                max_num_irls_iterations=2, max_num_solver_iterations=5, **extra
            )
            solver = IRLSMapSolver(opts, model, obs, mesh=mesh)
            solver.add_regularizer(TotalVariationRegularizer(), 0.01)
            solver.add_regularizer(
                TotalVariationRegularizer(use_3d_total_variation=True), 0.01
            )
            return np.asarray(solver.solve(jnp.zeros_like(hr)))

        assert matrices_equal(run(fused_irls=True), run(), 1e-8)

    def test_spatial_mesh(self):
        """fused_irls x row/col mesh: the all-in-graph IRLS loop around the
        halo-exchange tiled objective."""
        import pytest

        from super_resolution_tpu.parallel import COL_AXIS, ROW_AXIS, make_mesh

        if len(jax.devices()) < 4:
            pytest.skip("needs 4 virtual devices")
        hr, model, obs = self._problem(channels=1)
        mesh = make_mesh({ROW_AXIS: 2, COL_AXIS: 2}, jax.devices()[:4])
        host = self._run(model, obs, hr, mesh)
        fused = self._run(model, obs, hr, mesh, fused_irls=True)
        assert matrices_equal(fused, host, 1e-8)
