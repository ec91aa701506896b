"""Frame-sharded IRLSMapSolver (mesh=...) quality parity with single-device."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from super_resolution_tpu.evaluation import psnr
from super_resolution_tpu.models import ImageModel, ImageModelParameters
from super_resolution_tpu.motion import MotionShift, MotionShiftSequence
from super_resolution_tpu.ops.tv import TotalVariationRegularizer
from super_resolution_tpu.parallel import FRAME_AXIS, make_mesh
from super_resolution_tpu.solvers import IRLSMapSolver, IRLSMapSolverOptions

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_mesh_irls_solver_quality_parity():
    rng = np.random.default_rng(1)
    hr = jnp.asarray(rng.random((1, 16, 16)))
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1, 1), MotionShift(-1, 0), MotionShift(0, -1)] * 2
    )
    model = ImageModel.create(
        ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq)
    )
    obs = [np.asarray(model.apply(hr, k)) for k in range(8)]
    mesh = make_mesh({FRAME_AXIS: 8})
    results = {}
    for label, m in (("single", None), ("sharded", mesh)):
        solver = IRLSMapSolver(IRLSMapSolverOptions(), model, obs, mesh=m)
        solver.add_regularizer(TotalVariationRegularizer(), 0.001)
        results[label] = np.asarray(solver.solve(np.zeros((1, 16, 16))))
    p_single = float(psnr(results["single"], np.asarray(hr)))
    p_sharded = float(psnr(results["sharded"], np.asarray(hr)))
    # IRLS reweighting (w = 1/max(1e-5, r)) chaotically amplifies f64
    # reduction-order noise across outer iterations; parity is judged at the
    # quality level (same bar as the C++ reference comparison).
    assert abs(p_single - p_sharded) < 0.1, (p_single, p_sharded)


@pytest.mark.parametrize("reg_kind", ["tv", "btv"])
def test_spatial_mesh_irls_solver_parity(reg_kind):
    """IRLSMapSolver(mesh=row x col) routes through the halo-exchange tiled
    objective (BASELINE config 5's spatial axis) and matches single-device."""
    from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu.parallel import COL_AXIS, ROW_AXIS

    rng = np.random.default_rng(3)
    hr = jnp.asarray(rng.random((1, 16, 32)))
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1, 1), MotionShift(-1, 0), MotionShift(0.5, -0.5)]
    )
    model = ImageModel.create(
        ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq)
    )
    obs = [np.asarray(model.apply(hr, k)) for k in range(4)]
    mesh = make_mesh({ROW_AXIS: 2, COL_AXIS: 4})
    reg = (
        TotalVariationRegularizer()
        if reg_kind == "tv"
        else BilateralTotalVariationRegularizer(2, 0.7)
    )
    results = {}
    for label, m in (("single", None), ("tiled", mesh)):
        solver = IRLSMapSolver(
            IRLSMapSolverOptions(max_num_irls_iterations=3), model, obs, mesh=m
        )
        solver.add_regularizer(reg, 0.001)
        results[label] = np.asarray(solver.solve(np.zeros((1, 16, 32))))
    p_single = float(psnr(results["single"], np.asarray(hr)))
    p_tiled = float(psnr(results["tiled"], np.asarray(hr)))
    assert abs(p_single - p_tiled) < 0.1, (p_single, p_tiled)


@pytest.mark.parametrize("reg_kind", ["tv", "btv"])
def test_spatial_mesh_halo_routing_parity(reg_kind):
    """IRLSMapSolver(mesh=row x col) routes through the halo-exchange tiled
    objective (make_tiled_map_value_and_grad) and matches the
    single-device solve."""
    import super_resolution_tpu.parallel.halo as halo_mod
    from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu.parallel import COL_AXIS, ROW_AXIS

    rng = np.random.default_rng(11)
    hr = jnp.asarray(rng.random((1, 16, 16)), jnp.float64)
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1, 1), MotionShift(-1, 0), MotionShift(0.5, -0.5)]
    )
    model = ImageModel.create(
        ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq)
    )
    obs = [np.asarray(model.apply(hr, k)) for k in range(4)]
    mesh = make_mesh({ROW_AXIS: 2, COL_AXIS: 2}, jax.devices()[:4])
    reg = (
        TotalVariationRegularizer()
        if reg_kind == "tv"
        else BilateralTotalVariationRegularizer(2, 0.7)
    )

    calls = {"n": 0}
    orig = halo_mod.make_tiled_map_value_and_grad

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    halo_mod.make_tiled_map_value_and_grad = counted
    try:
        results = {}
        for label, m in (("single", None), ("tiled", mesh)):
            solver = IRLSMapSolver(
                IRLSMapSolverOptions(
                    max_num_irls_iterations=2, max_num_solver_iterations=8,
                ),
                model, obs, mesh=m,
            )
            solver.add_regularizer(reg, 0.001)
            results[label] = np.asarray(solver.solve(np.zeros((1, 16, 16))))
    finally:
        halo_mod.make_tiled_map_value_and_grad = orig
    assert calls["n"] >= 1  # the mesh solve actually took the halo path
    p_single = float(psnr(results["single"], np.asarray(hr)))
    p_tiled = float(psnr(results["tiled"], np.asarray(hr)))
    assert abs(p_single - p_tiled) < 0.1, (p_single, p_tiled)


def test_spatial_x_frame_mesh_solver_parity():
    """Composite row x col x frame mesh through IRLSMapSolver: the
    GSPMD-partitioned objective (the halo path is spatial-only)."""
    from super_resolution_tpu.parallel import COL_AXIS, ROW_AXIS

    rng = np.random.default_rng(13)
    hr = jnp.asarray(rng.random((1, 16, 16)), jnp.float64)
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1.25, 0.5),
         MotionShift(-0.75, 1.0), MotionShift(0.5, -1.25)]
    )
    model = ImageModel.create(
        ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq)
    )
    obs = [np.asarray(model.apply(hr, k)) for k in range(4)]
    mesh = make_mesh({ROW_AXIS: 2, COL_AXIS: 2, FRAME_AXIS: 2})
    results = {}
    for label, m in (("single", None), ("tiled", mesh)):
        solver = IRLSMapSolver(
            IRLSMapSolverOptions(
                max_num_irls_iterations=2, max_num_solver_iterations=6,
            ),
            model, obs, mesh=m,
        )
        solver.add_regularizer(TotalVariationRegularizer(), 0.001)
        results[label] = np.asarray(solver.solve(np.zeros((1, 16, 16))))
    p_single = float(psnr(results["single"], np.asarray(hr)))
    p_tiled = float(psnr(results["tiled"], np.asarray(hr)))
    assert abs(p_single - p_tiled) < 0.1, (p_single, p_tiled)
