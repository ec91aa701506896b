"""The solver's mesh paths against the single-device objective, on the 8
virtual CPU devices.

Frame and band meshes run the single-program objective partitioned by GSPMD
from the array shardings; row/col meshes run the halo-exchange tiled
objective (``parallel/halo.py``). Each mesh is compared with the one-device
run of the same problem: one objective evaluation, the full IRLS solve with
the host loop and with ``fused_irls``, and where the shards land.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel, ImageModelParameters
from super_resolution_tpu.motion import MotionShiftSequence
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu.ops.tv import TotalVariationRegularizer
from super_resolution_tpu.parallel import make_mesh
from super_resolution_tpu.solvers import IRLSMapSolver, IRLSMapSolverOptions

MESHES = {
    "frame4": {"frame": 4},
    "band4": {"band": 4},
    "frame2_band2": {"frame": 2, "band": 2},
    "row2": {"row": 2},
    "col2": {"col": 2},
    "rowcol2x2": {"row": 2, "col": 2},
}
REGS = {
    "none": None,
    "tv": TotalVariationRegularizer(),
    "tv3d": TotalVariationRegularizer(use_3d_total_variation=True),
    "btv": BilateralTotalVariationRegularizer(2, 0.7),
}
SHIFTS = [(0, 0), (1, 1), (0.5, -1.5), (-1, 0.25)]


def _solver(reg_name, mesh_name=None, channels=4, hw=(24, 32), **opts):
    rng = np.random.default_rng(17)
    hr = jnp.asarray(rng.random((channels, *hw)))
    model = ImageModel.create(ImageModelParameters(
        scale=2, blur_radius=3, blur_sigma=1.0,
        motion_sequence=MotionShiftSequence(SHIFTS),
    ))
    obs = [np.asarray(model.apply(hr, k)) for k in range(len(SHIFTS))]
    mesh = None
    if mesh_name is not None:
        axes = MESHES[mesh_name]
        mesh = make_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])
    options = IRLSMapSolverOptions(max_num_irls_iterations=2,
                                   max_num_solver_iterations=10, **opts)
    solver = IRLSMapSolver(options, model, obs, mesh=mesh)
    if REGS[reg_name] is not None:
        solver.add_regularizer(REGS[reg_name], 0.01)
    return solver, hr


def _evaluate(solver, x, w):
    """One evaluation of the objective the solver builds for its placement."""
    opts = solver.options
    make_spatial = solver._spatial_objective(opts, solver.num_channels)
    if make_spatial is not None:
        vg = make_spatial(solver.observations, solver.shifts)
    else:
        vg = solver._value_and_grad(opts, solver.observations, solver.shifts)
    weights = (solver._place_initial(w),) if solver.regularizers else ()
    return jax.jit(lambda xx, ww: vg.prepare(ww)(xx))(
        solver._place_initial(x), weights
    )


@pytest.mark.filterwarnings("ignore:Mesh solve falling back")
@pytest.mark.parametrize("reg_name", sorted(REGS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_objective_matches_single_device(mesh_name, reg_name):
    single, hr = _solver(reg_name)
    sharded, _ = _solver(reg_name, mesh_name)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random(hr.shape))
    w = jnp.asarray(rng.uniform(0.5, 1.5, hr.shape))
    c1, g1 = _evaluate(single, x, w)
    cm, gm = _evaluate(sharded, x, w)
    assert abs(float(cm) - float(c1)) <= 1e-10 * abs(float(c1))
    g1 = np.asarray(g1)
    assert np.max(np.abs(np.asarray(gm) - g1)) <= 1e-10 * np.max(np.abs(g1))


@pytest.mark.parametrize("fused", [False, True], ids=["host_irls", "fused_irls"])
@pytest.mark.parametrize("mesh_name,reg_name", [
    ("frame4", "btv"), ("band4", "tv3d"), ("rowcol2x2", "btv"),
    ("frame2_band2", "tv"),
])
def test_mesh_solve_matches_single_device(mesh_name, reg_name, fused):
    """The whole IRLS solve on the mesh lands where the one-device solve
    does (relative L2 <= 1e-6 in float64)."""
    single, hr = _solver(reg_name, fused_irls=fused)
    sharded, _ = _solver(reg_name, mesh_name, fused_irls=fused)
    x0 = jnp.zeros_like(hr)
    x1 = np.asarray(single.solve(x0))
    xm = np.asarray(sharded.solve(x0))
    assert np.linalg.norm(xm - x1) <= 1e-6 * np.linalg.norm(x1)


@pytest.mark.parametrize("mesh_name", ["frame4", "band4", "rowcol2x2",
                                       "frame2_band2"])
def test_mesh_shards_land_on_every_device(mesh_name):
    """The observations and the result are spread over every device of the
    mesh (a mesh that put everything on device 0 would fail here)."""
    sharded, hr = _solver("tv", mesh_name)
    n = int(np.prod(list(MESHES[mesh_name].values())))
    obs_devices = {s.device.id for s in sharded.observations.addressable_shards}
    out = sharded.solve(jnp.zeros_like(hr))
    assert obs_devices == set(range(n))
    assert {d.id for d in out.sharding.device_set} == set(range(n))


def test_scaling_harness_needs_the_devices_it_measures():
    """The scaling harness measures live devices only: asking for more than
    there are fails instead of falling back."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    with pytest.raises(RuntimeError, match="devices"):
        bench.bench_scaling(device_counts=[len(jax.devices()) + 1], iters=1,
                            repeats=1, hr=16, frames=2)
