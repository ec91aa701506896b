"""The MAP objective's XLA paths against a float64 numpy reference.

The objective every backend runs, checked for: border semantics (zero
outside the image after every operator), the reference's gradient chain,
fused versus separate TV/BTV terms, multi-band stacks, traced versus static
shifts, and the weight binding (``prepare``) the inner solvers use.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from super_resolution_tpu.ops.blur import gaussian_kernel_2d
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu.ops.tv import TotalVariationRegularizer
from super_resolution_tpu.solvers.objective import (
    data_term_cost_and_grad,
    data_term_cost_and_grad_static,
    make_map_value_and_grad,
)
from super_resolution_tpu.utils.testing import reference_objective


def _kernel(kind, rng):
    if kind == "none":
        return None
    if kind == "asym":
        return rng.random((5, 3))
    return gaussian_kernel_2d(2 * int(kind) + 1, 1.0)


def _problem(shifts, scale, hw, channels=1, kernel="1", seed=5):
    rng = np.random.default_rng(seed)
    x = rng.random((channels, *hw))
    obs = rng.random((len(shifts), channels, hw[0] // scale, hw[1] // scale))
    return x, obs, np.asarray(shifts, np.float64), _kernel(kernel, rng), rng


def _close(got, want, rel=1e-10):
    got = np.asarray(got, np.float64)
    scale = max(np.max(np.abs(want)), 1e-30)
    assert np.max(np.abs(got - want)) <= rel * scale, np.max(np.abs(got - want))


DATA_CASES = [
    # (shifts, scale, hw, channels, kernel)
    ([(0, 0), (1, 1), (0, 1), (1, 0)], 2, (32, 32), 1, "1"),
    ([(0, 0), (-1, 2)], 4, (32, 48), 1, "2"),
    ([(0, 0), (0.5, -0.5), (1.25, 0.75)], 2, (24, 40), 1, "1"),
    ([(0, 0), (1, 1)], 2, (32, 32), 1, "none"),
    ([(0, 0), (1, -1)], 3, (27, 33), 1, "asym"),
    ([(0, 0), (-2.5, -1.75)], 3, (30, 24), 2, "1"),
    ([(3, -3), (-3, 3)], 2, (20, 20), 1, "2"),
    ([(0.25, 0.75)], 4, (16, 32), 3, "asym"),
    ([(0, 0), (1, 0), (0, 1), (1, 1), (2, 2), (-1, -1)], 2, (18, 26), 1, "1"),
    ([(0, 0), (1.5, 0.5)], 1, (12, 14), 1, "1"),
]


@pytest.mark.parametrize("shifts,scale,hw,channels,kernel", DATA_CASES)
def test_data_term_matches_reference(shifts, scale, hw, channels, kernel):
    """Traced-shift data term (the solver's default) against the numpy
    reference, borders included."""
    x, obs, sh, k, _ = _problem(shifts, scale, hw, channels, kernel)
    cost, grad = data_term_cost_and_grad(
        jnp.asarray(x), jnp.asarray(obs), jnp.asarray(sh),
        None if k is None else jnp.asarray(k), scale, max_shift=4,
    )
    c_ref, g_ref = reference_objective(x, obs, sh, k, scale)
    assert abs(float(cost) - c_ref) <= 1e-10 * abs(c_ref)
    _close(grad, g_ref)


@pytest.mark.parametrize("shifts,scale,hw,channels,kernel", DATA_CASES[:6])
def test_static_data_term_matches_traced(shifts, scale, hw, channels, kernel):
    """Host-known shifts specialize the trace without changing the result."""
    x, obs, sh, k, _ = _problem(shifts, scale, hw, channels, kernel)
    kj = None if k is None else jnp.asarray(k)
    c_t, g_t = data_term_cost_and_grad(
        jnp.asarray(x), jnp.asarray(obs), jnp.asarray(sh), kj, scale, 4
    )
    c_s, g_s = data_term_cost_and_grad_static(
        jnp.asarray(x), jnp.asarray(obs), sh, kj, scale
    )
    assert abs(float(c_s) - float(c_t)) <= 1e-10 * abs(float(c_t))
    _close(g_s, np.asarray(g_t))


REGS = {
    "none": (None, None),
    "tv": (TotalVariationRegularizer(), ("tv", False)),
    "tv3d": (TotalVariationRegularizer(use_3d_total_variation=True), ("tv", True)),
    "btv": (BilateralTotalVariationRegularizer(3, 0.5), ("btv", 3, 0.5)),
    "btv_r2": (BilateralTotalVariationRegularizer(2, 0.7), ("btv", 2, 0.7)),
}


def _vg_inputs(reg_name, static, channels=2):
    x, obs, sh, k, rng = _problem([(0, 0), (1, -1), (0.5, 1.25)], 2, (20, 28),
                                  channels, "1")
    reg, spec = REGS[reg_name]
    regs = [] if reg is None else [(reg, 0.05)]
    w = rng.uniform(0.5, 1.5, x.shape)
    vg = make_map_value_and_grad(
        jnp.asarray(obs), jnp.asarray(sh), jnp.asarray(k), 2, regs,
        max_shift=4, static_shifts=sh if static else None,
    )
    weights = (jnp.asarray(w),) if regs else ()
    ref = reference_objective(x, obs, sh, k, 2, spec,
                              None if reg is None else 0.05 * w)
    return vg, jnp.asarray(x), weights, ref, (obs, sh, k, regs)


@pytest.mark.parametrize("static", [False, True], ids=["traced", "static"])
@pytest.mark.parametrize("reg_name", sorted(REGS))
def test_objective_with_regularizer_matches_reference(reg_name, static):
    """Data term plus one IRLS-weighted TV/3D-TV/BTV term, summed in one
    evaluation, against the reference's separate terms."""
    vg, x, weights, (c_ref, g_ref), _ = _vg_inputs(reg_name, static)
    cost, grad = vg(x, weights)
    assert abs(float(cost) - c_ref) <= 1e-10 * abs(c_ref)
    _close(grad, g_ref)


@pytest.mark.parametrize("reg_name", ["none", "tv", "tv3d", "btv"])
def test_prepare_matches_value_and_grad(reg_name):
    """Binding the weights once per inner solve changes nothing."""
    vg, x, weights, _, _ = _vg_inputs(reg_name, static=False)
    c1, g1 = vg(x, weights)
    c2, g2 = jax.jit(vg.prepare(weights))(x)
    assert abs(float(c2) - float(c1)) <= 1e-12 * abs(float(c1))
    _close(g2, np.asarray(g1), 1e-12)


@pytest.mark.parametrize("reg_name", ["none", "tv", "btv"])
def test_multiband_channels_independent(reg_name):
    """Without 3D TV the bands do not interact: a C-band objective is the
    sum of C one-band objectives, band by band."""
    vg, x, weights, _, (obs, sh, k, regs) = _vg_inputs(
        reg_name, static=False, channels=3
    )
    cost, grad = vg(x, weights)
    total = 0.0
    for ch in range(3):
        vg1 = make_map_value_and_grad(
            jnp.asarray(obs[:, ch:ch + 1]), jnp.asarray(sh), jnp.asarray(k), 2,
            regs, max_shift=4,
        )
        c1, g1 = vg1(x[ch:ch + 1], tuple(w[ch:ch + 1] for w in weights))
        total += float(c1)
        _close(grad[ch:ch + 1], np.asarray(g1), 1e-12)
    assert abs(float(cost) - total) <= 1e-10 * abs(total)


@pytest.mark.parametrize("shifts", [
    [(0, 0), (1, 1)], [(2, -1), (-1, 0)], [(0, 0), (0, 3), (3, 0)], [(-2, -2)],
])
def test_integer_shift_gradient_is_exact_adjoint(shifts):
    """For integer shifts and a symmetric kernel the reference's gradient
    chain is the exact adjoint: it equals jax.grad of the cost."""
    x, obs, sh, k, _ = _problem(shifts, 2, (16, 20), 1, "1")
    args = (jnp.asarray(obs), jnp.asarray(sh), jnp.asarray(k), 2)
    analytic = make_map_value_and_grad(*args, max_shift=4)
    auto = make_map_value_and_grad(*args, max_shift=4, diff_mode="autodiff")
    c_a, g_a = analytic(jnp.asarray(x))
    c_d, g_d = auto(jnp.asarray(x))
    assert abs(float(c_a) - float(c_d)) <= 1e-12 * abs(float(c_d))
    _close(g_a, np.asarray(g_d), 1e-10)


@pytest.mark.parametrize("kernel", ["none", "1", "2"])
def test_reference_gradient_matches_finite_differences(kernel):
    """The numpy reference is itself right: for integer shifts its gradient
    is the derivative of its cost (central differences)."""
    x, obs, sh, k, rng = _problem([(0, 0), (1, -1)], 2, (8, 10), 1, kernel)
    _, grad = reference_objective(x, obs, sh, k, 2)
    for idx in [(0, 0, 0), (0, 3, 4), (0, 7, 9), (0, 5, 1)]:
        step = np.zeros_like(x)
        step[idx] = 1e-6
        cp, _ = reference_objective(x + step, obs, sh, k, 2)
        cm, _ = reference_objective(x - step, obs, sh, k, 2)
        assert abs((cp - cm) / 2e-6 - grad[idx]) <= 1e-5 * max(1.0, abs(grad[idx]))


@pytest.mark.parametrize("reg_name", ["none", "tv", "btv"])
def test_irls_solve_static_matches_traced(reg_name):
    """A whole IRLS solve through IRLSMapSolver with host-known shifts
    lands where the traced-shift solve does."""
    from super_resolution_tpu.models import ImageModel, ImageModelParameters
    from super_resolution_tpu.motion import MotionShiftSequence
    from super_resolution_tpu.solvers import IRLSMapSolver, IRLSMapSolverOptions

    rng = np.random.default_rng(9)
    hr = jnp.asarray(rng.random((1, 24, 24)))
    seq = MotionShiftSequence([(0, 0), (1, 1), (0.5, -1.5), (-1, 0.25)])
    model = ImageModel.create(ImageModelParameters(
        scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq))
    obs = [model.apply(hr, k) for k in range(4)]
    outs = []
    for static in (False, True):
        solver = IRLSMapSolver(
            IRLSMapSolverOptions(max_num_irls_iterations=2,
                                 max_num_solver_iterations=10,
                                 use_static_shifts=static),
            model, obs,
        )
        reg, _ = REGS[reg_name]
        if reg is not None:
            solver.add_regularizer(reg, 0.01)
        outs.append(np.asarray(solver.solve(jnp.zeros_like(hr))))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-8)
