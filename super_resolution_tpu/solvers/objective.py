"""The MAP objective: data-fidelity term + IRLS-weighted regularization terms.

Replaces the reference's ObjectiveFunction / ObjectiveDataTerm /
ObjectiveIRLSRegularizationTerm stack (``src/optimization/objective_*.cpp``)
with fused pure functions.

Data term semantics (``objective_data_term.cpp:15-95``): the reference keeps
observations nearest-upsampled on the HR grid (``map_solver.cpp:80-85``),
degrades the HR estimate, re-nearest-upsamples it, takes per-pixel residuals
on the HR grid, and for the gradient additive-downsamples the HR residual
before the adjoint chain. Because nearest-upsampling by integer scale ``s``
repeats each LR pixel ``s^2`` times and additive-downsampling sums them back,
this is *exactly* equivalent to computing everything on the LR grid with an
``s^2`` factor:

    cost   = s^2 * sum_k ||D B M_k x - y_k||^2
    grad   = 2 s^2 * sum_k M_k^T B^T D^T (D B M_k x - y_k)

which is what we compute — no HR-grid blowup, one fused vmap over frames with
the per-frame gradients summed (the psum seam for frame-sharded execution).

Regularization term (``objective_irls_regularization_term.cpp``):
``cost += lambda * sum_i w_i r_i^2`` with gradient constants ``lambda * w``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from super_resolution_tpu.models.image_model import degrade, degrade_adjoint
from super_resolution_tpu.ops.resize import decimate, zero_upsample

__all__ = [
    "data_term_cost_and_grad",
    "data_term_cost",
    "make_map_value_and_grad",
    "finite_difference_grad",
]


def data_term_cost_and_grad(
    x: jnp.ndarray,
    observations: jnp.ndarray,
    shifts: jnp.ndarray,
    blur_kernel: jnp.ndarray | None,
    scale: int,
    max_shift: int = 16,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fused cost+gradient of ``s^2 sum_k ||A_k x - y_k||^2``.

    ``x``: HR estimate ``[C, H, W]``; ``observations``: LR stack
    ``[K, C, H/s, W/s]``; ``shifts``: ``[K, 2]`` (dx, dy) columns.
    """
    s2 = jnp.asarray(float(scale * scale), x.dtype)

    def per_frame(y, shift):
        r = degrade(x, shift[0], shift[1], blur_kernel, scale, max_shift) - y
        cost_k = jnp.sum(r * r)
        grad_k = degrade_adjoint(r, shift[0], shift[1], blur_kernel, scale, max_shift)
        return cost_k, grad_k

    costs, grads = jax.vmap(per_frame)(observations, shifts)
    return s2 * jnp.sum(costs), 2.0 * s2 * jnp.sum(grads, axis=0)


def data_term_cost(
    x: jnp.ndarray,
    observations: jnp.ndarray,
    shifts: jnp.ndarray,
    blur_kernel: jnp.ndarray | None,
    scale: int,
    max_shift: int = 16,
) -> jnp.ndarray:
    """Cost only (for autodiff / numerical-diff modes)."""
    s2 = jnp.asarray(float(scale * scale), x.dtype)

    def per_frame(y, shift):
        r = degrade(x, shift[0], shift[1], blur_kernel, scale, max_shift) - y
        return jnp.sum(r * r)

    return s2 * jnp.sum(jax.vmap(per_frame)(observations, shifts))


def data_term_cost_and_grad_static(
    x: jnp.ndarray,
    observations: jnp.ndarray,
    static_shifts,
    blur_kernel: jnp.ndarray | None,
    scale: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Data term with compile-time-constant shifts.

    When the motion sequence is host-known (every non-distributed solve), the
    per-frame warp specializes at trace time: integer shifts become a single
    shifted slice instead of a 4-tap bilinear gather, and zero-weight taps
    drop out — roughly halving the data term's HBM traffic for the common
    integer-shift case. Semantics identical to :func:`data_term_cost_and_grad`.
    """
    from super_resolution_tpu.ops.blur import blur as _blur, blur_adjoint as _blur_t
    from super_resolution_tpu.ops.warp import translate_static

    s2 = jnp.asarray(float(scale * scale), x.dtype)
    shift_list = [(float(s[0]), float(s[1])) for s in static_shifts]
    cost = jnp.zeros((), x.dtype)
    grad = jnp.zeros_like(x)
    for k, (dx, dy) in enumerate(shift_list):
        z = translate_static(x, dx, dy)
        if blur_kernel is not None:
            z = _blur(z, blur_kernel)
        r = decimate(z, scale) - observations[k]
        cost = cost + jnp.sum(r * r)
        g = zero_upsample(r, scale)
        if blur_kernel is not None:
            g = _blur_t(g, blur_kernel)
        grad = grad + translate_static(g, -dx, -dy)
    return s2 * cost, 2.0 * s2 * grad


def make_map_value_and_grad(
    observations: jnp.ndarray,
    shifts: jnp.ndarray,
    blur_kernel: jnp.ndarray | None,
    scale: int,
    regularizers: Sequence[tuple[object, float]] = (),
    max_shift: int = 16,
    diff_mode: str = "analytic",
    static_shifts=None,
) -> Callable:
    """Build ``value_and_grad(x, weights) -> (cost, grad)`` for the MAP objective.

    ``weights`` is a tuple of per-regularizer IRLS weight arrays (shape of x).

    ``diff_mode``:
    - ``"analytic"`` — the reference's hand-derived gradient chain
      (warp-based pseudo-adjoint + signum regularizer gradients). This is the
      parity path.
    - ``"autodiff"`` — ``jax.grad`` of the cost (the *true* gradient; replaces
      the reference's numerical-differentiation validation mode,
      ``map_solver.h:64-69``, with machine-precision derivatives).

    ``static_shifts`` (host-known ``(dx, dy)`` pairs) specializes the
    analytic data term on the motion at trace time
    (:func:`data_term_cost_and_grad_static`); otherwise the traced
    ``shifts`` are used, so one executable serves any motion.
    """
    if diff_mode not in ("analytic", "autodiff", "numerical"):
        raise ValueError(f"Unknown diff_mode {diff_mode!r}")

    regs = tuple(regularizers)

    def cost_fn(x, weights):
        cost = data_term_cost(x, observations, shifts, blur_kernel, scale, max_shift)
        for (reg, lam), w in zip(regs, weights):
            if lam <= 0.0:
                continue
            r = reg.residuals(x)
            cost = cost + jnp.sum((lam * w) * r * r)
        return cost

    if diff_mode == "autodiff":
        vg = jax.value_and_grad(cost_fn)

        def value_and_grad(x, weights=()):
            return vg(x, tuple(weights))

        value_and_grad.prepare = lambda weights: (
            lambda x: vg(x, tuple(weights))
        )
        return value_and_grad

    if diff_mode == "numerical":
        # The reference's --use_numerical_differentiation end to end
        # (map_solver.h:64-69, alglib_objective.cpp:77-139): central
        # differences of the cost, O(2n) evaluations per gradient — a
        # validation mode for tiny problems, exactly as infeasible at scale
        # as the reference's (which the reference also exposes anyway).
        def value_and_grad(x, weights=()):
            w = tuple(weights)
            cost = cost_fn(x, w)
            grad = finite_difference_grad(lambda z: cost_fn(z, w), x)
            return cost, grad

        value_and_grad.prepare = lambda weights: (
            lambda x: value_and_grad(x, tuple(weights))
        )
        return value_and_grad

    def value_and_grad(x, weights=()):
        if static_shifts is not None:
            cost, grad = data_term_cost_and_grad_static(
                x, observations, static_shifts, blur_kernel, scale
            )
        else:
            cost, grad = data_term_cost_and_grad(
                x, observations, shifts, blur_kernel, scale, max_shift
            )
        for (reg, lam), w in zip(regs, tuple(weights)):
            if lam <= 0.0:
                continue
            c, g = reg.cost_and_grad(x, lam * w)
            cost = cost + c
            grad = grad + g
        return cost, grad

    value_and_grad.prepare = lambda weights: (
        lambda x: value_and_grad(x, tuple(weights))
    )
    return value_and_grad


def finite_difference_grad(cost_fn: Callable, x: jnp.ndarray, step: float = 1e-6):
    """Central-difference gradient (the reference's numerical-diff testing mode,
    ``map_solver.h:64-69``). O(2n) cost evaluations — tiny problems only."""
    flat = x.reshape(-1)
    n = flat.size
    eye = jnp.eye(n, dtype=x.dtype)

    def one(e):
        fp = cost_fn((flat + step * e).reshape(x.shape))
        fm = cost_fn((flat - step * e).reshape(x.shape))
        return (fp - fm) / (2.0 * step)

    return lax.map(one, eye).reshape(x.shape)
