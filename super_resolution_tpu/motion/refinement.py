"""Joint motion refinement against the evolving HR estimate.

The reference estimates motion ONCE, from the aliased LR frames
(``registration.cpp:161-201``), and never revisits it — its registration
error (~0.1 HR px on realistic imaging, bounded by LR aliasing rather than
the estimator) is baked into every subsequent solve. This module closes the
loop the reference never could: with the HR estimate ``x`` partially solved,
the data-term cost

    E_k(dx, dy) = || D B M_{dx,dy} x - y_k ||^2

is a smooth function of each frame's 2 shift parameters (the bilinear warp
is piecewise-linear in the shift, so exact JVP Jacobians exist), and a few
damped Gauss-Newton steps per frame recover the motion to well below the
one-shot registration error. Because the estimated-motion solver takes the
shifts as traced arguments, feeding refined shifts back costs ZERO
recompiles: the alternating scheme (solve x | refine shifts | resume) reuses
one executable throughout.

The refinement is one jitted
program (vmapped over frames, ``lax.fori_loop`` over GN steps, 2 JVPs of
the degradation chain per step) and runs on the same device as the solve.

Convention: shifts are HR-pixel (dx, dy) rows, ``MotionShift`` semantics
(``frame = translate(reference, dx, dy)`` — content moves down-right;
``motion_module.cpp:29-51``). Frame 0 stays pinned to anchor the global
translation gauge (x itself can absorb a common drift otherwise).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["refine_shifts", "make_shift_refiner"]


def refine_shifts(
    x: jnp.ndarray,
    observations: jnp.ndarray,
    shifts: jnp.ndarray,
    blur_kernel: jnp.ndarray | None,
    scale: int,
    num_iterations: int = 3,
    damping: float = 1e-4,
    max_step: float = 0.5,
    max_shift: int = 16,
    pin_first: bool = True,
) -> jnp.ndarray:
    """Damped per-frame Gauss-Newton refinement of translational motion.

    ``x``: current HR estimate ``[C, H, W]``; ``observations``: ``[K, C,
    H/s, W/s]``; ``shifts``: ``[K, 2]`` HR-px (dx, dy) starting estimates.
    Returns the refined ``[K, 2]`` shifts (same dtype/shape; jittable, all
    arguments traced).

    Each GN step solves the per-frame 2x2 normal equations ``(J^T J + lam
    diag(J^T J)) d = -J^T r`` with ``J`` the exact Jacobian of the degraded
    prediction in (dx, dy) (two JVPs through warp -> blur -> decimate), and
    clips the step to ``max_step`` HR px — the bilinear warp's Jacobian is
    only piecewise-constant, so full-pixel jumps would overshoot the linear
    regime. ``pin_first`` keeps frame 0 at its input shift (the gauge
    anchor; frame 0 is (0, 0) by the registration convention).
    """
    # Imported here: models.image_model itself imports the motion package
    # (MotionShiftSequence), so a module-level import would be circular.
    from super_resolution_tpu.models.image_model import degrade

    dtype = x.dtype
    shifts = jnp.asarray(shifts, dtype)
    e_dx = jnp.asarray([1.0, 0.0], dtype)
    e_dy = jnp.asarray([0.0, 1.0], dtype)
    lam = jnp.asarray(damping, dtype)
    cap = jnp.asarray(max_step, dtype)

    def predict(s):
        return degrade(x, s[0], s[1], blur_kernel, scale, max_shift)

    def gn_step(_, s_and_y):
        s, y = s_and_y
        pred, j_dx = jax.jvp(predict, (s,), (e_dx,))
        _, j_dy = jax.jvp(predict, (s,), (e_dy,))
        r = pred - y
        a11 = jnp.sum(j_dx * j_dx)
        a22 = jnp.sum(j_dy * j_dy)
        a12 = jnp.sum(j_dx * j_dy)
        b1 = -jnp.sum(j_dx * r)
        b2 = -jnp.sum(j_dy * r)
        # Levenberg damping on the diagonal keeps the step well-posed on
        # flat frames (uniform regions: J ~ 0). The additive floor must
        # keep det = a11*a22 in the f32 NORMAL range: a flush-to-zero device
        # would turn a subnormal det into 0 and the step into 0/0 = NaN
        # (1e-12 squared is 1e-24 — comfortably normal).
        a11 = a11 + lam * a11 + jnp.asarray(1e-12, dtype)
        a22 = a22 + lam * a22 + jnp.asarray(1e-12, dtype)
        det = a11 * a22 - a12 * a12
        d_dx = (a22 * b1 - a12 * b2) / det
        d_dy = (a11 * b2 - a12 * b1) / det
        step = jnp.clip(jnp.stack([d_dx, d_dy]), -cap, cap)
        return s + step, y

    def refine_one(s0, y):
        s, _ = lax.fori_loop(0, num_iterations, gn_step, (s0, y))
        return s

    refined = jax.vmap(refine_one)(shifts, observations)
    if pin_first:
        refined = refined.at[0].set(shifts[0])
    return refined


def make_shift_refiner(
    blur_kernel,
    scale: int,
    num_iterations: int = 3,
    damping: float = 1e-4,
    max_step: float = 0.5,
    max_shift: int = 16,
):
    """Jitted ``(x, observations, shifts) -> refined_shifts`` closure.

    One compiled executable serves every refinement round of a solve (x,
    observations, and shifts are all traced arguments), mirroring how the
    shift-generic kernel serves every shift set.
    """
    def refiner(x, observations, shifts):
        return refine_shifts(
            x, observations, shifts, blur_kernel, scale,
            num_iterations=num_iterations, damping=damping,
            max_step=max_step, max_shift=max_shift,
        )

    return jax.jit(refiner)
