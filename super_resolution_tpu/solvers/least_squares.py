"""Matrix-free nonlinear CG and L-BFGS minimizers under ``jit``.

This is the JAX replacement for the reference's use of ALGLIB's
``mincg`` / ``minlbfgs`` (``src/optimization/alglib_objective.cpp``; only the
unconstrained optimizers are used, ``libs/alglib/src/optimization.h:1673-2005,
2770-2822``). Rather than wrapping a C library, both solvers are pure JAX:
the whole minimize loop is a ``lax.while_loop`` whose body evaluates the
(user-supplied) fused cost+gradient — so one ``jit`` traces objective,
line search, and direction updates into a single XLA computation, and the
same code shards across a device mesh when the objective carries
``psum``-reduced terms.

Matching the ALGLIB surface used by the reference:

- Stopping criteria (``mincgsetcond`` semantics, applied per iteration):
  ``|g| <= eps_g`` (Euclidean), ``|f_k - f_{k+1}| <= eps_f *
  max(|f_k|, |f_{k+1}|, 1)``, ``|x_{k+1} - x_k| <= eps_x``, and
  ``max_iterations`` (0 = unlimited -> capped at a large static bound).
- CG: Polak-Ribiere+ with automatic restart on non-descent directions.
- L-BFGS: two-loop recursion with ``memory`` corrections (reference default
  ``num_lbfgs_hessian_corrections = 5``, ``map_solver.h:49-52``).
- Both share a strong-Wolfe bracketing + zoom line search (Nocedal & Wright
  Alg. 3.5/3.6) with static evaluation bounds (compiler-friendly control
  flow; no data-dependent Python branching).

Exact iterate-for-iterate parity with ALGLIB's internal line search is
explicitly a non-goal; the parity target is the convergence point (the
reference tests tolerate 1e-3; see SURVEY.md §7 "CG parity with ALGLIB").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["minimize", "MinimizeResult", "LineSearchConfig"]


def _vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    # Full float32: a GPU may otherwise run a float32 dot in TF32, and every
    # CG step length and direction update comes from these products.
    return jnp.vdot(a.reshape(-1), b.reshape(-1), precision=lax.Precision.HIGHEST)


def _norm(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(_vdot(a, a))


class MinimizeResult(NamedTuple):
    x: jnp.ndarray
    cost: jnp.ndarray
    grad_norm: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    # Total objective (cost+grad) evaluations, incl. line-search trials and
    # the initial one — the real unit of work (each is one fused kernel pass).
    num_evaluations: jnp.ndarray | int = 0


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    c1: float = 1e-4
    c2: float = 0.4  # 0.4 for CG; use 0.9 for (L-)BFGS-style directions
    max_bracket: int = 10
    max_zoom: int = 10
    expansion: float = 2.0


class _LSState(NamedTuple):
    # Shared line-search carry. Phase 0 = bracketing, 1 = zoom, 2 = done.
    phase: jnp.ndarray
    it: jnp.ndarray
    a_prev: jnp.ndarray
    phi_prev: jnp.ndarray
    dphi_prev: jnp.ndarray
    a_cur: jnp.ndarray
    a_lo: jnp.ndarray
    phi_lo: jnp.ndarray
    dphi_lo: jnp.ndarray
    a_hi: jnp.ndarray
    phi_hi: jnp.ndarray
    dphi_hi: jnp.ndarray
    a_star: jnp.ndarray
    phi_star: jnp.ndarray
    g_star: jnp.ndarray
    found: jnp.ndarray


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """Minimizer of the cubic interpolant on [a, b]; falls back to bisection."""
    d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
    arg = d1 * d1 - dfa * dfb
    safe = arg >= 0.0
    d2 = jnp.sqrt(jnp.where(safe, arg, 0.0)) * jnp.sign(b - a)
    denom = dfb - dfa + 2.0 * d2
    t = b - (b - a) * (dfb + d2 - d1) / denom
    mid = 0.5 * (a + b)
    bad = (
        ~safe
        | ~jnp.isfinite(t)
        | (t <= jnp.minimum(a, b))
        | (t >= jnp.maximum(a, b))
        | (jnp.abs(denom) < 1e-30)
    )
    return jnp.where(bad, mid, t)


def wolfe_line_search(
    value_and_grad: Callable,
    x: jnp.ndarray,
    direction: jnp.ndarray,
    f0: jnp.ndarray,
    g0: jnp.ndarray,
    initial_step: jnp.ndarray,
    config: LineSearchConfig,
):
    """Strong-Wolfe line search along ``direction`` from ``x``.

    Returns ``(alpha, f_new, g_new, success)``. On failure returns the best
    Armijo-satisfying point seen (or the last evaluated point).
    """
    dtype = x.dtype
    dphi0 = _vdot(g0, direction).astype(dtype)
    c1 = jnp.asarray(config.c1, dtype)
    c2 = jnp.asarray(config.c2, dtype)

    def phi(a):
        f, g = value_and_grad(x + a * direction)
        return f.astype(dtype), g, _vdot(g, direction).astype(dtype)

    max_iters = config.max_bracket + config.max_zoom
    zero = jnp.zeros((), dtype)

    init = _LSState(
        phase=jnp.zeros((), jnp.int32),
        it=jnp.zeros((), jnp.int32),
        a_prev=zero,
        phi_prev=f0.astype(dtype),
        dphi_prev=dphi0,
        a_cur=jnp.maximum(initial_step.astype(dtype), jnp.asarray(1e-20, dtype)),
        a_lo=zero,
        phi_lo=f0.astype(dtype),
        dphi_lo=dphi0,
        a_hi=zero,
        phi_hi=f0.astype(dtype),
        dphi_hi=dphi0,
        a_star=zero,
        phi_star=f0.astype(dtype),
        g_star=g0,
        found=jnp.zeros((), jnp.bool_),
    )

    def cond(s: _LSState):
        return (s.phase < 2) & (s.it < max_iters)

    def body(s: _LSState):
        # One objective evaluation per loop iteration, at the trial point.
        a_trial = jnp.where(
            s.phase == 0, s.a_cur, _cubic_min(s.a_lo, s.phi_lo, s.dphi_lo, s.a_hi, s.phi_hi, s.dphi_hi)
        )
        phi_a, g_a, dphi_a = phi(a_trial)

        armijo_fail = (phi_a > f0 + c1 * a_trial * dphi0) | (
            (s.it > 0) & (s.phase == 0) & (phi_a >= s.phi_prev)
        )
        curvature_ok = jnp.abs(dphi_a) <= -c2 * dphi0
        wolfe = ~armijo_fail & curvature_ok

        def bracket_update(s):
            # Phase 0 transitions (N&W Alg 3.5).
            to_zoom_hi = armijo_fail  # zoom(a_prev, a)
            to_zoom_lo = (~armijo_fail) & (~curvature_ok) & (dphi_a >= 0)  # zoom(a, a_prev)
            new_phase = jnp.where(
                wolfe,
                jnp.int32(2),
                jnp.where(to_zoom_hi | to_zoom_lo, jnp.int32(1), jnp.int32(0)),
            )
            a_lo = jnp.where(to_zoom_hi, s.a_prev, jnp.where(to_zoom_lo, a_trial, s.a_lo))
            phi_lo = jnp.where(to_zoom_hi, s.phi_prev, jnp.where(to_zoom_lo, phi_a, s.phi_lo))
            dphi_lo = jnp.where(to_zoom_hi, s.dphi_prev, jnp.where(to_zoom_lo, dphi_a, s.dphi_lo))
            a_hi = jnp.where(to_zoom_hi, a_trial, jnp.where(to_zoom_lo, s.a_prev, s.a_hi))
            phi_hi = jnp.where(to_zoom_hi, phi_a, jnp.where(to_zoom_lo, s.phi_prev, s.phi_hi))
            dphi_hi = jnp.where(to_zoom_hi, dphi_a, jnp.where(to_zoom_lo, s.dphi_prev, s.dphi_hi))
            return s._replace(
                phase=new_phase,
                a_prev=a_trial,
                phi_prev=phi_a,
                dphi_prev=dphi_a,
                a_cur=a_trial * config.expansion,
                a_lo=a_lo, phi_lo=phi_lo, dphi_lo=dphi_lo,
                a_hi=a_hi, phi_hi=phi_hi, dphi_hi=dphi_hi,
            )

        def zoom_update(s):
            # Phase 1 transitions (N&W Alg 3.6).
            shrink_hi = (phi_a > f0 + c1 * a_trial * dphi0) | (phi_a >= s.phi_lo)
            # When not shrinking hi: a_trial becomes new lo; hi may flip to old lo.
            flip = (~shrink_hi) & (dphi_a * (s.a_hi - s.a_lo) >= 0)
            new_phase = jnp.where(wolfe, jnp.int32(2), jnp.int32(1))
            a_hi = jnp.where(shrink_hi, a_trial, jnp.where(flip, s.a_lo, s.a_hi))
            phi_hi = jnp.where(shrink_hi, phi_a, jnp.where(flip, s.phi_lo, s.phi_hi))
            dphi_hi = jnp.where(shrink_hi, dphi_a, jnp.where(flip, s.dphi_lo, s.dphi_hi))
            a_lo = jnp.where(shrink_hi, s.a_lo, a_trial)
            phi_lo = jnp.where(shrink_hi, s.phi_lo, phi_a)
            dphi_lo = jnp.where(shrink_hi, s.dphi_lo, dphi_a)
            return s._replace(
                phase=new_phase,
                a_lo=a_lo, phi_lo=phi_lo, dphi_lo=dphi_lo,
                a_hi=a_hi, phi_hi=phi_hi, dphi_hi=dphi_hi,
            )

        s_next = jax.tree_util.tree_map(
            lambda b0, z0: jnp.where(s.phase == 0, b0, z0),
            bracket_update(s),
            zoom_update(s),
        )

        # Track the best point satisfying at least sufficient decrease.
        better = (phi_a < s.phi_star) & (phi_a <= f0 + c1 * a_trial * dphi0)
        accept = wolfe | better
        return s_next._replace(
            it=s.it + 1,
            a_star=jnp.where(accept, a_trial, s.a_star),
            phi_star=jnp.where(accept, phi_a, s.phi_star),
            g_star=jnp.where(accept, g_a, s.g_star),
            found=s.found | wolfe,
        )

    final = lax.while_loop(cond, body, init)
    return final.a_star, final.phi_star, final.g_star, final.found, final.it


class _LinCGState(NamedTuple):
    k: jnp.ndarray
    x: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    d: jnp.ndarray
    alpha_prev: jnp.ndarray
    converged: jnp.ndarray
    n_evals: jnp.ndarray


def _minimize_linear_cg(
    value_and_grad: Callable,
    x0: jnp.ndarray,
    max_iterations: int,
    eps_g: jnp.ndarray,
    eps_f: jnp.ndarray,
    eps_x: jnp.ndarray,
    refresh_every: int,
    log_iterations: bool,
    check_g_static: bool = True,
    check_x_static: bool = True,
) -> MinimizeResult:
    """Exact-step CG for the (piecewise-)quadratic IRLS inner subproblem.

    With the IRLS weights fixed, the MAP inner objective is quadratic in
    ``x`` except on the measure-zero sign-crossing set of the TV/BTV forward
    differences (residuals are sums of |linear|, so ``w r^2`` is piecewise
    quadratic). The strong-Wolfe machinery is then pure overhead: it spends
    more than one objective evaluation per CG iteration on steps a quadratic
    model gives in closed form. Per iteration this method spends exactly ONE
    evaluation, at the trial point ``x + t d``:

        H d      = (g(x + t d) - g(x)) / t        (exact for quadratics)
        alpha    = -g.d / d.H d                   (the exact minimizing step)
        g_{k+1}  = g + alpha H d                  (gradient is affine)
        f_{k+1}  = f + alpha g.d + alpha^2/2 d.Hd

    Every ``refresh_every``-th iteration instead ACCEPTS the trial point
    (``alpha = t``, taking the trial's TRUE ``(f, g)``), which bounds both
    the floating-point drift of the extrapolation and the model error from
    sign-boundary crossings at zero extra cost — exactly ONE evaluation per
    iteration, no ``lax.cond`` in the loop body (a conditional second
    evaluation measured as wall-clock parity with Wolfe CG on-chip despite
    27% fewer counted evaluations; the scalar-select form realizes the
    savings). The accepted-trial step is slightly suboptimal for that one
    iteration (guarded: extrapolation is kept when the trial did not
    decrease f); the next PR+ direction absorbs it. Directions update with
    Polak-Ribiere+ exactly as :func:`minimize`'s ``"cg"`` method; on a true
    quadratic the two converge to the same point, this one without the
    bracketing evals. Replaces the same ALGLIB inner-solver seam
    (``src/optimization/alglib_objective.cpp:27-75``).
    """
    dtype = x0.dtype
    f0, g0 = value_and_grad(x0)
    f0 = f0.astype(dtype)
    tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)

    init = _LinCGState(
        k=jnp.zeros((), jnp.int32),
        x=x0,
        f=f0,
        g=g0,
        d=-g0,
        alpha_prev=jnp.zeros((), dtype),
        converged=_norm(g0) <= eps_g,
        n_evals=jnp.ones((), jnp.int32),
    )

    def cond(s: _LinCGState):
        return (s.k < max_iterations) & (~s.converged)

    # Disabled thresholds (the fixed-iteration bench mode) statically drop
    # their reduction passes from the loop body — with the eval-count
    # already down to 1/iteration, every extra full-array reduce in the
    # body is a measurable slice of the iteration (paired on-chip A/B:
    # the update algebra, not the evaluations, was eating the eval-count
    # win on the TV flagship).
    check_g = check_g_static
    check_x = check_x_static

    def body(s: _LinCGState):
        # One fused pass of second-order scalars off the carried arrays:
        # <g,d> and <g,g> (the latter serves the descent restart, the k=0
        # bootstrap scale, AND the PR+ denominator).
        dphi = _vdot(s.g, s.d).astype(dtype)
        gg = _vdot(s.g, s.g).astype(dtype)
        # Restart with steepest descent if d is not a descent direction.
        bad_dir = dphi >= 0
        d = jnp.where(bad_dir, -s.g, s.d)
        dphi = jnp.where(bad_dir, -gg, dphi)

        # Trial scale for the secant: the previous accepted step is the right
        # order of magnitude (keeps the gradient difference well above
        # rounding); 1/|g| bootstraps iteration 0.
        t = jnp.where(
            s.k == 0,
            1.0 / jnp.maximum(jnp.sqrt(gg), 1e-12),
            jnp.clip(s.alpha_prev, 1e-12, 1e12),
        )
        f_t, g_t = value_and_grad(s.x + t * d)
        f_t = f_t.astype(dtype)
        dg = g_t - s.g                       # = t * H d for quadratics
        dhd = (_vdot(d, dg) / t).astype(dtype)

        pos = dhd > tiny
        alpha_exact = -dphi / jnp.where(pos, dhd, 1.0)
        # Drift refresh: every refresh_every-th iteration ACCEPT the trial
        # point outright — its (f, g) are true values, resetting the
        # extrapolation error, at no extra evaluation. The acceptance must
        # be UNCONDITIONAL: gating it on f_t < f deadlocks once the
        # extrapolated f drifts below the objective's true floor (every
        # refresh then rejects and f free-falls — observed on-chip as a
        # negative reported cost on the TV objective while x stayed sound).
        # A rare ascent trial costs one iteration; PR+ recovers.
        # Nonpositive curvature along d (sign-boundary crossings / rounding
        # on this convex objective) also takes the trial when it decreased
        # f, else stalls.
        refresh_due = (s.k + 1) % refresh_every == 0
        took_trial = refresh_due | ((~pos) & (f_t < s.f))
        alpha = jnp.where(
            took_trial, t, jnp.where(pos, alpha_exact, 0.0)
        )

        # SCALAR blend covers every case with no full-array selects:
        # g_new = g + c*dg is the affine extrapolation for c = alpha/t and
        # EXACTLY g_t for c = 1 (the accepted trial).
        c = jnp.where(took_trial, jnp.ones((), dtype), alpha / t)
        x_new = s.x + alpha * d
        g_new = s.g + c * dg
        f_lin = s.f + alpha * dphi + 0.5 * alpha * alpha * dhd
        f_new = jnp.where(took_trial, f_t, f_lin)

        # Polak-Ribiere+: g_new - g = c*dg, so the numerator reuses the dg
        # array instead of materializing a fresh difference.
        beta = c * _vdot(g_new, dg) / jnp.maximum(gg, tiny)
        beta = jnp.maximum(beta, 0.0).astype(dtype)
        d_new = -g_new + beta * d

        if log_iterations:
            jax.debug.print(
                "Iteration complete ({k}). Sum of squared residuals = {f}",
                k=s.k + 1, f=f_new,
            )

        stalled = alpha == 0.0
        f_small = jnp.abs(s.f - f_new) <= eps_f * jnp.maximum(
            jnp.maximum(jnp.abs(s.f), jnp.abs(f_new)), 1.0
        )
        converged = f_small | stalled
        if check_g:
            converged = converged | (_norm(g_new) <= eps_g)
        if check_x:
            converged = converged | (jnp.abs(alpha) * _norm(d) <= eps_x)

        return _LinCGState(
            k=s.k + 1,
            x=x_new,
            f=f_new,
            g=g_new,
            d=d_new,
            alpha_prev=jnp.abs(alpha),
            converged=converged,
            n_evals=s.n_evals + 1,
        )

    final = lax.while_loop(cond, body, init)
    return MinimizeResult(
        x=final.x,
        cost=final.f,
        grad_norm=_norm(final.g),
        iterations=final.k,
        converged=final.converged,
        num_evaluations=final.n_evals,
    )


class _MinState(NamedTuple):
    k: jnp.ndarray
    x: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    d: jnp.ndarray
    alpha_prev: jnp.ndarray
    dphi_prev: jnp.ndarray
    f_prev: jnp.ndarray
    converged: jnp.ndarray
    n_evals: jnp.ndarray
    # L-BFGS memory (unused by CG, zero-sized there).
    s_mem: jnp.ndarray
    y_mem: jnp.ndarray
    rho_mem: jnp.ndarray
    mem_count: jnp.ndarray


def minimize(
    value_and_grad: Callable,
    x0: jnp.ndarray,
    method: str = "cg",
    max_iterations: int = 50,
    gradient_norm_threshold: float = 1e-6,
    cost_decrease_threshold: float = 1e-6,
    parameter_variation_threshold: float = 1e-6,
    memory: int = 5,
    log_iterations: bool = False,
    line_search: LineSearchConfig | None = None,
    initial_step_mode: str = "scaled",
    linear_cg_refresh_every: int = 8,
) -> MinimizeResult:
    """Minimize a smooth objective given its fused value+gradient function.

    ``method`` is ``"cg"`` (Polak-Ribiere+ nonlinear CG, the reference's
    default solver), ``"lbfgs"``, or ``"linear_cg"`` (exact-step CG for the
    quadratic IRLS inner subproblem — one objective evaluation per iteration
    instead of the Wolfe search's measured 1.56; see
    :func:`_minimize_linear_cg`). All options are static; the returned
    computation is a single jittable graph.
    """
    if method not in ("cg", "lbfgs", "linear_cg"):
        raise ValueError(
            f"Unknown method {method!r}; options: 'cg', 'lbfgs', 'linear_cg'"
        )
    if initial_step_mode not in ("scaled", "quadratic", "quadratic_min"):
        raise ValueError(
            f"Unknown initial_step_mode {initial_step_mode!r}; options: "
            "'scaled', 'quadratic', 'quadratic_min'"
        )
    if method == "lbfgs" and initial_step_mode != "scaled":
        raise ValueError(
            "initial_step_mode applies to CG only: L-BFGS directions are "
            "naturally scaled and always try alpha = 1 first."
        )
    if max_iterations <= 0:
        max_iterations = 10_000  # "0 = unlimited" with a static safety bound
    dtype = x0.dtype
    eps_g = jnp.asarray(gradient_norm_threshold, dtype)
    eps_f = jnp.asarray(cost_decrease_threshold, dtype)
    eps_x = jnp.asarray(parameter_variation_threshold, dtype)
    if method == "linear_cg":
        return _minimize_linear_cg(
            value_and_grad, x0, max_iterations, eps_g, eps_f, eps_x,
            max(1, linear_cg_refresh_every), log_iterations,
            # Static Python thresholds decide whether the reduction passes
            # exist in the loop body at all (the jnp eps values may be
            # tracers under an outer jit).
            check_g_static=float(gradient_norm_threshold) > 0.0,
            check_x_static=float(parameter_variation_threshold) > 0.0,
        )
    ls_config = line_search or LineSearchConfig(c2=0.4 if method == "cg" else 0.9)

    f0, g0 = value_and_grad(x0)
    f0 = f0.astype(dtype)
    d0 = -g0
    n = x0.size
    m = memory if method == "lbfgs" else 1

    init = _MinState(
        k=jnp.zeros((), jnp.int32),
        x=x0,
        f=f0,
        g=g0,
        d=d0,
        alpha_prev=jnp.zeros((), dtype),
        dphi_prev=jnp.zeros((), dtype),
        f_prev=f0,
        converged=_norm(g0) <= eps_g,
        n_evals=jnp.ones((), jnp.int32),
        s_mem=jnp.zeros((m, n), dtype),
        y_mem=jnp.zeros((m, n), dtype),
        rho_mem=jnp.zeros((m,), dtype),
        mem_count=jnp.zeros((), jnp.int32),
    )

    def cond(s: _MinState):
        return (s.k < max_iterations) & (~s.converged)

    def body(s: _MinState):
        dphi = _vdot(s.g, s.d).astype(dtype)
        # Guard: if d is not a descent direction, restart with steepest descent.
        bad_dir = dphi >= 0
        d = jnp.where(bad_dir, -s.g, s.d)
        dphi = jnp.where(bad_dir, -_vdot(s.g, s.g).astype(dtype), dphi)

        # Initial step: previous-step scaling (N&W eq. 3.60) or 1/|g| at k=0
        # for CG. L-BFGS directions are naturally scaled -> try alpha = 1.
        gnorm = _norm(s.g).astype(dtype)
        if method == "cg":
            first_step = 1.0 / jnp.maximum(gnorm, 1e-12)
            safe_dphi = jnp.where(dphi == 0, 1.0, dphi)
            scaled = s.alpha_prev * s.dphi_prev / safe_dphi
            if initial_step_mode == "quadratic":
                # N&W eq. just before 3.60: alpha0 from the one-dimensional
                # quadratic through (f_{k-1}, f_k, dphi). Near-exact for the
                # (near-)quadratic MAP objective -> first Wolfe trial usually
                # accepts, saving line-search evaluations.
                cand = 2.0 * (s.f - s.f_prev) / safe_dphi
                cand = jnp.where(cand > 0, cand, scaled)
            elif initial_step_mode == "quadratic_min":
                cand = 2.0 * (s.f - s.f_prev) / safe_dphi
                cand = jnp.where(
                    cand > 0, jnp.minimum(1.01 * cand, scaled), scaled
                )
            else:
                cand = scaled
            alpha0 = jnp.where(
                s.k == 0,
                first_step,
                jnp.clip(cand, 1e-12, 1e12),
            )
        else:
            alpha0 = jnp.where(
                s.mem_count == 0, 1.0 / jnp.maximum(gnorm, 1e-12), jnp.ones((), dtype)
            )

        alpha, f_new, g_new, ls_ok, ls_evals = wolfe_line_search(
            value_and_grad, s.x, d, s.f, s.g, alpha0, ls_config
        )
        # If the line search found nothing acceptable, stay put (alpha = 0)
        # and mark converged to avoid spinning.
        stalled = alpha == 0.0
        x_new = s.x + alpha * d
        step = alpha * d

        if method == "cg":
            # Polak-Ribiere+ with restart.
            y = g_new - s.g
            beta = _vdot(g_new, y) / jnp.maximum(_vdot(s.g, s.g), 1e-300)
            beta = jnp.maximum(beta, 0.0).astype(dtype)
            d_new = -g_new + beta * d
            s_mem, y_mem, rho_mem, mem_count = s.s_mem, s.y_mem, s.rho_mem, s.mem_count
        else:
            sv = step.reshape(-1)
            yv = (g_new - s.g).reshape(-1)
            sy = _vdot(sv, yv).astype(dtype)
            keep = sy > 1e-10 * _norm(step) * _norm(g_new - s.g)
            slot = s.mem_count % m
            s_mem = jnp.where(keep, s.s_mem.at[slot].set(sv), s.s_mem)
            y_mem = jnp.where(keep, s.y_mem.at[slot].set(yv), s.y_mem)
            rho_mem = jnp.where(
                keep, s.rho_mem.at[slot].set(1.0 / jnp.where(sy == 0, 1.0, sy)), s.rho_mem
            )
            mem_count = s.mem_count + keep.astype(jnp.int32)

            # Two-loop recursion over the valid window.
            q = g_new.reshape(-1)
            count = jnp.minimum(mem_count, m)

            def backward(i, carry):
                q, alphas = carry
                idx = (mem_count - 1 - i) % m
                valid = i < count
                a_i = jnp.where(valid, rho_mem[idx] * _vdot(s_mem[idx], q), 0.0)
                q = q - jnp.where(valid, a_i, 0.0) * y_mem[idx]
                return q, alphas.at[i].set(a_i)

            q, alphas = lax.fori_loop(0, m, backward, (q, jnp.zeros((m,), dtype)))
            last = (mem_count - 1) % m
            gamma = jnp.where(
                count > 0,
                _vdot(s_mem[last], y_mem[last])
                / jnp.maximum(_vdot(y_mem[last], y_mem[last]), 1e-300),
                1.0,
            ).astype(dtype)
            q = gamma * q

            def forward(i, q):
                j = m - 1 - i
                idx = (mem_count - 1 - j) % m
                valid = j < count
                b_i = jnp.where(valid, rho_mem[idx] * _vdot(y_mem[idx], q), 0.0)
                return q + jnp.where(valid, alphas[j] - b_i, 0.0) * s_mem[idx]

            q = lax.fori_loop(0, m, forward, q)
            d_new = -q.reshape(x0.shape)

        if log_iterations:
            # Mirror of AlglibSolverIterationCallback (alglib_objective.cpp:165-178).
            jax.debug.print(
                "Iteration complete ({k}). Sum of squared residuals = {f}",
                k=s.k + 1, f=f_new,
            )

        # ALGLIB-style stopping conditions.
        g_small = _norm(g_new) <= eps_g
        f_small = jnp.abs(s.f - f_new) <= eps_f * jnp.maximum(
            jnp.maximum(jnp.abs(s.f), jnp.abs(f_new)), 1.0
        )
        x_small = _norm(step) <= eps_x
        converged = g_small | f_small | x_small | stalled

        return _MinState(
            k=s.k + 1,
            x=x_new,
            f=f_new,
            g=g_new,
            d=d_new,
            alpha_prev=alpha,
            dphi_prev=dphi,
            f_prev=s.f,
            converged=converged,
            n_evals=s.n_evals + ls_evals,
            s_mem=s_mem,
            y_mem=y_mem,
            rho_mem=rho_mem,
            mem_count=mem_count,
        )

    final = lax.while_loop(cond, body, init)
    return MinimizeResult(
        x=final.x,
        cost=final.f,
        grad_norm=_norm(final.g),
        iterations=final.k,
        converged=final.converged,
        num_evaluations=final.n_evals,
    )
