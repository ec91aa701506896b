"""Solver options mirroring ``src/optimization/map_solver.h:28-79`` and
``irls_map_solver.h:14-37``."""

from __future__ import annotations

import dataclasses

__all__ = ["MapSolverOptions", "IRLSMapSolverOptions"]


@dataclasses.dataclass
class MapSolverOptions:
    """Options shared by MAP solvers (defaults = reference defaults)."""

    # 'cg' (reference default, strong-Wolfe nonlinear CG), 'lbfgs', or
    # 'linear_cg' — exact-step CG exploiting the quadratic IRLS inner
    # subproblem: one objective evaluation per iteration (the Wolfe search
    # measures 1.56/iter on the flagship) with a true re-evaluation every
    # linear_cg_refresh_every iterations.
    least_squares_solver: str = "cg"
    linear_cg_refresh_every: int = 8
    num_lbfgs_hessian_corrections: int = 5
    max_num_solver_iterations: int = 50
    gradient_norm_threshold: float = 1e-6
    cost_decrease_threshold: float = 1e-6
    parameter_variation_threshold: float = 1e-6
    # 'analytic' = reference-parity hand-derived gradients;
    # 'autodiff' = jax.grad of the cost (machine-precision derivatives);
    # 'numerical' = central differences (the reference's
    # use_numerical_differentiation, map_solver.h:64-69 — O(2n) cost
    # evaluations per gradient, tiny validation problems only).
    diff_mode: str = "analytic"
    split_channels: bool = False
    # Specialize the data term on host-known shifts (unrolled per-frame
    # slices) instead of the vmapped traced-shift form, which serves any
    # motion from one executable.
    use_static_shifts: bool = False
    # Run the ENTIRE IRLS loop in one jitted graph (irls_solve_fused): the
    # outer reweighting becomes a lax.while_loop around the inner CG/L-BFGS
    # while_loop — zero host round-trips per IRLS iteration. The host-loop
    # default keeps per-iteration logging and checkpoint/resume (the fused
    # path supports neither).
    fused_irls: bool = False

    def adjust_thresholds_adaptively(
        self, num_parameters: int, regularization_parameter_sum: float
    ) -> None:
        """Scale stop thresholds by (n_params * sum lambda), only upward
        (``map_solver.cpp:16-26``)."""
        threshold_scale = num_parameters * regularization_parameter_sum
        if threshold_scale < 1.0:
            return
        self.gradient_norm_threshold *= threshold_scale
        self.cost_decrease_threshold *= threshold_scale
        self.parameter_variation_threshold *= threshold_scale


@dataclasses.dataclass
class IRLSMapSolverOptions(MapSolverOptions):
    """IRLS outer-loop options (``irls_map_solver.h:27-35``)."""

    max_num_irls_iterations: int = 20
    irls_cost_difference_threshold: float = 1e-5
    # > 0: every N IRLS iterations, refine the per-frame motion shifts
    # against the current HR estimate by damped Gauss-Newton on the data
    # term (motion/refinement.py) — recovers estimated-registration error
    # (~0.1 HR px, bounded by LR aliasing) once the solve has sharpened x.
    # Shifts stay runtime data of the inner solve, so the refined shifts
    # reuse ONE compiled executable. The reference estimates motion once
    # and never revisits it (registration.cpp:161-201). Composes with the
    # host IRLS loop AND fused_irls (the refinement joins the fused
    # lax.while_loop), single-device or on a pure frame mesh (the per-frame
    # Gauss-Newton shards over the frame axis under GSPMD); band/spatial
    # meshes are rejected (they bake or tile the shifts).
    refine_motion_every: int = 0
    # Gauss-Newton steps per refinement round (2 reaches machine precision
    # against a converged x; the damped steps are ~free next to a solve).
    refine_motion_iterations: int = 2
    # Joint-convergence gate: a converged cost only certifies convergence
    # when the last refinement round moved every shift by less than this
    # (HR px). Raise it for low-texture stacks where Gauss-Newton dithers
    # near the damping floor — otherwise every refined solve runs to
    # max_num_irls_iterations even with the cost criterion satisfied.
    refine_motion_delta_threshold: float = 1e-4

    def adjust_thresholds_adaptively(
        self, num_parameters: int, regularization_parameter_sum: float
    ) -> None:
        threshold_scale = num_parameters * regularization_parameter_sum
        if threshold_scale < 1.0:
            return
        super().adjust_thresholds_adaptively(
            num_parameters, regularization_parameter_sum
        )
        self.irls_cost_difference_threshold *= threshold_scale
