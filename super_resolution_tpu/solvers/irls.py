"""IRLS MAP solver — the production solver (the JAX equivalent of
``src/optimization/irls_map_solver.cpp``).

Algorithm (``RunIRLSLoop``, ``irls_map_solver.cpp:45-157``):

1. Initialize per-regularizer IRLS weights to 1.
2. Inner solve: minimize ``s^2 sum_k ||A_k x - y_k||^2 + sum_r lambda_r
   sum_i w_i r_i(x)^2`` with matrix-free CG or L-BFGS — here one jitted
   ``lax.while_loop`` computation (see :mod:`least_squares`), reused without
   retracing across IRLS iterations (weights are traced arguments).
3. Reweight ``w_i = 1 / max(1e-5, r_i)`` — L1-via-weighted-L2
   (``irls_map_solver.cpp:128-143``, ``kMinResidualValue`` at :34).
4. Repeat until ``|cost_k - cost_{k+1}| < irls_cost_difference_threshold``
   (adaptively scaled) or ``max_num_irls_iterations``.

``split_channels`` solves each channel independently
(``irls_map_solver.cpp:200-262``) — the seam for band-axis sharding of
hyperspectral stacks.

The outer IRLS loop runs on the host (<= 20 cheap iterations around a fully
compiled inner solve), keeping per-iteration logging trivial; the frame loop
inside the data term is a vmap (the reference's serial ``for image_index``).
"""

from __future__ import annotations

import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from super_resolution_tpu.image.image_data import ImageData
from super_resolution_tpu.models.image_model import ImageModel
from super_resolution_tpu.solvers.least_squares import minimize
from super_resolution_tpu.solvers.map_solver import IRLSMapSolverOptions
from super_resolution_tpu.solvers.objective import make_map_value_and_grad
from super_resolution_tpu.solvers.solver import MapSolverBase

__all__ = [
    "IRLSMapSolver",
    "IRLSMapSolverOptions",
    "irls_solve_fused",
]


def irls_solve_fused(
    value_and_grad_builder,
    regularizers,
    x0: jnp.ndarray,
    options: IRLSMapSolverOptions,
    return_iterations: bool = False,
    shifts0=None,
    refiner=None,
):
    """The entire IRLS solve as ONE jittable computation.

    ``value_and_grad_builder(weights) -> (x -> (cost, grad))``. The IRLS
    outer loop is a ``lax.while_loop`` whose body runs the full inner
    CG/L-BFGS ``minimize`` (itself a while_loop) and reweights — so a
    complete multi-iteration MAP solve compiles to a single XLA program with
    no host round-trips, and shards across a mesh when the objective carries
    sharded terms. (The host-loop variant in :class:`IRLSMapSolver` keeps
    checkpointing and logging; use this one for production throughput.)

    With ``refiner`` (and ``shifts0``), motion refinement joins the fused
    loop: the shifts become loop-carried state, the builder is called as
    ``value_and_grad_builder(weights, shifts)``, and every
    ``options.refine_motion_every`` IRLS iterations the body runs
    ``refiner(x, shifts) -> (new_shifts, max|change|)`` under a ``lax.cond``
    — the whole alternating solve-x/refine-motion scheme compiles to one
    XLA program (one SPMD program on a frame mesh). Convergence then
    requires BOTH the cost criterion and the last refinement delta below
    ``options.refine_motion_delta_threshold`` (mirroring the host loop),
    and a refinement whose result could never be consumed (iteration cap
    next) is skipped. Returns ``(..., shifts)`` as the final element.
    """
    regs = tuple(regularizers)
    thr = jnp.asarray(options.irls_cost_difference_threshold, x0.dtype)
    max_irls = options.max_num_irls_iterations or 10_000
    refine_every = (
        getattr(options, "refine_motion_every", 0) if refiner is not None else 0
    )
    if refiner is not None and (shifts0 is None or refine_every <= 0):
        raise ValueError(
            "refiner requires shifts0 and options.refine_motion_every > 0."
        )
    delta_thr = jnp.asarray(
        getattr(options, "refine_motion_delta_threshold", 1e-4), x0.dtype
    )
    # Loop-carried shifts (a dummy scalar when refinement is off, so the
    # carry structure is static).
    shifts_init = shifts0 if refiner is not None else jnp.zeros((), x0.dtype)

    def inner(x, weights, shifts):
        # Bind the weights ONCE per inner solve: weight-derived constants
        # are then computed outside the CG while_loop body (XLA does not
        # hoist them out of the loop itself).
        if refiner is not None:
            prepared = value_and_grad_builder(weights, shifts)
        else:
            prepared = value_and_grad_builder(weights)
        return minimize(
            prepared,
            x,
            method=options.least_squares_solver,
            max_iterations=options.max_num_solver_iterations,
            gradient_norm_threshold=options.gradient_norm_threshold,
            cost_decrease_threshold=options.cost_decrease_threshold,
            parameter_variation_threshold=options.parameter_variation_threshold,
            memory=options.num_lbfgs_hessian_corrections,
            linear_cg_refresh_every=options.linear_cg_refresh_every,
        )

    if not regs and refiner is None:
        result = inner(x0, (), shifts_init)
        if return_iterations:
            return result.x, result.cost, result.iterations
        return result.x, result.cost

    weights0 = tuple(jnp.ones_like(x0) for _ in regs)
    inf = jnp.asarray(jnp.inf, x0.dtype)
    # inf until a refinement round has run (the requested refinement must
    # execute before the joint gate can certify convergence); 0 when off.
    delta_init = (
        jnp.asarray(jnp.inf, x0.dtype)
        if refiner is not None
        else jnp.zeros((), x0.dtype)
    )

    def cond(state):
        done, it = state[5], state[3]
        return (~done) & (it < max_irls)

    def body(state):
        x, weights, prev_cost, it, inner_its, _, shifts, last_delta = state
        result = inner(x, weights, shifts)
        x_new, cost = result.x, result.cost.astype(x0.dtype)
        new_weights = tuple(
            1.0 / jnp.maximum(_MIN_RESIDUAL, reg.residuals(x_new))
            for (reg, _), _w in zip(regs, weights)
        )
        if refiner is not None:
            cap_next = (it + 1) >= max_irls
            due = ((it + 1) % refine_every == 0) & (~cap_next)

            def do_refine(sh):
                new_sh, delta = refiner(x_new, sh)
                return new_sh, delta.astype(x0.dtype)

            shifts_new, last_delta = lax.cond(
                due, do_refine, lambda sh: (sh, last_delta), shifts
            )
        else:
            shifts_new = shifts
        diff = prev_cost - cost
        done = (jnp.abs(diff) < thr) & (last_delta < delta_thr)
        return (
            x_new, new_weights, cost, it + 1,
            inner_its + result.iterations.astype(jnp.int32), done,
            shifts_new, last_delta,
        )

    x, _, cost, _, inner_its, _, shifts_out, _ = lax.while_loop(
        cond, body,
        (x0, weights0, inf, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
         jnp.zeros((), jnp.bool_), shifts_init, delta_init),
    )
    out = (x, cost)
    if return_iterations:
        out = out + (inner_its,)
    if refiner is not None:
        out = out + (shifts_out,)
    return out

# Minimum residual for IRLS reweighting (``irls_map_solver.cpp:34``).
_MIN_RESIDUAL = 1e-5


def _warn_mesh_fallback(path: str, reasons) -> None:
    """A mesh configuration missed its path's eligibility: say so (a user
    asking for a spatial mesh should hear that the solve falls back to the
    GSPMD-partitioned objective)."""
    import warnings

    why = "; ".join(reasons) if reasons else "configuration not eligible"
    warnings.warn(
        f"Mesh solve falling back from the {path} path to the "
        f"GSPMD-partitioned objective: {why}.",
        RuntimeWarning,
        stacklevel=3,
    )

# Built inner solvers shared ACROSS solver instances (module-level): video
# sliding windows construct a fresh IRLSMapSolver per frame, and rebuilding
# the jit wrapper forces a full retrace. Keyed by everything the trace bakes
# in as a constant: options, regularizer signatures, blur kernel bytes,
# static shift bytes (None where shifts are traced arguments),
# scale/max_shift/verbosity, and the mesh identity. LRU-capped: a long-lived
# service sweeping options or baked shift sets must not leak executables
# (each entry pins a compiled XLA program).
from collections import OrderedDict

_BUILT_SOLVER_CACHE: OrderedDict = OrderedDict()
_BUILT_SOLVER_CACHE_MAX = 32


def _regs_signature(regs):
    return tuple(
        (type(r).__name__, tuple(sorted(vars(r).items())), lam)
        for r, lam in regs
    )


def _as_chw(image) -> jnp.ndarray:
    arr = getattr(image, "array", image)
    arr = jnp.asarray(arr)
    if arr.ndim == 2:
        arr = arr[None]
    return arr


class IRLSMapSolver(MapSolverBase):
    """MAP super-resolution solver with IRLS-reweighted regularization."""

    def __init__(
        self,
        options: IRLSMapSolverOptions,
        image_model: ImageModel,
        low_res_images,
        print_solver_output: bool = False,
        mesh=None,
    ):
        """``mesh``: optional jax.sharding.Mesh with a 'frame' (and optionally
        'band') axis — observations are placed sharded and GSPMD reduces the
        per-frame gradients with psum (see parallel/data_parallel.py)."""
        super().__init__(image_model, low_res_images, print_solver_output)
        self.options = options
        self.mesh = mesh
        self.last_inner_iterations = 0
        # (wall seconds, CG/L-BFGS iterations, objective evaluations) per
        # inner-solver call of the last solve().
        self.last_inner_calls: list[tuple[float, int, int]] = []
        # Built inner solvers, keyed by (split, options): repeated solve()
        # calls (video sliding windows, IRLS restarts) must reuse the jitted
        # executable — rebuilding the jit wrapper per call forces a full
        # retrace.
        self._inner_cache = {}
        self._spatial_mesh = False
        if mesh is not None:
            from super_resolution_tpu.parallel.mesh import (
                COL_AXIS,
                ROW_AXIS,
                named_sharding,
            )

            self._spatial_mesh = (
                ROW_AXIS in mesh.axis_names or COL_AXIS in mesh.axis_names
            )
            if self._spatial_mesh:
                from super_resolution_tpu.parallel.mesh import (
                    BAND_AXIS,
                    FRAME_AXIS,
                )

                sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
                row = ROW_AXIS if ROW_AXIS in mesh.axis_names else None
                col = COL_AXIS if COL_AXIS in mesh.axis_names else None
                # Composite spatial meshes (row x col x frame/band): shard
                # the observation stack on every participating axis the
                # shapes allow (non-divisible axes stay replicated and the
                # solve falls back accordingly).
                frame = (
                    FRAME_AXIS
                    if FRAME_AXIS in mesh.axis_names
                    and self.observations.shape[0] % sizes[FRAME_AXIS] == 0
                    else None
                )
                band = (
                    BAND_AXIS
                    if BAND_AXIS in mesh.axis_names
                    and self.observations.shape[1] % sizes[BAND_AXIS] == 0
                    else None
                )
                self.observations = jax.device_put(
                    self.observations, named_sharding(mesh, frame, band, row, col)
                )
            else:
                from super_resolution_tpu.parallel.data_parallel import (
                    shard_problem,
                )

                # x placement happens per solve; shard the static
                # observations now.
                zeros = jnp.zeros(self.hr_shape, self.observations.dtype)
                _, self.observations, _ = shard_problem(
                    mesh, zeros, self.observations,
                    jnp.zeros((self.observations.shape[0], 2)),
                )

        motion = image_model.motion_operator
        k = self.observations.shape[0]
        if motion is not None:
            arr = motion.motion_sequence.as_array()
            if arr.shape[0] < k:
                raise ValueError("Fewer motion shifts than LR frames.")
            self.shifts = jnp.asarray(arr[:k])
            # Bucket the warp-padding bound to the next power of two:
            # max_shift only sizes translate's internal pad (semantics are
            # pad -> warp -> crop, unchanged by extra pad), and per-window
            # exact values would give every video sliding window its own
            # trace — bucketing collapses them onto one cached executable.
            b = 2
            while b < motion.max_shift:
                b *= 2
            self.max_shift = b
        else:
            self.shifts = jnp.zeros((k, 2))
            self.max_shift = 2
        self._shifts_placement = None
        if mesh is not None:
            from super_resolution_tpu.parallel.mesh import FRAME_AXIS, named_sharding

            sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
            frame = (
                FRAME_AXIS
                if FRAME_AXIS in mesh.axis_names
                and k % sizes[FRAME_AXIS] == 0
                else None
            )
            self._shifts_placement = named_sharding(mesh, frame, None)
            self.shifts = jax.device_put(self.shifts, self._shifts_placement)

        blur = image_model.blur_operator
        self.blur_kernel = None if blur is None else jnp.asarray(blur.kernel)

    def solve(self, initial_estimate, checkpoint_path: str | None = None,
              resume: bool = False):
        """Run the solver; returns the same type as the input estimate."""
        x_full = _as_chw(initial_estimate)
        if x_full.shape != self.hr_shape:
            raise ValueError(
                f"Initial estimate shape {x_full.shape} != expected {self.hr_shape}"
            )

        c = self.num_channels
        channels_per_split = 1 if self.options.split_channels else c
        num_rounds = c // channels_per_split
        num_pixels = self.hr_shape[1] * self.hr_shape[2]
        num_data_points = channels_per_split * num_pixels
        # Pixels each INNER CALL solves (one channel round) — the correct
        # per-call normalizer for throughput reporting: with split_channels
        # an inner call touches channels_per_split*H*W elements, not C*H*W.
        self.last_inner_pixels = num_data_points

        # Adaptive threshold scaling (``irls_map_solver.cpp:214-216``).
        import dataclasses

        opts = dataclasses.replace(self.options)
        # Exposed for introspection (CLI logging, routing tests).
        self.last_resolved_options = opts
        spatial_vg = self._spatial_objective(
            opts, channels_per_split, warn=True
        )
        if self.verbose:
            print(
                "Solver routing: "
                + ("spatial_halo" if spatial_vg is not None else "xla")
                + (" static_shifts" if opts.use_static_shifts else "")
                + (" fused_irls" if opts.fused_irls else " host_irls")
                + (f" mesh={dict(zip(self.mesh.axis_names, self.mesh.devices.shape))}"
                   if self.mesh is not None else "")
            )
        opts.adjust_thresholds_adaptively(
            num_data_points, self.regularization_parameter_sum
        )

        if opts.fused_irls and checkpoint_path:
            raise ValueError(
                "fused_irls runs the whole IRLS loop on-device with no "
                "checkpoint seam; use the host-loop default for "
                "checkpoint/resume."
            )
        if getattr(opts, "refine_motion_every", 0) > 0:
            if self.mesh is not None and not self._pure_frame_mesh():
                raise ValueError(
                    "refine_motion_every on a mesh requires a pure frame "
                    "mesh (x replicated, per-device shifts as runtime data)."
                )
            if opts.use_static_shifts:
                raise ValueError(
                    "refine_motion_every is incompatible with "
                    "use_static_shifts (shifts must stay traced arguments)."
                )

        # Total inner CG/L-BFGS iterations of the last solve() call (all
        # channel rounds + IRLS iterations) — lets callers (the CLI's
        # verbose mode) report Mpixel-iterations/s for the actual solve.
        self.last_inner_iterations = 0
        self.last_inner_calls = []

        results = []
        kern = self.blur_kernel
        # Shift values are baked into the trace only on the static-shift
        # path; elsewhere they are traced arguments, and keying on them
        # would defeat the cross-window executable reuse.
        refining = getattr(opts, "refine_motion_every", 0) > 0
        shifts_baked = (
            opts.diff_mode == "analytic"
            and opts.use_static_shifts
            and self.mesh is None
        )
        cache_key = (
            channels_per_split,
            repr(opts),
            _regs_signature(self.regularizers),
            None if kern is None else (kern.shape, np.asarray(kern).tobytes()),
            np.asarray(self.shifts).tobytes() if shifts_baked else None,
            self.scale,
            self.max_shift,
            self.verbose,
            None if self.mesh is None else id(self.mesh),
        )
        inner = self._inner_cache.get(cache_key)
        if inner is None and self.mesh is None:
            # Cross-instance reuse (video sliding windows build a fresh
            # solver per frame); mesh solvers stay instance-local (the mesh
            # object itself is baked into the shard_map).
            inner = _BUILT_SOLVER_CACHE.get(cache_key)
            if inner is not None:
                _BUILT_SOLVER_CACHE.move_to_end(cache_key)
        if inner is None:
            if opts.fused_irls:
                inner = self._build_fused_solver(opts, channels_per_split)
            else:
                inner = self._build_inner_solver(channels_per_split, opts)
            self._inner_cache[cache_key] = inner
            if self.mesh is None:
                _BUILT_SOLVER_CACHE[cache_key] = inner
                while len(_BUILT_SOLVER_CACHE) > _BUILT_SOLVER_CACHE_MAX:
                    _BUILT_SOLVER_CACHE.popitem(last=False)
        for i in range(num_rounds):
            ch0 = i * channels_per_split
            ch1 = ch0 + channels_per_split
            x0 = x_full[ch0:ch1]
            obs = self.observations[:, ch0:ch1]
            ckpt = (
                f"{checkpoint_path}.round{i}.npz"
                if checkpoint_path and num_rounds > 1
                else (f"{checkpoint_path}.npz" if checkpoint_path else None)
            )
            if opts.fused_irls:
                if refining:
                    x, cost, its, new_shifts = inner(
                        self._place_initial(x0), obs, self.shifts
                    )
                    # Later channel rounds (and later solve() calls) start
                    # from the refined motion, like the host loop.
                    self.shifts = new_shifts
                    if self._shifts_placement is not None:
                        self.shifts = jax.device_put(
                            self.shifts, self._shifts_placement
                        )
                else:
                    x, cost, its = inner(
                        self._place_initial(x0), obs, self.shifts
                    )
                # One batched readback (each device_get is a host round trip).
                cost_v, its_v = jax.device_get((cost, its))
                self.last_inner_iterations += int(its_v)
                if self.verbose:
                    print(f"Fused IRLS round {i} done; final loss {float(cost_v)}.")
            else:
                x = self._run_irls_loop(inner, x0, obs, opts, ckpt, resume)
            results.append(x)
        out = jnp.concatenate(results, axis=0)
        if isinstance(initial_estimate, ImageData):
            result = ImageData(
                out, normalize="never", channel_major=True,
                spectral_mode=initial_estimate.spectral_mode,
            )
            return result
        return out

    # ------------------------------------------------------------------ internals

    def _has_frame_mesh(self) -> bool:
        if self.mesh is None:
            return False
        from super_resolution_tpu.parallel.mesh import FRAME_AXIS

        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        return sizes.get(FRAME_AXIS, 1) > 1

    def _pure_frame_mesh(self) -> bool:
        """True when every non-frame mesh axis has size 1 — the placement
        where shifts are per-device runtime data and x is replicated, so
        motion refinement composes with the distribution (GSPMD shards the
        per-frame Gauss-Newton over the frame axis)."""
        if self.mesh is None:
            return False
        from super_resolution_tpu.parallel.mesh import FRAME_AXIS

        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        return all(n == 1 for name, n in sizes.items() if name != FRAME_AXIS)

    def _spatial_objective(self, opts, channels_per_split: int, warn=False):
        """For a spatial (row/col) mesh, ``make_vg(observations, shifts) ->
        vg`` with ``vg.prepare(weights) -> (x -> (cost, grad))`` over the
        halo-exchange tiled objective (``parallel/halo.py``); None for every
        other placement, whose objective GSPMD partitions from the array
        shardings. A spatial mesh the halo path cannot serve falls back to
        GSPMD, with a warning when ``warn``."""
        if self.mesh is None or not self._spatial_mesh:
            return None
        from super_resolution_tpu.ops.btv import (
            BilateralTotalVariationRegularizer,
        )
        from super_resolution_tpu.ops.tv import TotalVariationRegularizer
        from super_resolution_tpu.parallel.halo import (
            make_tiled_map_value_and_grad,
        )
        from super_resolution_tpu.parallel.mesh import COL_AXIS, ROW_AXIS

        regs = tuple(self.regularizers)
        scale = self.scale
        axis_sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        spatial_only = all(
            n == 1 or name in (ROW_AXIS, COL_AXIS)
            for name, n in axis_sizes.items()
        )
        regs_ok = len(regs) <= 1 and all(
            (
                isinstance(r, TotalVariationRegularizer)
                and not getattr(r, "use_3d", False)
            )
            or isinstance(r, BilateralTotalVariationRegularizer)
            for r, _ in regs
        )
        n_row = axis_sizes.get(ROW_AXIS, 1)
        n_col = axis_sizes.get(COL_AXIS, 1)
        _, h_hr, w_hr = self.hr_shape
        shapes_ok = (
            h_hr % n_row == 0
            and w_hr % n_col == 0
            and (h_hr // n_row) % scale == 0
            and (w_hr // n_col) % scale == 0
        )
        analytic = opts.diff_mode == "analytic"
        if not (spatial_only and regs_ok and shapes_ok and analytic):
            if warn:
                reasons = []
                if not spatial_only:
                    reasons.append(
                        "mesh mixes spatial (row/col) with frame/band axes"
                    )
                if not regs_ok:
                    reasons.append(
                        "regularizers not tileable (need exactly <=1 2D TV "
                        "or BTV term)"
                    )
                if not shapes_ok:
                    reasons.append(
                        f"HR shape {(h_hr, w_hr)} not divisible into "
                        f"{n_row}x{n_col} scale-aligned tiles"
                    )
                if not analytic:
                    reasons.append(f"diff_mode {opts.diff_mode!r}")
                _warn_mesh_fallback("spatial halo-exchange", reasons)
            return None
        mesh = self.mesh
        kernel = self.blur_kernel
        max_shift = self.max_shift
        image_shape = (h_hr, w_hr)

        def make_vg(observations, shifts):
            vg = make_tiled_map_value_and_grad(
                mesh, kernel, scale, max_shift=max_shift,
                regularizers=regs, image_shape=image_shape,
            )

            def prepare(weights):
                w0 = tuple(weights)[0] if weights else None
                return lambda x: vg(x, observations, shifts, w0)

            vg.prepare = prepare
            return vg

        return make_vg

    def _value_and_grad(self, opts, observations, shifts):
        """The single-program objective: traced shifts (GSPMD partitions it
        on frame and band meshes), or host-known ones with
        ``use_static_shifts``."""
        static = (
            np.asarray(self.shifts)
            if opts.diff_mode == "analytic"
            and opts.use_static_shifts
            and self.mesh is None
            else None
        )
        return make_map_value_and_grad(
            observations, shifts, self.blur_kernel, self.scale,
            tuple(self.regularizers), max_shift=self.max_shift,
            diff_mode=opts.diff_mode, static_shifts=static,
        )

    def _build_fused_solver(self, opts, channels_per_split: int = 0):
        """All-in-graph IRLS (``irls_solve_fused``): one jitted computation
        per channel round, zero host round-trips. Routed by
        ``IRLSMapSolverOptions.fused_irls``. On a mesh the whole IRLS solve
        compiles to ONE SPMD program over the same objective the host loop
        uses."""
        regs = tuple(self.regularizers)
        make_spatial = self._spatial_objective(
            opts, channels_per_split or self.num_channels
        )
        refining = getattr(opts, "refine_motion_every", 0) > 0
        refine_step = self._refine_step_fn(opts) if refining else None

        def fused(x0, observations, shifts):
            def build_vg(s):
                if make_spatial is not None:
                    return make_spatial(observations, s)
                return self._value_and_grad(opts, observations, s)

            if refining:
                return irls_solve_fused(
                    lambda w, s: build_vg(s).prepare(w),
                    regs, x0, opts, return_iterations=True, shifts0=shifts,
                    refiner=lambda x, s: refine_step(x, observations, s),
                )
            return irls_solve_fused(
                build_vg(shifts).prepare, regs, x0, opts,
                return_iterations=True,
            )

        return jax.jit(fused)

    def _build_inner_solver(self, channels_per_split: int, opts):
        make_spatial = self._spatial_objective(opts, channels_per_split)

        def inner(x0, observations, shifts, weights):
            if make_spatial is not None:
                vg = make_spatial(observations, shifts)
            else:
                vg = self._value_and_grad(opts, observations, shifts)
            return minimize(
                vg.prepare(weights),
                x0,
                method=opts.least_squares_solver,
                max_iterations=opts.max_num_solver_iterations,
                gradient_norm_threshold=opts.gradient_norm_threshold,
                cost_decrease_threshold=opts.cost_decrease_threshold,
                parameter_variation_threshold=opts.parameter_variation_threshold,
                memory=opts.num_lbfgs_hessian_corrections,
                linear_cg_refresh_every=opts.linear_cg_refresh_every,
                log_iterations=self.verbose,
            )

        return jax.jit(inner)

    def _place_initial(self, x0):
        """Place the HR estimate (or IRLS state) on the mesh: band axis on
        channels, row/col axes on the spatial dims for spatial meshes;
        replicated over frame devices. No-op without a mesh."""
        if self.mesh is None:
            return x0
        from super_resolution_tpu.parallel.mesh import (
            BAND_AXIS,
            COL_AXIS,
            ROW_AXIS,
            named_sharding,
        )

        if self._spatial_mesh:
            sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
            row = ROW_AXIS if ROW_AXIS in self.mesh.axis_names else None
            col = COL_AXIS if COL_AXIS in self.mesh.axis_names else None
            band = (
                BAND_AXIS
                if BAND_AXIS in self.mesh.axis_names
                and x0.shape[0] % sizes[BAND_AXIS] == 0
                else None
            )
            return jax.device_put(x0, named_sharding(self.mesh, band, row, col))
        band = BAND_AXIS if BAND_AXIS in self.mesh.axis_names else None
        return jax.device_put(x0, named_sharding(self.mesh, band, None, None))

    def _reweight_fn(self, regs):
        """One JITTED program for the IRLS reweight ``w = 1/max(1e-5, r(x))``.

        Computed eagerly, the residual chain is ~8 separate device dispatches
        per regularizer; the jitted form is one. Cached per regularizer
        signature alongside the inner solvers; sharded ``x`` propagates its
        sharding through the jit."""
        key = ("reweight", _regs_signature(regs))
        fn = self._inner_cache.get(key)
        if fn is None:
            regs = tuple(regs)

            def reweight(x):
                return tuple(
                    1.0 / jnp.maximum(_MIN_RESIDUAL, reg.residuals(x))
                    for reg, _ in regs
                )

            fn = self._inner_cache[key] = jax.jit(reweight)
        return lambda x: fn(x)

    def _refine_step_fn(self, opts):
        """Pure Gauss-Newton refinement STEP ``(x, observations, shifts) ->
        (new_shifts, max|change|)``.
        Jittable and mesh-transparent: under GSPMD a frame-sharded
        observations/shifts pair shards the per-frame Gauss-Newton across
        the frame axis with x replicated — the same function serves the
        host-loop refiner, the fused-IRLS loop body, and frame meshes."""
        from super_resolution_tpu.motion.refinement import refine_shifts

        kern = self.blur_kernel
        scale = self.scale
        max_shift = self.max_shift
        gn_iters = opts.refine_motion_iterations

        def step(x, observations, shifts):
            refined = refine_shifts(
                x, observations, shifts, kern, scale,
                num_iterations=gn_iters, max_shift=max_shift,
            )
            return refined, jnp.max(jnp.abs(refined - shifts))

        return step

    def _shift_refiner(self, opts):
        """Jitted wrapper of :meth:`_refine_step_fn` for the host IRLS loop —
        one device dispatch per refinement round, the delta scalar riding
        the loop's existing batched ``device_get``. Cached MODULE-wide like
        the inner solvers (all arguments traced, so video sliding windows —
        a fresh solver per frame — reuse one jit wrapper)."""
        kern = self.blur_kernel
        key = (
            "refine", opts.refine_motion_iterations, self.scale,
            self.max_shift,
            None if kern is None else (kern.shape, np.asarray(kern).tobytes()),
        )
        fn = self._inner_cache.get(key) or _BUILT_SOLVER_CACHE.get(key)
        if fn is None:
            fn = jax.jit(self._refine_step_fn(opts))
            _BUILT_SOLVER_CACHE[key] = fn
            while len(_BUILT_SOLVER_CACHE) > _BUILT_SOLVER_CACHE_MAX:
                _BUILT_SOLVER_CACHE.popitem(last=False)
        self._inner_cache[key] = fn
        return fn

    def _run_irls_loop(self, inner, x0, observations, opts,
                       checkpoint_path=None, resume=False):
        """IRLS outer loop with optional checkpoint/resume: the state saved at
        the iteration seam (x, IRLS weights, iteration counter, previous cost)
        is exactly what the reference's iteration-complete hook exposes —
        SURVEY.md §5 identifies it as the natural checkpoint point; the
        reference itself persists nothing."""
        import os

        regs = self.regularizers
        x0 = self._place_initial(x0)
        weights = tuple(jnp.ones_like(x0) for _ in regs)
        x = x0
        prev_cost = float("inf")
        iteration = 0
        refine_every = getattr(opts, "refine_motion_every", 0)
        refiner = self._shift_refiner(opts) if refine_every > 0 else None
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            state = np.load(checkpoint_path)
            x = jnp.asarray(state["x"])
            weights = tuple(
                jnp.asarray(state[f"weight_{i}"]) for i in range(len(regs))
            )
            if self.mesh is not None:
                # Restore the mesh placement (checkpoints are host arrays);
                # without this the resumed solve compiles a second executable
                # for the unsharded layout.
                placement = x0.sharding
                x = jax.device_put(x, placement)
                weights = tuple(jax.device_put(w, placement) for w in weights)
            prev_cost = float(state["prev_cost"])
            iteration = int(state["iteration"])
            if "shifts" in state:
                # Motion-refined solves checkpoint the evolving shifts too.
                self.shifts = jnp.asarray(state["shifts"])
                if self._shifts_placement is not None:
                    self.shifts = jax.device_put(
                        self.shifts, self._shifts_placement
                    )
            if self.verbose:
                print(f"Resumed IRLS from {checkpoint_path} at iteration {iteration}.")
        # inf until a refinement ROUND has actually run and converged: with
        # refine_motion_every > 1 the cost can stabilize before the first
        # refinement is due, and the loop must not break with the requested
        # refinement never executed.
        last_refine_delta = float("inf") if refiner is not None else 0.0
        while True:
            t_inner = time.perf_counter()
            result = inner(x, observations, self.shifts, weights)
            jax.block_until_ready(result.x)
            t_call = time.perf_counter() - t_inner
            # Motion refinement at the IRLS seam: Gauss-Newton on the data
            # term against the just-solved x, fed straight back into the
            # inner solve (same executable — shifts are a traced argument on
            # this path by construction). Dispatched BEFORE the batched
            # readback so its delta scalar rides the one device_get below.
            # Skip a refinement whose result could never be consumed: when
            # the iteration cap fires right after this iteration, no further
            # inner solve runs, so refining here would only make the reported
            # shifts disagree with the motion that produced the returned x
            # (and waste a Gauss-Newton dispatch).
            cap_next = (
                opts.max_num_irls_iterations > 0
                and iteration + 1 >= opts.max_num_irls_iterations
            )
            refined_now = (
                refiner is not None
                and (iteration + 1) % refine_every == 0
                and not cap_next
            )
            if refined_now:
                self.shifts, delta_dev = refiner(
                    result.x, observations, self.shifts
                )
                if self._shifts_placement is not None:
                    # Pin the refined shifts back to the frame-sharded
                    # placement the inner executable was compiled for (the
                    # refiner jit may return a GSPMD-inferred layout; a
                    # placement drift would compile a second executable).
                    self.shifts = jax.device_put(
                        self.shifts, self._shifts_placement
                    )
            # ONE batched device_get for every host-side scalar: each
            # separate readback is its own host round trip.
            fetch = jax.device_get(
                (result.cost, result.iterations, result.num_evaluations)
                + ((delta_dev,) if refined_now else ())
            )
            cost_v, it_v, ev_v = fetch[:3]
            if refined_now:
                last_refine_delta = float(fetch[3])
                if self.verbose:
                    print(
                        f"Refined motion against the HR estimate "
                        f"(max shift change {last_refine_delta:.4g} HR px)."
                    )
            x, cost = result.x, float(cost_v)
            # Per-inner-call stats: call 0 includes the one-time jit trace +
            # compile(-cache load); later calls are steady-state device time
            # (the scalar readback above is loop bookkeeping, not solve time).
            self.last_inner_calls.append((t_call, int(it_v), int(ev_v)))
            self.last_inner_iterations += int(it_v)
            if not regs and refiner is None:
                if self.verbose:
                    print("Least squares done (no regularization terms to reweight).")
                break
            if regs:
                weights = self._reweight_fn(regs)(x)
            cost_difference = prev_cost - cost
            prev_cost = cost
            iteration += 1
            if self.verbose:
                print(
                    f"IRLS Iteration complete (#{iteration}). New loss is {cost} "
                    f"with a difference of {cost_difference}."
                )
            if checkpoint_path:
                payload = {"x": np.asarray(x), "prev_cost": prev_cost,
                           "iteration": iteration}
                if refiner is not None:
                    payload["shifts"] = np.asarray(self.shifts)
                for wi, warr in enumerate(weights):
                    payload[f"weight_{wi}"] = np.asarray(warr)
                np.savez(checkpoint_path, **payload)
            if (
                abs(cost_difference) < opts.irls_cost_difference_threshold
                and last_refine_delta
                < getattr(opts, "refine_motion_delta_threshold", 1e-4)
            ):
                # Converged — and the LAST-RUN refinement no longer moves
                # the motion (a refinement changes the objective, so cost
                # alone cannot certify joint convergence; inf until one has
                # run at all).
                break
            if (
                opts.max_num_irls_iterations > 0
                and iteration >= opts.max_num_irls_iterations
            ):
                break
        return x
