"""Frame- and band-sharded MAP solving over a device mesh.

Strategy (SURVEY.md §2b; the scaling-book recipe — pick a mesh, annotate
shardings, let XLA insert collectives):

- **Frame parallelism**: shard the LR observation stack ``[K, C, h, w]`` and
  shifts ``[K, 2]`` over the ``frame`` mesh axis; replicate the HR estimate.
  The data term's vmap-over-frames + sum then compiles to per-device partial
  sums with one ``psum`` over the frame axis per objective evaluation, and
  the whole CG/L-BFGS ``lax.while_loop`` runs in lockstep — exactly one
  reduction per cost/gradient evaluation.
- **Band parallelism**: shard the channel axis of both x and observations.
  For band-separable objectives (data term + 2D TV/BTV) the computation is
  embarrassingly parallel; use :func:`band_split_minimize` (a vmap over
  bands, matching ``split_channels`` per-channel semantics exactly) when
  per-band line searches must be independent.

No code here issues collectives by hand — shardings are annotations, GSPMD
does the rest, which is the idiomatic XLA path for this workload.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from super_resolution_tpu.parallel.mesh import BAND_AXIS, FRAME_AXIS
from super_resolution_tpu.solvers.least_squares import minimize
from super_resolution_tpu.solvers.objective import make_map_value_and_grad

__all__ = [
    "shard_problem",
    "make_sharded_map_solver",
    "band_split_minimize",
]


def _mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def shard_problem(
    mesh: Mesh,
    x0: jnp.ndarray,
    observations: jnp.ndarray,
    shifts: jnp.ndarray,
):
    """Place the problem on the mesh: observations/shifts sharded over
    ``frame`` (and channels over ``band`` if present); x sharded over
    ``band`` on its channel axis, replicated otherwise."""
    axes = _mesh_axes(mesh)
    frame = FRAME_AXIS if FRAME_AXIS in axes else None
    band = BAND_AXIS if BAND_AXIS in axes else None

    obs_spec = PartitionSpec(frame, band, None, None)
    shifts_spec = PartitionSpec(frame, None)
    x_spec = PartitionSpec(band, None, None)

    observations = jax.device_put(observations, NamedSharding(mesh, obs_spec))
    shifts = jax.device_put(shifts, NamedSharding(mesh, shifts_spec))
    x0 = jax.device_put(x0, NamedSharding(mesh, x_spec))
    return x0, observations, shifts


def make_sharded_map_solver(
    mesh: Mesh,
    blur_kernel,
    scale: int,
    regularizers: Sequence[tuple[object, float]] = (),
    max_shift: int = 16,
    method: str = "cg",
    max_iterations: int = 50,
    gradient_norm_threshold: float = 1e-6,
    cost_decrease_threshold: float = 1e-6,
    parameter_variation_threshold: float = 1e-6,
):
    """Build a jitted sharded solve step ``(x0, observations, shifts, weights)
    -> MinimizeResult`` whose output x keeps the input sharding."""
    axes = _mesh_axes(mesh)
    band = BAND_AXIS if BAND_AXIS in axes else None
    x_sharding = NamedSharding(mesh, PartitionSpec(band, None, None))

    @jax.jit
    def solve_step(x0, observations, shifts, weights=()):
        vg = make_map_value_and_grad(
            observations, shifts, blur_kernel, scale, regularizers,
            max_shift=max_shift,
        )
        result = minimize(
            lambda x: vg(x, weights),
            x0,
            method=method,
            max_iterations=max_iterations,
            gradient_norm_threshold=gradient_norm_threshold,
            cost_decrease_threshold=cost_decrease_threshold,
            parameter_variation_threshold=parameter_variation_threshold,
        )
        return result._replace(x=jax.lax.with_sharding_constraint(result.x, x_sharding))

    return solve_step


def band_split_minimize(
    value_and_grad_per_band,
    x0: jnp.ndarray,
    method: str = "cg",
    **options,
):
    """Solve each channel independently (split_channels semantics,
    ``irls_map_solver.cpp:200-229``) as a vmap over the band axis — each band
    gets its own line search and stopping test, and the vmapped axis shards
    over the ``band`` mesh axis when x0 is placed accordingly.

    ``value_and_grad_per_band(xc) -> (cost, grad)`` operates on one ``[1, H, W]``
    band.
    """

    def solve_one(xc):
        return minimize(value_and_grad_per_band, xc[None], method=method, **options)

    results = jax.vmap(solve_one)(x0)
    return results._replace(x=results.x[:, 0])
