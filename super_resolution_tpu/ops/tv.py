"""Anisotropic total variation regularizer (2D and 3D), vectorized.

Reference semantics (``src/optimization/tv_regularizer.cpp``):

- Per-pixel residual ``r = |x(r, c+1) - x(r, c)| + |x(r+1, c) - x(r, c)|``
  with forward differences and zeros past the image border (:21-106); 3D TV
  adds the spectral term ``|x(b+1) - x(b)|`` (:58-69, 90-106).
- The IRLS gradient of ``sum_i c_i r_i^2`` w.r.t. each pixel uses signum
  factors of the forward differences, accumulating the self / left / above
  (/ previous-band) contributions (:134-227). With ``G = 2 c r`` and
  ``s* = sign`` of each forward difference:

      grad = -G (s_x + s_y [+ s_z])
             + shift_right(G s_x) + shift_down(G s_y) [+ shift_band(G s_z)]

  where shift_* moves values one step along the axis with zero fill — a
  handful of pads and elementwise ops that XLA fuses into one pass
  (the reference walks every pixel in a triple scalar loop).

``constants`` is the per-pixel ``lambda * irls_weight`` array, matching
``objective_irls_regularization_term.cpp:25-32``.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["tv_residuals", "tv_cost_and_grad", "TotalVariationRegularizer"]


def _forward_diff_x(x: jnp.ndarray) -> jnp.ndarray:
    """x(r, c+1) - x(r, c); zero at the last column."""
    d = x[..., :, 1:] - x[..., :, :-1]
    return jnp.pad(d, [(0, 0)] * (x.ndim - 1) + [(0, 1)])


def _forward_diff_y(x: jnp.ndarray) -> jnp.ndarray:
    """x(r+1, c) - x(r, c); zero at the last row."""
    d = x[..., 1:, :] - x[..., :-1, :]
    return jnp.pad(d, [(0, 0)] * (x.ndim - 2) + [(0, 1), (0, 0)])


def _forward_diff_z(x: jnp.ndarray) -> jnp.ndarray:
    """x(b+1) - x(b) across the channel axis; zero at the last band."""
    d = x[1:] - x[:-1]
    return jnp.pad(d, [(0, 1)] + [(0, 0)] * (x.ndim - 1))


def _shift_right(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.pad(v[..., :, :-1], [(0, 0)] * (v.ndim - 1) + [(1, 0)])


def _shift_down(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.pad(v[..., :-1, :], [(0, 0)] * (v.ndim - 2) + [(1, 0), (0, 0)])


def _shift_band(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.pad(v[:-1], [(1, 0)] + [(0, 0)] * (v.ndim - 1))


def tv_residuals(x: jnp.ndarray, use_3d: bool = False) -> jnp.ndarray:
    """Per-pixel TV residuals of a ``[C, H, W]`` image."""
    r = jnp.abs(_forward_diff_x(x)) + jnp.abs(_forward_diff_y(x))
    if use_3d:
        r = r + jnp.abs(_forward_diff_z(x))
    return r


def tv_cost_and_grad(
    x: jnp.ndarray, constants: jnp.ndarray, use_3d: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """IRLS TV term: cost ``sum(c r^2)`` and its reference-parity gradient."""
    dx = _forward_diff_x(x)
    dy = _forward_diff_y(x)
    r = jnp.abs(dx) + jnp.abs(dy)
    if use_3d:
        dz = _forward_diff_z(x)
        r = r + jnp.abs(dz)
    cost = jnp.sum(constants * r * r)
    g = 2.0 * constants * r
    sx = jnp.sign(dx)
    sy = jnp.sign(dy)
    grad = -g * (sx + sy) + _shift_right(g * sx) + _shift_down(g * sy)
    if use_3d:
        sz = jnp.sign(dz)
        grad = grad - g * sz + _shift_band(g * sz)
    return cost, grad


class TotalVariationRegularizer:
    """Object wrapper mirroring the reference class API
    (``tv_regularizer.h:18-46``)."""

    def __init__(self, use_3d_total_variation: bool = False):
        self.use_3d = use_3d_total_variation

    def residuals(self, x: jnp.ndarray) -> jnp.ndarray:
        return tv_residuals(x, self.use_3d)

    def cost_and_grad(self, x: jnp.ndarray, constants: jnp.ndarray):
        return tv_cost_and_grad(x, constants, self.use_3d)
