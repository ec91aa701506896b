"""Shift-add fusion baseline (the JAX equivalent of
``src/shift_add_fusion.cpp``).

Places each LR pixel of frame k at HR position ``(s*y - dy_k, s*x - dx_k)``
(:58-77), masks unfilled HR pixels, and inpaints the holes (:84-90, where the
reference uses cv::inpaint Navier-Stokes).

Array formulation: "place pixel (y, x) at (s*y - dy, s*x - dx)" is
exactly ``translate(zero_upsample(frame, s), -dx, -dy)`` with integer shifts
— no scatter. Later frames overwrite earlier ones at collisions (matching the
reference's sequential ``at<uchar>() =`` writes). Hole filling is an
iterative known-neighbor diffusion (a masked 3x3 box filter repeated until
the grid is covered) instead of a host-side Navier-Stokes solve — both are
inpainting; this one is a fused stencil loop that stays on-device.
"""

from __future__ import annotations

import math

import numpy as np

import jax.numpy as jnp
from jax import lax

from super_resolution_tpu.ops.blur import correlate2d
from super_resolution_tpu.ops.resize import zero_upsample
from super_resolution_tpu.ops.warp import translate_static

__all__ = ["shift_add_fusion", "fill_holes"]


def fill_holes(image: jnp.ndarray, known_mask: jnp.ndarray, num_iterations: int | None = None):
    """Fill ``image`` where ``known_mask == 0`` by repeated known-neighbor
    averaging (3x3). Sweeps stop as soon as every pixel is covered (each
    sweep past coverage is a no-op, so the early exit is result-identical;
    regular shift sets cover the grid in 0-2 sweeps). ``num_iterations``
    caps the sweep count; the default cap covers any hole in the image."""
    cap = (
        max(image.shape[-2], image.shape[-1])
        if num_iterations is None
        else num_iterations
    )
    box = jnp.ones((3, 3), dtype=image.dtype)
    mask = known_mask.astype(image.dtype)

    def cond(carry):
        _, m, i = carry
        return (i < cap) & jnp.logical_not(jnp.all(m > 0))

    def body(carry):
        img, m, i = carry
        num = correlate2d(img * m, box)
        den = correlate2d(m, box)
        grown = den > 0
        fill = num / jnp.maximum(den, 1.0)
        img = jnp.where(m > 0, img, jnp.where(grown, fill, img))
        m = jnp.maximum(m, grown.astype(image.dtype))
        return img, m, i + 1

    filled, _, _ = lax.while_loop(cond, body, (image, mask, jnp.int32(0)))
    return filled


def shift_add_fusion(
    frames,
    shifts,
    scale: int,
    inpaint: bool = True,
) -> jnp.ndarray:
    """Fuse LR ``frames`` into an HR image.

    ``frames``: ``[K, H, W]`` or ``[K, C, H, W]`` array (or list of frames);
    ``shifts``: ``[K, 2]`` (dx, dy) — integer-valued; fractional parts are
    truncated like the reference's implicit double->int conversion
    (``shift_add_fusion.cpp:66-67``).
    """
    stack = jnp.asarray(jnp.stack([jnp.asarray(f) for f in frames])
                        if isinstance(frames, (list, tuple)) else frames)
    # Shifts are host-known placement offsets (compile-time constants under
    # jit) — keep them on the host; jnp.asarray here would re-stage them as
    # traced constants and break the float() specialization.
    shifts_arr = [(float(s[0]), float(s[1])) for s in np.asarray(shifts)]
    if stack.shape[0] != len(shifts_arr):
        raise ValueError("The number of motion estimates must match the number of frames.")

    out = None
    known = None
    for k in range(stack.shape[0]):
        dx, dy = shifts_arr[k]
        dx_i, dy_i = float(math.trunc(dx)), float(math.trunc(dy))
        up = zero_upsample(stack[k], scale)
        placed = translate_static(up, -dx_i, -dy_i)
        ones = jnp.ones_like(stack[k])
        mask = translate_static(zero_upsample(ones, scale), -dx_i, -dy_i)
        if out is None:
            out = placed
            known = mask
        else:
            # Sequential overwrite: frame k wins at collisions.
            out = jnp.where(mask > 0.5, placed, out)
            known = jnp.maximum(known, mask)
    if inpaint:
        out = fill_holes(out, known > 0.5)
    return out
