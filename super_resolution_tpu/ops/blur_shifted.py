"""Shifted-add correlation for small kernels.

For the small PSF kernels used here (3x3 .. 7x7), a sum of k^2 statically
shifted, weighted copies is elementwise work that XLA fuses with the
surrounding ops: no convolution dispatch, no layout changes. Numerically
identical to
:func:`super_resolution_tpu.ops.blur.correlate2d` (zero border).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["correlate2d_shifted"]


def _shift2d(x: jnp.ndarray, dr: int, dc: int) -> jnp.ndarray:
    """out(r, c) = x(r + dr, c + dc), zero outside."""
    h, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [
        (max(-dr, 0), max(dr, 0)),
        (max(-dc, 0), max(dc, 0)),
    ]
    xp = jnp.pad(x, pad)
    sl = [slice(None)] * (x.ndim - 2) + [
        slice(max(dr, 0), max(dr, 0) + h),
        slice(max(dc, 0), max(dc, 0) + w),
    ]
    return xp[tuple(sl)]


def correlate2d_shifted(x: jnp.ndarray, kernel) -> jnp.ndarray:
    """'SAME' zero-padded correlation via k^2 shifted adds (cv::filter2D parity)."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    mid_r, mid_c = kh // 2, kw // 2
    out = None
    for i in range(kh):
        for j in range(kw):
            weight = float(kernel[i, j])
            if weight == 0.0:
                continue
            term = _shift2d(x, i - mid_r, j - mid_c) * jnp.asarray(weight, x.dtype)
            out = term if out is None else out + term
    if out is None:
        return jnp.zeros_like(x)
    return out
