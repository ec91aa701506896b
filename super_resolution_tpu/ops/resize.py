"""Image resize operators with reference-exact interpolation semantics.

The four interpolation modes mirror the reference's ``ResizeInterpolationMethod``
(``src/image/image_data.h:26-68``):

- ``nearest``  — cv::INTER_NEAREST semantics: ``src_idx = floor(dst_idx * src/dst)``.
  Upsampling replicates pixels; downsampling keeps the top-left pixel of each
  patch (aliasing is deliberate — super-resolution depends on it,
  ``src/image_model/downsampling_module.cpp:24-26``).
- ``linear``   — cv::INTER_LINEAR: half-pixel-center coordinates
  ``src = (dst + 0.5) * src/dst - 0.5`` with clamped (replicate) borders.
- ``cubic``    — cv::INTER_CUBIC: Keys bicubic with a = -0.75, same coordinates.
- ``additive`` — the reference's custom mode (``src/image/image_data.cpp:80-134``):
  upsampling zero-pads between samples (placing ``x[r, c]`` at
  ``(r * ys, c * xs)`` with ``ys = H_out // H_in``); downsampling sums each
  ``ys x xs`` block (``out[r // ys, c // xs] += in[r, c]``). Additive
  downsample of an additive upsample recovers the input exactly; additive
  upsample is the exact adjoint of top-left decimation.

All functions operate on arrays shaped ``[..., H, W]`` (channel/batch axes
leading) and preserve dtype. Index plans are computed with numpy at trace time
(shapes are static under jit), so the device work is pure gathers / pads /
reshapes that XLA fuses — no scatters in any hot path.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

__all__ = [
    "resize",
    "nearest_resize",
    "linear_resize",
    "cubic_resize",
    "additive_resize",
    "decimate",
    "zero_upsample",
    "block_sum_downsample",
]


def _nearest_indices(n_out: int, n_in: int) -> np.ndarray:
    # OpenCV INTER_NEAREST: sx = floor(dst * (src / dst)), clamped.
    idx = np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int32)
    return np.clip(idx, 0, n_in - 1)


def nearest_resize(x: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """Nearest-neighbor resize to (H_out, W_out), cv::INTER_NEAREST parity."""
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    h_in, w_in = x.shape[-2], x.shape[-1]
    if (h_out, w_out) == (h_in, w_in):
        return x
    rows = _nearest_indices(h_out, h_in)
    cols = _nearest_indices(w_out, w_in)
    x = jnp.take(x, jnp.asarray(rows), axis=-2)
    x = jnp.take(x, jnp.asarray(cols), axis=-1)
    return x


def _linear_taps(n_out: int, n_in: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(idx0, idx1, frac): src = (dst+0.5)*scale - 0.5, replicate borders."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src)
    frac = src - i0
    # OpenCV clamps: sx<0 -> sx=0,f=0 ; sx>=n-1 -> sx=n-2,f=1. Equivalent to
    # clamping both tap indices into range (replicate border).
    idx0 = np.clip(i0, 0, n_in - 1).astype(np.int32)
    idx1 = np.clip(i0 + 1, 0, n_in - 1).astype(np.int32)
    frac = np.where(i0 < 0, 0.0, frac)
    frac = np.where(i0 >= n_in - 1, 1.0 if n_in > 1 else 0.0, frac)
    return idx0, idx1, frac


def _apply_taps_1d(x, idxs, weights, axis):
    out = None
    for idx, w in zip(idxs, weights):
        term = jnp.take(x, jnp.asarray(idx), axis=axis)
        w_arr = jnp.asarray(w, dtype=x.dtype)
        shape = [1] * x.ndim
        shape[axis] = len(idx)
        term = term * w_arr.reshape(shape)
        out = term if out is None else out + term
    return out


def linear_resize(x: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize to (H_out, W_out), cv::INTER_LINEAR parity."""
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    h_in, w_in = x.shape[-2], x.shape[-1]
    if h_out != h_in:
        i0, i1, f = _linear_taps(h_out, h_in)
        x = _apply_taps_1d(x, [i0, i1], [1.0 - f, f], axis=-2)
    if w_out != w_in:
        i0, i1, f = _linear_taps(w_out, w_in)
        x = _apply_taps_1d(x, [i0, i1], [1.0 - f, f], axis=-1)
    return x


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic interpolation kernel (OpenCV uses a = -0.75)."""
    at = np.abs(t)
    at2, at3 = at * at, at * at * at
    w = np.where(
        at <= 1.0,
        (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a, 0.0),
    )
    return w


def _cubic_taps(n_out: int, n_in: int):
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    idxs, weights = [], []
    for k in range(-1, 3):
        idxs.append(np.clip(base + k, 0, n_in - 1).astype(np.int32))
        weights.append(_cubic_kernel(k - frac))
    return idxs, weights


def cubic_resize(x: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """Bicubic resize (Keys a=-0.75) to (H_out, W_out), cv::INTER_CUBIC parity."""
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    h_in, w_in = x.shape[-2], x.shape[-1]
    if h_out != h_in:
        idxs, ws = _cubic_taps(h_out, h_in)
        x = _apply_taps_1d(x, idxs, ws, axis=-2)
    if w_out != w_in:
        idxs, ws = _cubic_taps(w_out, w_in)
        x = _apply_taps_1d(x, idxs, ws, axis=-1)
    return x


def decimate(x: jnp.ndarray, scale: int) -> jnp.ndarray:
    """Top-left decimation: ``out[r, c] = x[r*scale, c*scale]``.

    The forward downsampling operator D (``downsampling_module.cpp:19-27`` via
    INTER_NEAREST; selection-matrix form at :41-64). A strided slice that XLA
    fuses with its neighbours.
    """
    if scale == 1:
        return x
    return x[..., ::scale, ::scale]


def zero_upsample(
    x: jnp.ndarray, scale: int, out_hw: tuple[int, int] | None = None
) -> jnp.ndarray:
    """Zero-padding upsample: ``out[r*scale, c*scale] = x[r, c]``, zeros elsewhere.

    The exact adjoint D^T of :func:`decimate` and the reference's
    INTERPOLATE_ADDITIVE upsample (``image_data.cpp:99-115``). Implemented with
    interior-padded ``lax.pad`` — a cheap dilation, no scatter.
    """
    if scale == 1:
        return x
    h_in, w_in = x.shape[-2], x.shape[-1]
    if out_hw is None:
        out_hw = (h_in * scale, w_in * scale)
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    hi_h = h_out - ((h_in - 1) * scale + 1)
    hi_w = w_out - ((w_in - 1) * scale + 1)
    cfg = [(0, 0, 0)] * (x.ndim - 2) + [(0, hi_h, scale - 1), (0, hi_w, scale - 1)]
    return lax.pad(x, jnp.zeros((), dtype=x.dtype), cfg)


def block_sum_downsample(
    x: jnp.ndarray, out_hw: tuple[int, int]
) -> jnp.ndarray:
    """Additive downsample: ``out[r // ys, c // xs] += x[r, c]``.

    Matches ``image_data.cpp:116-133`` with ``ys = H_in // H_out`` (integer
    division). Rows/cols whose target index would fall out of range (possible
    only for non-divisible sizes, which is undefined behavior in the
    reference) are dropped.
    """
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    h_in, w_in = x.shape[-2], x.shape[-1]
    ys, xs = h_in // h_out, w_in // w_out
    x = x[..., : h_out * ys, : w_out * xs]
    batch = x.shape[:-2]
    x = x.reshape(*batch, h_out, ys, w_out, xs)
    return x.sum(axis=(-3, -1))


def additive_resize(x: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """INTERPOLATE_ADDITIVE resize (``image_data.cpp:80-134``).

    Up: zero-pad between samples at stride ``out // in``.
    Down: sum each ``in // out`` block. Axis-mixed resizes are invalid
    (mirrors the reference CHECK at ``image_data.cpp:94-95``).
    """
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    h_in, w_in = x.shape[-2], x.shape[-1]
    up = h_out >= h_in and w_out >= w_in
    down = h_out <= h_in and w_out <= w_in
    if not (up or down):
        raise ValueError(
            "Axis-independent up/downsampling is not supported for additive "
            f"interpolation: {(h_in, w_in)} -> {(h_out, w_out)}"
        )
    if up and (h_out, w_out) == (h_in, w_in):
        return x
    if up:
        ys, xs = h_out // h_in, w_out // w_in
        return zero_upsample(x, ys, (h_out, w_out)) if ys == xs else _zero_up2(
            x, ys, xs, (h_out, w_out)
        )
    return block_sum_downsample(x, (h_out, w_out))


def _zero_up2(x, ys, xs, out_hw):
    h_out, w_out = out_hw
    h_in, w_in = x.shape[-2], x.shape[-1]
    hi_h = h_out - ((h_in - 1) * ys + 1)
    hi_w = w_out - ((w_in - 1) * xs + 1)
    cfg = [(0, 0, 0)] * (x.ndim - 2) + [(0, hi_h, ys - 1), (0, hi_w, xs - 1)]
    return lax.pad(x, jnp.zeros((), dtype=x.dtype), cfg)


_METHODS = {
    "nearest": nearest_resize,
    "linear": linear_resize,
    "cubic": cubic_resize,
    "additive": additive_resize,
}


def resize(x: jnp.ndarray, out_hw: tuple[int, int], method: str = "nearest"):
    """Resize ``[..., H, W]`` to ``out_hw`` with one of the four reference modes."""
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(f"Unknown resize method {method!r}; options: {list(_METHODS)}")
    return fn(x, out_hw)
