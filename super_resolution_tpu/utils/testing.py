"""Test comparators mirroring ``src/util/test_util.{h,cpp}`` semantics."""

from __future__ import annotations

import numpy as np

__all__ = [
    "matrices_equal",
    "matrices_equal_cropped_border",
    "images_equal",
    "reference_objective",
]


def matrices_equal(a, b, tolerance: float = 0.0, verbose: bool = True) -> bool:
    """Elementwise |a-b| <= tolerance with diagnostics (``test_util.cpp:23-81``)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        if verbose:
            print(f"Matrix shapes differ: {a.shape} vs {b.shape}")
        return False
    diff = np.abs(a - b)
    max_diff = diff.max() if diff.size else 0.0
    ok = bool(max_diff <= tolerance) if tolerance > 0 else bool(np.array_equal(a, b))
    if not ok and verbose:
        loc = np.unravel_index(diff.argmax(), diff.shape)
        print(
            f"Matrices not equal: max diff {max_diff} at {loc} "
            f"(a={a[loc]}, b={b[loc]}, tolerance={tolerance})"
        )
    return ok


def matrices_equal_cropped_border(a, b, border: int, tolerance: float = 0.0) -> bool:
    """Compare excluding a border of the given width (``test_util.cpp:83-102``)."""
    a = np.asarray(a)[..., border:-border or None, border:-border or None]
    b = np.asarray(b)[..., border:-border or None, border:-border or None]
    return matrices_equal(a, b, tolerance)


def images_equal(img1, img2, tolerance: float = 1e-12) -> bool:
    """Per-channel image comparison (``test_util.cpp:104-134``)."""
    a = _as_chw(img1)
    b = _as_chw(img2)
    if a.shape != b.shape:
        print(f"Image shapes differ: {a.shape} vs {b.shape}")
        return False
    return all(matrices_equal(a[c], b[c], tolerance) for c in range(a.shape[0]))


def _as_chw(img) -> np.ndarray:
    arr = getattr(img, "array", img)
    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim == 2:
        arr = arr[None]
    return arr


# ------------------------------------------------------------------------
# Plain float64 numpy reference of the MAP objective (tests and the card's
# checks compare the JAX objectives against it).


def _np_warp(x: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """``out(r, c) = x(r - dy, c - dx)``, bilinear, zero outside."""
    iy, ix = int(np.floor(dy)), int(np.floor(dx))
    fy, fx = dy - iy, dx - ix
    h, w = x.shape[-2], x.shape[-1]
    out = np.zeros_like(x)
    for a, wy in ((0, 1.0 - fy), (1, fy)):
        for b, wx in ((0, 1.0 - fx), (1, fx)):
            if wy * wx == 0.0:
                continue
            m, n = iy + a, ix + b
            r0, r1 = max(m, 0), h + min(m, 0)
            c0, c1 = max(n, 0), w + min(n, 0)
            if r0 < r1 and c0 < c1:
                out[..., r0:r1, c0:c1] += (wy * wx) * x[..., r0 - m:r1 - m,
                                                        c0 - n:c1 - n]
    return out


def _np_correlate(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Zero-border correlation anchored at ``(kh // 2, kw // 2)``."""
    kh, kw = k.shape
    h, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [(kh // 2, kh - 1 - kh // 2),
                                      (kw // 2, kw - 1 - kw // 2)]
    xp = np.pad(x, pad)
    out = np.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            out += k[i, j] * xp[..., i:i + h, j:j + w]
    return out


def _np_tv(x, c, use_3d):
    def fwd(a, axis):
        d = np.diff(a, axis=axis)
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, 1)
        return np.pad(d, pad)

    def back(v, axis):
        pad = [(0, 0)] * v.ndim
        pad[axis] = (1, 0)
        sl = [slice(None)] * v.ndim
        sl[axis] = slice(None, -1)
        return np.pad(v[tuple(sl)], pad)

    axes = [-1, -2] + ([0] if use_3d else [])
    diffs = [fwd(x, a) for a in axes]
    r = sum(np.abs(d) for d in diffs)
    g = 2.0 * c * r
    grad = np.zeros_like(x)
    for a, d in zip(axes, diffs):
        grad += -g * np.sign(d) + back(g * np.sign(d), a)
    return float(np.sum(c * r * r)), grad


def _np_btv(x, c, p_range, decay):
    h, w = x.shape[-2], x.shape[-1]

    def diff(i, j):
        d = np.zeros_like(x)
        d[..., :h - i, :w - j] = x[..., :h - i, :w - j] - x[..., i:, j:]
        return d

    r = sum((decay ** (i + j)) * np.abs(diff(i, j))
            for i in range(p_range + 1) for j in range(p_range + 1))
    g = 2.0 * c * r
    grad = np.zeros_like(x)
    for i in range(p_range):
        for j in range(p_range):
            t = (decay ** (i + j)) * g * np.sign(diff(i, j))
            grad += t
            t = t.copy()
            t[..., 0, 0] = 0.0  # the reference skips terms sourced at the origin
            shifted = np.zeros_like(t)
            shifted[..., i:, j:] = t[..., :h - i, :w - j]
            grad -= shifted
    return float(np.sum(c * r * r)), grad


def reference_objective(x, observations, shifts, kernel, scale,
                        regularizer=None, constants=None):
    """float64 cost and gradient of ``s^2 sum_k ||D B M_k x - y_k||^2`` plus
    an optional IRLS-weighted ``sum c r(x)^2`` term, with the reference's
    border semantics and gradient chain, written tap by tap in numpy.

    ``regularizer`` is ``None``, ``("tv", use_3d)`` or ``("btv", range,
    decay)``; ``constants`` is ``lambda * weights`` (shape of x).
    """
    x = np.asarray(x, np.float64)
    obs = np.asarray(observations, np.float64)
    k = None if kernel is None else np.asarray(kernel, np.float64)
    s = int(scale)
    cost = 0.0
    grad = np.zeros_like(x)
    for y, (dx, dy) in zip(obs, np.asarray(shifts, np.float64)):
        z = _np_warp(x, float(dx), float(dy))
        if k is not None:
            z = _np_correlate(z, k)
        r = z[..., ::s, ::s] - y
        cost += float(np.sum(r * r))
        g = np.zeros_like(x)
        g[..., ::s, ::s] = r
        if k is not None:
            g = _np_correlate(g, k.T)
        grad += _np_warp(g, -float(dx), -float(dy))
    cost *= s * s
    grad *= 2.0 * s * s
    if regularizer is not None:
        c = np.broadcast_to(np.asarray(constants, np.float64), x.shape)
        if regularizer[0] == "tv":
            rc, rg = _np_tv(x, c, regularizer[1])
        else:
            rc, rg = _np_btv(x, c, regularizer[1], regularizer[2])
        cost += rc
        grad = grad + rg
    return cost, grad
