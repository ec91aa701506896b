"""Gaussian PSF blur with cv::filter2D parity (correlation, zero border).

Mirrors the reference BlurModule (``src/image_model/blur_module.cpp``):
the kernel is ``getGaussianKernel(size, sigma)`` outer-producted with itself
(``blur_module.cpp:20-22``), applied as *correlation* (cv::filter2D does not
flip the kernel) with BORDER_CONSTANT zero padding
(``src/util/matrix_util.h:18-22``). The "transpose" applies the transposed
kernel (``blur_module.cpp:30-36``) — identical for the symmetric Gaussian.

XLA's convolution primitive is also a correlation, so the forward map is a
single depthwise ``lax.conv_general_dilated`` (on the GPU, XLA hands it to
cuDNN or its own convolution emitter).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

__all__ = ["gaussian_kernel_1d", "gaussian_kernel_2d", "correlate2d", "blur", "blur_adjoint"]


def gaussian_kernel_1d(size: int, sigma: float, dtype=np.float64) -> np.ndarray:
    """cv::getGaussianKernel parity: normalized ``exp(-(i - (size-1)/2)^2 / (2 sigma^2))``."""
    if size < 1 or size % 2 != 1:
        raise ValueError("Blur kernel size must be a positive odd number.")
    if sigma <= 0:
        # OpenCV's automatic sigma for ksize (not used by the reference, which
        # CHECKs sigma > 0, but kept for API completeness).
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    i = np.arange(size, dtype=np.float64)
    center = (size - 1) / 2.0
    k = np.exp(-((i - center) ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(dtype)


def gaussian_kernel_2d(size: int, sigma: float, dtype=np.float64) -> np.ndarray:
    k = gaussian_kernel_1d(size, sigma, dtype=np.float64)
    return np.outer(k, k).astype(dtype)


def correlate2d(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """'SAME' zero-padded correlation of ``[..., H, W]`` with a 2D kernel.

    Matches cv::filter2D with a center anchor and BORDER_CONSTANT. For
    even-sized kernels OpenCV anchors at ``(k//2, k//2)``, giving asymmetric
    padding ``(k//2, k - 1 - k//2)`` on each axis.
    """
    kh, kw = kernel.shape
    batch = x.shape[:-2]
    h, w = x.shape[-2], x.shape[-1]
    xb = x.reshape((-1, 1, h, w))
    kern = jnp.asarray(kernel, dtype=x.dtype).reshape((1, 1, kh, kw))
    out = lax.conv_general_dilated(
        xb,
        kern,
        window_strides=(1, 1),
        padding=((kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        # Full float32: at default precision an accelerator may run float32
        # convolutions in reduced precision (TF32 on a GPU keeps about three
        # decimal digits), too coarse for the parity tests.
        precision=lax.Precision.HIGHEST,
    )
    return out.reshape(*batch, h, w)


def blur(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Forward PSF blur B (correlation with the kernel, zero border)."""
    return correlate2d(x, kernel)


def blur_adjoint(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Reference blur transpose: correlation with ``kernel.T`` (``blur_module.cpp:30-36``).

    For the symmetric separable Gaussian this equals the forward blur; it is
    the exact adjoint only for 180-degree-symmetric kernels (the true adjoint
    of zero-padded correlation flips the kernel in both axes).
    """
    return correlate2d(x, jnp.asarray(kernel).T)
