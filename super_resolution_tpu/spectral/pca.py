"""Spectral-basis PCA for hyperspectral stacks (the JAX equivalent of
``src/hyperspectral/spectral_pca.cpp``).

Training data is a subsampled set of pixel spectra: ``10 * num_bands``
samples split evenly across the input images with an even pixel stride
(``spectral_pca.cpp:23,50-66``). The basis comes from an SVD of the centered
sample matrix (equivalent to cv::PCA DATA_AS_ROW), truncated either to a band
count or to a retained-variance fraction (``spectral_pca.h:46-76``).

Projection/backprojection are per-pixel matmuls — ``[C, H, W]`` reshaped to
``[H*W, C]`` and multiplied by the basis — one matrix product where the
reference runs scalar loops (``spectral_pca.cpp:94-161``), kept at full
float32 precision (a GPU may otherwise run it in TF32).
Components are sign-canonicalized (largest-|entry| positive) since the PCA
sign is arbitrary.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from super_resolution_tpu.image.image_data import ImageData, SpectralMode

__all__ = ["SpectralPCA"]

_SAMPLES_PER_BAND = 10  # kPCASamplesMultiplicationFactor


def _as_chw(image) -> np.ndarray:
    arr = getattr(image, "array", image)
    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim == 2:
        arr = arr[None]
    return arr


class SpectralPCA:
    """PCA over the spectral axis, trained from one or more images."""

    def __init__(
        self,
        hyperspectral_images,
        num_pca_bands: int = 0,
        retained_variance: float | None = None,
    ):
        images = [_as_chw(img) for img in hyperspectral_images]
        if not images:
            raise ValueError("At least one image is required to compute the PCA basis.")
        num_channels = images[0].shape[0]
        if num_channels == 0:
            raise ValueError("Cannot compute PCA on empty images.")

        samples = self._gather_training_samples(images, num_channels)
        self.mean = samples.mean(axis=0)
        centered = samples - self.mean
        # SVD of the sample matrix == eigendecomposition of the covariance.
        _, svals, vt = np.linalg.svd(centered, full_matrices=False)
        variances = (svals**2) / max(samples.shape[0] - 1, 1)

        if retained_variance is not None:
            if not 0.0 < retained_variance <= 1.0:
                raise ValueError("retained_variance must be in (0, 1].")
            ratios = np.cumsum(variances) / variances.sum()
            k = int(np.searchsorted(ratios, retained_variance) + 1)
        elif num_pca_bands > 0:
            k = min(num_pca_bands, len(svals))
        else:
            k = len(svals)

        basis = vt[:k]  # [k, C]
        # Canonical sign: largest-|.| entry of each component positive.
        signs = np.sign(basis[np.arange(k), np.abs(basis).argmax(axis=1)])
        signs[signs == 0] = 1.0
        self.basis = basis * signs[:, None]
        self.num_spectral_bands = num_channels
        self.num_pca_bands = k

    @staticmethod
    def _gather_training_samples(images, num_channels) -> np.ndarray:
        num_images = len(images)
        num_pixels = images[0].shape[1] * images[0].shape[2]
        num_samples = num_channels * _SAMPLES_PER_BAND
        per_image = min(max(num_samples // num_images, 1), num_pixels)
        stride = max(num_pixels // per_image, 1)
        rows = []
        for img in images:
            if img.shape[0] != num_channels:
                raise ValueError("Inconsistent number of channels between images.")
            flat = img.reshape(num_channels, -1)  # [C, P]
            idx = (np.arange(per_image) * stride) % num_pixels
            rows.append(flat[:, idx].T)  # [per_image, C]
        return np.concatenate(rows, axis=0)

    # ------------------------------------------------------------- transforms

    def project(self, x: jnp.ndarray) -> jnp.ndarray:
        """``[C, H, W]`` spectra -> ``[k, H, W]`` PCA coefficients."""
        c, h, w = x.shape
        flat = x.reshape(c, h * w).T  # [P, C]
        coeffs = jnp.matmul(
            flat - jnp.asarray(self.mean, x.dtype),
            jnp.asarray(self.basis.T, x.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )  # [P, k]
        return coeffs.T.reshape(self.num_pca_bands, h, w)

    def back_project(self, y: jnp.ndarray) -> jnp.ndarray:
        """``[k, H, W]`` PCA coefficients -> ``[C, H, W]`` spectra."""
        k, h, w = y.shape
        coeffs = y.reshape(k, h * w).T  # [P, k]
        flat = jnp.matmul(
            coeffs, jnp.asarray(self.basis, y.dtype),
            precision=jax.lax.Precision.HIGHEST,
        ) + jnp.asarray(self.mean, y.dtype)
        return flat.T.reshape(self.num_spectral_bands, h, w)

    # ----------------------------------------------------- ImageData wrappers

    def get_pca_image(self, image) -> ImageData:
        """Mirror of ``SpectralPCA::GetPCAImage`` — sets HYPERSPECTRAL_PCA mode."""
        arr = jnp.asarray(_as_chw(image))
        out = ImageData(
            self.project(arr), normalize="never", channel_major=True,
            spectral_mode=SpectralMode.HYPERSPECTRAL_PCA,
        )
        return out

    def reconstruct_image(self, pca_image) -> ImageData:
        arr = jnp.asarray(_as_chw(pca_image))
        out = ImageData(
            self.back_project(arr), normalize="never", channel_major=True,
            spectral_mode=SpectralMode.HYPERSPECTRAL,
        )
        return out
