"""The forward/adjoint degradation image model (the JAX equivalent of
``src/image_model/``).

Models the observation process ``y_k = D B M_k x (+ n)``:

- ``M_k`` translational warp by per-frame (dx, dy) — :class:`MotionOperator`
- ``B``   Gaussian PSF blur — :class:`BlurOperator`
- ``D``   top-left decimation by ``scale`` — :class:`DownsamplingOperator`
- ``n``   additive Gaussian noise (data generation only) — :class:`NoiseOperator`

Each operator exposes three views:

- ``apply(x, k)`` / ``apply_transpose(x, k)`` — pure jnp functions on
  ``[..., H, W]`` arrays (jit/vmap-safe), the production path;
- ``operator_matrix(hw, k)`` — the explicit dense numpy matrix, a *test-only
  oracle* capped at 30x30 images / 10x10 kernels like the reference
  (``degradation_operator.cpp:16-17``), used to validate the fast operators
  against closed-form linear algebra.

The :class:`ImageModel` chains operators in order (forward) and reverse
(adjoint), mirroring ``image_model.cpp:76-118``. For the solver hot path,
:func:`degrade` / :func:`degrade_adjoint` provide the fused functional form
with traced per-frame shifts, vmappable over the frame axis so a whole LR
stack degrades in one XLA computation (the reference loops frames serially,
``objective_data_term.cpp:104-115``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from super_resolution_tpu.motion.motion_shift import MotionShiftSequence
from super_resolution_tpu.ops.blur import (
    blur as blur_op,
    blur_adjoint as blur_adjoint_op,
    gaussian_kernel_2d,
)
from super_resolution_tpu.ops.resize import decimate, nearest_resize, zero_upsample
from super_resolution_tpu.ops.warp import translate, translate_adjoint

__all__ = [
    "ImageModelParameters",
    "ImageModel",
    "DegradationOperator",
    "MotionOperator",
    "BlurOperator",
    "DownsamplingOperator",
    "NoiseOperator",
    "kernel_to_operator_matrix",
    "degrade",
    "degrade_adjoint",
]

# Dense-matrix oracle caps (``degradation_operator.cpp:16-17``).
_MAX_MATRIX_IMAGE_SIZE = 30
_MAX_MATRIX_KERNEL_SIZE = 10


def kernel_to_operator_matrix(kernel: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Dense correlation matrix of a 2D kernel over an HxW image.

    Row ``i`` holds the kernel taps that produce output pixel ``i`` under
    zero-padded correlation — matches
    ``DegradationOperator::ConvertKernelToOperatorMatrix``
    (``degradation_operator.cpp:22-76``).
    """
    kernel = np.asarray(kernel, dtype=np.float64)
    kh, kw = kernel.shape
    h, w = hw
    if kh > _MAX_MATRIX_KERNEL_SIZE or kw > _MAX_MATRIX_KERNEL_SIZE:
        raise ValueError("Kernel is too big to convert to matrix form.")
    if h > _MAX_MATRIX_IMAGE_SIZE or w > _MAX_MATRIX_IMAGE_SIZE:
        raise ValueError("Image is too big to compute a kernel matrix.")
    n = h * w
    mat = np.zeros((n, n))
    mid_r, mid_c = kh // 2, kw // 2
    for row in range(h):
        for col in range(w):
            out_idx = row * w + col
            for i in range(kh):
                for j in range(kw):
                    rr, cc = row + i - mid_r, col + j - mid_c
                    if 0 <= rr < h and 0 <= cc < w:
                        mat[out_idx, rr * w + cc] = kernel[i, j]
    return mat


class DegradationOperator:
    """Base operator: forward, transpose, and dense-matrix views."""

    def apply(self, x: jnp.ndarray, index: int) -> jnp.ndarray:
        raise NotImplementedError

    def apply_transpose(self, x: jnp.ndarray, index: int) -> jnp.ndarray:
        raise NotImplementedError

    def operator_matrix(self, hw: tuple[int, int], index: int) -> np.ndarray:
        """Default: identity (``degradation_operator.cpp:78-83``)."""
        n = hw[0] * hw[1]
        return np.eye(n)


class MotionOperator(DegradationOperator):
    """Per-frame translational warp M_k (``motion_module.cpp``)."""

    def __init__(self, motion_sequence: MotionShiftSequence, max_shift: int | None = None):
        self.motion_sequence = motion_sequence
        self.max_shift = max_shift or max(
            int(np.ceil(motion_sequence.max_abs_shift)) + 1, 2
        )

    def apply(self, x, index):
        s = self.motion_sequence[index]
        return translate(x, s.dx, s.dy, max_shift=self.max_shift)

    def apply_transpose(self, x, index):
        s = self.motion_sequence[index]
        return translate_adjoint(x, s.dx, s.dy, max_shift=self.max_shift)

    def operator_matrix(self, hw, index):
        """0/1 shift matrix; fractional shifts truncate like the reference's
        implicit double->int conversion (``motion_module.cpp:53-73``)."""
        h, w = hw
        s = self.motion_sequence[index]
        dy, dx = int(s.dy), int(s.dx)
        mat = np.zeros((h * w, h * w))
        for row in range(h):
            for col in range(w):
                sr, sc = row - dy, col - dx
                if 0 <= sr < h and 0 <= sc < w:
                    mat[row * w + col, sr * w + sc] = 1.0
        return mat


class BlurOperator(DegradationOperator):
    """Gaussian PSF blur B (``blur_module.cpp``). ``radius`` is the full
    (odd) kernel size, matching the reference's naming."""

    def __init__(self, radius: int, sigma: float):
        if radius < 1 or radius % 2 != 1:
            raise ValueError("Blur radius must be a positive odd number.")
        if sigma <= 0:
            raise ValueError("Blur sigma must be positive.")
        self.radius = radius
        self.sigma = sigma
        self.kernel = gaussian_kernel_2d(radius, sigma)

    def apply(self, x, index):
        return blur_op(x, self.kernel)

    def apply_transpose(self, x, index):
        return blur_adjoint_op(x, self.kernel)

    def operator_matrix(self, hw, index):
        return kernel_to_operator_matrix(self.kernel, hw)


class DownsamplingOperator(DegradationOperator):
    """Top-left decimation D (``downsampling_module.cpp``)."""

    def __init__(self, scale: int):
        if scale < 1:
            raise ValueError("Downsampling scale must be at least 1.")
        self.scale = scale

    def apply(self, x, index):
        return decimate(x, self.scale)

    def apply_transpose(self, x, index):
        return zero_upsample(x, self.scale)

    def operator_matrix(self, hw, index):
        """Row-selection matrix mapping HR pixels to the LR grid
        (``downsampling_module.cpp:41-64``)."""
        h, w = hw
        s = self.scale
        n_hr = h * w
        n_lr = n_hr // (s * s)
        mat = np.zeros((n_lr, n_hr))
        next_row = 0
        for row in range(0, h, s):
            for col in range(0, w, s):
                mat[next_row, row * w + col] = 1.0
                next_row += 1
        return mat


class NoiseOperator(DegradationOperator):
    """Additive Gaussian noise N(0, sigma/255) per channel
    (``additive_noise_module.cpp``). Data-generation only; the transpose is a
    no-op (the reference leaves it unimplemented, :38-44)."""

    def __init__(self, sigma: float, seed: int = 0):
        if sigma <= 0:
            raise ValueError("Noise sigma must be positive.")
        self.sigma = sigma
        self.seed = seed

    def apply(self, x, index):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), index)
        noise = jax.random.normal(key, x.shape, dtype=x.dtype) * (self.sigma / 255.0)
        return x + noise

    def apply_transpose(self, x, index):
        return x


@dataclasses.dataclass
class ImageModelParameters:
    """Mirror of ``ImageModelParameters`` (``image_model.h:26-50``)."""

    scale: int = 2
    blur_radius: int = 0          # full (odd) kernel size; 0 disables blur
    blur_sigma: float = 0.0
    motion_sequence: MotionShiftSequence | None = None
    motion_sequence_path: str = ""
    noise_sigma: float = 0.0
    noise_seed: int = 0


class ImageModel:
    """Ordered chain of degradation operators (``image_model.cpp``)."""

    def __init__(self, downsampling_scale: int, operators: Sequence[DegradationOperator] = ()):
        if downsampling_scale < 1:
            raise ValueError("Downsampling scale must be at least 1.")
        self.downsampling_scale = downsampling_scale
        self.operators: list[DegradationOperator] = list(operators)

    @classmethod
    def create(cls, params: ImageModelParameters) -> "ImageModel":
        """Factory assembling M -> B -> D (-> n), ``image_model.cpp:17-61``."""
        model = cls(params.scale)
        seq = params.motion_sequence
        if (seq is None or len(seq) == 0) and params.motion_sequence_path:
            seq = MotionShiftSequence.from_file(params.motion_sequence_path)
        if seq is not None and len(seq) > 0:
            model.add_operator(MotionOperator(seq))
        if params.blur_radius > 0 and params.blur_sigma > 0.0:
            model.add_operator(BlurOperator(params.blur_radius, params.blur_sigma))
        model.add_operator(DownsamplingOperator(params.scale))
        if params.noise_sigma > 0.0:
            model.add_operator(NoiseOperator(params.noise_sigma, params.noise_seed))
        return model

    def add_operator(self, operator: DegradationOperator) -> None:
        self.operators.append(operator)

    def apply(self, x: jnp.ndarray, index: int) -> jnp.ndarray:
        """Forward degradation of an HR ``[..., H, W]`` array for frame ``index``."""
        for op in self.operators:
            x = op.apply(x, index)
        return x

    def apply_transpose(self, x: jnp.ndarray, index: int) -> jnp.ndarray:
        """Adjoint chain, reverse operator order (``image_model.cpp:93-101``)."""
        for op in reversed(self.operators):
            x = op.apply_transpose(x, index)
        return x

    def model_matrix(self, hw: tuple[int, int], index: int) -> np.ndarray:
        """Dense ``A_k = D B M_k`` for the test oracle (``image_model.cpp:103-118``)."""
        if not self.operators:
            raise ValueError("Cannot build a model matrix with no operators.")
        mat = self.operators[0].operator_matrix(hw, index)
        for op in self.operators[1:]:
            mat = op.operator_matrix(hw, index) @ mat
        return mat

    # Convenience accessors for the fused functional path.

    @property
    def motion_operator(self) -> MotionOperator | None:
        for op in self.operators:
            if isinstance(op, MotionOperator):
                return op
        return None

    @property
    def blur_operator(self) -> BlurOperator | None:
        for op in self.operators:
            if isinstance(op, BlurOperator):
                return op
        return None


def degrade(
    x: jnp.ndarray,
    dx: jnp.ndarray,
    dy: jnp.ndarray,
    blur_kernel: jnp.ndarray | None,
    scale: int,
    max_shift: int = 16,
) -> jnp.ndarray:
    """Fused functional forward model ``D B M x`` with traced shifts.

    vmap over (dx, dy) arrays to degrade a whole stack:
    ``jax.vmap(lambda d: degrade(x, d[0], d[1], k, s))(shifts)``.
    """
    z = translate(x, dx, dy, max_shift=max_shift)
    if blur_kernel is not None:
        z = blur_op(z, blur_kernel)
    return decimate(z, scale)


def degrade_adjoint(
    r: jnp.ndarray,
    dx: jnp.ndarray,
    dy: jnp.ndarray,
    blur_kernel: jnp.ndarray | None,
    scale: int,
    max_shift: int = 16,
) -> jnp.ndarray:
    """Fused adjoint ``M^T B^T D^T r`` (reverse order, ``image_model.cpp:93-101``)."""
    z = zero_upsample(r, scale)
    if blur_kernel is not None:
        z = blur_adjoint_op(z, blur_kernel)
    return translate_adjoint(z, dx, dy, max_shift=max_shift)
