"""Subpixel translational registration via upsampled-DFT phase correlation.

An accelerator replacement for the reference's BRISK -> FLANN -> RANSAC ->
estimateRigidTransform pipeline (``src/motion/registration.cpp:41-201``),
which is CPU feature-matching through and through. Phase correlation is pure
FFTs + matmuls (the subpixel refinement is a small matrix-multiply DFT, per
Guizar-Sicairos et al. 2008), so it runs on the device and is trivially
vmappable over frames. The accuracy contract is the reference's: recover
known shifts within 0.01 px on dallas_half (``test/test_registration.cpp:20``).

Convention matches MotionModule: a shift (dx, dy) means
``frame(r, c) = reference(r - dy, c - dx)`` (content moves down-right), and
:func:`translational_registration` returns shifts such that
``translate(frames[0], dx_k, dy_k) ~= frames[k]``, with frame 0 = (0, 0).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from super_resolution_tpu.motion.motion_shift import MotionShift, MotionShiftSequence
from super_resolution_tpu.ops.warp import translate

__all__ = [
    "phase_correlation_shift",
    "robust_phase_correlation_shift",
    "translational_registration",
]

def _upsampled_dft(data, region, upsample_factor, row_offset, col_offset):
    """Evaluate the inverse DFT of ``data`` on a ``region x region`` grid with
    spacing ``1/upsample_factor`` starting at (row_offset, col_offset).

    Two small complex matmuls instead of a zero-padded giant FFT, at full
    float32 precision (a GPU may otherwise run float32 products in TF32,
    which keeps about three decimal digits — too few for 1/256-px peaks).
    """
    h, w = data.shape
    fy = jnp.fft.fftfreq(h)  # u / h
    fx = jnp.fft.fftfreq(w)
    steps = jnp.arange(region) / upsample_factor
    row_kernel = jnp.exp(2j * jnp.pi * jnp.outer(row_offset + steps, fy))
    col_kernel = jnp.exp(2j * jnp.pi * jnp.outer(fx, col_offset + steps))
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(
        jnp.matmul(row_kernel, data, precision=hi), col_kernel, precision=hi
    )


def _phase_correlation_once(ref, img, upsample_factor, lowpass_sigma):
    h, w = ref.shape
    f0 = jnp.fft.fft2(ref)
    f1 = jnp.fft.fft2(img)
    cross = f1 * jnp.conj(f0)
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-20)
    # Low-frequency emphasis: bilinear resampling's transfer function has a
    # nonlinear phase at high frequencies (exact only for offsets 0/0.5/1),
    # which biases a fully whitened spectrum. A Gaussian radial weight keeps
    # the refinement in the linear-phase regime.
    fy = jnp.fft.fftfreq(h)[:, None]
    fx = jnp.fft.fftfreq(w)[None, :]
    cross = cross * jnp.exp(-(fy * fy + fx * fx) / (2.0 * lowpass_sigma**2))

    # Integer-pixel peak of the correlation surface: frame = translate(ref,
    # dx, dy) makes the peak land at (dy, dx) (mod image size).
    corr = jnp.fft.ifft2(cross)
    peak = jnp.argmax(jnp.abs(corr))
    py = (peak // w).astype(ref.dtype)
    px = (peak % w).astype(ref.dtype)
    py = jnp.where(py > h / 2, py - h, py)
    px = jnp.where(px > w / 2, px - w, px)

    # Subpixel refinement: evaluate the correlation on a 1.5-px window around
    # the integer peak at 1/upsample_factor spacing via matrix-multiply DFT.
    region = int(np.ceil(upsample_factor * 1.5))
    r0 = py - (region // 2) / upsample_factor
    c0 = px - (region // 2) / upsample_factor
    cc = _upsampled_dft(cross, region, upsample_factor, r0, c0)
    sub_peak = jnp.argmax(jnp.abs(cc))
    sy = sub_peak // region
    sx = sub_peak % region
    dy = r0 + sy / upsample_factor
    dx = c0 + sx / upsample_factor
    return dx, dy


def phase_correlation_shift(
    reference: jnp.ndarray,
    frame: jnp.ndarray,
    upsample_factor: int = 256,
    num_refinement_iterations: int = 3,
    lowpass_sigma: float = 0.1,
    max_shift: int = 32,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Estimate (dx, dy) such that ``frame ~= translate(reference, dx, dy)``.

    Both images are 2D ``[H, W]`` (use channel 0 of multichannel stacks, like
    the reference's keypoint detector, ``registration.cpp:48-54``). After the
    initial phase-correlation estimate, the reference image is re-warped by
    the running estimate (with the *same* bilinear warp as the imaging model)
    and the residual shift re-estimated — the bilinear resampling bias cancels
    and accuracy lands near 1/upsample_factor (~0.002 px measured on
    dallas_half, vs the 0.01 px contract of ``test_registration.cpp:20``).
    """
    ref = jnp.asarray(reference)
    img = jnp.asarray(frame)
    if ref.ndim == 3:
        ref = ref[0]
    if img.ndim == 3:
        img = img[0]

    dx, dy = _phase_correlation_once(ref, img, upsample_factor, lowpass_sigma)
    for _ in range(max(0, num_refinement_iterations - 1)):
        warped = translate(ref, dx, dy, max_shift=max_shift)
        ddx, ddy = _phase_correlation_once(warped, img, upsample_factor,
                                           lowpass_sigma)
        dx = dx + ddx
        dy = dy + ddy
    return dx, dy


def robust_phase_correlation_shift(
    reference: jnp.ndarray,
    frame: jnp.ndarray,
    block_grid: tuple[int, int] = (3, 3),
    upsample_factor: int = 256,
    num_refinement_iterations: int = 3,
    lowpass_sigma: float = 0.1,
    mad_scale: float = 3.5,
    min_absolute_spread: float = 0.05,
    min_inliers: int = 3,
) -> tuple[float, float, np.ndarray]:
    """Outlier-tolerant shift estimation: per-block phase correlation with
    median/MAD consensus.

    Plays the role of the reference's RANSAC stage
    (``registration.cpp:128-157``): a pure global phase correlation assumes
    the translation model holds everywhere, so a corrupted region or a
    locally violated model (occlusion, local motion) biases the single
    estimate. Here the image pair is split into ``block_grid`` blocks, each
    block votes with its own phase-correlation estimate (vmapped — one
    batched FFT), and votes farther than ``mad_scale`` robust standard
    deviations (1.4826 x MAD) from the per-axis median are rejected; the
    consensus is the per-axis median of the inlier votes.

    The consensus is used for *detection and repair*, not as the final
    answer (individual blocks see stronger boundary effects than the full
    image, costing ~0.02 px): outlier blocks of the frame are replaced by
    the reference content warped by the consensus shift, and the full-image
    estimator (:func:`phase_correlation_shift`) runs on the repaired frame —
    on clean data (no outliers) this degenerates to exactly the global
    estimator, so the 0.01 px contract is inherited bit-for-bit. Falls back
    to the plain global estimate when fewer than ``min_inliers`` blocks
    agree (e.g. aperture-problem blocks on synthetic data).

    Returns ``(dx, dy, inlier_mask)`` with the mask ordered row-major over
    blocks.
    """
    ref = jnp.asarray(reference)
    img = jnp.asarray(frame)
    if ref.ndim == 3:
        ref = ref[0]
    if img.ndim == 3:
        img = img[0]
    h, w = ref.shape
    gy, gx = block_grid
    bh, bw = h // gy, w // gx
    if min(bh, bw) < 16:
        raise ValueError(f"Blocks {bh}x{bw} too small for reliable correlation.")

    def blocks(a):
        a = a[: gy * bh, : gx * bw]
        return a.reshape(gy, bh, gx, bw).transpose(0, 2, 1, 3).reshape(-1, bh, bw)

    est = jax.vmap(
        lambda r, f: phase_correlation_shift(
            r, f, upsample_factor, num_refinement_iterations, lowpass_sigma
        )
    )(blocks(ref), blocks(img))
    dxs = np.asarray(est[0], np.float64)
    dys = np.asarray(est[1], np.float64)

    med = np.array([np.median(dxs), np.median(dys)])
    mad = np.array([np.median(np.abs(dxs - med[0])), np.median(np.abs(dys - med[1]))])
    tol = np.maximum(mad_scale * 1.4826 * mad, min_absolute_spread)
    inliers = (np.abs(dxs - med[0]) <= tol[0]) & (np.abs(dys - med[1]) <= tol[1])

    if bool(inliers.all()) or int(inliers.sum()) < min_inliers:
        # Clean data (or degenerate blocks): the plain global estimator.
        dx, dy = phase_correlation_shift(
            ref, img, upsample_factor, num_refinement_iterations, lowpass_sigma
        )
        return float(dx), float(dy), inliers

    # Repair: overwrite the outlier blocks with reference content warped by
    # the consensus shift, then estimate globally on the repaired frame. The
    # patched-in content carries exactly the consensus shift, so any residual
    # bias is second-order (patched fraction x consensus error).
    cdx = float(dxs[inliers].mean())
    cdy = float(dys[inliers].mean())
    warped = np.asarray(translate(ref, cdx, cdy, max_shift=32))
    repaired = np.asarray(img).copy()
    for i in range(gy):
        for j in range(gx):
            if not inliers[i * gx + j]:
                sl = (slice(i * bh, (i + 1) * bh), slice(j * bw, (j + 1) * bw))
                repaired[sl] = warped[sl]
    dx, dy = phase_correlation_shift(
        ref, jnp.asarray(repaired), upsample_factor,
        num_refinement_iterations, lowpass_sigma,
    )
    return float(dx), float(dy), inliers


def translational_registration(
    images, upsample_factor: int = 256, robust: bool = False,
    block_grid: tuple[int, int] = (3, 3),
) -> MotionShiftSequence:
    """Register each frame against frame 0 (frame 0 gets shift (0, 0)).

    Accepts a list of ImageData / ``[C, H, W]`` / ``[H, W]`` arrays or a
    stacked ``[K, ...]`` array. Mirrors ``TranslationalRegistration``
    (``registration.cpp:161-201``) with phase correlation instead of BRISK.

    ``robust=True`` uses per-block consensus voting
    (:func:`robust_phase_correlation_shift`) — the RANSAC-equivalent for
    data with corrupted regions or locally violated translation models.
    """
    def chan0(img):
        arr = jnp.asarray(getattr(img, "array", img))
        return arr[0] if arr.ndim == 3 else arr

    frames = [chan0(img) for img in images]
    if not frames:
        return MotionShiftSequence()
    ref = frames[0]
    shifts = [MotionShift(0, 0)]
    if len(frames) > 1 and robust:
        for f in frames[1:]:
            dx, dy, _ = robust_phase_correlation_shift(
                ref, f, block_grid=block_grid, upsample_factor=upsample_factor
            )
            shifts.append(MotionShift(dx, dy))
    elif len(frames) > 1:
        stack = jnp.stack(frames[1:])
        est = jax.vmap(lambda f: phase_correlation_shift(ref, f, upsample_factor))(
            stack
        )
        dxs, dys = np.asarray(est[0]), np.asarray(est[1])
        shifts += [MotionShift(float(dx), float(dy)) for dx, dy in zip(dxs, dys)]
    return MotionShiftSequence(shifts)
