"""Registration tests, mirroring ``test/test_registration.cpp``: recover known
shifts on dallas_half within 0.01 px. Adds fractional-shift cases the
reference never tested (its tolerance contract still applies)."""

import cv2
import numpy as np

import jax.numpy as jnp

from super_resolution_tpu.motion import MotionShift, MotionShiftSequence
from super_resolution_tpu.motion.registration import (
    phase_correlation_shift,
    translational_registration,
)
from super_resolution_tpu.ops.warp import translate_static

TOLERANCE = 0.01


def _load_dallas_half(test_data_dir):
    img = cv2.imread(f"{test_data_dir}/dallas_half.jpg", cv2.IMREAD_GRAYSCALE)
    return jnp.asarray(img.astype(np.float64) / 255.0)


def test_known_integer_shifts(test_data_dir):
    """The reference's exact test shifts (``test_registration.cpp:28-66``)."""
    original = _load_dallas_half(test_data_dir)
    ground_truth = [(0, 0), (0, 1), (2, 0), (5, 5), (-5, -1)]
    shifted = [translate_static(original, dx, dy) for dx, dy in ground_truth]
    registered = translational_registration(shifted)
    assert len(registered) == len(ground_truth)
    for (dx, dy), est in zip(ground_truth, registered):
        assert abs(est.dx - dx) <= TOLERANCE, (est.dx, dx)
        assert abs(est.dy - dy) <= TOLERANCE, (est.dy, dy)


def test_subpixel_shifts(test_data_dir):
    original = _load_dallas_half(test_data_dir)
    cases = [(0.5, 0.25), (-1.25, 2.75), (3.5, -0.5)]
    for dx, dy in cases:
        shifted = translate_static(original, dx, dy)
        est_dx, est_dy = phase_correlation_shift(original, shifted)
        assert abs(float(est_dx) - dx) <= TOLERANCE, (float(est_dx), dx)
        assert abs(float(est_dy) - dy) <= TOLERANCE, (float(est_dy), dy)


def test_registration_multichannel_uses_channel0(test_data_dir):
    original = _load_dallas_half(test_data_dir)
    img3 = jnp.stack([original] * 3)
    shifted = [img3, translate_static(img3, 2.0, -1.0)]
    registered = translational_registration(shifted)
    assert abs(registered[1].dx - 2.0) <= TOLERANCE
    assert abs(registered[1].dy - (-1.0)) <= TOLERANCE


def test_empty_registration():
    assert len(translational_registration([])) == 0


def test_robust_registration_clean_data_holds_contract(test_data_dir):
    """Block-consensus voting meets the same 0.01 px contract on clean data,
    including the reference's (5,5) and (-5,-1) cases."""
    original = _load_dallas_half(test_data_dir)
    ground_truth = [(0, 0), (5, 5), (-5, -1), (0.5, 0.25), (-1.25, 2.75)]
    shifted = [translate_static(original, dx, dy) for dx, dy in ground_truth]
    registered = translational_registration(shifted, robust=True)
    for (dx, dy), est in zip(ground_truth, registered):
        assert abs(est.dx - dx) <= TOLERANCE, (est.dx, dx)
        assert abs(est.dy - dy) <= TOLERANCE, (est.dy, dy)


def test_robust_registration_rejects_corrupted_region(test_data_dir):
    """A frame with a corrupted block (the RANSAC scenario,
    ``registration.cpp:128-157``): consensus voting rejects the block and
    recovers the true shift; the corrupted blocks are flagged as outliers."""
    from super_resolution_tpu.motion.registration import (
        robust_phase_correlation_shift,
    )

    original = _load_dallas_half(test_data_dir)
    dx, dy = 3.0, -2.0
    shifted = np.array(translate_static(original, dx, dy))  # writable copy
    # Corrupt the top-left region (~1/9 of the image) with CONTENT MOVED THE
    # WRONG WAY: a locally violated translation model, not just noise.
    h, w = shifted.shape
    bh, bw = h // 3, w // 3
    shifted[:bh, :bw] = np.asarray(
        translate_static(original, -8.0, 7.0)
    )[:bh, :bw]
    est_dx, est_dy, inliers = robust_phase_correlation_shift(
        original, jnp.asarray(shifted)
    )
    assert abs(est_dx - dx) <= TOLERANCE, (est_dx, dx)
    assert abs(est_dy - dy) <= TOLERANCE, (est_dy, dy)
    assert not inliers[0], "corrupted block should be voted out"
    assert inliers.sum() >= 6


def test_robust_registration_fallback_few_inliers():
    """Degenerate synthetic input (aperture problem everywhere): falls back
    to the global estimate instead of averaging garbage."""
    from super_resolution_tpu.motion.registration import (
        robust_phase_correlation_shift,
    )

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((96, 96)))
    dx, dy = 1.5, -0.75
    shifted = translate_static(img, dx, dy)
    est_dx, est_dy, _ = robust_phase_correlation_shift(
        img, shifted, block_grid=(2, 2), min_inliers=5  # > 4 blocks -> fallback
    )
    assert abs(est_dx - dx) <= TOLERANCE
    assert abs(est_dy - dy) <= TOLERANCE
