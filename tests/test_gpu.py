"""Checks that only mean something on the card: float32 work that a GPU may
run in reduced precision (TF32) unless asked not to, and registration's
FFTs on the device. Each skips without a GPU; ``python chip_smoke.py`` runs
them on the card, in its own process.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _on(device, x):
    return jax.device_put(jnp.asarray(x, jnp.float32), device)


def test_solver_dot_products_full_precision(gpu_device):
    """Every CG step length and direction update comes from these products:
    they must not run in TF32 (about three decimal digits)."""
    from super_resolution_tpu.solvers.least_squares import _vdot

    rng = np.random.default_rng(0)
    a = rng.standard_normal(1 << 20).astype(np.float32)
    b = rng.standard_normal(1 << 20).astype(np.float32)
    got = float(_vdot(_on(gpu_device, a), _on(gpu_device, b)))
    want = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    scale = float(np.linalg.norm(a.astype(np.float64)) * np.linalg.norm(b))
    assert abs(got - want) <= 1e-5 * scale, (got, want)


def test_blur_full_precision(gpu_device):
    """The PSF convolution asks for full float32 precision."""
    from super_resolution_tpu.ops.blur import correlate2d, gaussian_kernel_2d

    rng = np.random.default_rng(1)
    x = rng.random((1, 256, 256)).astype(np.float32)
    k = gaussian_kernel_2d(7, 1.5)
    got = np.asarray(correlate2d(_on(gpu_device, x), jnp.asarray(k, jnp.float32)))
    xp = np.pad(x[0].astype(np.float64), 3)
    want = np.zeros((256, 256))
    for i in range(7):
        for j in range(7):
            want += k[i, j] * xp[i:i + 256, j:j + 256]
    assert np.max(np.abs(got[0] - want)) < 1e-5


def test_pca_projection_full_precision(gpu_device):
    """The spectral PCA projection is one float32 matrix product per image."""
    from super_resolution_tpu.spectral import SpectralPCA

    rng = np.random.default_rng(2)
    cube = rng.random((64, 64, 64)).astype(np.float32)
    pca = SpectralPCA([cube])
    got = np.asarray(pca.back_project(pca.project(_on(gpu_device, cube))))
    assert np.max(np.abs(got - cube)) < 1e-4


def test_objective_matches_float64_reference(gpu_device):
    """The MAP objective in float32 on the card against the float64 numpy
    reference: cost relative error <= 1e-5, gradient <= 1e-5 of its
    largest entry (float32 sums of ~10^5 terms taken in another order)."""
    from super_resolution_tpu.ops.blur import gaussian_kernel_2d
    from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu.solvers import make_map_value_and_grad
    from super_resolution_tpu.utils.testing import reference_objective

    rng = np.random.default_rng(3)
    x = rng.random((1, 256, 256))
    obs = rng.random((4, 1, 64, 64))
    shifts = np.asarray([[0, 0], [1, 1], [0.5, -0.5], [-1.25, 0.75]])
    kernel = gaussian_kernel_2d(7, 1.5)
    weights = rng.uniform(0.5, 1.5, x.shape)
    regs = [(BilateralTotalVariationRegularizer(3, 0.5), 0.01)]
    vg = make_map_value_and_grad(_on(gpu_device, obs), _on(gpu_device, shifts),
                                 _on(gpu_device, kernel), 4, regs, max_shift=4)
    c32, g32 = jax.jit(lambda xx, w: vg(xx, (w,)))(
        _on(gpu_device, x), _on(gpu_device, weights)
    )
    c64, g64 = reference_objective(x, obs, shifts, kernel, 4, ("btv", 3, 0.5),
                                   0.01 * weights)
    assert abs(float(c32) - c64) <= 1e-5 * abs(c64), (float(c32), c64)
    assert np.max(np.abs(np.asarray(g32, np.float64) - g64)) <= (
        1e-5 * np.max(np.abs(g64))
    )


def test_registration_runs_on_device(gpu_device):
    """Phase-correlation registration runs its FFTs on the card and meets
    the 0.01 px contract on a seeded smooth scene."""
    from super_resolution_tpu.motion.registration import translational_registration
    from super_resolution_tpu.ops.warp import translate_static

    rng = np.random.default_rng(4)
    f = np.fft.fftfreq(192)
    spectrum = np.fft.fft2(rng.standard_normal((192, 192)))
    lowpass = np.exp(-(f[:, None] ** 2 + f[None, :] ** 2) / (2 * 0.05 ** 2))
    img = _on(gpu_device, np.real(np.fft.ifft2(spectrum * lowpass)))
    truth = [(0.0, 0.0), (2.0, 0.0), (0.5, 0.25)]
    frames = [translate_static(img, dx, dy) for dx, dy in truth]
    assert all(fr.devices() == {gpu_device} for fr in frames)
    est = translational_registration(frames)
    for (dx, dy), sh in zip(truth, est):
        assert abs(sh.dx - dx) <= 0.01 and abs(sh.dy - dy) <= 0.01, (sh, dx, dy)
