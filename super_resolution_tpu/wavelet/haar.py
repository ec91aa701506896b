"""Single-level Haar wavelet transform (the JAX equivalent of
``src/wavelet/wavelet_transform.cpp``).

Per-2x2-block coefficients with 0.5 scaling (:63-115):

    ll = 0.5 (a + b + c + d)    lh = 0.5 (a - b + c - d)
    hl = 0.5 (a + b - c - d)    hh = 0.5 (a - b - c + d)

for a block ``[[a, b], [c, d]]``, with the exact inverse (:117-173).
Implemented as reshape + elementwise combines (no per-pixel loops); the
orthonormality contract is iDWT(DWT(x)) == x to ~1/255
(``test_wavelet_transform.cpp:18,36``) — here it is exact to float precision.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

__all__ = ["WaveletCoefficients", "wavelet_transform", "inverse_wavelet_transform"]


class WaveletCoefficients(NamedTuple):
    """LL/LH/HL/HH subbands, each ``[..., H/2, W/2]``
    (``wavelet_transform.h:12-31``)."""

    ll: jnp.ndarray
    lh: jnp.ndarray
    hl: jnp.ndarray
    hh: jnp.ndarray

    def stitched(self) -> jnp.ndarray:
        """2x2 visualization layout [[ll, lh], [hl, hh]]
        (``wavelet_transform.cpp:12-61``)."""
        top = jnp.concatenate([self.ll, self.lh], axis=-1)
        bottom = jnp.concatenate([self.hl, self.hh], axis=-1)
        return jnp.concatenate([top, bottom], axis=-2)


def wavelet_transform(x: jnp.ndarray) -> WaveletCoefficients:
    """Haar DWT of ``[..., H, W]`` (H, W even)."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"Wavelet transform needs even dimensions, got {(h, w)}")
    batch = x.shape[:-2]
    blocks = x.reshape(*batch, h // 2, 2, w // 2, 2)
    a = blocks[..., 0, :, 0]
    b = blocks[..., 0, :, 1]
    c = blocks[..., 1, :, 0]
    d = blocks[..., 1, :, 1]
    ll = 0.5 * (a + b + c + d)
    lh = 0.5 * (a - b + c - d)
    hl = 0.5 * (a + b - c - d)
    hh = 0.5 * (a - b - c + d)
    return WaveletCoefficients(ll, lh, hl, hh)


def inverse_wavelet_transform(coefficients: WaveletCoefficients) -> jnp.ndarray:
    """Exact inverse Haar DWT -> ``[..., H, W]``."""
    ll, lh, hl, hh = coefficients
    a = 0.5 * (ll + lh + hl + hh)
    b = 0.5 * (ll - lh + hl - hh)
    c = 0.5 * (ll + lh - hl - hh)
    d = 0.5 * (ll - lh - hl + hh)
    batch = ll.shape[:-2]
    h2, w2 = ll.shape[-2], ll.shape[-1]
    blocks = jnp.stack(
        [jnp.stack([a, b], axis=-1), jnp.stack([c, d], axis=-1)], axis=-3
    )  # [..., h2, 2, w2, 2]
    return blocks.reshape(*batch, h2 * 2, w2 * 2)
