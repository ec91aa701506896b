"""ImageData — the N-channel image container (the JAX equivalent of
``src/image/image_data.{h,cpp}``).

Design: a thin host-level wrapper over a single channel-major ``[C, H, W]``
jnp array plus spectral-mode metadata. Unlike the reference (a vector of
per-channel cv::Mat), the pixel payload is one dense array so it moves to
device memory in one transfer and feeds the pure-function solvers directly
(``.array``). The channel-major layout matches the reference's canonical
``GetPixelIndex`` flattening (``src/util/util.cpp:81-89``):
``index = channel * H * W + row * W + col``.

Semantics replicated from the reference:

- Normalization on ingest: values are divided by 255 when the max exceeds 1
  under NORMALIZE mode (``image_data.cpp:282-291``); the checked constructor
  rejects values outside [0, 255] (``image_data.cpp:218-235``).
- Spectral mode auto-detection: 3 channels -> BGR color, >3 -> hyperspectral
  (``image_data.cpp:36-44``).
- Luminance-only YCrCb: ``num_channels`` reports 1 and the chroma channels are
  hidden until conversion back to BGR, which bilinearly interpolates them to
  the (possibly super-resolved) luminance size (``image_data.cpp:144-168,
  404-406, 490-495``).
- The four resize modes (see :mod:`super_resolution_tpu.ops.resize`).
"""

from __future__ import annotations

import enum
from typing import Iterable

import numpy as np

import jax.numpy as jnp

from super_resolution_tpu.image.color import bgr_to_ycrcb, ycrcb_to_bgr
from super_resolution_tpu.ops.resize import linear_resize as _linear_resize
from super_resolution_tpu.ops.resize import resize as _resize

__all__ = ["ImageData", "SpectralMode", "ImageDataReport"]


class SpectralMode(enum.Enum):
    """Mirror of ``ImageSpectralMode`` (``src/image/image_data.h:73-83``)."""

    NONE = "none"
    HYPERSPECTRAL = "hyperspectral"
    HYPERSPECTRAL_PCA = "hyperspectral_pca"
    COLOR_BGR = "color_bgr"
    COLOR_YCRCB = "color_ycrcb"

    @property
    def is_color(self) -> bool:
        return self in (SpectralMode.COLOR_BGR, SpectralMode.COLOR_YCRCB)

    @property
    def is_hyperspectral(self) -> bool:
        return self in (SpectralMode.HYPERSPECTRAL, SpectralMode.HYPERSPECTRAL_PCA)


def _default_spectral_mode(num_channels: int) -> SpectralMode:
    if num_channels == 3:
        return SpectralMode.COLOR_BGR
    if num_channels > 3:
        return SpectralMode.HYPERSPECTRAL
    return SpectralMode.NONE


class ImageDataReport:
    """Image statistics (``src/image/image_data.h:87-107``)."""

    def __init__(self, image: "ImageData"):
        arr = np.asarray(image.hidden_array)
        self.image_size = image.size  # (width, height)
        self.num_channels = arr.shape[0]
        neg = arr < 0.0
        over = arr > 1.0
        self.num_negative_pixels = int(neg.sum())
        self.num_over_one_pixels = int(over.sum())
        neg_per_channel = neg.reshape(arr.shape[0], -1).sum(axis=1)
        over_per_channel = over.reshape(arr.shape[0], -1).sum(axis=1)
        self.channel_with_most_negative_pixels = int(neg_per_channel.argmax())
        self.max_num_negative_pixels_in_one_channel = int(neg_per_channel.max())
        self.channel_with_most_over_one_pixels = int(over_per_channel.argmax())
        self.max_num_over_one_pixels_in_one_channel = int(over_per_channel.max())
        # Reference initializes extremes to [1, 0] so they only tighten outward
        # (``image_data.cpp:581-583``).
        self.smallest_pixel_value = float(min(arr.min(), 1.0))
        self.largest_pixel_value = float(max(arr.max(), 0.0))

    def print(self) -> None:
        n = self.image_size[0] * self.image_size[1] * self.num_channels
        print(
            f"Image Statistics: {self.image_size[0]} x {self.image_size[1]} "
            f"x {self.num_channels} ({n} pixels)"
        )
        print(f"  Num negative pixels: {self.num_negative_pixels}")
        print(f"  Num over one pixels: {self.num_over_one_pixels}")
        print(f"  Minimum pixel value: {self.smallest_pixel_value}")
        print(f"  Maximum pixel value: {self.largest_pixel_value}")


class ImageData:
    """N-channel float image over a ``[C, H, W]`` array.

    Constructors accept ``[H, W]``, ``[H, W, C]`` (OpenCV layout) or
    ``[C, H, W]`` (pass ``channel_major=True``) arrays. ``normalize`` mirrors
    the reference's three ingest behaviors:

    - ``"auto"``  — checked range [0, 255], divide by 255 iff max > 1
      (default ctor, ``image_data.cpp:218-235``)
    - ``"always"``— NORMALIZE_IMAGE: divide by 255 iff max > 1
    - ``"never"`` — DO_NOT_NORMALIZE_IMAGE: values taken as-is
    """

    def __init__(
        self,
        array=None,
        normalize: str = "auto",
        channel_major: bool = False,
        spectral_mode: SpectralMode | None = None,
        _luminance_only: bool = False,
    ):
        self._luminance_only = _luminance_only
        if array is None:
            self._array = None
            self._mode = SpectralMode.NONE
            return
        if isinstance(array, ImageData):
            self._array = array.hidden_array
            self._mode = array.spectral_mode
            self._luminance_only = array._luminance_only
            return
        arr = jnp.asarray(array, dtype=_float_dtype())
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and not channel_major:
            arr = jnp.moveaxis(arr, -1, 0)
        elif arr.ndim != 3:
            raise ValueError(f"Expected 2D or 3D image array, got shape {arr.shape}")
        arr = _apply_normalization(arr, normalize)
        self._array = arr
        self._mode = spectral_mode or _default_spectral_mode(arr.shape[0])

    # ---------------------------------------------------------------- basics

    @property
    def array(self) -> jnp.ndarray:
        """Visible channels as ``[C, H, W]`` (luminance-only hides chroma)."""
        if self._array is None:
            raise ValueError("Image is empty.")
        if self._is_luminance_view():
            return self._array[:1]
        return self._array

    @property
    def hidden_array(self) -> jnp.ndarray:
        """All channels, including hidden chroma."""
        if self._array is None:
            raise ValueError("Image is empty.")
        return self._array

    @property
    def spectral_mode(self) -> SpectralMode:
        return self._mode

    def set_spectral_mode(self, mode: SpectralMode) -> None:
        self._mode = mode

    def _is_luminance_view(self) -> bool:
        return self._mode == SpectralMode.COLOR_YCRCB and self._luminance_only

    @property
    def num_channels(self) -> int:
        """Visible channel count; 1 for luminance-only YCrCb (``image_data.cpp:490-495``)."""
        if self._array is None:
            return 0
        return 1 if self._is_luminance_view() else self._array.shape[0]

    @property
    def total_num_channels(self) -> int:
        return 0 if self._array is None else self._array.shape[0]

    @property
    def size(self) -> tuple[int, int]:
        """(width, height), matching the reference's cv::Size convention."""
        if self._array is None:
            return (0, 0)
        return (self._array.shape[2], self._array.shape[1])

    @property
    def shape_hw(self) -> tuple[int, int]:
        if self._array is None:
            return (0, 0)
        return (self._array.shape[1], self._array.shape[2])

    @property
    def num_pixels(self) -> int:
        w, h = self.size
        return w * h

    def is_empty(self) -> bool:
        return self._array is None

    # -------------------------------------------------------------- channels

    def add_channel(self, channel, normalize: str = "always") -> None:
        """Append a ``[H, W]`` channel (``image_data.cpp:267-296``)."""
        ch = jnp.asarray(channel, dtype=_float_dtype())
        if ch.ndim != 2:
            raise ValueError("add_channel expects a single [H, W] band.")
        ch = _apply_normalization(ch[None], normalize)
        if self._array is None:
            self._array = ch
        else:
            if ch.shape[1:] != self._array.shape[1:]:
                raise ValueError(
                    f"Channel size {ch.shape[1:]} != image size {self._array.shape[1:]}"
                )
            self._array = jnp.concatenate([self._array, ch], axis=0)
        self._mode = _default_spectral_mode(self._array.shape[0])

    def channel(self, index: int) -> jnp.ndarray:
        if not 0 <= index < self.num_channels:
            raise IndexError("Channel index out of bounds.")
        return self.array[index]

    def pixel_value(self, channel: int, row: int, col: int) -> float:
        return float(self.channel(channel)[row, col])

    # ---------------------------------------------------------------- resize

    def resized(self, new_size, method: str = "nearest") -> "ImageData":
        """Return a resized copy. ``new_size`` is (width, height) or a scalar scale.

        All channels (including hidden chroma) resize together, mirroring
        ``image_data.cpp:310-364``.
        """
        if self._array is None:
            raise ValueError("Cannot resize an empty image.")
        if isinstance(new_size, (int, float)):
            if new_size <= 0:
                raise ValueError("Scale factor must be positive.")
            w, h = self.size
            new_size = (int(w * new_size), int(h * new_size))
        w, h = int(new_size[0]), int(new_size[1])
        if w <= 0 or h <= 0:
            raise ValueError("Images must have a positive size.")
        out = _resize(self._array, (h, w), method=method)
        return self._with_array(out)

    # ----------------------------------------------------------------- color

    def change_color_space(
        self, new_mode: SpectralMode, luminance_only: bool = False
    ) -> "ImageData":
        """BGR <-> YCrCb conversion (``image_data.cpp:366-425``). Returns a copy."""
        if not self._mode.is_color:
            raise ValueError("Cannot convert a non-color image to another color space.")
        if not new_mode.is_color:
            raise ValueError("new_mode must be a color mode.")
        if new_mode == self._mode:
            return ImageData(self)
        arr = self._array
        if self._mode == SpectralMode.COLOR_BGR and new_mode == SpectralMode.COLOR_YCRCB:
            out = ImageData(
                bgr_to_ycrcb(arr), normalize="never", channel_major=True,
                spectral_mode=new_mode, _luminance_only=luminance_only,
            )
            return out
        if self._mode == SpectralMode.COLOR_YCRCB and new_mode == SpectralMode.COLOR_BGR:
            if self._luminance_only:
                arr = _interpolate_color(arr, arr[0].shape)
            return ImageData(
                ycrcb_to_bgr(arr), normalize="never", channel_major=True,
                spectral_mode=new_mode,
            )
        raise ValueError(f"Unsupported color conversion {self._mode} -> {new_mode}.")

    def interpolate_color_from(self, color_image: "ImageData") -> "ImageData":
        """Adopt interpolated chroma from ``color_image`` (``image_data.cpp:453-463``).

        ``self`` must expose a single (luminance) channel; the two color
        channels of ``color_image`` are bilinearly resized to this image's
        size. Returns a new 3-channel image in ``color_image``'s color space.
        """
        if self.num_channels != 1:
            raise ValueError("Color can only be interpolated into single-channel images.")
        if color_image.total_num_channels != 3:
            raise ValueError("The color image must have 3 channels.")
        lum = self.array[0]
        chroma = _interpolate_color(color_image.hidden_array, lum.shape)[1:]
        arr = jnp.concatenate([lum[None], chroma], axis=0)
        return ImageData(
            arr, normalize="never", channel_major=True,
            spectral_mode=color_image.spectral_mode,
        )

    # ------------------------------------------------------------ arithmetic

    def _with_array(self, arr) -> "ImageData":
        out = ImageData()
        out._array = arr
        out._mode = self._mode
        out._luminance_only = self._luminance_only
        return out

    def __mul__(self, scalar: float) -> "ImageData":
        return self._with_array(self.hidden_array * scalar)

    def __truediv__(self, scalar: float) -> "ImageData":
        return self._with_array(self.hidden_array * (1.0 / scalar))

    def __add__(self, other: "ImageData") -> "ImageData":
        if other.hidden_array.shape != self.hidden_array.shape:
            raise ValueError("Images must have identical shapes to be added.")
        return self._with_array(self.hidden_array + other.hidden_array)

    # --------------------------------------------------------- visualization

    def visualization_image(self) -> np.ndarray:
        """uint8 HxW or HxWx3 (BGR) image for display/save (``image_data.cpp:539-574``)."""
        if self._array is None:
            raise ValueError("Image is empty.")
        arr = self._array
        n = arr.shape[0]
        if n < 3:
            mono = np.clip(np.asarray(arr[0]), 0.0, 1.0)
            return (mono * 255).astype(np.uint8)
        if self._mode == SpectralMode.COLOR_YCRCB:
            return self.change_color_space(SpectralMode.COLOR_BGR).visualization_image()
        bgr = jnp.stack([arr[0], arr[n // 2], arr[n - 1]])
        img = np.clip(np.asarray(jnp.moveaxis(bgr, 0, -1)), 0.0, 1.0)
        return (img * 255).astype(np.uint8)

    def report(self) -> ImageDataReport:
        return ImageDataReport(self)


def _float_dtype():
    import jax

    return jax.dtypes.canonicalize_dtype(jnp.float64)  # f64 under x64, else f32


def _apply_normalization(arr: jnp.ndarray, normalize: str) -> jnp.ndarray:
    if normalize not in ("auto", "always", "never"):
        raise ValueError(f"Unknown normalize mode {normalize!r}")
    if normalize == "never":
        return arr
    max_val = float(jnp.max(arr)) if arr.size else 0.0
    if normalize == "auto":
        min_val = float(jnp.min(arr)) if arr.size else 0.0
        if min_val < 0 or max_val > 255:
            raise ValueError(
                "Invalid pixel range: auto-normalization requires values in "
                "[0, 255]. Use normalize='never' for arbitrary values."
            )
    if max_val > 1.0:
        arr = arr / 255.0
    return arr


def _interpolate_color(channels: jnp.ndarray, target_hw) -> jnp.ndarray:
    """Bilinearly resize chroma channels 1..2 to the luminance size
    (``image_data.cpp:144-168``); channel 0 is returned untouched at target size
    position 0 only if it already matches."""
    th, tw = target_hw
    out = [None, None, None]
    for i in range(1, 3):
        ch = channels[i]
        if ch.shape != (th, tw):
            ch = _linear_resize(ch, (th, tw))
        out[i] = ch
    c0 = channels[0]
    if c0.shape != (th, tw):
        c0 = _linear_resize(c0, (th, tw))
    out[0] = c0
    return jnp.stack(out)
