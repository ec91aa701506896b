"""Extension-dispatched image I/O (equivalent of ``src/util/data_loader.{h,cpp}``).

Standard image extensions load through OpenCV; anything else is treated as an
HSI configuration file for the ENVI BSQ path (``data_loader.cpp:96-114``).
Directory loads are sorted by filename — the reference uses raw ``readdir``
order (``data_loader.cpp:75-94``, flagged in SURVEY.md §2 #28), which is
filesystem-dependent; sorting is the deterministic fix.
"""

from __future__ import annotations

import os

import numpy as np

# OpenCV is imported inside the functions that use it: the package, the
# solver and the CLI on ENVI input run without it.

from super_resolution_tpu.image.image_data import ImageData
from super_resolution_tpu.spectral.envi import HyperspectralDataLoader

__all__ = ["load_image", "load_images", "save_image"]

_IMAGE_EXTENSIONS = {
    ".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".gif", ".jp2", ".webp",
}


def load_image(file_path: str) -> ImageData:
    """Load a standard image (normalized to [0, 1]) or an ENVI config path."""
    ext = os.path.splitext(file_path)[1].lower()
    if ext in _IMAGE_EXTENSIONS:
        import cv2

        image = cv2.imread(file_path, cv2.IMREAD_UNCHANGED)
        if image is None:
            raise FileNotFoundError(f"Could not read image {file_path}")
        return ImageData(image.astype(np.float64))
    loader = HyperspectralDataLoader(file_path)
    loader.load_image_from_envi_file()
    return loader.get_image()


def load_images(directory: str) -> list[ImageData]:
    """Load all images in a directory, sorted by filename."""
    if not os.path.isdir(directory):
        raise NotADirectoryError(directory)
    names = sorted(
        f for f in os.listdir(directory)
        if not f.startswith(".") and os.path.isfile(os.path.join(directory, f))
    )
    return [load_image(os.path.join(directory, f)) for f in names]


def save_image(image: ImageData, file_path: str) -> None:
    """1/3-channel images save as visualization images via imwrite; anything
    else exports as ENVI binary (``data_loader.cpp:116-130``)."""
    n = image.total_num_channels
    ext = os.path.splitext(file_path)[1].lower()
    if n in (1, 3) and ext in _IMAGE_EXTENSIONS:
        import cv2

        cv2.imwrite(file_path, image.visualization_image())
    else:
        HyperspectralDataLoader(file_path).save_image(image)
