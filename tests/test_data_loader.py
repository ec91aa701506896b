"""Extension-dispatched data loader tests (``src/util/data_loader.cpp`` parity)."""

import os

import cv2
import numpy as np
import pytest

from super_resolution_tpu.utils.data_loader import load_image, load_images, save_image


def test_load_standard_image(seeded_data_dir):
    image = load_image(f"{seeded_data_dir}/fb.png")
    assert image.size == (28, 28)
    arr = np.asarray(image.array)
    assert 0.0 <= arr.min() and arr.max() <= 1.0


def test_load_envi_config(seeded_data_dir):
    image = load_image(f"{seeded_data_dir}/test_hs_config.txt")
    assert image.num_channels == 5
    assert image.size == (3, 6)


def test_load_images_sorted(tmp_path, seeded_data_dir):
    img = cv2.imread(f"{seeded_data_dir}/fb.png", cv2.IMREAD_GRAYSCALE)
    # Write out of order; expect sorted-by-name load order.
    for name in ["c.png", "a.png", "b.png"]:
        cv2.imwrite(str(tmp_path / name), img)
    (tmp_path / ".hidden.png").write_bytes(b"")  # skipped
    images = load_images(str(tmp_path))
    assert len(images) == 3


def test_load_missing_image():
    with pytest.raises(FileNotFoundError):
        load_image("/nonexistent/image.png")
    with pytest.raises(NotADirectoryError):
        load_images("/nonexistent_dir")


def test_save_image_dispatch(tmp_path, seeded_data_dir):
    image = load_image(f"{seeded_data_dir}/fb.png")
    png_path = str(tmp_path / "out.png")
    save_image(image, png_path)
    assert os.path.exists(png_path)
    # >3 channels dispatches to ENVI regardless of extension.
    hsi = load_image(f"{seeded_data_dir}/test_hs_config.txt")
    envi_path = str(tmp_path / "out_cube")
    save_image(hsi, envi_path)
    assert os.path.exists(envi_path + ".hdr")
    reread = load_image(envi_path + ".config")
    assert reread.num_channels == 5
