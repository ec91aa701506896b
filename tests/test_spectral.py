"""Spectral PCA, ENVI I/O, and wavelet tests, mirroring
``test/test_spectral_pca.cpp``, ``test/test_hyperspectral_data_loader.cpp``,
and ``test/test_wavelet_transform.cpp``."""

import os

import cv2
import numpy as np
import pytest

from super_resolution_tpu.spectral import (
    HyperspectralDataLoader,
    SpectralPCA,
    read_envi_header,
)
from super_resolution_tpu.utils.config_reader import ConfigurationFileReader
from super_resolution_tpu.utils.testing import matrices_equal
from super_resolution_tpu.wavelet import (
    inverse_wavelet_transform,
    wavelet_transform,
)

RECON_TOL = 1e-5


def test_pca_worked_example():
    """Known decomposition from the reference's published example
    (``test_spectral_pca.cpp:19-63``); component signs are canonical up to flip."""
    ch1 = np.array([1.85, 2.05, -0.95, -1.55, -2.55, 2.85, 1.95, 2.75, -2.75, -3.65])
    ch2 = np.array(
        [2.2175, 2.5425, -1.2075, -1.9575, -3.3825, 3.6425, 2.5925, 3.3175, -3.4825, -4.2825]
    )
    image = np.stack([ch1.reshape(10, 1), ch2.reshape(10, 1)])
    pca = SpectralPCA([image])
    projected = np.asarray(pca.project(np.asarray(image)))

    known1 = np.array(
        [2.88737, 3.266, -1.53633, -2.49680, -4.23402, 4.62459, 3.24237, 4.30858, -4.43722, -5.62453]
    )
    known2 = np.array(
        [0.0538, 0.00622, 0.01545, 0.01729, 0.12995, -0.05886, -0.10306, 0.06669, 0.03664, -0.16411]
    )
    for c, known in enumerate([known1, known2]):
        est = projected[c].reshape(-1)
        sign = np.sign(np.dot(est, known)) or 1.0
        assert matrices_equal(sign * est, known, RECON_TOL)

    # Round trip is exact.
    recon = np.asarray(pca.back_project(pca.project(np.asarray(image))))
    assert matrices_equal(recon, image, RECON_TOL)


def _correlated_hyperspectral(num_channels=300, hw=(25, 50), seed=33):
    rng = np.random.default_rng(seed)
    chans = []
    for i in range(num_channels):
        scalar = i / num_channels
        chans.append(rng.normal(0.5, 0.1, size=hw) * scalar)
    return np.stack(chans)


def test_pca_full_rank_round_trip():
    img = _correlated_hyperspectral()
    pca = SpectralPCA([img])
    recon = np.asarray(pca.back_project(pca.project(np.asarray(img))))
    assert matrices_equal(recon, img, RECON_TOL)


def test_pca_truncated_reconstruction():
    img = _correlated_hyperspectral()
    pca = SpectralPCA([img], num_pca_bands=250)
    assert pca.num_pca_bands == 250
    recon = np.asarray(pca.back_project(pca.project(np.asarray(img))))
    assert matrices_equal(recon, img, 0.05)


def test_pca_retained_variance():
    img = _correlated_hyperspectral()
    pca = SpectralPCA([img], retained_variance=0.999)
    assert pca.num_pca_bands < img.shape[0]
    recon = np.asarray(pca.back_project(pca.project(np.asarray(img))))
    assert matrices_equal(recon, img, 0.05)


def test_pca_image_data_wrappers():
    from super_resolution_tpu import SpectralMode

    img = _correlated_hyperspectral(num_channels=10, hw=(6, 6))
    pca = SpectralPCA([img], num_pca_bands=4)
    pca_img = pca.get_pca_image(img)
    assert pca_img.num_channels == 4
    assert pca_img.spectral_mode == SpectralMode.HYPERSPECTRAL_PCA
    recon = pca.reconstruct_image(pca_img)
    assert recon.num_channels == 10
    assert recon.spectral_mode == SpectralMode.HYPERSPECTRAL


def test_envi_header_parse(seeded_data_dir):
    """Golden header values (``test_hyperspectral_data_loader.cpp:35-49``)."""
    params = read_envi_header(f"{seeded_data_dir}/example_envi_header.hdr")
    assert params.interleave == "bsq"
    assert params.data_type == "float"
    assert params.big_endian is False
    assert params.header_offset == 0
    assert params.num_data_rows == 11620
    assert params.num_data_cols == 11620
    assert params.num_data_bands == 1506


def test_envi_crop_read(seeded_data_dir):
    """Value-encodes-coordinates goldens (``test_hyperspectral_data_loader.cpp:52-84``)."""
    loader = HyperspectralDataLoader(f"{seeded_data_dir}/test_hs_config.txt")
    loader.load_image_from_envi_file()
    image = loader.get_image()
    assert image.size == (3, 6)  # (width, height)
    assert image.num_channels == 5
    expected_ch0 = np.array(
        [
            [5.20, 5.21, 5.22],
            [5.30, 5.31, 5.32],
            [5.40, 5.41, 5.42],
            [5.50, 5.51, 5.52],
            [5.60, 5.61, 5.62],
            [5.70, 5.71, 5.72],
        ]
    )
    assert matrices_equal(np.asarray(image.channel(0)), expected_ch0, 1e-6)
    expected_ch4 = expected_ch0 + 4.0
    assert matrices_equal(np.asarray(image.channel(4)), expected_ch4, 1e-6)


def test_envi_save_load_round_trip(seeded_data_dir, tmp_path):
    """Save -> load round trip (``test_hyperspectral_data_loader.cpp:88-111``)."""
    loader = HyperspectralDataLoader(f"{seeded_data_dir}/test_hs_config.txt")
    loader.load_image_from_envi_file()
    original = loader.get_image()

    out_path = str(tmp_path / "hs_envi_out")
    writer = HyperspectralDataLoader(out_path)
    writer.save_image(original)
    assert os.path.exists(out_path + ".hdr")
    assert os.path.exists(out_path + ".config")

    reread = HyperspectralDataLoader(out_path + ".config")
    reread.load_image_from_envi_file()
    result = reread.get_image()
    assert matrices_equal(
        np.asarray(result.hidden_array), np.asarray(original.hidden_array), 1e-6
    )
    # The .hdr also parses back correctly.
    params = read_envi_header(out_path + ".hdr")
    assert (params.num_data_bands, params.num_data_rows, params.num_data_cols) == (
        5, 6, 3,
    )


def test_config_reader_basics(tmp_path):
    p = tmp_path / "cfg.txt"
    p.write_text("# comment\nkey1  value one\nkey2 42\n\n")
    reader = ConfigurationFileReader(" ")
    reader.read_file(str(p))
    assert reader.get_value("key1") == "value one"
    assert reader.get_value_as_int("key2") == 42
    assert reader.get_value("missing") is None
    with pytest.raises(KeyError):
        reader.get_value_or_die("missing")


def test_wavelet_round_trip_golden_values():
    img = np.array(
        [
            [1.0, 2.0, 3.0, 4.0],
            [5.0, 6.0, 7.0, 8.0],
            [9.0, 10.0, 11.0, 12.0],
            [13.0, 14.0, 15.0, 16.0],
        ]
    )
    coeffs = wavelet_transform(img)
    # LL of top-left block [[1,2],[5,6]] = 0.5*14 = 7.
    assert float(coeffs.ll[0, 0]) == 7.0
    assert float(coeffs.lh[0, 0]) == 0.5 * (1 - 2 + 5 - 6)
    assert float(coeffs.hl[0, 0]) == 0.5 * (1 + 2 - 5 - 6)
    assert float(coeffs.hh[0, 0]) == 0.5 * (1 - 2 - 5 + 6)
    recon = np.asarray(inverse_wavelet_transform(coeffs))
    assert matrices_equal(recon, img, 1e-12)


def test_wavelet_round_trip_real_image(test_data_dir):
    """DWT -> iDWT identity on dallas.jpg within 1/255
    (``test_wavelet_transform.cpp:18,36``)."""
    img = cv2.imread(f"{test_data_dir}/dallas.jpg", cv2.IMREAD_COLOR)
    arr = np.moveaxis(img.astype(np.float64) / 255.0, -1, 0)
    coeffs = wavelet_transform(arr)
    recon = np.asarray(inverse_wavelet_transform(coeffs))
    assert matrices_equal(recon, arr, 1.0 / 255.0)
    assert np.abs(recon - arr).max() < 1e-12  # actually exact


def test_wavelet_stitched_layout():
    rng = np.random.default_rng(44)
    img = rng.random((2, 8, 8))
    coeffs = wavelet_transform(img)
    stitched = np.asarray(coeffs.stitched())
    assert stitched.shape == (2, 8, 8)
    assert matrices_equal(stitched[:, :4, :4], np.asarray(coeffs.ll))
    assert matrices_equal(stitched[:, :4, 4:], np.asarray(coeffs.lh))
    assert matrices_equal(stitched[:, 4:, :4], np.asarray(coeffs.hl))
    assert matrices_equal(stitched[:, 4:, 4:], np.asarray(coeffs.hh))


def test_wavelet_odd_size_rejected():
    with pytest.raises(ValueError):
        wavelet_transform(np.zeros((3, 5, 4)))
