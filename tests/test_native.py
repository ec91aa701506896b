"""Native C++ ENVI loader tests: build, correctness vs numpy, integration."""

import numpy as np
import pytest

from super_resolution_tpu import native


@pytest.fixture(scope="module")
def lib():
    path = native.build_library()
    if path is None:
        pytest.skip("No C++ toolchain available.")
    assert native.native_available()
    return native.get_library()


def test_native_write_read_round_trip(lib, tmp_path):
    rng = np.random.default_rng(55)
    cube = rng.random((7, 9, 11)).astype(np.float32)
    path = str(tmp_path / "cube.bsq")
    native.write_bsq(path, cube)
    out = native.read_bsq(path, 7, 9, 11)
    np.testing.assert_array_equal(out, cube)


def test_native_cropped_read_matches_numpy(lib, tmp_path):
    rng = np.random.default_rng(56)
    cube = rng.random((10, 20, 15)).astype(np.float32)
    path = str(tmp_path / "cube.bsq")
    cube.tofile(path)
    out = native.read_bsq(path, 10, 20, 15, crop=((2, 8), (3, 17), (1, 14)))
    np.testing.assert_array_equal(out, cube[2:8, 3:17, 1:14])


def test_native_big_endian(lib, tmp_path):
    rng = np.random.default_rng(57)
    cube = rng.random((3, 4, 5)).astype(np.float32)
    path = str(tmp_path / "cube_be.bsq")
    native.write_bsq(path, cube, big_endian=True)
    raw = np.fromfile(path, dtype=">f4").reshape(3, 4, 5)
    np.testing.assert_array_equal(raw.astype(np.float32), cube)
    out = native.read_bsq(path, 3, 4, 5, big_endian=True)
    np.testing.assert_array_equal(out, cube)


def test_native_invalid_crop(lib, tmp_path):
    cube = np.zeros((2, 2, 2), dtype=np.float32)
    path = str(tmp_path / "cube2.bsq")
    cube.tofile(path)
    with pytest.raises(IOError):
        native.read_bsq(path, 2, 2, 2, crop=((0, 3), (0, 2), (0, 2)))


def test_native_reference_envi_file(lib, seeded_data_dir):
    """The native loader reads the reference's coordinate-encoded test cube."""
    out = native.read_bsq(
        f"{seeded_data_dir}/example_envi_data", 10, 9, 5, crop=((5, 10), (2, 8), (0, 3))
    )
    assert out.shape == (5, 6, 3)
    assert abs(float(out[0, 0, 0]) - 5.20) < 1e-6
    assert abs(float(out[4, 5, 2]) - 9.72) < 1e-6


def test_envi_loader_uses_native_when_available(lib, seeded_data_dir):
    from super_resolution_tpu.spectral import HyperspectralDataLoader

    loader = HyperspectralDataLoader(f"{seeded_data_dir}/test_hs_config.txt")
    loader.load_image_from_envi_file()
    image = loader.get_image()
    assert image.num_channels == 5
    assert abs(image.pixel_value(0, 0, 0) - 5.20) < 1e-6
