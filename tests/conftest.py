"""Test configuration: run on a virtual 8-device CPU mesh with float64.

The suite validates numerical parity against the float64 C++ reference, so we
force the CPU backend (deterministic, fast compiles) with 8 virtual devices
for multi-device sharding tests, and enable x64. Production code paths are
dtype-agnostic; the card runs float32 (chip_smoke.py, bench.py).

Tests that need the card carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them here; ``python chip_smoke.py`` runs them on the
card.
"""

import os

# Override (not setdefault) and also set the config knob: JAX may already be
# imported, and the suite must never open an accelerator.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import signal  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_TEST_DATA = "/root/reference/test_data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs the GPU; skips elsewhere (chip_smoke.py runs these on "
        "the card)",
    )
    # pytest-timeout is not installed in this environment; provide a minimal
    # SIGALRM-based implementation so @pytest.mark.timeout(N) is enforced
    # rather than a silent unknown-mark no-op.
    config.addinivalue_line(
        "markers",
        "timeout(seconds): fail the test if it runs longer than `seconds` "
        "(SIGALRM-based stand-in for the absent pytest-timeout plugin)",
    )


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    if marker is None or not hasattr(signal, "SIGALRM"):
        return (yield)
    seconds = int(marker.args[0])

    def _on_timeout(signum, frame):
        raise TimeoutError(f"test exceeded timeout mark of {seconds}s")

    old_handler = signal.signal(signal.SIGALRM, _on_timeout)
    signal.alarm(seconds)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old_handler)


@pytest.fixture(scope="session")
def test_data_dir():
    return REFERENCE_TEST_DATA


@pytest.fixture(scope="session")
def seeded_data_dir(tmp_path_factory):
    """Small fixtures generated from a seed, for tests whose assertions do
    not depend on a photograph's content:

    - ``fb.png``: a 28x28 grayscale image;
    - ``example_envi_data``: a 10-band, 9-row, 5-column float32 BSQ cube
      whose values encode their coordinates (band + row/10 + col/100), as
      the reference's test cube does;
    - ``test_hs_config.txt``: the reference's crop of that cube (rows 2-7,
      columns 0-2, bands 5-9; end indices exclusive);
    - ``example_envi_header.hdr``: an ENVI header with the reference test's
      golden values.
    """
    import cv2

    d = tmp_path_factory.mktemp("seeded_data")
    rng = np.random.default_rng(2024)
    yy, xx = np.mgrid[0:28, 0:28]
    img = 128 + 60 * np.sin(xx / 4.0) * np.cos(yy / 5.0) + rng.normal(0, 20, (28, 28))
    cv2.imwrite(str(d / "fb.png"), np.clip(img, 0, 255).astype(np.uint8))

    b, r, c = np.meshgrid(np.arange(10), np.arange(9), np.arange(5), indexing="ij")
    (b + r / 10.0 + c / 100.0).astype("<f4").tofile(str(d / "example_envi_data"))
    (d / "test_hs_config.txt").write_text(
        "file example_envi_data\n"
        "interleave bsq\n"
        "data_type float\n"
        "big_endian false\n"
        "header_offset 0\n"
        "num_data_rows 9\n"
        "num_data_cols 5\n"
        "num_data_bands 10\n"
        "start_row 2\n"
        "end_row 8\n"
        "start_col 0\n"
        "end_col 3\n"
        "start_band 5\n"
        "end_band 10\n"
    )
    (d / "example_envi_header.hdr").write_text(
        "ENVI\n"
        "samples = 11620\n"
        "lines   = 11620\n"
        "bands   = 1506\n"
        "header offset = 0\n"
        "file type = ENVI Standard\n"
        "data type = 4\n"
        "interleave = bsq\n"
        "byte order = 0\n"
    )
    return str(d)


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test where there is none. Decided
    here, at run time, never while modules are imported."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs the GPU (running on {devices[0].platform})")
    return devices[0]


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(0)
