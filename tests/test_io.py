"""npy loading (native + fallback) and checkpoint format tests."""
import numpy as np
import pytest

from dpmmsubclusters_tpu.io.npy import load_data


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("swap", [False, True])
def test_load_data_scrub_and_layout(tmp_path, rng, dtype, swap):
    shape = (1000, 8)
    a = (rng.normal(size=shape) * 10).astype(dtype)
    if np.issubdtype(dtype, np.floating):
        a[0, 0] = np.nan
    np.save(tmp_path / "d.npy", a)
    got = load_data(str(tmp_path / "d.npy"), swapdims=swap)
    want = np.nan_to_num(a.astype(np.float32), nan=0.0)
    if swap:
        want = want.T
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want)


def test_load_data_native_path(tmp_path, rng):
    """Large file exercises the native OpenMP loader when built."""
    a = rng.normal(size=(300_000, 8)).astype(np.float64)
    a[5, 3] = np.nan
    np.save(tmp_path / "big.npy", a)
    got = load_data(str(tmp_path / "big.npy"))
    want = np.nan_to_num(a.astype(np.float32), nan=0.0)
    np.testing.assert_allclose(got, want)


def test_native_build_is_atomic_under_concurrent_builders(tmp_path):
    """Processes that start together may all build the native loader; each
    build is renamed into place whole, so none loads a half-written file
    and no temporary file is left behind."""
    import ctypes
    import os
    import shutil
    import subprocess

    native = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    for name in ("build.sh", "fastload.cc"):
        shutil.copy(os.path.join(native, name), tmp_path)
    builders = [subprocess.Popen(["sh", str(tmp_path / "build.sh")],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE) for _ in range(4)]
    assert [b.wait(timeout=300) for b in builders] == [0] * 4
    assert sorted(os.listdir(tmp_path)) == [
        "build.sh", "fastload.cc", "libdpmmfastload.so"]
    lib = ctypes.CDLL(str(tmp_path / "libdpmmfastload.so"))
    assert hasattr(lib, "dpmm_convert")


def test_load_data_prefix_convention(tmp_path, rng):
    a = rng.normal(size=(50, 3)).astype(np.float32)
    np.save(tmp_path / "mydata.npy", a)
    got = load_data(str(tmp_path) + "/", prefix="mydata")
    np.testing.assert_allclose(got, a)
