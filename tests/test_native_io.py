"""Native C++ I/O runtime vs the numpy readers."""

import numpy as np
import pytest

from sycl_points_tpu.points import io, native_io
from sycl_points_tpu.points.conversion import read_kitti_bin

RNG = np.random.default_rng(23)


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native_io.ensure_built():
        pytest.skip("native library unavailable")


def test_native_ply_matches_numpy_reader(tmp_path):
    n = 5000
    p = str(tmp_path / "scan.ply")
    io.write_ply(p, {
        "points": (RNG.normal(size=(n, 3)) * 20.0).astype(np.float32),
        "intensities": RNG.uniform(0, 255, size=n).astype(np.float32),
    }, binary=True)
    a = native_io.read_ply(p)
    b = io.read_ply(p)
    np.testing.assert_allclose(a["points"], b["points"])
    np.testing.assert_allclose(a["intensities"], b["intensities"])


def test_native_ascii_ply(tmp_path):
    cloud = {
        "points": RNG.normal(size=(40, 3)).astype(np.float32),
        "intensities": RNG.uniform(size=40).astype(np.float32),
        "normals": RNG.normal(size=(40, 3)).astype(np.float32),
    }
    p = str(tmp_path / "a.ply")
    io.write_ply(p, cloud, binary=False)
    got = native_io.read_ply(p)
    np.testing.assert_allclose(got["points"], cloud["points"], atol=1e-5)
    np.testing.assert_allclose(got["normals"], cloud["normals"], atol=1e-5)


def test_native_kitti(tmp_path):
    raw = RNG.normal(size=(128, 4)).astype(np.float32)
    p = str(tmp_path / "0.bin")
    raw.tofile(p)
    got = native_io.read_kitti_bin(p)
    ref = read_kitti_bin(p)
    np.testing.assert_allclose(got["points"], ref["points"])
    np.testing.assert_allclose(got["intensities"], ref["intensities"])


def test_prefetch_loader(tmp_path):
    paths = []
    for i in range(5):
        raw = np.full((10, 4), float(i), np.float32)
        p = str(tmp_path / f"{i}.bin")
        raw.tofile(p)
        paths.append(p)
    with native_io.PrefetchLoader(paths, prefetch=3) as loader:
        scans = list(loader)
    assert len(scans) == 5
    for i, s in enumerate(scans):
        np.testing.assert_allclose(s["points"], float(i))


# -- native LZF codec (PCL binary_compressed payloads) -------------------------

def _lzf_test_data():
    rng = np.random.default_rng(7)
    runs = (rng.uniform(-10, 10, size=(4000, 4)).astype(np.float32) * 0).tobytes()
    noise = rng.integers(0, 256, size=5000, dtype=np.uint8).tobytes()
    structured = (np.arange(30000, dtype=np.float32) % 256).tobytes()
    return runs + noise + structured + runs[:1000]


def test_lzf_native_python_cross_compat():
    """Native and pure-Python codecs must be stream-compatible in every
    direction (both implement the public liblzf/PCL format)."""
    data = _lzf_test_data()
    c_nat = native_io.lzf_compress(data)
    c_py = io._lzf_compress_py(data)
    assert native_io.lzf_decompress(c_nat, len(data)) == data
    assert io._lzf_decompress_py(c_nat, len(data)) == data
    assert native_io.lzf_decompress(c_py, len(data)) == data
    assert io._lzf_decompress_py(c_py, len(data)) == data
    # both compress (the structured data is highly repetitive)
    assert len(c_nat) < len(data) // 2
    assert len(c_py) < len(data) // 2


def test_lzf_native_rejects_corrupt_stream():
    data = _lzf_test_data()
    c = native_io.lzf_compress(data)
    with pytest.raises(ValueError):
        native_io.lzf_decompress(c[: len(c) // 2], len(data))
    # back-reference before stream start
    bad = bytes([0x20 | 0x1f, 0xFF])  # len-2 ref at distance 8192, empty out
    with pytest.raises(ValueError):
        native_io.lzf_decompress(bad, 2)


def test_lzf_incompressible_roundtrip():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()
    c = native_io.lzf_compress(data)
    assert native_io.lzf_decompress(c, len(data)) == data
    assert len(c) <= len(data) + len(data) // 32 + 64  # worst-case bound


def test_pcd_binary_compressed_uses_native_codec(tmp_path):
    """End-to-end: compressed PCD write/read round trip through the
    dispatching codec (native when built, which this suite guarantees)."""
    cloud = {
        "points": RNG.normal(size=(500, 3)).astype(np.float32),
        "intensities": RNG.uniform(size=500).astype(np.float32),
    }
    path = str(tmp_path / "c.pcd")
    io.write_pcd(path, cloud, binary=True, compressed=True)
    out = io.read_pcd(path)
    np.testing.assert_allclose(out["points"], cloud["points"], rtol=1e-6)
    np.testing.assert_allclose(out["intensities"], cloud["intensities"],
                               rtol=1e-6)
