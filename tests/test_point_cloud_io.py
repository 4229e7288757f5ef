"""PointCloud container + PLY/PCD round-trip tests (mirrors the reference
tests/test_file_io.cpp round-trip strategy)."""

import numpy as np
import pytest

import jax.numpy as jnp

from sycl_points_tpu.points import io
from sycl_points_tpu.points.point_cloud import PointCloud, compact_device, filter_by_mask

RNG = np.random.default_rng(11)


def make_cloud_dict(n=100):
    return {
        "points": RNG.normal(size=(n, 3)).astype(np.float32) * 10.0,
        "rgb": RNG.uniform(size=(n, 4)).astype(np.float32),
        "intensities": RNG.uniform(size=(n,)).astype(np.float32) * 100.0,
        "normals": (lambda v: v / np.linalg.norm(v, axis=1, keepdims=True))(
            RNG.normal(size=(n, 3))
        ).astype(np.float32),
    }


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("ext", ["ply", "pcd"])
def test_roundtrip(tmp_path, binary, ext):
    cloud = make_cloud_dict()
    path = str(tmp_path / f"cloud.{ext}")
    io.write_file(path, cloud, binary=binary)
    back = io.read_file(path)
    np.testing.assert_allclose(back["points"], cloud["points"], atol=1e-4)
    np.testing.assert_allclose(back["intensities"], cloud["intensities"], atol=1e-3)
    np.testing.assert_allclose(back["normals"], cloud["normals"], atol=1e-4)
    # rgb quantized to 8 bits
    np.testing.assert_allclose(back["rgb"][:, :3], cloud["rgb"][:, :3], atol=1.5 / 255)


def test_nonfinite_points_skipped(tmp_path):
    cloud = make_cloud_dict(10)
    cloud["points"][3] = np.nan
    cloud["points"][7, 0] = np.inf
    path = str(tmp_path / "c.ply")
    io.write_ply(path, cloud)
    back = io.read_ply(path)
    assert back["points"].shape[0] == 8


def write_scan_ply(path, n, seed):
    """A seeded LiDAR-like scan (unit rays x ranges 1-80 m, intensities) as
    binary PLY, the layout of the reference's bundled scan pair."""
    rng = np.random.default_rng(seed)
    rays = rng.normal(size=(n, 3))
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    pts = (rays * rng.uniform(1.0, 80.0, size=(n, 1))).astype(np.float32)
    io.write_ply(path, {
        "points": pts,
        "intensities": rng.uniform(0, 255, size=n).astype(np.float32),
    }, binary=True)
    return pts


def test_read_bundled_scan_pair(tmp_path):
    pts_s = write_scan_ply(str(tmp_path / "source.ply"), 69792, seed=1)
    write_scan_ply(str(tmp_path / "target.ply"), 65000, seed=2)
    src = io.read_file(str(tmp_path / "source.ply"))
    tgt = io.read_file(str(tmp_path / "target.ply"))
    assert src["points"].shape == (69792, 3)
    assert "intensities" in src
    assert tgt["points"].shape[0] > 60000
    np.testing.assert_array_equal(src["points"], pts_s)
    # sane LiDAR ranges
    r = np.linalg.norm(src["points"], axis=1)
    assert np.isfinite(src["points"]).all()
    assert r.max() < 200.0


def test_point_cloud_padding_and_count():
    d = make_cloud_dict(100)
    pc = PointCloud.from_numpy(d["points"], intensities=d["intensities"])
    assert pc.capacity >= 100
    assert pc.capacity % 256 == 0
    assert int(pc.count()) == 100
    out = pc.to_numpy()
    np.testing.assert_allclose(out["points"], d["points"])
    np.testing.assert_allclose(out["intensities"], d["intensities"])


def test_compact_device():
    d = make_cloud_dict(100)
    pc = PointCloud.from_numpy(d["points"])
    keep = jnp.asarray(np.arange(pc.capacity) % 2 == 0)
    filtered = filter_by_mask(pc, keep)
    compacted = compact_device(filtered)
    assert int(compacted.count()) == 50
    expected = d["points"][np.arange(100) % 2 == 0]
    np.testing.assert_allclose(compacted.to_numpy()["points"], expected)


def test_merge_with_timestamps_base_shift():
    # Reference semantics (PointCloudShared::merge_timestamp_offsets):
    # merged start = min(starts), offsets shift by each side's base delta.
    from sycl_points_tpu.points.point_cloud import PointCloud, merge_with_timestamps

    a = PointCloud.from_numpy(np.zeros((2, 3), np.float32), capacity=2).replace(
        timestamp_offsets=jnp.asarray([0.0, 10.0], jnp.float32)
    )
    b = PointCloud.from_numpy(np.ones((2, 3), np.float32), capacity=2).replace(
        timestamp_offsets=jnp.asarray([0.0, 5.0], jnp.float32)
    )
    m, start = merge_with_timestamps(a, b, a_start_ms=100.0, b_start_ms=95.0)
    assert float(start) == 95.0
    np.testing.assert_allclose(
        np.asarray(m.timestamp_offsets), [5.0, 15.0, 0.0, 5.0]
    )

    # One side without timestamps -> merged cloud has none (invalidated).
    b2 = PointCloud.from_numpy(np.ones((2, 3), np.float32), capacity=2)
    m2, start2 = merge_with_timestamps(a, b2, a_start_ms=100.0)
    assert m2.timestamp_offsets is None
    assert float(start2) == 100.0


def test_lzf_roundtrip_paths():
    """Both LZF stream paths: long literal runs (incompressible random
    bytes) and back-references (repetitive data), plus overlap copies."""
    from sycl_points_tpu.points.io import _lzf_compress, _lzf_decompress

    rng = np.random.default_rng(3)
    cases = [
        rng.integers(0, 256, size=5000, dtype=np.uint8).tobytes(),  # literals
        b"abcabcabcabc" * 400,                  # short-distance refs (overlap)
        (b"x" * 300 + b"pattern" * 100) * 5,    # long runs + repeats
        b"",                                    # empty stream
        b"a",                                   # below match length
    ]
    for raw in cases:
        comp = _lzf_compress(raw)
        assert _lzf_decompress(comp, len(raw)) == raw


def test_pcd_binary_compressed_roundtrip(tmp_path):
    """binary_compressed PCD (PCL LZF, SoA layout) round-trips through the
    writer/reader pair, including intensity."""
    from sycl_points_tpu.points import io

    rng = np.random.default_rng(7)
    cloud = {
        "points": rng.normal(size=(257, 3)).astype(np.float32),
        "intensities": rng.uniform(size=257).astype(np.float32),
    }
    p = str(tmp_path / "c.pcd")
    io.write_pcd(p, cloud, compressed=True)
    # header advertises the compressed mode
    head = open(p, "rb").read(400).decode("ascii", errors="replace")
    assert "DATA binary_compressed" in head
    back = io.read_pcd(p)
    np.testing.assert_allclose(back["points"], cloud["points"], rtol=1e-6)
    np.testing.assert_allclose(back["intensities"], cloud["intensities"], rtol=1e-6)
