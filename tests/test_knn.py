"""Brute-force KNN vs scipy cKDTree oracle (mirrors the reference
tests/test_kdtree.cpp CompareWithBruteForce strategy)."""

import numpy as np
import pytest
from scipy.spatial import cKDTree

import jax.numpy as jnp

from sycl_points_tpu.ops.knn import BruteForceKNN, brute_force_knn
from sycl_points_tpu.utils import lie

RNG = np.random.default_rng(5)


def random_cloud(n, scale=10.0):
    return (RNG.normal(size=(n, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("m,q,k", [(1000, 100, 1), (1000, 100, 10), (257, 33, 5), (5000, 1000, 20)])
def test_matches_ckdtree(m, q, k):
    tgt = random_cloud(m)
    qry = random_cloud(q)
    res = brute_force_knn(
        jnp.asarray(tgt), jnp.ones(m, bool), jnp.asarray(qry), k, chunk=256
    )
    d_ref, i_ref = cKDTree(tgt).query(qry, k=k)
    d_ref = d_ref.reshape(q, k)
    i_ref = i_ref.reshape(q, k)
    np.testing.assert_allclose(np.asarray(res.distances), d_ref**2, rtol=1e-3, atol=1e-3)
    # indices may differ on exact ties; compare distances per slot instead
    got_d = np.linalg.norm(tgt[np.asarray(res.indices)] - qry[:, None], axis=-1)
    np.testing.assert_allclose(got_d, d_ref, rtol=1e-3, atol=1e-3)


def test_masked_targets_excluded():
    tgt = random_cloud(100)
    mask = np.ones(100, bool)
    mask[::2] = False
    qry = tgt[::2]  # queries at masked positions
    res = brute_force_knn(jnp.asarray(tgt), jnp.asarray(mask), jnp.asarray(qry), 1)
    assert np.all(mask[np.asarray(res.indices[:, 0])])


def test_pose_folding():
    tgt = random_cloud(500)
    src = random_cloud(200)
    T = np.asarray(lie.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 1.0, -2.0, 0.5], dtype=np.float32)))
    tree = BruteForceKNN(jnp.asarray(tgt), jnp.ones(500, bool))
    res = tree.search(jnp.asarray(src), 1, pose=jnp.asarray(T))
    moved = src @ T[:3, :3].T + T[:3, 3]
    d_ref, i_ref = cKDTree(tgt).query(moved, k=1)
    np.testing.assert_array_equal(np.asarray(res.indices[:, 0]), i_ref)
    np.testing.assert_allclose(np.asarray(res.distances[:, 0]), d_ref**2, rtol=1e-3, atol=1e-4)


def test_radius_search():
    tgt = random_cloud(1000, scale=1.0)
    qry = random_cloud(50, scale=1.0)
    tree = BruteForceKNN(jnp.asarray(tgt), jnp.ones(1000, bool))
    r = 0.5
    res = tree.radius_search(jnp.asarray(qry), r, max_k=20)
    kd = cKDTree(tgt)
    for i, lst in enumerate(kd.query_ball_point(qry, r)):
        got = set(int(x) for x in np.asarray(res.indices[i]) if x >= 0)
        ref = set(lst)
        if len(ref) <= 20:
            assert got == ref
        else:
            assert got.issubset(ref) and len(got) == 20


def test_approx_knn_matches_exact_on_cpu():
    # approx_max_k lowers to an exact top_k on CPU (and GPU), so the
    # approximate path must agree with brute force exactly here.
    from sycl_points_tpu.ops.knn import approx_knn

    rng = np.random.default_rng(11)
    pts = jnp.asarray(rng.uniform(-10, 10, size=(700, 3)).astype(np.float32))
    mask = jnp.asarray(rng.random(700) < 0.9)
    q = jnp.asarray(rng.uniform(-10, 10, size=(300, 3)).astype(np.float32))
    exact = brute_force_knn(pts, mask, q, 5)
    approx = approx_knn(pts, mask, q, 5)
    np.testing.assert_allclose(
        np.sort(np.asarray(approx.distances), axis=1),
        np.sort(np.asarray(exact.distances), axis=1),
        rtol=1e-4, atol=1e-4,
    )
    # Indices may differ on exact distance ties; verify the reported index
    # actually yields the reported distance instead.
    gathered = np.sum(
        (np.asarray(q)[:, None, :] - np.asarray(pts)[np.asarray(approx.indices)]) ** 2,
        axis=-1,
    )
    np.testing.assert_allclose(gathered, np.asarray(approx.distances), rtol=1e-3, atol=1e-3)


def test_approx_knn_chunked_path():
    from sycl_points_tpu.ops.knn import approx_knn

    rng = np.random.default_rng(12)
    pts = jnp.asarray(rng.uniform(-10, 10, size=(2000, 3)).astype(np.float32))
    mask = jnp.ones(2000, bool)
    q = jnp.asarray(rng.uniform(-10, 10, size=(100, 3)).astype(np.float32))
    exact = brute_force_knn(pts, mask, q, 4)
    approx = approx_knn(pts, mask, q, 4, chunk=512)
    # approx path builds -d2 as 2*q.t - |q|^2 - |t|^2 (mask folded into tt);
    # association differs from the exact path's (|q|^2+|t|^2) - 2*q.t by a
    # few f32 ulps on 100 m^2-scale distances.
    np.testing.assert_allclose(
        np.sort(np.asarray(approx.distances), axis=1),
        np.sort(np.asarray(exact.distances), axis=1),
        rtol=5e-4, atol=1e-4,
    )


@pytest.mark.parametrize("k", [16, 20])
def test_approx_knn_high_k_equals_brute_force(k):
    """At k >= 16 (the robust-covariance tiers) approx_knn is one exact pass
    on CPU and GPU: the same neighbour distances as brute force."""
    from sycl_points_tpu.ops.knn import approx_knn

    rng = np.random.default_rng(k)
    pts = jnp.asarray(rng.uniform(-10, 10, size=(900, 3)).astype(np.float32))
    mask = jnp.asarray(rng.random(900) < 0.9)
    exact = brute_force_knn(pts, mask, pts, k)
    approx = approx_knn(pts, mask, pts, k, chunk=256)
    np.testing.assert_allclose(
        np.asarray(approx.distances), np.asarray(exact.distances), rtol=1e-6, atol=0
    )
    d_ref, _ = cKDTree(np.asarray(pts)[np.asarray(mask)]).query(np.asarray(pts), k=k)
    np.testing.assert_allclose(np.asarray(exact.distances), d_ref**2, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("case", ["flat", "chunked", "masked", "all_masked", "pose"])
def test_nn1_against_ckdtree(case):
    """The k=1 correspondence search (ICP hot loop): exact nearest neighbour
    and squared distance on the flat path (one chunk) and the chunked scan,
    with masked targets, with no valid target (distance inf), and with a
    pose folded into the queries."""
    rng = np.random.default_rng(29)
    tgt = rng.uniform(-10, 10, size=(1000, 3)).astype(np.float32)
    qry = rng.uniform(-10, 10, size=(300, 3)).astype(np.float32)
    mask = np.ones(1000, bool)
    chunk = 8192 if case == "flat" else 256
    pose = None
    if case == "masked":
        mask[::3] = False
    if case == "all_masked":
        mask[:] = False
    if case == "pose":
        pose = lie.se3_exp(jnp.asarray([0.1, -0.2, 0.3, 1.0, 2.0, -0.5], jnp.float32))
    res = BruteForceKNN(jnp.asarray(tgt), jnp.asarray(mask)).search(
        jnp.asarray(qry), 1, pose=pose, chunk=chunk
    )
    idx = np.asarray(res.indices[:, 0])
    d2 = np.asarray(res.distances[:, 0])
    if case == "all_masked":
        assert np.all(np.isinf(d2))
        return
    q = qry if pose is None else qry @ np.asarray(pose)[:3, :3].T + np.asarray(pose)[:3, 3]
    valid = np.nonzero(mask)[0]
    d_ref, i_ref = cKDTree(tgt[valid]).query(q)
    np.testing.assert_array_equal(idx, valid[i_ref])
    np.testing.assert_allclose(d2, d_ref**2, rtol=1e-5, atol=1e-6)
