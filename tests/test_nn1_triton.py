"""The off-path Triton nn1 kernel (scripts/nn1_triton.py) in interpret
mode: exact against brute_force_knn for each block and split shape, under
vmap, through its KNN wrapper with a pose, and +inf against an all-masked
target."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

import nn1_triton as nt  # noqa: E402
from sycl_points_tpu.ops.knn import brute_force_knn  # noqa: E402
from sycl_points_tpu.utils import lie  # noqa: E402


@pytest.mark.parametrize("bq,bt,split", [(8, 1024, 8), (16, 64, 1), (32, 128, 4), (8, 32, 8)])
def test_kernel_matches_brute_force(bq, bt, split):
    t, m, q = nt.small_problem()
    got = nt.nn1_triton(t, m, q, bq=bq, bt=bt, split=split, interpret=True)
    nt.check_same(got, brute_force_knn(t, m, q, 1))


def test_kernel_all_masked_is_inf():
    t, m, q = nt.small_problem()
    i, d = nt.nn1_triton(t, jnp.zeros_like(m), q, interpret=True)
    assert np.isinf(np.asarray(d)).all()
    assert (np.asarray(i) == 0).all()


def test_kernel_under_vmap():
    ts, ms, qs = zip(*(nt.small_problem(seed=s) for s in range(3)))
    f = jax.vmap(lambda t, m, q: nt.nn1_triton(t, m, q, bq=16, bt=64, split=4, interpret=True))
    i, d = f(jnp.stack(ts), jnp.stack(ms), jnp.stack(qs))
    for b in range(3):
        nt.check_same((i[b], d[b]), brute_force_knn(ts[b], ms[b], qs[b], 1))


def test_knn_wrapper_applies_pose(monkeypatch):
    kernel = nt.nn1_triton
    monkeypatch.setattr(nt, "nn1_triton", lambda *a, **k: kernel(*a, **k, interpret=True))
    t, m, q = nt.small_problem(seed=1)
    pose = lie.se3_exp(jnp.asarray([0.1, -0.2, 0.05, 1.0, 2.0, -0.5]))
    knn = nt.TritonNN1KNN(t, m, (16, 64, 4))
    got = jax.jit(lambda q, T: knn.search(q, 1, pose=T))(q, pose)
    ref = jax.jit(lambda q, T: brute_force_knn(t, m, q, 1, pose=T))(q, pose)
    nt.check_same((got.indices[:, 0], got.distances[:, 0]), ref)
