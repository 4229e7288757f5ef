"""Exact 1-nearest-neighbour search (the ICP correspondence search) as a
Pallas kernel through Triton, and its measurement against XLA's
``brute_force_knn(k=1)``.

Off the package's path: nothing in ``sycl_points_tpu`` imports this file.
On an H100 the kernel beats XLA alone and inside ``align_pipeline`` on the
benchmark pair, but made the odometry frames slower (see PERF.md), so the
package keeps the XLA search.  This file keeps the kernel and the
measurement, so both can be re-run and the kernel picked up again.

The kernel: each program holds a block of ``bq`` queries in registers and
loops over power-of-two chunks of ``bt`` targets (coordinates split into
x/y/z rows, masked targets carried as a +inf bias), folding a running
(min, argmin) of the exact broadcast distance sum_k (q_k - t_k)^2.  The
targets are also split ``split`` ways across a second grid axis (split-M),
so that ~1,000 sampled queries still fill the card's 132 SMs; XLA takes
the min over the ``split`` partial results.  Ties go to the lowest target
index, as in ``brute_force_knn``.  ``tests/test_nn1_triton.py`` runs it in
interpret mode.

Usage (on the GPU):
  python scripts/nn1_triton.py           # sweep, then a,b,b,a timing alone
                                         # and inside align_pipeline
  python scripts/nn1_triton.py --check   # exactness check only
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import triton as plgpu  # noqa: E402

import bench  # noqa: E402
from sycl_points_tpu.ops.knn import KNNResult, brute_force_knn  # noqa: E402
from sycl_points_tpu.ops.transform import transform_points  # noqa: E402
from sycl_points_tpu.points.point_cloud import round_up  # noqa: E402

_IMAX = int(np.iinfo(np.int32).max)
# (bq, bt, split): a grid around the best points of the first sweep (bq
# 16-64, bt 128-512, split 1-32, best at bq 16, bt 512, split 8)
SWEEP = [(bq, bt, split) for bq in (8, 16) for bt in (512, 1024) for split in (8, 16)]


def _nn1_kernel(qx_ref, qy_ref, qz_ref, tx_ref, ty_ref, tz_ref, tw_ref,
                d_ref, i_ref, *, bt: int, n_chunks: int):
    qx = qx_ref[...][:, None]  # [bq, 1]
    qy = qy_ref[...][:, None]
    qz = qz_ref[...][:, None]
    bq = qx.shape[0]
    base = pl.program_id(1) * (n_chunks * bt)
    lane = jax.lax.broadcasted_iota(jnp.int32, (bq, bt), 1)

    def body(c, carry):
        best_d, best_i = carry
        sl = pl.ds(c * bt, bt)
        ex = qx - tx_ref[sl][None, :]
        ey = qy - ty_ref[sl][None, :]
        ez = qz - tz_ref[sl][None, :]
        d2 = ex * ex + ey * ey + ez * ez + tw_ref[sl][None, :]  # [bq, bt]
        cd = jnp.min(d2, axis=1)
        ci = jnp.min(jnp.where(d2 == cd[:, None], lane, _IMAX), axis=1) + (base + c * bt)
        take = cd < best_d
        return jnp.where(take, cd, best_d), jnp.where(take, ci, best_i)

    init = (jnp.full((bq,), jnp.inf, jnp.float32), jnp.zeros((bq,), jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, n_chunks, body, init)
    d_ref[...] = best_d
    i_ref[...] = best_i


@functools.partial(jax.jit, static_argnames=("bq", "bt", "split", "num_warps", "interpret"))
def nn1_triton(target_points, target_mask, query_points, *, bq=8, bt=1024, split=8,
               num_warps=4, interpret=False):
    """Exact nearest neighbour: (indices [Q] int32, squared distances [Q]);
    an all-masked target gives index 0 and distance inf."""
    Q, M = query_points.shape[0], target_points.shape[0]
    Qp, Mp = round_up(Q, bq), round_up(M, bt * split)
    q = jnp.zeros((3, Qp), jnp.float32).at[:, :Q].set(query_points.T)
    t = jnp.zeros((3, Mp), jnp.float32).at[:, :M].set(target_points.T)
    tw = jnp.full((Mp,), jnp.inf, jnp.float32).at[:M].set(
        jnp.where(target_mask, 0.0, jnp.inf))
    q_spec = pl.BlockSpec((bq,), lambda i, j: (i,))
    t_spec = pl.BlockSpec((Mp // split,), lambda i, j: (j,))
    o_spec = pl.BlockSpec((None, bq), lambda i, j: (j, i))
    d, idx = pl.pallas_call(
        functools.partial(_nn1_kernel, bt=bt, n_chunks=Mp // (bt * split)),
        grid=(Qp // bq, split),
        in_specs=[q_spec] * 3 + [t_spec] * 4,
        out_specs=[o_spec, o_spec],
        out_shape=[jax.ShapeDtypeStruct((split, Qp), jnp.float32),
                   jax.ShapeDtypeStruct((split, Qp), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=2),
        interpret=interpret,
        name="nn1_triton",
    )(q[0], q[1], q[2], t[0], t[1], t[2], tw)
    s = jnp.argmin(d, axis=0)  # the first split on ties: the lowest index
    cols = jnp.arange(Qp)
    return idx[s, cols][:Q], d[s, cols][:Q]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TritonNN1KNN:
    """``BruteForceKNN`` whose k=1 search is the kernel with block sizes
    ``cfg`` = (bq, bt, split)."""

    points: jax.Array
    mask: jax.Array
    cfg: tuple = dataclasses.field(default=(8, 1024, 8), metadata={"static": True})

    def search(self, query_points, k: int, pose: Optional[jax.Array] = None, chunk: int = 8192):
        if k != 1:
            return brute_force_knn(self.points, self.mask, query_points, k, pose, chunk)
        if pose is not None:
            query_points = transform_points(query_points, pose)
        bq, bt, split = self.cfg
        i, d = nn1_triton(self.points, self.mask, query_points, bq=bq, bt=bt, split=split)
        return KNNResult(i[:, None], d[:, None])


def check_same(got, ref: KNNResult, tag=""):
    """Same indices as ``brute_force_knn``, distances equal to float32
    rounding (the kernel sums the three squares in another order)."""
    i, d = got
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ref.indices[:, 0]), err_msg=tag)
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref.distances[:, 0]), rtol=1e-6,
                               err_msg=tag)


def small_problem(seed=0, m=700, q=100):
    rng = np.random.default_rng(seed)
    tgt = (rng.normal(size=(m, 3)) * 20).astype(np.float32)
    qry = (rng.normal(size=(q, 3)) * 20).astype(np.float32)
    mask = rng.uniform(size=m) > 0.2
    return jnp.asarray(tgt), jnp.asarray(mask), jnp.asarray(qry)


def abba(a, b, *args):
    """Median ms of ``a`` and ``b`` timed interleaved a, b, b, a."""
    a1, b1, b2, a2 = (bench.median_ms(f, *args) for f in (a, b, b, a))
    return f"xla {a1:.4f}/{a2:.4f} ms, kernel {b1:.4f}/{b2:.4f} ms"


def measure():
    from sycl_points_tpu.ops.knn import BruteForceKNN
    from sycl_points_tpu.registration.pipeline import align_pipeline

    src, tgt, cap, _, _ = bench.load_pair()
    pre = jax.jit(lambda c: bench.preprocess(c, cap))
    src_p, tgt_p = pre(src), pre(tgt)
    n_src = int(np.asarray(src_p.mask).sum())
    q_all = src_p.points[:n_src]
    q_smp = q_all[np.random.default_rng(0).choice(n_src, 1000, replace=False)]
    shapes = {f"Q={len(q)} M={t.capacity}": (t.points, t.mask, q)
              for q in (q_smp, q_all) for t in (tgt_p, tgt)}

    xla = jax.jit(lambda t, m, q: brute_force_knn(t, m, q, 1))
    for name, args in shapes.items():
        print(f"xla {name}: {bench.median_ms(xla, *args):.4f} ms", flush=True)
    for bq, bt, split in SWEEP:
        f = jax.jit(functools.partial(nn1_triton, bq=bq, bt=bt, split=split))
        for name, args in shapes.items():
            check_same(f(*args), xla(*args), f"{(bq, bt, split)} {name}")
            print(f"sweep bq={bq} bt={bt} split={split} {name}: "
                  f"{bench.median_ms(f, *args):.4f} ms", flush=True)

    kernel = jax.jit(nn1_triton)  # the defaults
    for name, args in shapes.items():
        print(f"ALONE {name} a,b,b,a: {abba(xla, kernel, *args)}", flush=True)
    key = jax.random.key(1234)

    def align_only(build):
        return jax.jit(lambda s, t: align_pipeline(
            s, t, build(t), bench.PIPELINE_PARAMS, key=key).result.T)

    def pair_step(build):
        return jax.jit(lambda s, t: align_pipeline(
            bench.preprocess(s, cap), bench.preprocess(t, cap), build(bench.preprocess(t, cap)),
            bench.PIPELINE_PARAMS, key=key).result.T)

    for tag, make, args in (("align_pipeline", align_only, (src_p, tgt_p)),
                            ("pair step", pair_step, (src, tgt))):
        fa = make(BruteForceKNN.build)
        fb = make(lambda c: TritonNN1KNN(c.points, c.mask))
        diff = np.abs(np.asarray(fa(*args)) - np.asarray(fb(*args))).max()
        print(f"E2E {tag} a,b,b,a: {abba(fa, fb, *args)}; pose diff {diff:.2e}", flush=True)


def main(argv=None) -> int:
    from sycl_points_tpu.utils.compile_cache import enable_persistent_cache
    from sycl_points_tpu.utils.device import card_line, require_gpu

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="exactness check only")
    args = ap.parse_args(argv)
    require_gpu()
    enable_persistent_cache()
    print(f"card {card_line()}", flush=True)
    t, m, q = small_problem()
    for bq, bt, split in SWEEP:
        check_same(nn1_triton(t, m, q, bq=bq, bt=bt, split=split), brute_force_knn(t, m, q, 1))
    print("nn1_triton exact against brute_force_knn", flush=True)
    if not args.check:
        measure()
    return 0


if __name__ == "__main__":
    sys.exit(main())
