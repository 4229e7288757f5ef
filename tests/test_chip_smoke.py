"""chip_smoke.py and the compile-cache policy, on the CPU.

Each smoke phase runs here at a tiny scan size and must meet the same
bounds it meets at full width on the GPU; main() itself refuses to run
without a GPU.  The full-width run is the ``gpu``-marked test."""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from sycl_points_tpu.utils import compile_cache  # noqa: E402

TINY = cs.Sizes(n_az=512, n_rings=32, frames=8, stream_frames=5,
                fleet_frames=4, queries=100, reps=1)


@pytest.fixture(scope="module")
def pair():
    return cs.make_pair(TINY)


@pytest.mark.parametrize(
    "phase", ["knn", "pair", "lo", "lio", "stream", "fleet", "sharded_align"]
)
def test_phase_runs_tiny_on_cpu(phase, pair):
    if phase in ("knn", "pair"):
        getattr(cs, f"phase_{phase}")(TINY, pair)
    elif phase == "fleet":
        cs.phase_fleet(TINY, 4)
    elif phase == "sharded_align":
        cs.phase_sharded_align(TINY, pair, 4)
    else:
        getattr(cs, f"phase_{phase}")(TINY)


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_cache_honours_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_persistent_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
