"""Test configuration: force an 8-device virtual CPU mesh.

Tests exercise the real kernels (jit-compiled XLA paths) on CPU, with 8
virtual devices so the multi-chip sharding paths compile and run without a
GPU.  Benchmarks (bench.py, chip_smoke.py) run on the GPU; tests that need
one carry the ``gpu`` marker and skip here.

Pytest plugins may import jax before this file runs, so we use
``jax.config`` (effective until the backend is first used) as well as the
environment.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# run growth precompiles inline (see fused_submap._spawn_precompile):
# background-vs-main concurrent XLA:CPU compiles segfault on this host
os.environ["SYCL_POINTS_SYNC_PRECOMPILE"] = "1"


# Raise the main-thread stack growth cap: full-suite runs (300+ compiled
# programs in one process) intermittently segfault inside XLA:CPU's
# backend_compile_and_load on this 1-core host; LLVM compile recursion is a
# known deep-stack consumer and 8 MB is the distro default.
import resource

try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    _want = 512 << 20
    if _hard == resource.RLIM_INFINITY or _hard >= _want:
        resource.setrlimit(resource.RLIMIT_STACK, (_want, _hard))
    elif _soft < _hard:
        resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except (ValueError, OSError):
    pass

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

assert jax.default_backend() == "cpu", (
    "tests must run on the virtual CPU mesh, got " + jax.default_backend()
)

# Tests never use the persistent compilation cache, even where an app entry
# point they drive enables it: cached executables from an earlier run would
# mask compile failures, and the cache directory lives in the checkout.
jax.config.update("jax_enable_compilation_cache", False)


# Schedule the growth-ladder-heavy test files FIRST: their 30-60 s fused
# submap/registration compiles crash XLA:CPU (segfault inside
# backend_compile_and_load) when they run after ~250 tests of accumulated
# executables in one process — every observed full-suite crash involved
# ladder compiles (inline or in a background thread); every subset run with
# the ladder early passes.  Fresh-process big compiles are stable.
_COMPILE_HEAVY_FILES = (
    "test_round3_fixes.py",
    "test_round4_fixes.py",
    "test_pipelined_odometry.py",
    "test_pipelined_lio.py",
    "test_map_growth.py",
)


def pytest_collection_modifyitems(config, items):
    def rank(item):
        name = item.fspath.basename
        try:
            return _COMPILE_HEAVY_FILES.index(name)
        except ValueError:
            return len(_COMPILE_HEAVY_FILES)

    items.sort(key=rank)


@pytest.fixture
def gpu_card():
    """Skips the test unless an NVIDIA GPU is visible.  Decided here, when
    the test runs, and by ``nvidia-smi`` (this process's JAX is held to the
    CPU), never while a module is imported."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (no nvidia-smi)")
    if subprocess.run(["nvidia-smi", "-L"], capture_output=True).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi finds none)")
