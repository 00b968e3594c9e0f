"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Multi-chip sharding tests run on a fake 8-device CPU mesh (SURVEY.md §4),
and f64 gives parity with the reference Julia tolerances sqrt(eps(Float64))
(`/root/reference/src/basic_tralcnlss.jl:181-182`).  Env vars must be set
before jax initializes, hence this module-level block.
"""
import os

# Force-set: a machine with a GPU would otherwise run the suite there.
# BENLSIP_GPU_TESTS=1 leaves the platform alone, for the @pytest.mark.gpu
# tests on the card: `BENLSIP_GPU_TESTS=1 python -m pytest tests/ -m gpu`.
_WANT_GPU = os.environ.get("BENLSIP_GPU_TESTS", "") == "1"
if not _WANT_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _WANT_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache stays OFF in tests: a test importing a bench
# module that enables it (bench_scaling.py used to, at module level) makes
# jax serialize every compiled CPU executable — measured to segfault the
# full-suite run inside executable.serialize().  Tests never benefit from
# the cache (fresh programs each session); pin it disabled.
jax.config.update("jax_compilation_cache_dir", None)

# Loop strategy: SolverOptions.unroll_limit defaults to 0 (while_loops),
# which is also what tests want — masked-unrolled inner loops triple CPU
# compile times without exercising anything the while_loop strategy
# doesn't.  tests/test_loops.py covers strategy parity explicitly.


import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The full suite (~200 tests, hundreds of distinct jitted programs on the
    8-virtual-device CPU backend) accumulates enough native executable
    state in one process that XLA:CPU eventually SEGFAULTS inside
    backend_compile (reproduced twice at ~85% of the suite; any half of
    the suite alone is green).  Cross-module cache reuse is ~nil — each
    module compiles its own shapes — so dropping the caches costs seconds
    and keeps the single-process `pytest tests/` invocation stable.
    """
    yield
    import jax

    jax.clear_caches()
