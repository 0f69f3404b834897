"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device logic is tested without GPUs via JAX's standard
fake-multi-device mechanism (SURVEY.md section 4): 8 virtual CPU devices
stand in for the cards of a mesh.  The suite never needs an accelerator;
the config flag is set as well as the env var so a machine with a GPU
still runs the tests on the CPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound accumulated XLA-CPU compiler state across the suite.

    A rare LLVM-side segfault has been observed (twice) deep into full-suite
    runs, always during a pjit compile and never reproducible in isolation
    or in module subsets; dropping live compiled programs between modules
    keeps the CPU backend's state small at a modest recompile cost (each
    module overwhelmingly compiles its own shapes anyway).
    """
    yield
    jax.clear_caches()
