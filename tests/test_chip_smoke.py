"""The bring-up script's refusal off the GPU, the device peak table and the
compile-cache location -- the parts of the GPU tooling a CPU run can check.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from hashjoin3d_tpu.utils.measure import HBM_PEAK_GBS, hbm_peak_gbs
from hashjoin3d_tpu.utils.misc import CHECKOUT_CACHE_DIR, compile_cache_dir

REPO = Path(__file__).resolve().parent.parent


def test_chip_smoke_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_hbm_peak_table():
    assert hbm_peak_gbs("NVIDIA H100 80GB HBM3") == 3350.0
    assert all(v > 0 for v in HBM_PEAK_GBS.values())
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        hbm_peak_gbs("cpu")


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, None),
    ({}, CHECKOUT_CACHE_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, CHECKOUT_CACHE_DIR),
])
def test_compile_cache_dir(env, want):
    """A set JAX_COMPILATION_CACHE_DIR is left to JAX; otherwise the cache
    is the fixed, git-ignored ``.jax_cache`` inside the checkout."""
    assert compile_cache_dir(env) == want
    assert CHECKOUT_CACHE_DIR == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
