"""Test configuration: CPU backend, float64 parity mode, 8 virtual devices.

The suite runs on the CPU (``JAX_PLATFORMS=cpu`` unless the run names a
platform): pytest-xdist starts several workers, and on a GPU machine each
one would otherwise reserve most of the card and the second would fail.
Tests marked ``gpu`` run with ``JAX_PLATFORMS=cuda`` (README "Tests").
Float64 is the parity mode used to validate against the reference semantics
(BASELINE.md: ESS/R-hat/MCSE within 1e-6 of reference float64).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

# Persistent XLA executable cache (utils/profiling.enable_compilation_cache:
# JAX_COMPILATION_CACHE_DIR, else the checkout's .jax_cache): after one
# priming run the suite skips most compiles.
from mcmcdiagnostictools_jl_tpu.utils.profiling import enable_compilation_cache

enable_compilation_cache(min_compile_time_secs=0.05)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def ar1(rng, phi, sigma, size):
    """AR(1) chains fixture mirroring the reference test helper
    (test/helpers.jl:4-12): x_t = phi * x_{t-1} + sigma * eps_t."""
    noise = rng.standard_normal(size)
    out = np.empty(size)
    out[0] = noise[0]
    for t in range(1, size[0]):
        out[t] = phi * out[t - 1] + sigma * noise[t]
    return out
