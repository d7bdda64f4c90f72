"""What runs where: dispatch without a device, the compile cache's place,
and the entry points that must refuse instead of falling back.

No choice in the library depends on the device: ``autocov_method="auto"``
is the batched FFT and ``fold_impl="auto"`` the fold sort measured fastest
on the GPU (PERF.md "H100 bring-up"), for every input dtype.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmcdiagnostictools_jl_tpu as mdt
from mcmcdiagnostictools_jl_tpu.diagnostics.ess_rhat import (
    _method_name,
    _resolve_fold_merge,
)
from mcmcdiagnostictools_jl_tpu.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fold-sort implementation that won on the H100 (PERF.md)
FOLD_WINNER = "merge"
DTYPES = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}


def _sample(dtype, shape=(400, 4, 3)):
    x = np.random.default_rng(3).standard_normal(shape)
    return jnp.asarray(x).astype(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_auto_autocov_is_fft(dtype):
    """The rFFT takes f32/f64; bf16 enters through the fast rank transform,
    whose normal scores are f32."""
    assert _method_name("auto") == "fft"
    x = _sample(DTYPES[dtype])
    kw = {"rank_mode": "fast"} if dtype == "bf16" else {}
    a = mdt.ess_rhat(x, kind="rank", **kw)
    b = mdt.ess_rhat(x, kind="rank", autocov_method=mdt.FFTAutocovMethod(),
                     **kw)
    np.testing.assert_array_equal(np.asarray(a.ess), np.asarray(b.ess))
    np.testing.assert_array_equal(np.asarray(a.rhat), np.asarray(b.rhat))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_auto_fold_is_measured_winner(dtype):
    """(bf16 never reaches the fold sort: the exact transform's ndtri takes
    f32/f64 only, and fast mode does not sort.)"""
    assert _resolve_fold_merge("auto") == _resolve_fold_merge(FOLD_WINNER)
    x = _sample(DTYPES[dtype])
    a = mdt.rhat(x, kind="tail")
    b = mdt.rhat(x, kind="tail", fold_impl=FOLD_WINNER)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unknown_fold_impl_raises():
    with pytest.raises(ValueError, match="fold_impl"):
        _resolve_fold_merge("valley")


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


@pytest.mark.usefixtures("restore_cache_config")
class TestCompileCache:
    def test_env_dir_is_used_and_nothing_else_set(self, monkeypatch,
                                                  tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert profiling.enable_compilation_cache() == str(tmp_path)
        assert profiling.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_dir_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        first = profiling.enable_compilation_cache()
        second = profiling.enable_compilation_cache()
        assert first == second == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first

    def test_default_dir_is_git_ignored(self):
        with open(os.path.join(ROOT, ".gitignore")) as fh:
            assert ".jax_cache/" in fh.read().split()


def _run_smoke(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--multi"]], ids=["one", "multi"])
def test_chip_smoke_refuses_without_gpu(args):
    proc = _run_smoke(args, ROOT)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke([], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.usefixtures("restore_cache_config")
def test_bench_propagates_failure(monkeypatch, capsys):
    """A failing run raises; the workload is never shrunk to succeed."""
    import bench

    monkeypatch.setattr(bench, "DRAWS", 100)
    monkeypatch.setattr(bench, "CHAINS", 4)
    params = bench.PARAMS
    calls = []

    def failing(x, **kw):
        calls.append(x.shape)
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    monkeypatch.setattr(mdt, "ess_rhat", failing)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        bench.main()
    assert calls == [(100, 4, params)]
    out = capsys.readouterr().out
    assert "device:" in out and '"metric"' not in out


def test_bench_describes_cpu_device():
    import bench

    info = bench.describe_device()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    json.dumps(info)


def test_dryrun_multichip_refuses_missing_devices():
    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="need 64 devices"):
        dryrun_multichip(64)


@pytest.mark.gpu
def test_fast_mode_exact_on_ties_on_gpu():
    """The precision detector of chip_smoke.py phase 3 at a test size: on
    integer-valued f32 draws the fast mode equals exact mode on the card."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda -m gpu")
    x = jax.random.poisson(jax.random.key(1), 3.0, (4000, 64, 32))
    x = x.astype(jnp.float32)
    a = mdt.ess_rhat(x, kind="rank")
    b = mdt.ess_rhat(x, kind="rank", rank_mode="fast")
    np.testing.assert_allclose(np.asarray(b.ess), np.asarray(a.ess),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(b.rhat), np.asarray(a.rhat),
                               rtol=1e-5)
