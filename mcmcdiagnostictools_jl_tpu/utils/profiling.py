"""Profiling / tracing hooks and the persistent compilation cache (SURVEY.md
section 5: the aux subsystems the reference lacks).

- :func:`trace` — context manager around ``jax.profiler.trace`` writing a
  TensorBoard-compatible trace of the diagnostics kernels.
- :func:`annotate` — ``jax.named_scope`` pass-through so kernel families show
  up as named regions in profiles.

Example::

    from mcmcdiagnostictools_jl_tpu.utils.profiling import trace
    with trace("/tmp/mdt-trace"):
        mdt.ess_rhat(x)
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the block to ``log_dir`` (TensorBoard format)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope for kernel regions (shows up in XLA profiles)."""
    return jax.named_scope(name)


# Fixed cache location inside the checkout: the directory is part of the
# cache key, so it must not move between runs (listed in .gitignore).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache(min_compile_time_secs: float = 1.0) -> str:
    """Persist compiled executables to disk so process-cold calls skip XLA.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps the cache in that
    directory and no other is set here; otherwise the cache lives in
    ``DEFAULT_CACHE_DIR``. Returns the directory in use.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path
