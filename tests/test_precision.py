"""Every floating-point matmul carries an explicit full precision.

On a GPU, XLA may compute an f32 ``dot_general`` without a ``precision``
in TF32 (a 10-bit mantissa): prefix counts, CDF rows and leaf values would
silently lose digits. The CPU never shows it numerically, so these tests
read the traced programs instead: every ``dot_general`` whose operands are
not both bf16 (exact 0/1 one-hots accumulated in f32) must ask for
``Precision.HIGHEST``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmcdiagnostictools_jl_tpu.diagnostics import batch, discretediag, gelmandiag
from mcmcdiagnostictools_jl_tpu.diagnostics.ess_rhat import _ess_rhat_pipeline
from mcmcdiagnostictools_jl_tpu.models import gbt, hmc
from mcmcdiagnostictools_jl_tpu.ops import fastrank, seghist

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_eqns(jaxpr):
    """All ``dot_general`` equations of ``jaxpr``, nested programs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                if hasattr(sub, "consts") and hasattr(sub, "jaxpr"):
                    yield from _dot_eqns(sub.jaxpr)  # ClosedJaxpr
                elif hasattr(sub, "eqns"):
                    yield from _dot_eqns(sub)  # Jaxpr


def _unpinned(fn, *args):
    """(number of dots, dots that need a pin and lack HIGHEST)."""
    dots = list(_dot_eqns(jax.make_jaxpr(fn)(*args).jaxpr))
    bad = []
    for eqn in dots:
        dtypes = {v.aval.dtype for v in eqn.invars}
        if dtypes == {jnp.dtype(jnp.bfloat16)}:
            continue
        precision = eqn.params["precision"]
        if precision is None or any(p != HIGHEST for p in precision):
            bad.append((dtypes, precision))
    return len(dots), bad


def _f32(*shape, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).standard_normal(shape), jnp.float32
    )


def _seghist():
    vals = _f32(64, 3)
    seg = jnp.asarray(np.random.default_rng(1).integers(0, 4, (64, 3)),
                      jnp.int32)
    valid = jnp.ones((64, 3), bool)
    return (lambda v, s, ok: seghist.weighted_segment_moments(
        v, s, ok, nseg=4, tile=16)), (vals, seg, valid)


def _window_mcse():
    flat = _f32(60, 3)
    return (lambda f: batch._window_mcse_mean(
        f, np.array([0, 30]), np.array([20, 60]), maxlag=10)), (flat,)


def _gelman():
    return (lambda p: gelmandiag._gelman_core(p, 0.05)), (_f32(50, 3, 4),)


def _discretediag_mc():
    b, m = 2, 3
    cdf = jnp.tile(jnp.asarray([0.3, 0.7, 1.0], jnp.float32), (b, 1))
    trans = jnp.tile(cdf[:, None, :], (1, m, 1))
    zero_row = jnp.zeros((b, m), bool)
    m_true = jnp.full((b,), m, jnp.int32)
    phia = jnp.full((b,), 0.5, jnp.float32)

    def run(key):
        return discretediag._boot_chunk(
            key, phia, cdf, trans, zero_row, m_true, n=8, d=2, m=m, S=4,
            kind="mc", stat_kind="hang")

    return run, (jax.random.key(0),)


def _gbt_bigk():
    binned = jnp.asarray(np.random.default_rng(2).integers(0, 8, (40, 2)),
                         jnp.int32)
    y = jnp.asarray(np.arange(40) % 6, jnp.int32)

    def run(b, labels):
        return gbt._fit_gbt_bigk(
            b, labels, num_classes=6, n_rounds=2, learning_rate=0.1,
            max_depth=2, n_bins=8, reg_lambda=1.0, min_child_weight=1.0,
            class_chunk=4)

    return run, (binned, y)


def _gbt_predict_bigk():
    binned = jnp.zeros((10, 2), jnp.int32)
    sf = jnp.zeros((2, 3), jnp.int32)
    sb = jnp.zeros((2, 3), jnp.int32)
    lv = _f32(2, 4, 6)
    y = jnp.zeros((10,), jnp.int32)
    return (lambda *a: gbt._predict_stats_bigk(*a, 2, 4)), (
        binned, sf, sb, lv, y)


def _gbt_dense():
    binned = jnp.asarray(np.random.default_rng(3).integers(0, 8, (40, 2)),
                         jnp.int32)
    y = jnp.asarray(np.arange(40) % 3, jnp.int32)

    def run(b, labels):
        return gbt._fit_gbt(
            b, labels, num_classes=3, n_rounds=2, learning_rate=0.1,
            max_depth=2, n_bins=8, reg_lambda=1.0, min_child_weight=1.0)

    return run, (binned, y)


def _hmc():
    def run(key):
        return hmc.hmc_sample(hmc.eight_schools_logpdf,
                              jnp.zeros((2, 10)), key,
                              num_samples=3, step_size=0.1, max_leapfrog=2)

    return run, (jax.random.PRNGKey(0),)


SITES = {
    "ops/seghist.weighted_segment_moments": (_seghist, 2),
    "diagnostics/batch._window_mcse_mean": (_window_mcse, 1),
    "diagnostics/gelmandiag._gelman_core": (_gelman, 2),
    "diagnostics/discretediag._boot_chunk": (_discretediag_mc, 2),
    "models/gbt._fit_gbt_bigk": (_gbt_bigk, 4),
    "models/gbt._predict_stats_bigk": (_gbt_predict_bigk, 1),
    "models/gbt._fit_gbt": (_gbt_dense, 2),
    "models/hmc.hmc_sample": (_hmc, 2),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_f32_matmuls_pinned_to_highest(site):
    build, min_dots = SITES[site]
    fn, args = build()
    ndots, bad = _unpinned(fn, *args)
    assert ndots >= min_dots, f"{site}: expected >= {min_dots} dots"
    assert not bad, f"{site}: unpinned f32 dots {bad}"


@pytest.mark.parametrize("kind", ["rank", "tail", "median"])
def test_fast_mode_has_no_matmul(kind):
    """The fast rank transform counts with a scatter and looks up with a
    gather: no dot_general whose precision could round prefix counts."""
    x = _f32(400, 4, 3)
    q = 0.1 if kind == "tail" else None
    ndots, _ = _unpinned(
        lambda y: _ess_rhat_pipeline(
            y, kind=kind, split_chains=2, maxlag=50, method="fft",
            relative=False, q=q, rank_mode="fast"), x)
    assert ndots == 0
    ndots, _ = _unpinned(lambda y: fastrank.fast_rank_bulk_tail(y), x)
    assert ndots == 0
