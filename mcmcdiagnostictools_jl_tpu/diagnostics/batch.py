"""Batched classical diagnostics over (draws, chains[, parameters...]).

The reference's Geweke / Heidelberger-Welch / Raftery-Lewis functions are
single-vector APIs (one chain at a time). These wrappers evaluate them for
every (chain, parameter) series at once, which is what the batched-suite
benchmark configuration exercises (BASELINE.md config 3):

- ``gewekediag_batch`` — fully vectorized: the window means and MCSEs batch
  by folding (chain, param) into the parameter axis with a single-chain
  layout, reproducing the scalar ``gewekediag`` numbers.
- ``heideldiag_batch`` — the burn-in scan has a static candidate list
  (starts 1, 1+delta, ... < n/2), so every candidate's Cramer-von Mises
  statistic and MCSE is computed batched and the per-series "first converged
  candidate" is a vectorized select, matching the scalar loop's semantics.
- ``rafterydiag_batch`` — the BIC thinning search is inherently sequential
  per series and cheap; it loops on the host.

All outputs have shape ``(chains, *param_shape)``.

Compilation economics (the reason for the masked kernel below): every window /
burn-in candidate has a different draw count, and a fresh shape means a fresh
XLA compile (seconds each — dwarfing the actual compute). ``_window_mcse_mean`` therefore computes the single-chain
mean-MCSE of ANY (start, stop) window of a fixed-shape series stack with
masking: zero-masked centering makes the zero-padded full-length FFT return
exactly the window's lag sums, and the dynamic-length Geyer reduction
(``geyer_ess_from_rho_dynamic``) reproduces the per-window ``maxlag``
clamping. One compile serves every window of every call with the same
(n, S, nwindows) signature.
"""

from __future__ import annotations

import math
import warnings
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import erfcinv

from ..ops.autocov import _mean_autocov_direct
from ..ops.geyer import geyer_ess_from_rho_dynamic
from ..ops.special import pcramer
from ..utils.layout import canonicalize
from .mcse import mcse
from .rafterydiag import RafteryResult


class GewekeBatchResult(NamedTuple):
    zscore: np.ndarray  # (chains, *pshape)
    pvalue: np.ndarray


class HeidelBatchResult(NamedTuple):
    burnin: np.ndarray
    stationarity: np.ndarray
    pvalue: np.ndarray
    mean: np.ndarray
    halfwidth: np.ndarray
    test: np.ndarray


def _series_matrix(samples):
    """(draws, chains, P) canonical -> (draws, 1, chains*P) single-chain layout
    plus the output shape (chains, *pshape)."""
    x3, pshape = canonicalize(samples, min_ndim=2)
    d, c, p = x3.shape
    flat = x3.reshape(d, 1, c * p)  # series index = chain * P + param
    return x3, flat, (c,) + pshape


def _mcse_series(flat, **kw):
    """MCSE per series of the (draws, 1, S) stack with split_chains=1."""
    return np.asarray(mcse(flat, split_chains=1, **kw))


@partial(jax.jit, static_argnames=("maxlag",))
def _window_mcse_mean(flat, starts, stops, maxlag: int = 250):
    """Mean-MCSE of arbitrary (start, stop) windows of a series stack.

    ``flat``: (n, S); ``starts``/``stops``: (W,) int32 half-open 0-based window
    bounds (each window must have length > 4). Returns ``(mcse, mean, ess)``
    each of shape (W, S). Numerically the single-chain (split_chains=1)
    mean-MCSE of ``flat[start:stop]``: masked centering zeroes everything
    outside the window, so the lag-k sums of the padded series are exactly the
    window's own (src/ess_rhat.jl:103-118 semantics with the window's length
    in every normalization — the FFT and direct estimators compute the same
    sums; the direct lag scan is used because its XLA graph compiles faster
    than a 2^a*3^b-length batched FFT, and this is not the throughput path).
    """
    n, nser = flat.shape
    nwin = len(starts)
    dtype = flat.dtype
    idx = jnp.arange(n, dtype=jnp.int32)
    starts = jnp.asarray(starts, jnp.int32)
    stops = jnp.asarray(stops, jnp.int32)

    mask = (
        (idx[:, None] >= starts[None]) & (idx[:, None] < stops[None])
    ).astype(dtype)  # (n, W)
    m = (stops - starts).astype(dtype)  # (W,)
    mean = jnp.einsum("nw,ns->ws", mask, flat,
                      precision=jax.lax.Precision.HIGHEST) / m[:, None]
    z = (flat[:, None, :] - mean[None]) * mask[:, :, None]  # (n, W, S)
    var = jnp.sum(z * z, axis=0) / (m[:, None] - 1.0)  # (W, S)

    # unnormalized lag sums c_k = sum_i z_i z_{i+k} for every window at once
    zs = z.reshape(n, 1, nwin * nser)
    c = _mean_autocov_direct(zs, None, maxlag) * n  # (L+1, W*S)
    c = c.reshape(maxlag + 1, nwin, nser)
    acov = c / m[None, :, None]
    w_stat = var  # single chain: W = chain_var, between-chain var = 0
    var_plus = (m[:, None] - 1.0) / m[:, None] * w_stat
    rho = (1.0 - (w_stat[None] - acov) / var_plus[None]).reshape(
        maxlag + 1, nwin * nser
    )
    eff_maxlag = jnp.minimum(maxlag, (stops - starts) - 4)  # (W,)
    ess = geyer_ess_from_rho_dynamic(
        rho,
        jnp.repeat(m, nser),
        jnp.repeat(eff_maxlag, nser),
    ).reshape(nwin, nser)
    return jnp.sqrt(var) / jnp.sqrt(ess), mean, ess


@partial(jax.jit, static_argnames=("maxlag",))
def _heidel_scan_kernel(flat, cand_starts, half_start, maxlag: int = 250):
    """Fused Heidelberger scan: suffix MCSEs + Cramer-von Mises p-values.

    ``flat``: (n, S); ``cand_starts``: (W,) 0-based burn-in candidates;
    ``half_start``: 0-based start of the second-half window whose MCSE scales
    the CvM statistic (src/heideldiag.jl:26-39). Returns
    ``(mcse_cand, mean_cand, pvals)`` each (W, S).
    """
    n, _ = flat.shape
    starts = jnp.concatenate([jnp.asarray([half_start], jnp.int32),
                              jnp.asarray(cand_starts, jnp.int32)])
    stops = jnp.full(starts.shape, n, jnp.int32)
    mcse_all, mean_all, _ = _window_mcse_mean(flat, starts, stops, maxlag)
    s0 = (n - half_start) * mcse_all[0] ** 2  # (S,)

    csum = jnp.cumsum(flat, axis=0)  # (n, S)
    idx = jnp.arange(n, dtype=flat.dtype)

    def one(a, ybar):
        # Brownian-bridge partial sums of the suffix y = flat[a:]:
        # b_j = sum(y[:j-a+1]) - ybar*(j-a+1) for j >= a, via the global cumsum
        prev = jnp.where(a > 0, csum[jnp.maximum(a - 1, 0)], 0.0)  # (S,)
        steps = (idx - a.astype(flat.dtype) + 1.0)[:, None]  # (n, 1)
        b = csum - prev[None] - ybar[None] * steps
        active = (idx >= a.astype(flat.dtype))[:, None]
        ssq = jnp.sum(jnp.where(active, b * b, 0.0), axis=0)  # (S,)
        md = jnp.asarray(n, flat.dtype) - a.astype(flat.dtype)
        return ssq / (md * s0) / md

    cvm = jax.vmap(one)(starts[1:], mean_all[1:])  # (W, S)
    pvals = 1.0 - pcramer(cvm)
    return mcse_all[1:], mean_all[1:], pvals


def gewekediag_batch(samples, *, first: float = 0.1, last: float = 0.5,
                     **mcse_kwargs):
    """Batched Geweke diagnostic; see :func:`gewekediag` for semantics."""
    if not 0 < first < 1:
        raise ValueError("`first` is not in (0, 1)")
    if not 0 < last < 1:
        raise ValueError("`last` is not in (0, 1)")
    if first + last > 1:
        raise ValueError("`first` and `last` proportions overlap")
    x3, flat, out_shape = _series_matrix(samples)
    n = x3.shape[0]
    stop1 = round(first * n)
    start2 = round(n - last * n + 1) - 1
    if set(mcse_kwargs) <= {"maxlag"} and min(stop1, n - start2) > 4:
        # one fixed-shape masked kernel for both windows (single compile)
        s, m, _ = _window_mcse_mean(
            flat[:, 0, :], np.array([0, start2]), np.array([stop1, n]),
            maxlag=mcse_kwargs.get("maxlag", 250),
        )
        s1, s2 = np.asarray(s)
        m1, m2 = np.asarray(m)
    else:
        w1 = flat[:stop1]
        w2 = flat[start2:]
        s1 = _mcse_series(w1, **mcse_kwargs)
        s2 = _mcse_series(w2, **mcse_kwargs)
        m1 = np.asarray(jnp.mean(w1[:, 0, :], axis=0))
        m2 = np.asarray(jnp.mean(w2[:, 0, :], axis=0))
    z = (m1 - m2) / np.hypot(s1, s2)
    p = np.vectorize(math.erfc)(np.abs(z) / math.sqrt(2))
    return GewekeBatchResult(z.reshape(out_shape), p.reshape(out_shape))


def heideldiag_batch(samples, *, alpha: float = 0.05, eps: float = 0.1,
                     start: int = 1, **mcse_kwargs):
    """Batched Heidelberger-Welch; see :func:`heideldiag` for semantics."""
    x3, flat, out_shape = _series_matrix(samples)
    n = x3.shape[0]
    nseries = flat.shape[2]
    delta = int(0.10 * n)
    half_start = int(n / 2) - 1  # 0-based start of the second-half window

    starts = []
    i = 1
    while i < n / 2:
        starts.append(i)
        i += delta
    i_exit = i  # first i >= n/2 (the loop-exit value, used for burnin when
    # no candidate converges, src/heideldiag.jl:25-39)

    fast = set(mcse_kwargs) <= {"maxlag"} and n - half_start > 4
    if fast:
        # every suffix window + the CvM scan in ONE fused jitted call
        mcse_c, ybars, pv = _heidel_scan_kernel(
            flat[:, 0, :], np.array([i1 - 1 for i1 in starts]), half_start,
            maxlag=mcse_kwargs.get("maxlag", 250),
        )
        pvals = np.asarray(pv)
        ybars = np.asarray(ybars)
        halfw = math.sqrt(2.0) * float(erfcinv(alpha)) * np.asarray(mcse_c)
    else:
        s = _mcse_series(flat[half_start:], **mcse_kwargs)
        s0 = (n - half_start) * s**2  # (S,)
        pvals = np.empty((len(starts), nseries))
        ybars = np.empty((len(starts), nseries))
        halfw = np.empty((len(starts), nseries))
        for k, i1 in enumerate(starts):
            y = np.asarray(flat[i1 - 1 :, 0, :])  # (m, S)
            m = y.shape[0]
            ybar = y.mean(axis=0)
            b = np.cumsum(y, axis=0) - ybar[None, :] * np.arange(1, m + 1)[:, None]
            cvm = (b * b).sum(axis=0) / (m * s0) / m
            pvals[k] = 1.0 - np.asarray(pcramer(jnp.asarray(cvm)))
            ybars[k] = ybar
            sk = _mcse_series(flat[i1 - 1 :], **mcse_kwargs)
            halfw[k] = math.sqrt(2.0) * float(erfcinv(alpha)) * sk

    converged_any = pvals > alpha
    first_idx = np.argmax(converged_any, axis=0)
    has_conv = converged_any.any(axis=0)
    sel = np.where(has_conv, first_idx, len(starts) - 1)
    rows = sel, np.arange(nseries)
    pvalue = pvals[rows]
    ybar = ybars[rows]
    halfwidth = halfw[rows]
    burnin = np.where(
        has_conv,
        np.asarray(starts)[sel] + start - 2,
        i_exit + start - 2,
    )
    passed = halfwidth / np.abs(ybar) <= eps
    return HeidelBatchResult(
        burnin.reshape(out_shape),
        has_conv.reshape(out_shape),
        pvalue.reshape(out_shape),
        ybar.reshape(out_shape),
        halfwidth.reshape(out_shape),
        passed.reshape(out_shape),
    )


def _pattern_counts(vals, nbins: int):
    """Per-series bincounts: ``vals`` (L, S) ints in [0, nbins) -> (nbins, S)."""
    length, nser = vals.shape
    if length == 0:
        return np.zeros((nbins, nser), dtype=np.int64)
    flat = vals + nbins * np.arange(nser, dtype=vals.dtype)[None, :]
    return (
        np.bincount(flat.ravel(), minlength=nbins * nser)
        .reshape(nser, nbins)
        .T
    )


def rafterydiag_batch(
    samples, *, q: float = 0.025, r: float = 0.005, s: float = 0.95,
    eps: float = 0.001, range_start: int = 1, range_step: int = 1,
):
    """Vectorized Raftery-Lewis over every (chain, parameter) series.

    The dichotomize / pattern-count / G2 stages run batched across all series
    for each candidate thinning; only the per-series "first BIC < 0" decision
    is scalar bookkeeping (src/rafterydiag.jl:42-59 semantics, numerically
    identical to the scalar :func:`rafterydiag` loop — asserted in tests).
    Returns a :class:`RafteryResult` of arrays shaped (chains, *pshape).
    """
    import math as _math

    from scipy.special import erfinv

    # NumPy-only canonicalization: this diagnostic is host-side, so the
    # sample never needs a device round trip
    x = np.asarray(samples, dtype=float)
    if x.ndim == 1:
        x = x[:, None]
    pshape = x.shape[2:]
    ndraws, nchains = x.shape[0], x.shape[1]
    out_shape = (nchains,) + pshape
    series = x.reshape(ndraws, -1)  # (n, S), series index = chain*P + param
    n, nser = series.shape
    phi = _math.sqrt(2.0) * float(erfinv(s))
    nmin = _math.ceil(q * (1.0 - q) * (phi / r) ** 2)
    if nmin > n:
        warnings.warn(
            f"At least {nmin} samples are needed for specified q, r, and s"
        )
        nanv = np.full(out_shape, np.nan)
        return RafteryResult(
            np.full(out_shape, -1.0), nanv.copy(), nanv.copy(),
            np.full(out_shape, nmin), nanv.copy(),
        )

    thr = np.quantile(series, q, axis=0)  # (S,)
    dichot = (series <= thr[None, :]).astype(np.int64)

    kthin_res = np.zeros(nser, dtype=np.int64)
    alpha = np.full(nser, np.nan)
    beta = np.full(nser, np.nan)
    active = np.ones(nser, dtype=bool)
    kthin = 0
    while active.any():
        kthin += 1
        test = dichot[::kthin]
        ntest = len(test)
        if ntest <= 4:
            # scalar reference would fail here (log of a non-positive count);
            # mark the stragglers unconverged instead of crashing the batch
            break
        temp = test[: ntest - 2] + 2 * test[1 : ntest - 1] + 4 * test[2:]
        counts = _pattern_counts(temp, 8)  # (8, S)
        # trantest[i1, i2, i3] = counts[i1 + 2*i2 + 4*i3] (Fortran reshape,
        # src/rafterydiag.jl:44-47)
        tran = counts.reshape(2, 2, 2, nser, order="F").astype(float)
        sum_i1 = tran.sum(axis=0, keepdims=True)
        sum_i3 = tran.sum(axis=2, keepdims=True)
        sum_both = tran.sum(axis=(0, 2), keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            fitted = sum_i1 * sum_i3 / sum_both
            g2 = np.where(
                tran > 0, 2.0 * tran * np.log(tran / fitted), 0.0
            ).sum(axis=(0, 1, 2))
        bic = g2 - 2.0 * _math.log(ntest - 2.0)
        done = active & (bic < 0.0)
        if done.any():
            tf = _pattern_counts(test[: ntest - 1] + 2 * test[1:], 4)
            with np.errstate(divide="ignore", invalid="ignore"):
                a = tf[2] / (tf[0] + tf[2])
                b = tf[1] / (tf[1] + tf[3])
            kthin_res[done] = kthin
            alpha[done] = a[done]
            beta[done] = b[done]
            active &= ~done

    kthin_eff = (kthin_res * range_step).astype(float)
    kthin_eff[kthin_res == 0] = np.nan
    with np.errstate(divide="ignore", invalid="ignore"):
        m = np.log(eps * (alpha + beta) / np.maximum(alpha, beta)) / np.log(
            np.abs(1.0 - alpha - beta)
        )
        burnin = kthin_eff * np.ceil(m) + range_start - 1
        ntot = ((2.0 - alpha - beta) * alpha * beta * phi**2) / (
            r**2 * (alpha + beta) ** 3
        )
        keep = kthin_eff * np.ceil(ntot)
        total = burnin + keep
    return RafteryResult(
        kthin_eff.reshape(out_shape),
        burnin.reshape(out_shape),
        total.reshape(out_shape),
        np.full(out_shape, nmin),
        (total / nmin).reshape(out_shape),
    )
