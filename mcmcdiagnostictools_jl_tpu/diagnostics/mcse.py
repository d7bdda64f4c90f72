"""Monte Carlo standard error (MCSE).

Mirrors the reference mcse.jl capability surface:

- ``kind="mean"``   — ``std / sqrt(ESS_mean)``  (src/mcse.jl:45-51)
- ``kind="std"``    — delta method on the proxy ``(x - mean)^2``:
  ``sqrt((E[mu4]/E[var] - E[var]) / S) / 2``  (src/mcse.jl:52-65)
- ``kind="median"`` / ``Quantile(p)`` — Beta(S*p+1, S*(1-p)+1) asymptotic
  error distribution evaluated at normcdf(+-1), mapped through the inverse
  ECDF: ``mcse = (x_u - x_l) / 2``  (src/mcse.jl:96-118)
- any callable — subsampling bootstrap (SBM) over overlapping batches of size
  ``batch_size`` (default ``floor(sqrt(draws*chains))``), uncorrected variance,
  scaled by ``sqrt(b/n)``  (src/mcse.jl:120-148)

The quantile path is fully batched: one sort per parameter block plus a
batched ``betaincinv``; the indices l/u are data-dependent gathers, which XLA
supports natively.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.fastrank import (
    DEFAULT_NBINS,
    build_hist_cdf,
    hist_quantile,
    hist_rank_value,
)
from ..ops.ranknorm import _flatten_sample, _has_nan_cols
from ..ops.special import betaincinv
from ..utils.layout import canonicalize, maybe_scalar
from .ess_rhat import (
    Quantile,
    _basic_ess_rhat,
    _ess_array,
    _indicator_leq,
    _method_name,
    _niter_after_split,
    _warn_short,
)

# standard normal CDF at +1 / -1 (reference src/mcse.jl:1-2)
_NORMCDF1 = 0.8413447460685429
_NORMCDFN1 = 0.15865525393145705


def mcse(samples, *, kind="mean", batch_size: int | None = None, **ess_kwargs):
    """MCSE of the estimator ``kind`` applied to ``samples``.

    ``samples`` has shape ``(draws[, chains[, parameters...]])``. ``kind`` is
    ``"mean"`` (default), ``"std"``, ``"median"``, ``Quantile(p)``, or any
    callable (SBM fallback; only ``batch_size`` applies). Remaining kwargs are
    forwarded to the ESS computation (``split_chains``, ``maxlag``,
    ``autocov_method``).

    ``rank_mode="fast"`` makes the median/quantile paths sort-free: the
    indicator-proxy threshold AND the Beta-interval inverse-ECDF order
    statistics (src/mcse.jl:96-118) are read off the histogram CDF
    (ops/fastrank.py), each within one bin width of the exact value.
    """
    x3, pshape = canonicalize(samples)
    if callable(kind) and not isinstance(kind, Quantile):
        if ess_kwargs:
            raise TypeError(
                "the SBM fallback only accepts `batch_size`; "
                f"got extra kwargs {sorted(ess_kwargs)}"
            )
        return maybe_scalar(_mcse_sbm(x3, kind, batch_size), pshape)
    if batch_size is not None:
        raise TypeError("`batch_size` only applies to the SBM (callable) fallback")
    if kind == "mean":
        return maybe_scalar(_mcse_mean(x3, ess_kwargs), pshape)
    if kind == "std":
        return maybe_scalar(_mcse_std(x3, ess_kwargs), pshape)
    if kind == "median":
        return maybe_scalar(_mcse_quantile(x3, 0.5, ess_kwargs), pshape)
    if isinstance(kind, Quantile):
        return maybe_scalar(_mcse_quantile(x3, float(kind.p), ess_kwargs), pshape)
    raise ValueError(f"the `kind` `{kind!r}` is not supported by `mcse`")


def _mcse_mean(x3, ess_kwargs):
    s = _ess_array(x3, "mean", None, **ess_kwargs)
    mean = jnp.mean(x3, axis=(0, 1), keepdims=True)
    c = x3 - mean
    n = x3.shape[0] * x3.shape[1]
    std = jnp.sqrt(jnp.sum(c * c, axis=(0, 1)) / (n - 1))
    return std / jnp.sqrt(s)


def _mcse_std(x3, ess_kwargs):
    mean = jnp.mean(x3, axis=(0, 1), keepdims=True)
    x2 = (x3 - mean) ** 2  # expectand proxy for std
    s = _ess_array(x2, "mean", None, **ess_kwargs)
    mean_var = jnp.mean(x2, axis=(0, 1))
    mean_moment4 = jnp.mean(x2 * x2, axis=(0, 1))
    return jnp.sqrt((mean_moment4 / mean_var - mean_var) / s) / 2.0


def _mcse_quantile(x3, p: float, ess_kwargs):
    if ess_kwargs.get("rank_mode", "exact") == "fast":
        return _mcse_quantile_fast(x3, p, ess_kwargs)
    s_eff = _ess_array(x3, "quantile", p, **ess_kwargs)  # (P,)
    return _mcse_quantile_from_ess(x3, p, s_eff)


def _mcse_quantile_fast(x3, p: float, ess_kwargs):
    """Sort-free quantile MCSE: threshold, proxy ESS, and the zoomed
    inverse-ECDF endpoints all in ONE jitted graph sharing one coarse CDF
    (two histogram passes total — a separate `_ess_array` call would
    rebuild the identical coarse CDF for its proxy threshold)."""
    split_chains = ess_kwargs.get("split_chains", 2)
    maxlag = ess_kwargs.get("maxlag", 250)
    unknown = set(ess_kwargs) - {
        "split_chains", "maxlag", "autocov_method", "rank_mode", "rank_nbins"
    }
    if unknown:
        raise TypeError(f"unexpected mcse kwargs: {sorted(unknown)}")
    niter = _niter_after_split(x3.shape[0], split_chains)
    if niter <= 4:
        _warn_short(niter)
        return jnp.full(x3.shape[2], jnp.nan, x3.dtype)
    eff_maxlag = min(maxlag, niter - 4)
    return _mcse_quantile_fast_jit(
        x3, p,
        split_chains=split_chains,
        maxlag=eff_maxlag,
        method=_method_name(ess_kwargs.get("autocov_method", "auto")),
        nbins=ess_kwargs.get("rank_nbins", DEFAULT_NBINS),
    )


@partial(jax.jit, static_argnames=("p", "split_chains", "maxlag", "method",
                                   "nbins"))
def _mcse_quantile_fast_jit(x3, p: float, *, split_chains: int, maxlag: int,
                            method, nbins: int):
    xf = _flatten_sample(x3)
    cdf = build_hist_cdf(xf, nbins)
    thr = hist_quantile(cdf, (p,), nbins)[0]
    s_eff, _ = _basic_ess_rhat(
        _indicator_leq(x3, thr), split_chains, maxlag, method,
        relative=False,
    )
    return _mcse_quantile_from_ess_fast(x3, p, s_eff, nbins=nbins, cdf=cdf)


@partial(jax.jit, static_argnames=("p",))
def _mcse_quantile_from_ess(x3, p: float, s_eff):
    """Beta error-distribution quantile MCSE (src/mcse.jl:96-118), batched."""
    xf = _flatten_sample(x3)
    n = xf.shape[0]
    xs = jnp.sort(xf, axis=0)  # (N, P)
    alpha = s_eff * p + 1.0
    beta = s_eff * (1.0 - p) + 1.0
    prob_upper = betaincinv(alpha, beta, _NORMCDF1)
    prob_lower = betaincinv(alpha, beta, _NORMCDFN1)
    # inverse ECDF with 1-based l/u clamped to [1, N] (src/mcse.jl:111-112)
    l = jnp.clip(jnp.floor(prob_lower * n), 1, n).astype(jnp.int32)
    u = jnp.clip(jnp.ceil(prob_upper * n), 1, n).astype(jnp.int32)
    x_l = jnp.take_along_axis(xs, (l - 1)[None, :], axis=0)[0]
    x_u = jnp.take_along_axis(xs, (u - 1)[None, :], axis=0)[0]
    out = (x_u - x_l) / 2.0
    bad = jnp.isnan(s_eff) | _has_nan_cols(xf)
    return jnp.where(bad, jnp.nan, out)


def _mcse_quantile_from_ess_fast(x3, p: float, s_eff, *, nbins: int,
                                 cdf=None):
    """Sort-free Beta error-distribution quantile MCSE (``rank_mode="fast"``).

    The reference's inverse ECDF reads the l-th and u-th order statistics of
    the sorted sample (src/mcse.jl:111-117). The output ``(x_u - x_l) / 2``
    is a DIFFERENCE of nearby order statistics — at large n the interval
    spans only a couple of global histogram bins, so a single-resolution
    inversion would carry O(bin/interval) relative error. Two passes fix
    that: the (shared) global CDF locates the covering bins, then a second
    histogram over just that (per-column) value range — one coarse bin of
    padding each side so both true order statistics are interior —
    re-inverts at ~nbins times finer resolution. Zero sorts; residual error
    ~ interval / nbins.
    """
    xf = _flatten_sample(x3)
    n = xf.shape[0]
    if cdf is None:
        cdf = build_hist_cdf(xf, nbins)
    alpha = s_eff * p + 1.0
    beta = s_eff * (1.0 - p) + 1.0
    prob_upper = betaincinv(alpha, beta, _NORMCDF1)
    prob_lower = betaincinv(alpha, beta, _NORMCDFN1)
    l = jnp.clip(jnp.floor(prob_lower * n), 1, n)
    u = jnp.clip(jnp.ceil(prob_upper * n), 1, n)
    # coarse pass: covering-bin EDGES bracket the true order statistics
    # (rank-l's element lies in the bin where cum < l <= cum + cnt)
    width = (cdf.hi - cdf.lo) / nbins
    k_l = jnp.sum((cdf.cum + 0.5 <= l[None, :]).astype(jnp.int32), axis=0) - 1
    k_u = jnp.sum((cdf.cum + 0.5 <= u[None, :]).astype(jnp.int32), axis=0) - 1
    lo_z = cdf.lo + (jnp.clip(k_l, 0, nbins - 1) - 1) * width
    hi_z = cdf.lo + (jnp.clip(k_u, 0, nbins - 1) + 2) * width
    lo_z = jnp.nan_to_num(jnp.maximum(lo_z, cdf.lo))
    hi_z = jnp.nan_to_num(jnp.minimum(hi_z, cdf.hi))
    # zoom pass: out-of-range elements clip into the boundary bins, which
    # keeps every in-range rank exact; the padding keeps ranks l/u interior
    cdf_z = build_hist_cdf(xf, nbins, minmax=(lo_z, hi_z, cdf.bad))
    x_l = hist_rank_value(cdf_z, l, nbins)
    x_u = hist_rank_value(cdf_z, u, nbins)
    out = (x_u - x_l) / 2.0
    bad = jnp.isnan(s_eff) | cdf.bad
    return jnp.where(bad, jnp.nan, out)


def _mcse_sbm(x3, f, batch_size: int | None):
    """Subsampling bootstrap MCSE for an arbitrary estimator ``f``.

    ``f`` receives 1-d windows of the chain-major flattened sample (draws of
    chain 0, then chain 1, ...), must accept a jnp array and return a scalar.
    Reference: src/mcse.jl:120-148.
    """
    ndraws, nchains, nparams = x3.shape
    n = ndraws * nchains
    b = int(jnp.sqrt(n)) if batch_size is None else int(batch_size)
    if not 0 < b <= n:
        raise ValueError("batch_size must be in [1, draws*chains]")
    # chain-major flatten: Julia's vec() of the (draws, chains) matrix
    flat = jnp.moveaxis(x3, 1, 0).reshape(n, nparams)

    nwin = n - b + 1
    starts = jnp.arange(nwin)

    def stat_for_window(start):
        win = jax.lax.dynamic_slice(flat, (start, 0), (b, nparams))  # (b, P)
        return jax.vmap(f, in_axes=1)(win)  # (P,)

    # batch_size vmaps 64 overlapping windows per step instead of a fully
    # sequential scan over all ~n-b+1 of them — batched for ANY callable
    # without assuming its algebra
    vals = jax.lax.map(stat_for_window, starts,
                       batch_size=min(64, nwin))  # (nwin, P)
    mean = jnp.mean(vals, axis=0, keepdims=True)
    var = jnp.mean((vals - mean) ** 2, axis=0)  # uncorrected (ddof=0)
    out = jnp.sqrt(var * (b / n))
    # all-equal slices and NaN slices degrade to NaN (src/mcse.jl:136-142)
    allsame = jnp.all(flat == flat[0][None], axis=0)
    bad = allsame | _has_nan_cols(flat)
    return jnp.where(bad, jnp.nan, out)
