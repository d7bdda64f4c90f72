"""Gelman, Rubin and Brooks PSRF diagnostics.

Batched re-derivation of the reference gelmandiag.jl: per-chain covariances,
moment-matched degrees of freedom for the F-based upper confidence limit
(src/gelmandiag.jl:1-53), and the multivariate PSRF via the symmetric
whitened between-chain matrix ``L^-1 B L^-T`` and its largest eigenvalue
(src/gelmandiag.jl:80-105).

Everything is a fused set of chain-axis contractions (the covariance matrices
are chain-batched matmuls, pinned to full f32 precision); the F quantile uses
the device-side ``betaincinv``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.special import fdist_quantile
from ..utils.layout import _float_dtype

_HIGHEST = jax.lax.Precision.HIGHEST


class GelmanResult(NamedTuple):
    psrf: jnp.ndarray
    psrfci: jnp.ndarray


class GelmanMultivariateResult(NamedTuple):
    psrf: jnp.ndarray
    psrfci: jnp.ndarray
    psrfmultivariate: float


def _as3d(chains):
    x = jnp.asarray(chains)
    if x.ndim < 3:
        raise ValueError("samples must have shape (draws, chains, parameters...)")
    x = x.reshape(x.shape[0], x.shape[1], -1)
    return x.astype(_float_dtype(x.dtype))


def _covdiag(x, y):
    """Per-column covariance between (C, P) matrices, ddof=1."""
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    yc = y - jnp.mean(y, axis=0, keepdims=True)
    return jnp.sum(xc * yc, axis=0) / (x.shape[0] - 1)


@jax.jit
def _gelman_core(psi, alpha):
    niters, nchains, nparams = psi.shape
    rfixed = (niters - 1) / niters
    rrandomscale = (nchains + 1) / (nchains * niters)

    chain_mean = jnp.mean(psi, axis=0)  # psibar: (C, P)
    centered = psi - chain_mean[None]
    # per-chain covariance matrices: (C, P, P) batched matmul
    s2_full = jnp.einsum("ncp,ncq->cpq", centered, centered,
                         precision=_HIGHEST) / (niters - 1)
    w_full = jnp.mean(s2_full, axis=0)  # W: (P, P)
    pb_centered = chain_mean - jnp.mean(chain_mean, axis=0, keepdims=True)
    b_full = niters * jnp.matmul(pb_centered.T, pb_centered,
                                 precision=_HIGHEST) / (nchains - 1)  # B

    w = jnp.diagonal(w_full)
    b = jnp.diagonal(b_full)
    s2 = jnp.diagonal(s2_full, axis1=1, axis2=2)  # (C, P) per-chain variances
    psibar2 = jnp.mean(chain_mean, axis=0)  # (P,)

    var_w = jnp.var(s2, axis=0, ddof=1) / nchains
    var_b = (2.0 / (nchains - 1)) * b**2
    var_wb = (niters / nchains) * (
        _covdiag(s2, chain_mean**2) - 2.0 * psibar2 * _covdiag(s2, chain_mean)
    )

    v = rfixed * w + rrandomscale * b
    var_v = (
        rfixed**2 * var_w
        + rrandomscale**2 * var_b
        + 2.0 * rfixed * rrandomscale * var_wb
    )
    df = 2.0 * v**2 / var_v
    b_df = nchains - 1
    w_df = 2.0 * w**2 / var_w

    correction = (df + 3.0) / (df + 1.0)
    rrandom = rrandomscale * b / w
    psrf = jnp.sqrt(correction * (rfixed + rrandom))

    q = 1.0 - alpha / 2.0
    fq = fdist_quantile(jnp.full_like(w_df, float(b_df)), w_df, q)
    rrandom_ci = jnp.where(jnp.isnan(rrandom), rrandom, rrandom * fq)
    psrfci = jnp.sqrt(correction * (rfixed + rrandom_ci))
    return psrf, psrfci, w_full, b_full


def gelmandiag(chains, *, alpha: float = 0.05) -> GelmanResult:
    """PSRF point estimates and upper CI for ``chains`` of shape
    ``(draws, chains, parameters...)``. Requires >= 2 chains
    (src/gelmandiag.jl:3)."""
    psi = _as3d(chains)
    if psi.shape[1] < 2:
        raise ValueError("Gelman diagnostic requires at least 2 chains")
    pshape = jnp.asarray(chains).shape[2:]
    psrf, psrfci, _, _ = _gelman_core(psi, alpha)
    return GelmanResult(psrf.reshape(pshape), psrfci.reshape(pshape))


def gelmandiag_multivariate(chains, *, alpha: float = 0.05) -> GelmanMultivariateResult:
    """Univariate PSRFs plus the multivariate PSRF
    ``rfixed + rrandomscale * eigmax(L^-1 B L^-T)`` with ``W = L L^T``
    (src/gelmandiag.jl:80-105). Requires >= 2 parameters."""
    psi = _as3d(chains)
    niters, nchains, nparams = psi.shape
    if nchains < 2:
        raise ValueError("Gelman diagnostic requires at least 2 chains")
    if nparams < 2:
        raise ValueError(
            "computation of the multivariate potential scale reduction factor "
            "requires at least two variables"
        )
    pshape = jnp.asarray(chains).shape[2:]
    psrf, psrfci, w_full, b_full = _gelman_core(psi, alpha)
    mv = _multivariate_psrf(w_full, b_full, niters, nchains)
    return GelmanMultivariateResult(
        psrf.reshape(pshape), psrfci.reshape(pshape), float(mv)
    )


@jax.jit
def _multivariate_psrf(w_full, b_full, niters, nchains):
    rfixed = (niters - 1) / niters
    rrandomscale = (nchains + 1) / (nchains * niters)
    l = jnp.linalg.cholesky(w_full)
    y1 = jax.scipy.linalg.solve_triangular(l, b_full, lower=True)
    y = jax.scipy.linalg.solve_triangular(l, y1.T, lower=True)
    lam_max = jnp.max(jnp.linalg.eigvalsh((y + y.T) / 2.0))
    return rfixed + rrandomscale * lam_max
