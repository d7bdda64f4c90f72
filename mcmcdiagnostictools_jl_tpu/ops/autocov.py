"""Batched autocovariance estimators — the flagship kernel family.

Computes the chain-mean autocovariance curve ``mean_autocov[k]`` for lags
``k = 0..maxlag`` over all (chain, parameter) series at once:

- ``"fft"``  — zero-pad to the next 2^a*3^b length >= 2n-1, batched real FFT,
  |.|^2, inverse real FFT; ``acov_k = Re c_k / Re c_0 * chain_var * (n-1)/n``
  (reference FFTAutocovMethod, src/ess_rhat.jl:103-118,130-152,181-195).
- ``"direct"`` — the biased Geyer estimator ``sum_i x_i x_{i+k} / n``
  (reference AutocovMethod, src/ess_rhat.jl:161-179).
- ``"bda"`` — the BDA3 variogram estimator
  ``mean_chain_var - mean_j sum_i (x_i - x_{i+k})^2 / (2(n-k))``
  (reference BDAAutocovMethod, src/ess_rhat.jl:197-213), computed from the FFT
  cross term and prefix sums of squares rather than an O(n*L) difference loop.

All series enter centered (per split-chain mean already removed). Inputs are
``(niter, C, P)``; outputs ``(maxlag+1, P)`` — the chain mean has already been
taken, which on a chain-sharded mesh becomes a single psum of the
``(maxlag+1, P_local)`` block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def next_fft_size(n: int) -> int:
    """Smallest ``2^a * 3^b >= n`` — mirrors ``nextprod([2,3], n)``
    (reference src/ess_rhat.jl:110). Static/host-side."""
    if n <= 1:
        return 1
    best = None
    p3 = 1
    while p3 < 3 * n:
        # smallest power of two >= n / p3
        q = (n + p3 - 1) // p3
        p2 = 1 << max(0, (q - 1).bit_length())
        cand = p3 * p2
        if cand >= n and (best is None or cand < best):
            best = cand
        p3 *= 3
    return best


def _fft_unnormalized(centered, maxlag: int):
    """Unnormalized circular-free autocovariance ``c_k = sum_i x_i x_{i+k}``
    for k=0..maxlag via batched rFFT. centered: (niter, C, P).

    Pad length: ``nextprod(2,3, niter + maxlag)`` — a circular product at lag
    ``k`` wraps only through indices ``i >= pad - k``, all zero when
    ``pad >= niter + k``, so every consumed lag is exact. The reference pads
    to ``2 niter - 1`` (src/ess_rhat.jl:110) because its cache keeps ALL
    lags; we consume ``maxlag + 1 << niter`` of them, so the shorter pad
    halves the FFT work at default maxlag (same values up to f.p. rounding
    of a different-length transform).
    """
    niter = centered.shape[0]
    m = next_fft_size(niter + maxlag)
    f = jnp.fft.rfft(centered, n=m, axis=0)
    s = jnp.real(f) ** 2 + jnp.imag(f) ** 2
    c = jnp.fft.irfft(s, n=m, axis=0)
    return c[: maxlag + 1]  # (L+1, C, P)


def _mean_autocov_fft(centered, chain_var, maxlag: int):
    niter = centered.shape[0]
    c = _fft_unnormalized(centered, maxlag)
    # acov_k = c_k / c_0 * chain_var * (n-1)/n, then mean over chains
    # (src/ess_rhat.jl:190-194; the c_0 ratio + chain_var product reproduces the
    # reference's rounding path exactly). A constant chain has c_0 = 0; its
    # autocovariance is exactly 0 (the direct estimator's value), so guard the
    # 0/0 — the reference FFT method NaNs here while its default direct method
    # does not, and we follow the direct behavior.
    c0 = c[0][None]
    ratio = jnp.where(c0 > 0, c / jnp.where(c0 > 0, c0, 1.0), 0.0)
    acov = ratio * (chain_var * ((niter - 1) / niter))[None]
    return jnp.mean(acov, axis=1)  # (L+1, P)


def _mean_autocov_direct(centered, chain_var, maxlag: int):
    """Literal biased estimator: mean over chains of dot(x[:n-k], x[k:]) / n.

    lax.scan over the lag axis with a rolling shifted copy — O(n*L) work,
    used for parity testing rather than throughput.
    """
    del chain_var
    niter = centered.shape[0]
    pad = jnp.concatenate(
        [centered, jnp.zeros((maxlag,) + centered.shape[1:], centered.dtype)], axis=0
    )

    def step(y, _):
        ck = jnp.sum(centered * y[:niter], axis=0) / niter  # (C, P)
        return jnp.roll(y, -1, axis=0), jnp.mean(ck, axis=0)

    _, curve = jax.lax.scan(step, pad, None, length=maxlag + 1)
    return curve  # (L+1, P)


def _mean_autocov_bda(centered, chain_var, maxlag: int):
    """BDA3 variogram via FFT cross-term + prefix sums of squares.

    sum_i (x_i - x_{i+k})^2 = S1_k + S2_k - 2 c_k with
    S1_k = sum_{i < n-k} x_i^2 and S2_k = sum_{i >= k} x_i^2.
    """
    niter = centered.shape[0]
    c = _fft_unnormalized(centered, maxlag)  # (L+1, C, P)
    sq = centered * centered
    csum = jnp.cumsum(sq, axis=0)  # csum[j] = sum_{i<=j} x_i^2
    total = csum[-1]  # (C, P)
    lags = jnp.arange(maxlag + 1)
    # S1_k = csum[n-k-1]; S2_k = total - (csum[k-1] if k>0 else 0)
    s1 = csum[niter - 1 - lags]  # (L+1, C, P)
    prev = jnp.concatenate([jnp.zeros_like(csum[:1]), csum[: len(lags) - 1]], axis=0)
    s2 = total[None] - prev
    nk = (niter - lags).astype(centered.dtype)[:, None, None]
    vario = (s1 + s2 - 2.0 * c) / (2.0 * nk)
    mean_chain_var = jnp.mean(chain_var, axis=0)  # (P,)
    return mean_chain_var[None] - jnp.mean(vario, axis=1)  # (L+1, P)


_METHODS = {
    "fft": _mean_autocov_fft,
    "direct": _mean_autocov_direct,
    "bda": _mean_autocov_bda,
}


def mean_autocov_curve(centered, chain_var, maxlag: int, method="fft"):
    """Mean-over-chains autocovariance curve for lags 0..maxlag.

    ``centered``: (niter, C, P) per-chain centered samples.
    ``chain_var``: (C, P) unbiased per-chain variances.
    ``method``: "fft" | "direct" | "bda", or a callable with this signature
    (the open extension point mirroring the reference's AbstractAutocovMethod
    protocol, src/ess_rhat.jl:2,95-126).
    Returns (maxlag+1, P).
    """
    if callable(method):
        return method(centered, chain_var, maxlag)
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown autocov method {method!r}; expected one of {sorted(_METHODS)} or a callable"
        ) from None
    return fn(centered, chain_var, maxlag)
