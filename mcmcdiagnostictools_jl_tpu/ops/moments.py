"""Fused per-chain moment statistics for R-hat / ESS.

One pass over the split samples computes, per parameter: chain means, unbiased
within-chain variances, ``W`` (mean within-chain variance), and the pooled
variance estimator ``var_plus = (n-1)/n * W + var(chain_means)`` used by both
R-hat and ESS (reference src/ess_rhat.jl:391-406, 529-545).

On a chain-sharded mesh these reductions become psums over the chain axis; the
single-device path here is the N=1 special case of the same contractions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ChainStats(NamedTuple):
    chain_mean: jnp.ndarray  # (C, P)
    chain_var: jnp.ndarray  # (C, P), ddof=1
    w: jnp.ndarray  # (P,) mean within-chain variance
    var_plus: jnp.ndarray  # (P,) pooled variance estimator
    rhat: jnp.ndarray  # (P,) sqrt(var_plus / W)
    degenerate: jnp.ndarray  # (P,) bool: all samples in the slice identical


def stats_from_chain_moments(chain_mean, chain_var, niter: int, degenerate) -> ChainStats:
    """Assemble ``ChainStats`` from per-chain first/second moments.

    ``var_plus = (niter-1)/niter * W + var(chain_means; ddof=(C>1))`` — when a
    single (split) chain is present the between-chain term is dropped, matching
    the reference's ``corrected=(nchains > 1)`` guard (src/ess_rhat.jl:403,541).
    """
    nchains = chain_mean.shape[0]
    w = jnp.mean(chain_var, axis=0)  # (P,)
    grand_mean = jnp.mean(chain_mean, axis=0)  # (P,)
    dm = chain_mean - grand_mean[None]
    ddof = 1 if nchains > 1 else 0
    between = (
        jnp.sum(dm * dm, axis=0) / (nchains - ddof)
        if nchains > 1
        else jnp.zeros_like(grand_mean)
    )
    correction = (niter - 1) / niter
    var_plus = correction * w + between
    # The reference relies on exact 0/0 -> NaN when every sample in a slice is
    # identical (test/ess_rhat.jl:242-257). XLA's reassociation can turn the
    # between-chain term into a tiny nonzero value, so the degenerate case is
    # detected explicitly and poisoned with NaN.
    var_plus = jnp.where(degenerate, jnp.nan, var_plus)
    rhat = jnp.sqrt(var_plus / w)
    return ChainStats(chain_mean, chain_var, w, var_plus, rhat, degenerate)


def chain_stats(samples) -> ChainStats:
    """Compute per-chain moments and basic split-R-hat from ``(niter, C, P)``."""
    niter, _, _ = samples.shape
    chain_mean = jnp.mean(samples, axis=0)  # (C, P)
    centered = samples - chain_mean[None]
    chain_var = jnp.sum(centered * centered, axis=0) / (niter - 1)  # (C, P)
    degenerate = jnp.all(samples == samples[0, 0][None, None], axis=(0, 1))
    return stats_from_chain_moments(chain_mean, chain_var, niter, degenerate)
