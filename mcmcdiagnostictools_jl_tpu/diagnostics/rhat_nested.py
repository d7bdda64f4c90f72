"""Nested R-hat for the many-short-chains regime (Margossian et al. 2024).

Mirrors the reference rhat_nested.jl: chains are grouped into superchains (all
chains of a superchain share an initialization); per parameter and superchain
``Wk`` (mean within-chain variance) and ``Bk`` (between-chain variance) are
combined as ``rhat = sqrt(1 + var(superchain_means) / mean(Wk + Bk))``
(src/rhat_nested.jl:127-188). Kinds reuse the rank/bulk/tail transforms
(src/rhat_nested.jl:98-125).

Batched formulation: chains are permuted so superchains are contiguous, the
superchain axis becomes a real array axis, and both reduction levels are plain
axis-reductions — on a chain-sharded mesh the inner level reduces locally and
the outer level is one psum over superchain partial sums.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ranknorm import fold_around_median, rank_normalize
from ..utils.indices import unique_indices
from ..utils.layout import canonicalize, maybe_scalar
from ..utils.split import split_chains_reshape

_KINDS = ("rank", "bulk", "tail", "basic")


def rhat_nested(samples, superchain_ids, *, kind: str = "rank", split_chains: int = 2):
    """Nested R-hat of ``samples`` shaped ``(draws, chains[, parameters...])``.

    ``superchain_ids`` is a length-``chains`` vector assigning each chain to a
    superchain; every superchain must contain the same number of chains and
    there must be at least 2 superchains (src/rhat_nested.jl:68-81).
    """
    if kind not in _KINDS:
        raise ValueError(f"the `kind` `{kind}` is not supported by `rhat_nested`")
    samples = jnp.asarray(samples)
    if samples.ndim < 2:
        raise ValueError(
            "`samples` must have at least 2 dimensions (draws, chains[, parameters...])"
        )
    x3, pshape = canonicalize(samples, min_ndim=2)
    perm, nsuper = _validate_superchain_ids(superchain_ids, x3.shape[1])
    vals = _rhat_nested_pipeline(
        x3, jnp.asarray(perm), nsuper=nsuper, kind=kind, split_chains=split_chains
    )
    return maybe_scalar(vals, pshape)


def _validate_superchain_ids(superchain_ids, nchains: int):
    """Return (chain permutation grouping superchains contiguously, nsuper)."""
    ids = np.asarray(superchain_ids)
    if ids.ndim != 1 or len(ids) != nchains:
        raise ValueError(
            f"`superchain_ids` has length {ids.size} but `samples` has {nchains} chains"
        )
    _, groups = unique_indices(ids)
    nsuper = len(groups)
    if nsuper < 2:
        raise ValueError(f"at least 2 superchains are required, got {nsuper}")
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError("all superchains must contain the same number of chains")
    return np.concatenate(groups), nsuper


@partial(jax.jit, static_argnames=("nsuper", "kind", "split_chains"))
def _rhat_nested_pipeline(x3, perm, *, nsuper: int, kind: str, split_chains: int):
    if kind == "bulk":
        x3 = rank_normalize(x3)
    elif kind == "tail":
        x3 = rank_normalize(fold_around_median(x3))
    elif kind == "rank":
        bulk = _rhat_nested_basic(rank_normalize(x3), perm, nsuper, split_chains)
        tail = _rhat_nested_basic(
            rank_normalize(fold_around_median(x3)), perm, nsuper, split_chains
        )
        return jnp.maximum(bulk, tail)
    return _rhat_nested_basic(x3, perm, nsuper, split_chains)


def _rhat_nested_basic(x3, perm, nsuper: int, split_chains: int):
    """Two-level B/W reduction (src/rhat_nested.jl:127-188), batched over P."""
    x3 = x3[:, perm, :]  # superchains contiguous
    samples = split_chains_reshape(x3, split_chains)  # (niter, C*split, P)
    niter, nchains, nparams = samples.shape
    m = nchains // nsuper  # (split) chains per superchain
    s = samples.reshape(niter, nsuper, m, nparams)

    chain_mean = jnp.mean(s, axis=0)  # (S, m, P)
    centered = s - chain_mean[None]
    chain_var = jnp.sum(centered * centered, axis=0) / (niter - 1)  # (S, m, P)
    wk = jnp.mean(chain_var, axis=1)  # (S, P)
    superchain_mean = jnp.mean(chain_mean, axis=1)  # (S, P)
    dm = chain_mean - superchain_mean[:, None]
    bk = (
        jnp.sum(dm * dm, axis=1) / (m - 1)
        if m > 1
        else jnp.zeros_like(wk)  # corrected=(m > 1), src/rhat_nested.jl:175
    )
    var_within = jnp.mean(wk + bk, axis=0)  # (P,)
    grand = jnp.mean(superchain_mean, axis=0)
    ds_ = superchain_mean - grand[None]
    var_between = jnp.sum(ds_ * ds_, axis=0) / (nsuper - 1)  # ddof=1
    # degenerate all-identical slices must be NaN despite XLA reassociation
    degenerate = jnp.all(samples == samples[0, 0][None, None], axis=(0, 1))
    var_between = jnp.where(degenerate, jnp.nan, var_between)
    return jnp.sqrt(1.0 + var_between / var_within)
