"""Chain splitting with the reference's exact remainder-discard rule.

Every chain's draw axis is split into ``split`` consecutive sub-chains. When
``d = draws % split > 0`` the chains cannot be evenly split, and **one draw is
discarded after each of the first d splits** within each chain — reference
``copyto_split!`` (src/utils.jl:13-41) and the documented contract in
src/ess_rhat.jl:4-7. Getting this rule exactly right matters: it changes every
downstream ESS/R-hat number for odd draw counts.

Batched formulation: instead of a per-column copy loop, the split is a single
static gather along the draw axis — split ``k`` (0-indexed) reads draws
``[k*niter + min(k, d), k*niter + min(k, d) + niter)``.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp


def split_draw_indices(ndraws: int, split: int) -> np.ndarray:
    """Static (split, niter) index matrix implementing the discard rule.

    ``idx[k, i] = k * niter + min(k, d) + i`` with ``niter = ndraws // split``
    and ``d = ndraws % split`` — i.e. one draw is skipped after each of the
    first ``d`` splits (reference src/utils.jl:29-36).
    """
    if split < 1:
        raise ValueError("split_chains must be >= 1")
    niter = ndraws // split
    d = ndraws % split
    k = np.arange(split)[:, None]
    i = np.arange(niter)[None, :]
    return k * niter + np.minimum(k, d) + i


def split_chains_reshape(x, split: int):
    """Split the draws of ``x`` of shape ``(draws, chains, P)`` into
    ``(draws // split, chains * split, P)``.

    Output chain ordering is chain-major — all splits of chain 0, then chain 1,
    ... — matching the reference's column layout (src/utils.jl:32-38). The
    ordering only matters for determinism: every downstream statistic is
    permutation-invariant in the chain axis.
    """
    ndraws, nchains = x.shape[0], x.shape[1]
    if split == 1:
        return x
    niter = ndraws // split
    d = ndraws % split
    # static slices (no gather): split k reads draws [k*niter + min(k,d), +niter)
    parts = [
        jax.lax.slice_in_dim(x, k * niter + min(k, d), k * niter + min(k, d) + niter, axis=0)
        for k in range(split)
    ]
    y = jnp.stack(parts, axis=2)  # (niter, chains, split, P)
    return y.reshape(niter, nchains * split, *x.shape[2:])
