"""Per-split-chain moments straight from a sorted sample — the sort-saver.

The tail R-hat needs only per-split-chain means/variances of the
rank-normalized folded sample (reference ``_rhat(Val(:tail), x)``,
src/ess_rhat.jl:413-415) — order-free sums. Routing the folded rank-normal
values back to original (draw, chain) positions with a full inverse payload
sort only to immediately reduce over the draw axis is wasted work: the fold
sort already carries each element's original flat position, from which its
split-chain id is an elementwise formula. The per-chain sums then become a
weighted one-hot contraction over row tiles — no fourth sort.

Layout contract (utils/split.py, ops/ranknorm.py):
- flat position ``n = draw * nchains + chain`` (``_flatten_sample`` row order);
- split ``k`` of a draw follows the remainder-discard rule: ``niter = draws //
  split``, ``d = draws % split``; splits ``k < d`` own draws ``[k*(niter+1),
  k*(niter+1)+niter)`` (one draw after each discarded), splits ``k >= d`` own
  ``[k*niter+d, (k+1)*niter+d)`` (reference src/utils.jl:29-36);
- split-chain id ``chain * split + k`` (chain-major, split_chains_reshape).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# these contractions carry data values, not 0/1 products: keep full f32
# precision (the GPU default may round f32 operands to TF32)
_HIGHEST = jax.lax.Precision.HIGHEST


def split_chain_ids_from_flat(order, ndraws: int, nchains: int, split: int):
    """Split-chain id and validity of flat positions ``order``.

    ``order``: int32 array of flat positions ``draw * nchains + chain``.
    Returns ``(seg, valid)`` of the same shape: ``seg`` in
    ``[0, nchains*split)`` and ``valid`` False for draws discarded by the
    remainder rule (they belong to no split chain).
    """
    niter = ndraws // split
    d = ndraws % split
    draw = order // nchains
    chain = order - draw * nchains
    boundary = d * (niter + 1)
    in_first = draw < boundary
    k = jnp.where(
        in_first,
        draw // (niter + 1),
        jnp.where(niter > 0, (draw - boundary) // max(niter, 1) + d, 0),
    )
    valid = jnp.where(in_first, draw % (niter + 1) < niter, True)
    seg = chain * split + k.astype(order.dtype)
    return seg.astype(jnp.int32), valid


@partial(jax.jit, static_argnames=("nseg", "tile"))
def weighted_segment_moments(values, seg, valid, *, nseg: int, tile: int = 4096):
    """Per-segment sum and sum-of-squares: ``(sum, sumsq)`` each (nseg, P).

    ``values``/``seg``/``valid``: (N, P); segments differ per column. Row
    tiles keep the one-hot block (tile, P, nseg) bounded; XLA fuses the
    compare into the contraction.
    """
    n, p = values.shape
    npad = (-n) % tile
    if npad:
        values = jnp.pad(values, ((0, npad), (0, 0)))
        seg = jnp.pad(seg, ((0, npad), (0, 0)))
        valid = jnp.pad(valid, ((0, npad), (0, 0)))
    nt = values.shape[0] // tile
    v = values.reshape(nt, tile, p)
    s = seg.reshape(nt, tile, p)
    ok = valid.reshape(nt, tile, p)
    ks = jnp.arange(nseg, dtype=seg.dtype)

    def one(args):
        vt, st, okt = args
        onehot = ((st[:, :, None] == ks[None, None, :]) & okt[:, :, None]).astype(
            vt.dtype
        )
        a = jnp.einsum("np,nps->sp", vt, onehot, precision=_HIGHEST)
        b = jnp.einsum("np,nps->sp", vt * vt, onehot, precision=_HIGHEST)
        return a, b

    a, b = jax.lax.map(one, (v, s, ok))
    return a.sum(0), b.sum(0)


def split_chain_stats_from_sorted(
    values_sorted, order_sorted, ndraws: int, nchains: int, split: int
):
    """ChainStats of ``values`` routed back to (draws, chains) — without
    moving them back to original rows.

    ``values_sorted``: (N, P) transformed values in any order; ``order_sorted``:
    (N, P) the flat original position of each value. Numerically equivalent to
    ``chain_stats(split_chains_reshape(values_in_original_order, split))`` up
    to summation order (sum-of-squares vs two-pass variance).

    Degeneracy (all-identical slice -> NaN R-hat) must be flagged by the
    caller on ``ChainStats.degenerate`` semantics; here it is detected from
    the value range like the fused kernel (min == max).
    """
    from .moments import stats_from_chain_moments

    niter = ndraws // split
    seg, valid = split_chain_ids_from_flat(order_sorted, ndraws, nchains, split)
    ssum, ssq = weighted_segment_moments(
        values_sorted, seg, valid, nseg=nchains * split
    )
    chain_mean = ssum / niter
    chain_var = (ssq - niter * chain_mean * chain_mean) / (niter - 1)
    vmin = jnp.min(jnp.where(valid, values_sorted, jnp.inf), axis=0)
    vmax = jnp.max(jnp.where(valid, values_sorted, -jnp.inf), axis=0)
    degenerate = vmin == vmax
    return stats_from_chain_moments(chain_mean, chain_var, niter, degenerate)
