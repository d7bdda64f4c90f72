"""Batched rank/quantile transforms — the sort-based kernel family.

All functions operate on the canonical ``(draws, chains, P)`` layout and are
batched over the parameter axis with a single XLA sort (no per-parameter
loops). They reproduce the reference's numeric conventions exactly:

- tied ranking ("average" method) over the joint draws x chains sample
  (reference src/utils.jl:169-193, StatsBase.tiedrank),
- the Blom alpha=3/8 transform ``(r - 3/8) / (n + 1/4)`` (src/utils.jl:189-193),
- the normal quantile via ``ndtri``,
- type-7 (linear-interpolation) quantiles matching ``Statistics.quantile``,
- folding around the per-parameter median (src/utils.jl:148-158).

NaN semantics: any NaN inside a parameter slice poisons that slice's output
(the JAX analogue of the reference's ``missing`` handling,
src/utils.jl:175-179).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri


def _sort_pair(keys, payload):
    """Ascending unstable sort along axis 0 carrying a payload.

    Unstable is safe here because tied ranks are averaged.
    """
    return jax.lax.sort((keys, payload), dimension=0, num_keys=1, is_stable=False)


def _unpermute(order, values):
    """Route ``values`` back to original rows: ``out[order[j], p] =
    values[j, p]`` for a per-column permutation ``order`` — the inverse of
    a payload sort, as one scatter with unique indices. (As a second sort
    keyed on ``order``, XLA:GPU's permutation-sort rewrite produced an
    invalid scatter inside ``shard_map``.)"""
    cols = jax.lax.broadcasted_iota(jnp.int32, order.shape, 1)
    return jnp.zeros_like(values).at[order, cols].set(
        values, unique_indices=True)


def _flatten_sample(x3):
    """(draws, chains, P) -> (draws*chains, P)."""
    d, c, p = x3.shape
    return x3.reshape(d * c, p)


def _has_nan_cols(xf):
    """(N, P) -> (P,) bool, True where the column contains a NaN."""
    return jnp.any(jnp.isnan(xf), axis=0)


def tiedrank(xf):
    """Tied ("average") 1-based ranks along axis 0 of ``xf`` with shape (N, P).

    Equal values receive the average of the ranks they would occupy. Matches
    StatsBase.tiedrank used by the reference (src/utils.jl:180).

    One payload-carrying sort and one scatter back to the original rows,
    fully batched over P. Unstable sorts are safe: tied
    ranks are averaged.
    """
    iota = jax.lax.broadcasted_iota(jnp.int32, xf.shape, 0)
    xs, order = _sort_pair(xf, iota)
    return _tiedrank_sorted(xs, order)


def _avg_ranks_sorted(xs):
    """Tied ("average") 1-based ranks of presorted values, in SORTED order.

    Equal-value runs get the mean of their positions: start/end of each run
    via cummax/cummin over run-boundary markers — no segment loop.
    """
    n = xs.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, xs.shape, 0)
    neq_prev = xs[1:] != xs[:-1]
    first_of_group = jnp.concatenate(
        [jnp.ones((1, xs.shape[1]), dtype=bool), neq_prev], axis=0
    )
    last_of_group = jnp.concatenate(
        [neq_prev, jnp.ones((1, xs.shape[1]), dtype=bool)], axis=0
    )
    start = jax.lax.cummax(jnp.where(first_of_group, idx, 0), axis=0)
    end = jax.lax.cummin(jnp.where(last_of_group, idx, n - 1), axis=0, reverse=True)
    return (start + end).astype(xs.dtype) * 0.5 + 1.0


def _tiedrank_sorted(xs, order):
    """Ranks in original positions from a presorted (values, permutation) pair."""
    avg_rank_sorted = _avg_ranks_sorted(xs)
    return _unpermute(order, avg_rank_sorted)


def rank_normalize_folded_sorted(xs, order, med):
    """Rank-normalize ``|x - med|`` reusing the (xs, order) sort of ``x``.

    ``xs``/``order``: ascending values and the original-position permutation
    from the bulk transform's sort; ``med``: (P,) per-column median. Returns
    the rank-normalized folded sample in ORIGINAL row order, shape of ``xs``
    — numerically identical to ``rank_normalize(|x - med|)``.

    Although the folded values form a valley in xs-order (sortable by one
    bitonic merge), a merge written stage by stage in XLA does not fuse, so
    this uses a plain payload sort. The payload is ``order`` so one scatter
    lands the result directly in original row order.
    """
    n = xs.shape[0]
    folded = jnp.abs(xs - med[None, :])
    fs, forder = _sort_pair(folded, order)
    ranks_sorted = _avg_ranks_sorted(fs)
    z = _unpermute(forder, ndtri((ranks_sorted - 0.375) / (n + 0.25)))
    bad = _has_nan_cols(xs)[None, :]
    return jnp.where(bad, jnp.nan, z)


# Fold-sort decomposition block length: the valley two-sort reshapes the
# flattened sample to (ceil(N/S), S) and sorts each axis once.
_VALLEY_BLOCK = 8192


def valley_sort_2d(keys, payload, s: int = _VALLEY_BLOCK):
    """Sort a per-column *valley* (circularly bitonic) sequence with payload.

    ``keys``: (N, P) per-column valleys — the shape of ``|xs - med|`` when
    ``xs`` is sorted (fold transform, reference src/utils.jl:148-158 applied
    to a sorted sample). A bitonic sequence needs only a log-depth bitonic
    merge, not a full sort; expressed stage-by-stage at the XLA level the
    merge does not fuse, but it DECOMPOSES into two batched small-axis
    sorts:

    view the (virtually inf-padded) sequence as ``(M, S)`` with flat index
    ``i = m * S + low``. Every m-column (fixed ``low``) is a subsequence of a
    valley, hence bitonic, and the high bitonic-merge stages (distance >= S)
    form a complete bitonic merge of each m-column — i.e. they SORT each
    m-column. After that, the standard bitonic-merge recursion invariant
    says each contiguous S-block is bitonic with blocks ordered, so sorting
    within blocks (axis 1) completes the global sort. Two ``lax.sort`` calls
    over short axes replace one deep full sort, keys bit-identical (same
    NaN-last total order, exact ties). ``fold_impl="merge"`` selects it;
    whether ``"auto"`` does is a measurement (PERF.md "H100 bring-up").
    """
    n, p = keys.shape
    m = -(-n // s)
    npad = m * s - n
    if npad:
        # NaN pads sort after EVERYTHING in the lax.sort total order
        # (-NaN < -inf < finite < +inf < NaN), so the final [:n] slice cuts
        # exactly the pad rows — +inf data keeps its payload, and NaN-bearing
        # columns (masked downstream) still land their NaNs last.
        keys = jnp.pad(keys, ((0, npad), (0, 0)), constant_values=jnp.nan)
        payload = jnp.pad(payload, ((0, npad), (0, 0)))
    k3 = keys.reshape(m, s, p)
    p3 = payload.reshape(m, s, p)
    k3, p3 = jax.lax.sort((k3, p3), dimension=0, num_keys=1, is_stable=False)
    k3, p3 = jax.lax.sort((k3, p3), dimension=1, num_keys=1, is_stable=False)
    return k3.reshape(-1, p)[:n], p3.reshape(-1, p)[:n]


def folded_rank_values_sorted(xs, order, med, *, merge: str | None = None):
    """Rank-normalized folded values in FOLD-SORTED order, with positions.

    ``xs``/``order``: the bulk transform's sort of ``x``; ``med``: (P,)
    medians. Returns ``(zf_sorted, forder)`` — ``zf_sorted[j]`` is the
    rank-normal transform of the j-th smallest ``|x - med|`` and ``forder[j]``
    its original flat row. Same values as ``rank_normalize_folded_sorted``
    but WITHOUT routing back to original rows: callers that only need order-free
    reductions of the folded transform (tail R-hat's split-chain moments,
    ops/seghist.py) skip that scatter.

    ``merge``: ``None`` uses a plain payload ``lax.sort``; ``"two_sort"``
    sorts the folded valley with the two-axis bitonic-merge decomposition
    (:func:`valley_sort_2d`) — bit-identical keys, tie order free (tied
    ranks are averaged downstream).
    """
    n = xs.shape[0]
    folded = jnp.abs(xs - med[None, :])
    if merge == "two_sort":
        fs, forder = valley_sort_2d(folded, order)
    else:
        fs, forder = _sort_pair(folded, order)
    zf_sorted = ndtri((_avg_ranks_sorted(fs) - 0.375) / (n + 0.25))
    return zf_sorted, forder


def rank_normalize_from_sort(xs, order, bad):
    """Rank-normalize from a presorted (values, positions) pair.

    Returns the flat (N, P) rank-normal sample in original row order — the
    bulk transform given ``sort_with_positions`` output (one scatter).
    """
    n = xs.shape[0]
    zb_sorted = ndtri((_avg_ranks_sorted(xs) - 0.375) / (n + 0.25))
    zb = _unpermute(order, zb_sorted)
    return jnp.where(bad[None, :], jnp.nan, zb)


def rank_normalize(x3):
    """Rank-normalize each parameter slice over its joint (draw, chain) sample.

    tiedrank -> Blom quantiles ``(r - 3/8) / (n + 1/4)`` -> inverse normal CDF.
    Reference: ``_rank_normalize`` src/utils.jl:169-193. NaN in a slice yields
    an all-NaN slice (mirrors the all-missing rule, src/utils.jl:176-179).
    """
    return rank_normalize_with_median(x3)[0]


def rank_normalize_with_median(x3):
    """Rank-normalize and return the per-parameter median from the same sort.

    The rank/tail kinds need both the rank transform of ``x`` and its median
    (for folding); sharing the sort saves one full O(N log N) pass — sorts are
    the dominant cost of the exact rank pipeline.
    """
    d, c, p = x3.shape
    xf = _flatten_sample(x3)
    n = xf.shape[0]
    with jax.named_scope("mdt.rank_sort"):
        iota = jax.lax.broadcasted_iota(jnp.int32, xf.shape, 0)
        xs, order = _sort_pair(xf, iota)
        r = _tiedrank_sorted(xs, order)
    q = (r - 0.375) / (n + 0.25)
    z = ndtri(q)
    bad = _has_nan_cols(xf)[None, :]
    z = jnp.where(bad, jnp.nan, z)
    med = jnp.where(bad[0], jnp.nan, sorted_quantile(xs, 0.5))
    return z.reshape(d, c, p), med


def sort_with_positions(x3):
    """One payload sort of the flattened sample: ``(xs, order, bad)``.

    ``xs``: ascending values (N, P); ``order``: original row of each sorted
    value; ``bad``: (P,) NaN-poisoned columns. The shared entry point for
    every transform that can reuse a single sort (rank/tail kinds, quantile
    thresholds, medians).
    """
    xf = _flatten_sample(x3)
    iota = jax.lax.broadcasted_iota(jnp.int32, xf.shape, 0)
    xs, order = _sort_pair(xf, iota)
    return xs, order, _has_nan_cols(xf)


def rank_bulk_tail_transforms(x3):
    """Fused rank-kind transform pair: ``(z_bulk, z_tail, med)``.

    ``z_bulk`` = rank-normalized ``x`` and ``z_tail`` = rank-normalized
    ``|x - median|`` — the two inputs of the ``:rank`` kind
    (src/ess_rhat.jl:604-624) — sharing one key sort: the median and the bulk
    ranks are read off the sorted values, and the fold transform reuses the
    (values, positions) pair.

    Two plain sorts (the key sort and the folded-value sort), each routed
    back to original rows by one scatter, and no stage-by-stage merge
    (whose stages do not fuse). The median is read off the first sort for
    free. Numerically identical to
    transforming independently.
    """
    d, c, p = x3.shape
    with jax.named_scope("mdt.rank_sort"):
        xs, order, bad = sort_with_positions(x3)
    n = xs.shape[0]
    zb_sorted = ndtri((_avg_ranks_sorted(xs) - 0.375) / (n + 0.25))
    med = jnp.where(bad, jnp.nan, sorted_quantile(xs, 0.5))
    with jax.named_scope("mdt.rank_inverse"):
        zb = _unpermute(order, zb_sorted)
    with jax.named_scope("mdt.fold_sort"):
        zf = rank_normalize_folded_sorted(xs, order, med)
    z = jnp.where(bad[None, :], jnp.nan, zb)
    return z.reshape(d, c, p), zf.reshape(d, c, p), med


def sorted_quantile(xs, p):
    """Type-7 quantile from presorted values ``xs`` of shape (N, P).

    ``h = (N-1) p``; linear interpolation between ``xs[floor(h)]`` and
    ``xs[floor(h)+1]`` — identical to Julia ``Statistics.quantile`` and
    ``numpy.quantile(method="linear")``.
    """
    n = xs.shape[0]
    h = (n - 1) * jnp.asarray(p, dtype=xs.dtype)
    lo = jnp.clip(jnp.floor(h).astype(jnp.int32), 0, n - 1)
    hi = jnp.clip(lo + 1, 0, n - 1)
    g = h - lo.astype(xs.dtype)
    xlo = xs[lo]
    xhi = xs[hi]
    return xlo + g * (xhi - xlo)


def batched_quantile(x3, p):
    """Per-parameter type-7 quantile over the joint (draw, chain) sample.

    Returns shape (P,). NaN-poisoned per parameter slice.
    """
    xf = _flatten_sample(x3)
    (xs,) = jax.lax.sort((xf,), dimension=0, num_keys=1, is_stable=False)
    q = sorted_quantile(xs, p)
    return jnp.where(_has_nan_cols(xf), jnp.nan, q)


def batched_median(x3):
    """Per-parameter median (type-7 quantile at p=0.5), shape (P,)."""
    return batched_quantile(x3, 0.5)


def fold_around_median(x3):
    """``abs(x - median(x_param))`` per parameter slice.

    Reference: ``_fold_around_median`` src/utils.jl:148-158.
    """
    med = batched_median(x3)
    return jnp.abs(x3 - med[None, None, :])
