"""Distributed rank transform — ring merge-count over the chain shards.

The gather-based sharded rank path materializes the full (draws x
chains_total) sample on every device (``sharded.py``), so its HBM footprint
grows with the pod's total chain count. This module computes the exact same
tied-rank statistics with **O(N_local) peak memory**: every device's sorted
block travels the ring once (``ppermute`` over ICI), and each device
accumulates, for every one of its own elements,

- ``cl``  — the exact global count of strictly smaller elements,
- ``ce``  — the exact global count of equal elements (ties), and
- ``eq_before`` — ties held by ring-earlier devices (fixes each copy's
  global sorted position),

from which the reference's tied "average" rank is ``cl + (ce + 1)/2``
(StatsBase.tiedrank semantics, reference src/utils.jl:169-193), the Blom/
``ndtri`` transform is elementwise, and any type-7 quantile is a masked psum
of the elements whose global sorted position hits ``floor((N-1) p)`` /
``floor((N-1) p) + 1`` — no gather anywhere.

Counting a visiting sorted block against the local sorted block is gather-
free: one value sort of the 2N concatenation with a membership marker as
payload, run-boundary cummax/cummin to read off per-run visitor counts, and
one compaction sort to land the counts back on the local elements (ties
share counts, so unstable sorts are safe throughout).

Exactness note: ranks over arbitrary float keys fundamentally require
Omega(N_global) bits of information exchange (the rank function's breakpoints
are the data), so per-device *communication* cannot be independent of the
total chain count for an exact transform; what this module removes is the
O(N_global) **memory** and the redundant full-sample sort per device. Total
ring traffic equals the all_gather's, but it flows in N_local-sized hops that
pipeline over ICI and are consumed streaming.

Numerics: counts are integer-exact (int32), so in float64 parity mode the
ranks, medians and quantiles are bit-identical to the gather path's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri


def _run_bounds(xs):
    """(start, end) int32 indices of each position's equal-value run.

    ``xs``: (M, P) sorted along axis 0. NaNs each form their own run (NaN !=
    NaN), which is harmless — NaN columns are masked downstream.
    """
    m = xs.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, xs.shape, 0)
    neq_prev = xs[1:] != xs[:-1]
    ones = jnp.ones((1, xs.shape[1]), dtype=bool)
    first = jnp.concatenate([ones, neq_prev], axis=0)
    last = jnp.concatenate([neq_prev, ones], axis=0)
    start = jax.lax.cummax(jnp.where(first, idx, 0), axis=0)
    end = jax.lax.cummin(jnp.where(last, idx, m - 1), axis=0, reverse=True)
    return start, end


def _count_block(a_sorted, b_sorted):
    """Per-element visitor counts: ``(nless, neq)`` of B against sorted A.

    ``a_sorted``/``b_sorted``: (N, P) each, sorted along axis 0. Returns for
    every element of ``a_sorted`` (in A-sorted order) the number of B
    elements strictly smaller / exactly equal. One 2-operand value sort of
    the 2N concatenation + run-boundary scans + one compaction sort — no
    searchsorted.
    """
    n, p = a_sorted.shape
    c = jnp.concatenate([a_sorted, b_sorted], axis=0)  # (2N, P)
    marker = jnp.concatenate(
        [jnp.zeros((n, p), jnp.int32), jnp.ones((n, p), jnp.int32)], axis=0
    )
    cs, ms = jax.lax.sort((c, marker), dimension=0, num_keys=1, is_stable=False)
    csb = jnp.cumsum(ms, axis=0)  # inclusive B-count
    csb_excl = csb - ms
    mtot = 2 * n
    idx = jax.lax.broadcasted_iota(jnp.int32, cs.shape, 0)
    neq_prev = cs[1:] != cs[:-1]
    ones = jnp.ones((1, p), dtype=bool)
    first = jnp.concatenate([ones, neq_prev], axis=0)
    last = jnp.concatenate([neq_prev, ones], axis=0)
    # B-count before the run / B-count in the run, broadcast to every member
    before = jax.lax.cummax(jnp.where(first, csb_excl, -1), axis=0)
    at_end = jax.lax.cummin(
        jnp.where(last, csb, mtot + 1), axis=0, reverse=True
    )
    nless = before
    neq = at_end - before
    # compact the A rows (marker 0) back to A-sorted order: single i32 key
    # marker*2N + position keeps relative order; ties in A share counts so
    # any within-run permutation is equivalent
    key = ms * mtot + idx
    _, nless_a, neq_a = jax.lax.sort(
        (key, nless, neq), dimension=0, num_keys=1, is_stable=False
    )
    return nless_a[:n], neq_a[:n]


def ring_rank_counts(xs_loc, axis_name: str, kshards: int):
    """Exact global tie-rank counts of the local sorted block.

    ``xs_loc``: (N_loc, P) local sorted values on each of ``kshards`` chain
    shards. Returns ``(cl, ce, eq_before)`` int32 arrays of the same shape:
    global strictly-smaller count, global tie count, and tie count on
    devices with smaller ring index (for global-position assignment).
    """
    start, end = _run_bounds(xs_loc)
    cl = start
    ce = end - start + 1
    eq_before = jnp.zeros_like(cl)
    if kshards == 1:
        return cl, ce, eq_before
    me = jax.lax.axis_index(axis_name)
    perm = [(j, (j + 1) % kshards) for j in range(kshards)]
    buf = xs_loc
    for t in range(1, kshards):
        buf = jax.lax.ppermute(buf, axis_name, perm)
        src = (me - t) % kshards  # original owner of the visiting block
        nless, neq = _count_block(xs_loc, buf)
        cl = cl + nless
        ce = ce + neq
        eq_before = eq_before + jnp.where(src < me, neq, 0)
    return cl, ce, eq_before


def global_positions(cl, ce, eq_before, xs_loc):
    """0-based global sorted position of every local element copy."""
    start, _ = _run_bounds(xs_loc)
    idx = jax.lax.broadcasted_iota(jnp.int32, xs_loc.shape, 0)
    return cl + eq_before + (idx - start)


def ranks_from_counts(cl, ce, dtype):
    """Tied average 1-based rank: ``cl + (ce + 1)/2`` (StatsBase.tiedrank)."""
    return cl.astype(dtype) + (ce.astype(dtype) + 1.0) * 0.5


def rank_normal_from_counts(cl, ce, ntotal: int, dtype):
    """Blom alpha=3/8 + inverse normal CDF of the tied ranks
    (reference src/utils.jl:189-193)."""
    r = ranks_from_counts(cl, ce, dtype)
    return ndtri((r - 0.375) / (ntotal + 0.25))


def quantiles_from_positions(xs_loc, gpos, ntotal: int, ps, axis_name: str):
    """Exact type-7 quantiles of the global sample — one psum, no gather.

    ``gpos``: global positions from :func:`global_positions`. ``ps``: static
    tuple of probabilities. Returns (len(ps), P): each quantile interpolates
    the order statistics at ``floor((N-1)p)`` and ``+1``, which exactly one
    device contributes per parameter (psum-combined).
    """
    outs = []
    for prob in ps:
        h = (ntotal - 1) * float(prob)
        lo = min(int(h), ntotal - 1)
        hi = min(lo + 1, ntotal - 1)
        g = h - lo
        vlo = jnp.sum(jnp.where(gpos == lo, xs_loc, 0.0), axis=0)
        vhi = jnp.sum(jnp.where(gpos == hi, xs_loc, 0.0), axis=0)
        outs.append((vlo, vhi, g))
    stacked_lo = jax.lax.psum(
        jnp.stack([o[0] for o in outs]), axis_name
    )
    stacked_hi = jax.lax.psum(
        jnp.stack([o[1] for o in outs]), axis_name
    )
    gs = jnp.asarray([o[2] for o in outs], dtype=xs_loc.dtype)[:, None]
    return stacked_lo + gs * (stacked_hi - stacked_lo)
