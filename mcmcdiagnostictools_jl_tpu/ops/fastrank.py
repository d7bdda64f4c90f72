"""Histogram/CDF rank transform — the f32 fast mode (``rank_mode="fast"``).

The exact rank pipeline (ops/ranknorm.py) is sort-bound: the key sort and
the fold sort dominate the rank-kind wall. Fast mode replaces
BOTH sorts with a fixed-width histogram CDF:

1. per-column ``[lo, hi]`` from one min/max pass;
2. per-column bin counts, within-bin first moments and within-bin position
   range over ``nbins`` equal-width bins — one scatter pass (integer
   counts, so they are exact and independent of summation order);
3. exclusive prefix ``C[k]`` = elements in bins below ``k``;
4. per element, the **mean-anchored interpolated rank**

       rank = C[b] + cnt[b] * clip(frac - fm[b] + 1/2, 0, 1) + 1/2

   where ``frac`` is the element's position inside its bin and ``fm[b]`` the
   bin's mean position, read with one gather of the per-bin tables. Then the
   same Blom ``(r - 3/8)/(n + 1/4)`` + ``ndtri`` transform as the exact path
   (reference semantics: src/utils.jl:169-193).

Anchoring the within-bin CDF at the bin mean (instead of assuming a uniform
spread) makes *point masses exact*: a tied group occupies one bin with
``frac == fm``, so every member gets ``C[b] + cnt[b]/2 + 1/2`` — precisely
StatsBase.tiedrank's tied-average — regardless of where in the bin the value
sits. ``fm`` is clamped to the frac range of the bin's smallest and largest
member, so a pure bin's anchor equals its members' ``frac`` bit for bit
whatever order the frac sum was accumulated in; quantiles that land in a
pure bin return the member value itself, so the fold transform's median is
exact on discrete draws too. Singleton bins are exact for the same reason. A
uniform-filled bin has ``fm ~= 1/2`` and the formula degrades gracefully to
plain linear interpolation. No sort, no inverse permutation: elements are
transformed in place, so the (draw, chain) order never leaves the array and
the tail kind's fold transform needs no routing.

Error bound (tested in tests/test_fastrank.py): exact ties share a bin and
map to identical z. Within bin ``b`` both the exact tied ranks and the
mean-anchored rank lie in ``[C[b] + 1/2, C[b] + cnt[b] + 1/2]``, hence

    |rank_fast - rank_exact| <= cnt[b]          (worst case, mixed bins)
    rank_fast == rank_exact (+ f32 rounding)    (pure / singleton bins)

i.e. a quantile error ``<= max-mixed-bin occupancy / n``. For a continuous
sample with density bounded by ``f_max`` the expected occupancy is
``n * f_max * (hi-lo) / nbins``; at the default ``nbins=4096`` on a standard
normal sample ESS/R-hat move by <0.1% (pinned empirically). Ranks are weakly
monotone in the value: bin ``b``'s ranks stay <= ``C[b+1] + 1/2`` <= bin
``b+1``'s.

Distributed: the histogram moments are one ``psum`` over the chain axis (the
per-shard counts add), turning the rank transform's communication from the
ring's ``k-1`` rounds of 2N-row sorts into a single ``(nbins, P_local)``
reduction — parallel/sharded.py ``rank_impl="hist"``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri

DEFAULT_NBINS = 4096


class HistCDF(NamedTuple):
    """Per-column histogram CDF over ``nbins`` equal-width bins.

    ``cum``:  (nbins+1, P) prefix counts; ``cum[k]`` = elements in bins
              ``< k`` (``cum[0] = 0``, ``cum[nbins] = n``).
    ``fm``:   (nbins, P) mean within-bin position in [0, 1], clamped to the
              bin's observed frac range (1/2 for empty bins) — the
              interpolation anchor.
    ``lo``/``hi``: (P,) bin-range endpoints (degenerate columns: lo == hi).
    ``n``:    total element count (the GLOBAL count in the sharded case).
    ``bad``:  (P,) NaN-poisoned columns.
    ``point``: (nbins, P) the common value of a bin whose members are all
              equal (a point mass or a singleton), NaN elsewhere.
    """

    cum: jnp.ndarray
    fm: jnp.ndarray
    lo: jnp.ndarray
    hi: jnp.ndarray
    n: int
    bad: jnp.ndarray
    point: jnp.ndarray

    @property
    def counts(self):
        return self.cum[1:] - self.cum[:-1]


def column_minmax(xf):
    """Per-column (lo, hi, bad) with NaNs ignored for the range.

    NaN columns are poisoned downstream via ``bad``; their range falls back
    to [0, 1] so bin arithmetic stays finite.
    """
    bad = jnp.any(jnp.isnan(xf), axis=0)
    lo = jnp.min(jnp.where(jnp.isnan(xf), jnp.inf, xf), axis=0)
    hi = jnp.max(jnp.where(jnp.isnan(xf), -jnp.inf, xf), axis=0)
    ok = jnp.isfinite(lo) & jnp.isfinite(hi)
    lo = jnp.where(ok, lo, 0.0)
    hi = jnp.where(ok, hi, 1.0)
    return lo, hi, bad


def _bin_coords(xf, lo, hi, nbins: int):
    """Continuous bin coordinate ``s`` in [0, nbins]: integer part = bin,
    fractional part = within-bin position. Elements exactly at ``hi`` land
    in the last bin with frac 1; NaNs map to bin 0 (their columns are
    poisoned by the caller).

    The coordinate arithmetic runs in at least f32: a bf16/f16 ``s`` (values
    up to ``nbins`` with 8 mantissa bits) would quantize the bin index to
    ~16-bin granularity and silently void the documented occupancy/n bound.
    """
    ct = jnp.promote_types(xf.dtype, jnp.float32)
    lo = lo.astype(ct)
    width = hi.astype(ct) - lo
    scale = jnp.where(width > 0, nbins / width, 0.0)
    s = (jnp.nan_to_num(xf).astype(ct) - lo[None]) * scale[None]
    s = jnp.clip(s, 0.0, float(nbins))
    b = jnp.clip(s.astype(jnp.int32), 0, nbins - 1)
    return b, s - b.astype(s.dtype)


def histogram_moments(xf, b, frac, nbins: int):
    """Per-column bin statistics of an (N, P) sample with bins ``b`` and
    within-bin positions ``frac`` (``_bin_coords``).

    Returns ``(cnt, s1, vmin, vmax)``, each (nbins, P): int32 counts, the
    sum of ``frac``, and the smallest and largest member value (+inf / -inf
    for empty bins). One scatter per statistic; the counts are integers, so
    they are exact for any n and any order of accumulation.
    """
    p = b.shape[1]
    v = jnp.nan_to_num(xf).astype(frac.dtype)
    cols = jax.lax.broadcasted_iota(jnp.int32, b.shape, 1)
    cnt = jnp.zeros((nbins, p), jnp.int32).at[b, cols].add(1)
    s1 = jnp.zeros((nbins, p), frac.dtype).at[b, cols].add(frac)
    vmin = jnp.full((nbins, p), jnp.inf, frac.dtype).at[b, cols].min(v)
    vmax = jnp.full((nbins, p), -jnp.inf, frac.dtype).at[b, cols].max(v)
    return cnt, s1, vmin, vmax


def lookup_bins(b, tables):
    """Per-element lookup of stacked (nbins, P, W) tables at (N, P) bins.

    Returns (W, N, P): one gather of W-wide rows.
    """
    cols = jax.lax.broadcasted_iota(jnp.int32, b.shape, 1)
    return jnp.moveaxis(tables[b, cols], -1, 0)


def build_hist_cdf(xf, nbins: int = DEFAULT_NBINS, minmax=None,
                   psum_axis: str | None = None, n_global=None):
    """Histogram CDF of a flat (N, P) sample.

    One min/max pass + one scatter pass + an O(nbins) prefix sum.
    ``psum_axis``: inside ``shard_map``, reduce the bin statistics over that
    mesh axis — the entire communication cost of the distributed rank
    transform (``minmax`` must then be the global (lo, hi, bad), and
    ``n_global`` the global element count).
    """
    if minmax is not None:
        lo, hi, bad = minmax
    else:
        lo, hi, bad = column_minmax(xf)
    b, frac = _bin_coords(xf, lo, hi, nbins)
    cnt, s1, vmin, vmax = histogram_moments(xf, b, frac, nbins)
    n = xf.shape[0]
    if psum_axis is not None:
        cnt, s1 = jax.lax.psum((cnt, s1), psum_axis)
        vmin = jax.lax.pmin(vmin, psum_axis)
        vmax = jax.lax.pmax(vmax, psum_axis)
        n = n_global if n_global is not None else n * jax.lax.psum(1, psum_axis)
    occupied = cnt > 0
    # the frac of the bin's extreme members, by the same arithmetic that
    # placed them: bitwise equal to their own frac
    _, fmin = _bin_coords(jnp.where(occupied, vmin, 0.0), lo, hi, nbins)
    _, fmax = _bin_coords(jnp.where(occupied, vmax, 0.0), lo, hi, nbins)
    fm = jnp.clip(s1 / jnp.maximum(cnt, 1).astype(s1.dtype), fmin, fmax)
    fm = jnp.where(occupied, fm, 0.5)
    point = jnp.where(occupied & (vmin == vmax), vmin, jnp.nan)
    cum = jnp.pad(jnp.cumsum(cnt, axis=0), ((1, 0), (0, 0)))
    return HistCDF(cum.astype(s1.dtype), fm, lo, hi, n, bad, point)


def interpolated_ranks(xf, cdf: HistCDF, nbins: int):
    """Per-element mean-anchored rank in [1/2, n + 1/2], original order.

    Degenerate (constant) columns get the exact tied rank ``(n+1)/2``.
    """
    cnt = cdf.counts
    tables = jnp.stack([cdf.cum[:-1], cnt, cnt * (0.5 - cdf.fm)], axis=-1)
    b, frac = _bin_coords(xf, cdf.lo, cdf.hi, nbins)
    c_lo, cnt_b, off_b = lookup_bins(b, tables)
    g = jnp.clip(frac * cnt_b + off_b, 0.0, cnt_b)
    rank = c_lo + g + 0.5
    degenerate = (cdf.hi <= cdf.lo)[None, :]
    return jnp.where(degenerate, (cdf.n + 1) * 0.5, rank)


def z_from_ranks(rank, n, bad):
    """Blom alpha=3/8 + inverse normal CDF, NaN-poisoned columns masked."""
    z = ndtri((rank - 0.375) / (n + 0.25))
    return jnp.where(bad[None, :], jnp.nan, z)


def hist_rank_value(cdf: HistCDF, h, nbins: int):
    """Value at 1-based (possibly fractional, per-column) rank ``h`` — the
    inverse of the mean-anchored rank map, (P,).

    ``h`` is a scalar or a (P,) array of target ranks in ``[1, n]`` (the
    convention of ``interpolated_ranks``: a singleton at sorted position i
    has rank i, 1-based). The covering bin comes from an O(nbins) comparison
    count (the table is small — no sort, no per-element work), the
    within-bin position from the inverse of the anchored interpolation.
    Error bounded by one bin width; a bin whose members are all equal
    returns their value exactly. Per-column ``h`` is what the MCSE quantile
    path needs: its Beta-interval order statistics depend on the per-column
    ESS (src/mcse.jl:111-117).
    """
    cum = cdf.cum  # (nbins+1, P)
    width = (cdf.hi - cdf.lo) / nbins
    h = jnp.broadcast_to(jnp.asarray(h, cum.dtype), cdf.lo.shape)
    # ranks in bin b span [cum[b] + 1/2, cum[b+1] + 1/2]
    k = jnp.sum((cum + 0.5 <= h[None, :]).astype(jnp.int32), axis=0) - 1
    k = jnp.clip(k, 0, nbins - 1)
    kk = k[None, :]
    c_lo = jnp.take_along_axis(cum, kk, axis=0)[0]
    cnt = jnp.take_along_axis(cdf.counts, kk, axis=0)[0]
    fm = jnp.take_along_axis(cdf.fm, kk, axis=0)[0]
    point = jnp.take_along_axis(cdf.point, kk, axis=0)[0]
    # invert rank = c_lo + clip(frac*cnt + cnt*(1/2 - fm), 0, cnt) + 1/2
    g = jnp.clip(h - 0.5 - c_lo, 0.0, cnt)
    frac = jnp.where(cnt > 0, g / jnp.maximum(cnt, 1.0) + fm - 0.5, 0.5)
    frac = jnp.clip(frac, 0.0, 1.0)
    v = cdf.lo + (k.astype(cum.dtype) + frac) * width
    v = jnp.where(jnp.isnan(point), v, point.astype(v.dtype))
    v = jnp.where(cdf.hi <= cdf.lo, cdf.lo, v)
    return jnp.where(cdf.bad, jnp.nan, v)


def hist_quantile(cdf: HistCDF, ps, nbins: int):
    """Approximate type-7 quantiles from the histogram CDF, (len(ps), P).

    The type-7 order statistic at probability ``p`` sits at 1-based rank
    ``(n-1)p + 1`` (``interpolated_ranks`` emits 1-based tied ranks — a
    singleton gets ``C+1``); each probability is one ``hist_rank_value``
    inversion.
    """
    n = cdf.n
    return jnp.stack(
        [hist_rank_value(cdf, (n - 1) * p + 1.0, nbins) for p in ps], axis=0
    )


def fast_rank_normalize_flat(xf, nbins: int = DEFAULT_NBINS, cdf=None):
    """Histogram rank-normal transform of a flat (N, P) sample, in place.

    Returns ``(z, cdf)`` — ``z`` in ORIGINAL row order (no sort, no inverse
    permutation) and the CDF for quantile reuse (median for the fold
    transform, tail thresholds). Pass a prebuilt ``cdf`` (e.g. one whose
    moments were psummed across shards) to skip the histogram pass.
    """
    if cdf is None:
        cdf = build_hist_cdf(xf, nbins)
    rank = interpolated_ranks(xf, cdf, nbins)
    return z_from_ranks(rank, cdf.n, cdf.bad), cdf


def fast_rank_normalize(x3, nbins: int = DEFAULT_NBINS):
    """Histogram rank-normal transform on canonical (draws, chains, P)."""
    d, c, p = x3.shape
    z, _ = fast_rank_normalize_flat(x3.reshape(d * c, p), nbins)
    return z.reshape(d, c, p)


def _folded_cdf(folded, cdf: HistCDF, med, nbins: int):
    """Histogram CDF of ``|x - med|`` with its range DERIVED from the bulk
    CDF instead of a second min/max pass over the sample: lo = 0 (a valid
    lower bound — at worst the bottom bins sit empty, which only tightens
    occupancy) and hi = max(hi - med, med - lo). Saves a full-sample
    reduction per transform."""
    m = jnp.nan_to_num(med)
    hi_f = jnp.maximum(cdf.hi - m, m - cdf.lo)
    hi_f = jnp.where(hi_f > 0, hi_f, 1.0)
    lo_f = jnp.zeros_like(hi_f)
    # degenerate columns: propagate the bulk degeneracy (hi <= lo) so the
    # tied-rank override still fires
    hi_f = jnp.where(cdf.hi <= cdf.lo, lo_f, hi_f)
    return build_hist_cdf(folded, nbins, minmax=(lo_f, hi_f, cdf.bad))


def fast_rank_bulk_tail(x3, nbins: int = DEFAULT_NBINS):
    """Fused fast-mode transform pair ``(z_bulk, z_tail, med)``.

    The rank kind's two inputs (src/ess_rhat.jl:604-624) with zero sorts:
    the bulk histogram also yields the (approximate) median; the fold
    transform ``|x - med|`` is re-histogrammed (its distribution is not a
    bin-aligned reflection of the original's unless the median sits on a
    bin edge). Both outputs stay in (draw, chain) order.
    """
    d, c, p = x3.shape
    xf = x3.reshape(d * c, p)
    z_bulk, cdf = fast_rank_normalize_flat(xf, nbins)
    med = hist_quantile(cdf, (0.5,), nbins)[0]
    folded = jnp.abs(xf - jnp.nan_to_num(med)[None, :])
    z_tail, _ = fast_rank_normalize_flat(
        folded, nbins, cdf=_folded_cdf(folded, cdf, med, nbins))
    z_tail = jnp.where(cdf.bad[None, :], jnp.nan, z_tail)
    return (
        z_bulk.reshape(d, c, p),
        z_tail.reshape(d, c, p),
        med,
    )
