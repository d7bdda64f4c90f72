"""shard_map'ed diagnostics over a (chains, params) mesh.

The single-device pipeline in ``diagnostics.ess_rhat`` is re-expressed here
with explicit collectives (SURVEY.md section 5):

- cross-chain scalar statistics (W, var_plus, B) — two psums over the chain
  axis of per-chain partial sums (numerically two-pass: grand mean first,
  then centered second moments);
- the mean autocovariance curve — one psum of the local-chain
  ``(maxlag+1, P_local)`` block;
- the sort-based transforms (rank-normalize, fold, quantile proxies) need the
  global per-parameter sample, obtained with one all_gather over the chain
  axis; each device then slices its own chains back out, so FFT work stays
  with the chain owners. (A fully distributed sort is the planned
  optimization; the all_gather is exact.)

The single-device path is the K=1 special case of the same code — no forked
logic; parity with ``diagnostics.ess_rhat`` is asserted in tests on a virtual
8-device CPU mesh.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..diagnostics.ess_rhat import ESSRhat, _method_name
from ..ops.autocov import mean_autocov_curve
from ..ops.fastrank import (
    DEFAULT_NBINS,
    build_hist_cdf,
    fast_rank_normalize_flat,
    hist_quantile,
)
from ..ops.geyer import geyer_ess_from_rho
from ..ops.ranknorm import (
    _unpermute,
    folded_rank_values_sorted,
    rank_normalize,
    rank_normalize_from_sort,
    sort_with_positions,
    sorted_quantile,
    batched_quantile,
    _has_nan_cols,
)
from ..ops.seghist import (
    split_chain_ids_from_flat,
    split_chain_stats_from_sorted,
    weighted_segment_moments,
)
from ..utils.layout import canonicalize, maybe_scalar
from ..utils.split import split_chains_reshape
from .mesh import MeshConfig, shard_canonical
from .ring_rank import (
    global_positions,
    quantiles_from_positions,
    rank_normal_from_counts,
    ring_rank_counts,
)


def _my_chain_slice(gathered, local_chains: int, axis_name: str):
    """Slice this device's chain block back out of an all_gathered array."""
    idx = jax.lax.axis_index(axis_name)
    return jax.lax.dynamic_slice_in_dim(
        gathered, idx * local_chains, local_chains, axis=1
    )


def _sharded_moments(samples, chain_axis: str):
    """Cross-chain W / var_plus / rhat via psums. samples: local (niter, c, P)."""
    niter, c_loc, _ = samples.shape
    kshards = jax.lax.psum(1, chain_axis)
    nchains = c_loc * kshards

    chain_mean = jnp.mean(samples, axis=0)  # (c, P)
    centered = samples - chain_mean[None]
    chain_var = jnp.sum(centered * centered, axis=0) / (niter - 1)
    w = jax.lax.psum(jnp.sum(chain_var, axis=0), chain_axis) / nchains

    grand = jax.lax.psum(jnp.sum(chain_mean, axis=0), chain_axis) / nchains
    dm = chain_mean - grand[None]
    if nchains > 1:
        between = jax.lax.psum(jnp.sum(dm * dm, axis=0), chain_axis) / (nchains - 1)
    else:
        between = jnp.zeros_like(grand)
    var_plus = (niter - 1) / niter * w + between

    # degenerate (all-identical) slices -> NaN, across every shard
    first = samples[0, 0]
    loc_same = jnp.all(samples == first[None, None], axis=(0, 1))
    glob_same = (
        (jax.lax.pmin(jnp.where(loc_same, 1, 0), chain_axis) == 1)
        & (jax.lax.pmax(first, chain_axis) == jax.lax.pmin(first, chain_axis))
    )
    var_plus = jnp.where(glob_same, jnp.nan, var_plus)
    rhat = jnp.sqrt(var_plus / w)
    return chain_mean, chain_var, centered, w, var_plus, rhat, nchains


def _sharded_basic(xb, *, split_chains, maxlag, method, relative, chain_axis):
    """Basic ESS + R-hat on this device's chain/param block with collectives."""
    samples = split_chains_reshape(xb, split_chains)
    niter = samples.shape[0]
    c_loc = samples.shape[1]
    (chain_mean, chain_var, centered, w, var_plus, rhat, nchains) = _sharded_moments(
        samples, chain_axis
    )
    ntotal = niter * nchains
    acov_local = mean_autocov_curve(centered, chain_var, maxlag, method)  # (L+1, Ploc)
    acov = jax.lax.psum(acov_local * c_loc, chain_axis) / nchains
    rho = 1.0 - (w[None] - acov) / var_plus[None]
    ess = geyer_ess_from_rho(rho, ntotal, relative)
    return ess, rhat


def _global_transform(xb, transform, chain_axis: str):
    """Apply a global-sample transform via all_gather + slice-back."""
    c_loc = xb.shape[1]
    full = jax.lax.all_gather(xb, chain_axis, axis=1, tiled=True)
    return _my_chain_slice(transform(full), c_loc, chain_axis)


def _global_rank_parts(xb, chain_axis: str, split_chains: int = 2):
    """One all_gather + one payload sort: the rank-kind ingredients.

    Returns ``(z_local, tail_rhat, bad)`` — the local chain block of
    ``rank_normalize(x)`` plus the tail R-hat. The tail side never routes
    values back to (draw, chain) order: the folded rank-normal split-chain
    moments come off the fold sort via the weighted one-hot histogram
    (ops/seghist.py), computed identically on every chain shard from the
    replicated gathered sample (zero extra collectives).
    """
    c_loc = xb.shape[1]
    full = jax.lax.all_gather(xb, chain_axis, axis=1, tiled=True)
    xs, order, bad = sort_with_positions(full)
    med = jnp.where(bad, jnp.nan, sorted_quantile(xs, 0.5))
    z = rank_normalize_from_sort(xs, order, bad).reshape(full.shape)
    tail_rhat = _tail_rhat_full(xs, order, med, bad, full.shape, split_chains,
                                chain_axis)
    return _my_chain_slice(z, c_loc, chain_axis), tail_rhat, bad


def _replicated_pmax(values, chain_axis: str):
    """Replication certificate for bitwise-identical per-shard values.

    ``lax.pmax``'s all-reduce combiner does NOT propagate NaN (max(NaN, x)
    inits from -inf, so an all-NaN input comes back -inf) — NaN columns are
    carried through a sentinel instead.
    """
    isnan = jnp.isnan(values)
    safe = jax.lax.pmax(jnp.where(isnan, -jnp.inf, values), chain_axis)
    nan_any = jax.lax.pmax(isnan.astype(jnp.int32), chain_axis) > 0
    return jnp.where(nan_any, jnp.nan, safe)


def _tail_rhat_full(xs, order, med, bad, full_shape, split_chains, chain_axis):
    d, c, _ = full_shape
    zf_sorted, forder = folded_rank_values_sorted(xs, order, med)
    stats = split_chain_stats_from_sorted(zf_sorted, forder, d, c, split_chains)
    rhat = jnp.where(bad, jnp.nan, stats.rhat)
    # computed identically on every chain shard from the gathered sample; the
    # pmax is a replication certificate for shard_map's out_spec check, not a
    # reduction (all operands are bitwise equal)
    return _replicated_pmax(rhat, chain_axis)


# ---------------------------------------------------------------------------
# ring-mode rank kinds (gather-free; parallel/ring_rank.py)
# ---------------------------------------------------------------------------


def _sort_pair(keys, payload):
    return jax.lax.sort(
        (keys, payload), dimension=0, num_keys=1, is_stable=False
    )


def _ring_rank_parts(xb, chain_axis: str, kshards: int, quantile_ps):
    """One local sort + one ring pass: the rank-kind ingredients, gather-free.

    Returns ``(xs, order, z_sorted, quants, bad)`` — local sorted values,
    their local flat positions, the rank-normal transform in local sorted
    order, the requested global type-7 quantiles (len(ps), P), and the
    NaN-poisoned column mask. Exact tied ranks via the ring merge-count
    (O(N_local) memory; reference semantics src/utils.jl:169-193).
    """
    d, c_loc, p = xb.shape
    xf = xb.reshape(d * c_loc, p)
    iota = jax.lax.broadcasted_iota(jnp.int32, xf.shape, 0)
    xs, order = _sort_pair(xf, iota)
    bad_loc = jnp.any(jnp.isnan(xf), axis=0)
    bad = jax.lax.pmax(bad_loc.astype(jnp.int32), chain_axis) > 0
    cl, ce, eqb = ring_rank_counts(xs, chain_axis, kshards)
    ntot = d * c_loc * kshards
    z_sorted = rank_normal_from_counts(cl, ce, ntot, xs.dtype)
    gpos = global_positions(cl, ce, eqb, xs)
    quants = quantiles_from_positions(xs, gpos, ntot, quantile_ps, chain_axis)
    quants = jnp.where(bad[None, :], jnp.nan, quants)
    return xs, order, z_sorted, quants, bad


def _rhat_from_local_chain_moments(chain_mean, chain_var, niter: int,
                                   vmin, vmax, chain_axis: str):
    """Basic split R-hat from per-shard split-chain moments (psum algebra of
    ``stats_from_chain_moments``; degenerate slices via global min == max)."""
    c_loc = chain_mean.shape[0]
    kshards = jax.lax.psum(1, chain_axis)
    nchains = c_loc * kshards
    w = jax.lax.psum(jnp.sum(chain_var, axis=0), chain_axis) / nchains
    grand = jax.lax.psum(jnp.sum(chain_mean, axis=0), chain_axis) / nchains
    dm = chain_mean - grand[None]
    if nchains > 1:
        between = jax.lax.psum(jnp.sum(dm * dm, axis=0), chain_axis) / (
            nchains - 1
        )
    else:
        between = jnp.zeros_like(grand)
    var_plus = (niter - 1) / niter * w + between
    degenerate = jax.lax.pmax(vmax, chain_axis) == jax.lax.pmin(
        vmin, chain_axis
    )
    var_plus = jnp.where(degenerate, jnp.nan, var_plus)
    return jnp.sqrt(var_plus / w)


def _local_split_moments(values_sorted, order_sorted, ndraws: int,
                         c_loc: int, split: int):
    """Per-split-chain moments of this shard's values from fold/sort order.

    ``order_sorted`` holds LOCAL flat positions (draw * c_loc + chain_loc).
    Returns ``(chain_mean, chain_var, vmin, vmax)`` with C = c_loc * split.
    """
    niter = ndraws // split
    seg, valid = split_chain_ids_from_flat(
        order_sorted, ndraws, c_loc, split
    )
    ssum, ssq = weighted_segment_moments(
        values_sorted, seg, valid, nseg=c_loc * split
    )
    chain_mean = ssum / niter
    chain_var = (ssq - niter * chain_mean * chain_mean) / (niter - 1)
    vmin = jnp.min(jnp.where(valid, values_sorted, jnp.inf), axis=0)
    vmax = jnp.max(jnp.where(valid, values_sorted, -jnp.inf), axis=0)
    return chain_mean, chain_var, vmin, vmax


def _ring_tail_rhat(xs, order, med, bad, d, c_loc, split_chains,
                    chain_axis, kshards):
    """Tail R-hat via a second ring pass on the folded values.

    Folded rank-normal split-chain moments come straight off the fold sort
    (ops/seghist.py) per shard; the cross-chain B/W reduction is psums —
    never routed back to (draw, chain) order, never gathered.
    """
    folded = jnp.abs(xs - med[None, :])
    fs, forder = _sort_pair(folded, order)
    cl, ce, _ = ring_rank_counts(fs, chain_axis, kshards)
    ntot = d * c_loc * kshards
    zf_sorted = rank_normal_from_counts(cl, ce, ntot, xs.dtype)
    cm, cv, vmin, vmax = _local_split_moments(
        zf_sorted, forder, d, c_loc, split_chains
    )
    niter = d // split_chains
    rhat = _rhat_from_local_chain_moments(
        cm, cv, niter, vmin, vmax, chain_axis
    )
    return jnp.where(bad, jnp.nan, rhat)


def _ring_kernel(
    xb, *, kind, split_chains, maxlag, method, relative, q, chain_axis,
    kshards,
):
    """Rank-kind ESS/R-hat with the ring rank transform (no all_gather)."""
    d, c_loc, p = xb.shape
    tail_prob = 0.1 if q is None else q
    if kind == "tail":
        ps = (tail_prob / 2, 1 - tail_prob / 2, 0.5)
    else:
        ps = (0.5,)
    xs, order, z_sorted, quants, bad = _ring_rank_parts(
        xb, chain_axis, kshards, ps
    )
    med = quants[-1]
    if kind == "tail":
        proxies = []
        for i in range(2):
            thr = quants[i]
            proxy = (xb <= thr[None, None, :]).astype(xb.dtype)
            proxies.append(
                jnp.where(jnp.isnan(thr)[None, None, :], jnp.nan, proxy)
            )
        ess2, _ = _sharded_basic(
            jnp.concatenate(proxies, axis=2), split_chains=split_chains,
            maxlag=maxlag, method=method, relative=relative,
            chain_axis=chain_axis,
        )
        ess = jnp.minimum(ess2[:p], ess2[p:])
        rhat = _ring_tail_rhat(
            xs, order, med, bad, d, c_loc, split_chains, chain_axis, kshards
        )
        return ess, rhat
    # bulk / rank: rank-normalize back to local (draw, chain) order
    z = _unpermute(order, z_sorted)
    z = jnp.where(bad[None, :], jnp.nan, z).reshape(d, c_loc, p)
    ess_bulk, rhat_bulk = _sharded_basic(
        z, split_chains=split_chains, maxlag=maxlag, method=method,
        relative=relative, chain_axis=chain_axis,
    )
    if kind == "bulk":
        return ess_bulk, rhat_bulk
    rhat_tail = _ring_tail_rhat(
        xs, order, med, bad, d, c_loc, split_chains, chain_axis, kshards
    )
    return ess_bulk, jnp.maximum(rhat_tail, rhat_bulk)


# ---------------------------------------------------------------------------
# histogram-mode rank kinds (gather-free, sort-free; ops/fastrank.py)
# ---------------------------------------------------------------------------


def _sharded_minmax(xf, chain_axis: str):
    """Global per-column (lo, hi, bad) across the chain shards.

    Three tiny collectives (pmin/pmax/pmax) — together with the histogram
    psum this is the ENTIRE communication cost of the distributed rank
    transform, replacing the ring's k-1 rounds of 2N-row sorts or the
    gather's O(chains_total) per-device footprint.
    """
    bad_loc = jnp.any(jnp.isnan(xf), axis=0)
    bad = jax.lax.pmax(bad_loc.astype(jnp.int32), chain_axis) > 0
    lo_loc = jnp.min(jnp.where(jnp.isnan(xf), jnp.inf, xf), axis=0)
    hi_loc = jnp.max(jnp.where(jnp.isnan(xf), -jnp.inf, xf), axis=0)
    lo = jax.lax.pmin(lo_loc, chain_axis)
    hi = jax.lax.pmax(hi_loc, chain_axis)
    ok = jnp.isfinite(lo) & jnp.isfinite(hi)
    lo = jnp.where(ok, lo, 0.0)
    hi = jnp.where(ok, hi, 1.0)
    return lo, hi, bad


def _sharded_fast_rank(xf, chain_axis: str, kshards: int, nbins: int,
                       minmax=None):
    """Global histogram CDF + local in-place rank transform.

    Each shard histograms its local elements, ONE psum merges the bin
    moments, and every element is transformed locally against the global
    CDF — no element ever leaves its shard. Returns ``(z_local, cdf)``
    with the approximation bound of ops/fastrank.py (global occupancy / n).
    ``minmax``: pass a precomputed global (lo, hi, bad) to skip the
    reduction round (the fold transform derives its range from the bulk
    CDF — ops/fastrank._folded_cdf rationale).
    """
    if minmax is None:
        minmax = _sharded_minmax(xf, chain_axis)
    n_global = xf.shape[0] * kshards
    cdf = build_hist_cdf(
        xf, nbins, minmax=minmax, psum_axis=chain_axis, n_global=n_global,
    )
    return fast_rank_normalize_flat(xf, nbins, cdf=cdf)


def _fold_minmax_from(cdf, med):
    """Global (lo, hi, bad) of ``|x - med|`` derived from the bulk CDF —
    no extra collective round (ops/fastrank._folded_cdf rationale)."""
    m = jnp.nan_to_num(med)
    hi_f = jnp.maximum(cdf.hi - m, m - cdf.lo)
    hi_f = jnp.where(hi_f > 0, hi_f, 1.0)
    lo_f = jnp.zeros_like(hi_f)
    hi_f = jnp.where(cdf.hi <= cdf.lo, lo_f, hi_f)
    return lo_f, hi_f, cdf.bad


def _local_rhat_psum(z3, split_chains: int, chain_axis: str, bad):
    """Split R-hat of an in-(draw,chain)-order transform via psum algebra."""
    samples = split_chains_reshape(z3, split_chains)
    niter = samples.shape[0]
    chain_mean = jnp.mean(samples, axis=0)
    centered = samples - chain_mean[None]
    chain_var = jnp.sum(centered * centered, axis=0) / (niter - 1)
    vmin = jnp.min(samples, axis=(0, 1))
    vmax = jnp.max(samples, axis=(0, 1))
    rhat = _rhat_from_local_chain_moments(
        chain_mean, chain_var, niter, vmin, vmax, chain_axis
    )
    return jnp.where(bad, jnp.nan, rhat)


def _hist_kernel(
    xb, *, kind, split_chains, maxlag, method, relative, q, chain_axis,
    kshards, nbins,
):
    """Rank-kind ESS/R-hat with the histogram rank transform.

    Sort-free AND gather-free: the only rank-transform communication is one
    (nbins, P_local) psum of histogram moments (+ 3 scalar-vector
    pmin/pmax). Approximate to the documented ops/fastrank.py bound;
    ``rank_impl="hist"`` is opt-in for that reason.
    """
    d, c_loc, p = xb.shape
    xf = xb.reshape(d * c_loc, p)
    z, cdf = _sharded_fast_rank(xf, chain_axis, kshards, nbins)
    tail_prob = 0.1 if q is None else q
    if kind == "tail":
        t_lo, t_hi, med = hist_quantile(
            cdf, (tail_prob / 2, 1 - tail_prob / 2, 0.5), nbins
        )
        proxies = []
        for thr in (t_lo, t_hi):
            proxy = (xb <= thr[None, None, :]).astype(xb.dtype)
            proxies.append(
                jnp.where(jnp.isnan(thr)[None, None, :], jnp.nan, proxy)
            )
        ess2, _ = _sharded_basic(
            jnp.concatenate(proxies, axis=2), split_chains=split_chains,
            maxlag=maxlag, method=method, relative=relative,
            chain_axis=chain_axis,
        )
        ess = jnp.minimum(ess2[:p], ess2[p:])
    else:
        med = hist_quantile(cdf, (0.5,), nbins)[0]
        ess, rhat_bulk = _sharded_basic(
            z.reshape(d, c_loc, p), split_chains=split_chains,
            maxlag=maxlag, method=method, relative=relative,
            chain_axis=chain_axis,
        )
        if kind == "bulk":
            return ess, rhat_bulk
    folded = jnp.abs(xf - jnp.nan_to_num(med)[None, :])
    z_tail, _ = _sharded_fast_rank(
        folded, chain_axis, kshards, nbins,
        minmax=_fold_minmax_from(cdf, med),
    )
    rhat_tail = _local_rhat_psum(
        z_tail.reshape(d, c_loc, p), split_chains, chain_axis, cdf.bad
    )
    if kind == "tail":
        return ess, rhat_tail
    return ess, jnp.maximum(rhat_tail, rhat_bulk)


def _sharded_quantile_proxy(xb, q, chain_axis: str):
    c_loc = xb.shape[1]
    full = jax.lax.all_gather(xb, chain_axis, axis=1, tiled=True)
    thr = batched_quantile(full, q)  # (P_loc,) identical on all chain shards
    y = (xb <= thr[None, None, :]).astype(xb.dtype)
    has_nan = _has_nan_cols(full.reshape(-1, full.shape[2]))
    return jnp.where((jnp.isnan(thr) | has_nan)[None, None, :], jnp.nan, y)


def _sharded_kernel(
    xb, *, kind, split_chains, maxlag, method, relative, q, chain_axis
):
    if kind == "basic":
        return _sharded_basic(
            xb, split_chains=split_chains, maxlag=maxlag, method=method,
            relative=relative, chain_axis=chain_axis,
        )
    if kind == "bulk":
        y = _global_transform(xb, rank_normalize, chain_axis)
        return _sharded_basic(
            y, split_chains=split_chains, maxlag=maxlag, method=method,
            relative=relative, chain_axis=chain_axis,
        )
    if kind == "tail":
        # one all_gather + one payload sort serves both quantile thresholds
        # and the folded rank transform; the two indicator proxies run as one
        # stacked 2P-wide basic pipeline (one autocov psum, not two)
        tail_prob = 0.1 if q is None else q
        nparams = xb.shape[2]
        full = jax.lax.all_gather(xb, chain_axis, axis=1, tiled=True)
        xs, order, bad = sort_with_positions(full)
        proxies = []
        for p in (tail_prob / 2, 1 - tail_prob / 2):
            thr = jnp.where(bad, jnp.nan, sorted_quantile(xs, p))
            proxy = (xb <= thr[None, None, :]).astype(xb.dtype)
            proxies.append(
                jnp.where(jnp.isnan(thr)[None, None, :], jnp.nan, proxy)
            )
        ess2, _ = _sharded_basic(
            jnp.concatenate(proxies, axis=2), split_chains=split_chains,
            maxlag=maxlag, method=method, relative=relative,
            chain_axis=chain_axis,
        )
        ess = jnp.minimum(ess2[:nparams], ess2[nparams:])
        med = jnp.where(bad, jnp.nan, sorted_quantile(xs, 0.5))
        rhat = _tail_rhat_full(xs, order, med, bad, full.shape, split_chains,
                               chain_axis)
        return ess, rhat
    if kind == "rank":
        y, rhat_tail, _ = _global_rank_parts(
            xb, chain_axis, split_chains=split_chains
        )
        ess_bulk, rhat_bulk = _sharded_basic(
            y, split_chains=split_chains, maxlag=maxlag, method=method,
            relative=relative, chain_axis=chain_axis,
        )
        return ess_bulk, jnp.maximum(rhat_tail, rhat_bulk)
    raise ValueError(f"unsupported kind {kind!r}")


_RING_AUTO_BYTES = 1 << 27  # gather path above this full-sample size


def _resolve_rank_impl(rank_impl: str, x3, kind: str) -> str:
    """Pick gather vs ring for the sort-based kinds.

    ``auto`` switches to the ring merge-count when the gathered full sample
    would exceed ~128 MB per device — the regime where the all_gather's
    O(chains_total) device-memory footprint dominates.
    ``hist`` (opt-in, never auto-selected: it is approximate) replaces the
    rank transform with the one-psum histogram CDF (ops/fastrank.py).
    """
    if rank_impl not in ("auto", "gather", "ring", "hist"):
        raise ValueError(f"unknown rank_impl {rank_impl!r}")
    if kind == "basic":
        return "gather"  # no sort-based transform involved
    if rank_impl != "auto":
        return rank_impl
    nbytes = x3.size * x3.dtype.itemsize
    return "ring" if nbytes > _RING_AUTO_BYTES else "gather"


def ess_rhat_sharded(
    samples,
    cfg: MeshConfig,
    *,
    kind: str = "rank",
    split_chains: int = 2,
    maxlag: int = 250,
    autocov_method="auto",
    relative: bool = False,
    tail_prob: float = 0.1,
    rank_impl: str = "auto",
    rank_nbins: int = DEFAULT_NBINS,
):
    """ESS + R-hat over a chain/param-sharded mesh.

    ``samples`` has the canonical shape ``(draws, chains[, parameters...])``;
    it is placed with sharding ``P(None, chains, params)`` and every
    collective stays inside one jitted shard_map. Results are replicated over
    the chain axis and sharded over params. ``rank_impl`` selects how the
    sort-based kinds see the global sample: ``"gather"`` (one all_gather,
    every device sorts the full sample), ``"ring"`` (ring merge-count,
    O(N_local) memory — parallel/ring_rank.py), or ``"hist"`` (opt-in
    approximate fast mode: local histograms + ONE psum of bin moments, no
    sorts at all — the distributed analogue of ``rank_mode="fast"``, bound
    documented in ops/fastrank.py); ``"auto"`` picks between the exact two
    by size.
    """
    x3, pshape = canonicalize(samples)
    niter = x3.shape[0] // split_chains
    if niter <= 4:
        raise ValueError("sharded ess_rhat requires >4 draws per split chain")
    eff_maxlag = min(maxlag, niter - 4)
    impl = _resolve_rank_impl(rank_impl, x3, kind)
    x3 = shard_canonical(x3, cfg)
    fn = build_sharded_ess_rhat_fn(
        cfg, kind=kind, split_chains=split_chains, eff_maxlag=eff_maxlag,
        method=_method_name(autocov_method), relative=relative,
        # only the tail kind consumes the probability — normalizing to None
        # otherwise keeps the cache from re-tracing identical pipelines for
        # every distinct (ignored) tail_prob
        q=(tail_prob if kind == "tail" else None),
        rank_impl=impl, rank_nbins=rank_nbins,
    )
    ess, rhat = fn(x3)
    return ESSRhat(maybe_scalar(ess, pshape), maybe_scalar(rhat, pshape))


@functools.lru_cache(maxsize=128)
def build_sharded_ess_rhat_fn(
    cfg: MeshConfig, *, kind: str, split_chains: int, eff_maxlag: int,
    method, relative: bool, q: float | None, rank_impl: str,
    rank_nbins: int,
):
    """Construct the jitted shard_map'ed ESS/R-hat pipeline for one option
    signature — cached so repeat calls (and the streaming executor's chunk
    loop) reuse one traced executable instead of re-tracing per call.
    ``rank_impl`` must already be resolved (no "auto"); ``method`` likewise;
    ``q`` is the tail probability (None for non-tail kinds).
    """
    impl = rank_impl

    if impl == "hist" and kind in ("bulk", "tail", "rank"):
        kernel = partial(
            _hist_kernel,
            kind=kind,
            split_chains=split_chains,
            maxlag=eff_maxlag,
            method=method,
            relative=relative,
            q=q,
            chain_axis=cfg.chain_axis,
            kshards=cfg.mesh.shape[cfg.chain_axis],
            nbins=rank_nbins,
        )
    elif impl == "ring" and kind in ("bulk", "tail", "rank"):
        kernel = partial(
            _ring_kernel,
            kind=kind,
            split_chains=split_chains,
            maxlag=eff_maxlag,
            method=method,
            relative=relative,
            q=q,
            chain_axis=cfg.chain_axis,
            kshards=cfg.mesh.shape[cfg.chain_axis],
        )
    else:
        kernel = partial(
            _sharded_kernel,
            kind=kind,
            split_chains=split_chains,
            maxlag=eff_maxlag,
            method=method,
            relative=relative,
            q=q,
            chain_axis=cfg.chain_axis,
        )
    fn = shard_map(
        kernel,
        mesh=cfg.mesh,
        in_specs=(cfg.data_spec,),
        out_specs=(cfg.param_spec, cfg.param_spec),
    )
    return jax.jit(fn)


def _nested_rhat_from_moments_dist(chain_mean, chain_var, nsuper_local: int,
                                   chain_axis: str, vmin, vmax):
    """Nested R-hat from per-shard split-chain moments (superchains local to
    their shard; the across-superchain level is psums —
    src/rhat_nested.jl:144-185 algebra)."""
    ctot_loc, nparams = chain_mean.shape
    m = ctot_loc // nsuper_local
    kshards = jax.lax.psum(1, chain_axis)
    nsuper = nsuper_local * kshards
    cm = chain_mean.reshape(nsuper_local, m, nparams)
    cv = chain_var.reshape(nsuper_local, m, nparams)
    wk = jnp.mean(cv, axis=1)
    sm = jnp.mean(cm, axis=1)
    if m > 1:
        dm = cm - sm[:, None]
        bk = jnp.sum(dm * dm, axis=1) / (m - 1)
    else:
        bk = jnp.zeros_like(wk)
    var_within = jax.lax.psum(jnp.sum(wk + bk, axis=0), chain_axis) / nsuper
    grand = jax.lax.psum(jnp.sum(sm, axis=0), chain_axis) / nsuper
    ds_ = sm - grand[None]
    var_between = jax.lax.psum(jnp.sum(ds_ * ds_, axis=0), chain_axis) / (
        nsuper - 1
    )
    degenerate = jax.lax.pmax(vmax, chain_axis) == jax.lax.pmin(
        vmin, chain_axis
    )
    var_between = jnp.where(degenerate, jnp.nan, var_between)
    return jnp.sqrt(1.0 + var_between / var_within)


def rhat_nested_sharded(
    samples,
    superchain_ids,
    cfg: MeshConfig,
    *,
    kind: str = "rank",
    split_chains: int = 2,
    rank_impl: str = "auto",
    rank_nbins: int = DEFAULT_NBINS,
):
    """Nested R-hat over a chain/param-sharded mesh (BASELINE config 5).

    Chains are pre-permuted host-side so superchains are contiguous and each
    chain shard holds whole superchains; the within-superchain level then
    reduces locally and the across-superchain level is one psum
    (SURVEY.md section 5(d): segment-psum keyed by superchain id).
    ``superchains_per_shard = nsuper / chain_shards`` must divide evenly.
    """
    import numpy as np

    from ..diagnostics.rhat_nested import _validate_superchain_ids

    x3, pshape = canonicalize(samples)
    perm, nsuper = _validate_superchain_ids(superchain_ids, x3.shape[1])
    kshards = cfg.mesh.shape[cfg.chain_axis]
    if nsuper % kshards != 0:
        raise ValueError(
            f"number of superchains ({nsuper}) must divide evenly across the "
            f"chain shards ({kshards})"
        )
    x3 = jnp.asarray(x3)[:, np.asarray(perm), :]  # superchains contiguous
    impl = _resolve_rank_impl(rank_impl, x3, kind)
    x3 = shard_canonical(x3, cfg)
    nsuper_local = nsuper // kshards

    fn = build_sharded_rhat_nested_fn(
        cfg, kind=kind, split_chains=split_chains,
        nsuper_local=nsuper_local, rank_impl=impl, rank_nbins=rank_nbins,
    )
    vals = fn(x3)
    from ..utils.layout import maybe_scalar as _ms

    return _ms(vals, pshape)


@functools.lru_cache(maxsize=128)
def build_sharded_rhat_nested_fn(
    cfg: MeshConfig, *, kind: str, split_chains: int, nsuper_local: int,
    rank_impl: str, rank_nbins: int,
):
    """Construct the jitted shard_map'ed nested-R-hat pipeline for one
    option signature — cached like :func:`build_sharded_ess_rhat_fn` so
    repeat calls reuse one traced executable."""
    impl = rank_impl
    kshards = cfg.mesh.shape[cfg.chain_axis]
    nsuper = nsuper_local * kshards

    def ring_kernel(xb):
        # gather-free: ring merge-count ranks + local split-chain moments off
        # the sort order (ops/seghist.py), two-level psum reduction
        d, c_loc, _ = xb.shape
        xs, order, z_sorted, quants, bad = _ring_rank_parts(
            xb, cfg.chain_axis, kshards, (0.5,)
        )
        med = quants[0]

        def nested_from_sorted(values_sorted, positions):
            cm, cv, vmin, vmax = _local_split_moments(
                values_sorted, positions, d, c_loc, split_chains
            )
            r = _nested_rhat_from_moments_dist(
                cm, cv, nsuper_local, cfg.chain_axis, vmin, vmax
            )
            return jnp.where(bad, jnp.nan, r)

        if kind in ("bulk", "rank"):
            bulk = nested_from_sorted(z_sorted, order)
            if kind == "bulk":
                return bulk
        folded = jnp.abs(xs - med[None, :])
        fs, forder = _sort_pair(folded, order)
        cl, ce, _ = ring_rank_counts(fs, cfg.chain_axis, kshards)
        ntot = d * c_loc * kshards
        zf_sorted = rank_normal_from_counts(cl, ce, ntot, xs.dtype)
        tail = nested_from_sorted(zf_sorted, forder)
        if kind == "tail":
            return tail
        return jnp.maximum(bulk, tail)

    def hist_kernel(xb):
        # sort-free AND gather-free: one histogram psum per transform
        # (ops/fastrank.py bound applies; opt-in via rank_impl="hist")
        d, c_loc, p = xb.shape
        xf = xb.reshape(d * c_loc, p)

        def nested_local(z3, bad):
            samples_ = split_chains_reshape(z3, split_chains)
            cm = jnp.mean(samples_, axis=0)
            cent = samples_ - cm[None]
            cv = jnp.sum(cent * cent, axis=0) / (samples_.shape[0] - 1)
            vmin = jnp.min(samples_, axis=(0, 1))
            vmax = jnp.max(samples_, axis=(0, 1))
            r = _nested_rhat_from_moments_dist(
                cm, cv, nsuper_local, cfg.chain_axis, vmin, vmax
            )
            return jnp.where(bad, jnp.nan, r)

        z, cdf = _sharded_fast_rank(xf, cfg.chain_axis, kshards, rank_nbins)
        if kind in ("bulk", "rank"):
            bulk = nested_local(z.reshape(d, c_loc, p), cdf.bad)
            if kind == "bulk":
                return bulk
        med = hist_quantile(cdf, (0.5,), rank_nbins)[0]
        folded = jnp.abs(xf - jnp.nan_to_num(med)[None, :])
        z_tail, _ = _sharded_fast_rank(
            folded, cfg.chain_axis, kshards, rank_nbins,
            minmax=_fold_minmax_from(cdf, med),
        )
        tail = nested_local(z_tail.reshape(d, c_loc, p), cdf.bad)
        if kind == "tail":
            return tail
        return jnp.maximum(bulk, tail)

    def kernel(xb):
        # The rank-transformed kinds are pure moment statistics (no autocov),
        # so neither transform is ever routed back to (draw, chain) order:
        # both the bulk and folded split-chain moments come off ONE payload
        # sort of the gathered sample via the weighted one-hot histogram,
        # computed identically on every chain shard (zero extra collectives).
        if kind == "basic":
            return _nested_basic_local(xb, nsuper_local, split_chains,
                                       cfg.chain_axis)
        full = jax.lax.all_gather(xb, cfg.chain_axis, axis=1, tiled=True)
        xs, order, bad = sort_with_positions(full)
        d, c = full.shape[0], full.shape[1]

        def nested_from(values_sorted, positions):
            stats = split_chain_stats_from_sorted(
                values_sorted, positions, d, c, split_chains
            )
            r = _nested_rhat_from_chain_moments(
                stats.chain_mean, stats.chain_var, nsuper, stats.degenerate
            )
            # replication certificate (identical on every chain shard)
            return _replicated_pmax(jnp.where(bad, jnp.nan, r), cfg.chain_axis)

        if kind in ("bulk", "rank"):
            from ..ops.ranknorm import _avg_ranks_sorted
            from jax.scipy.special import ndtri

            n = xs.shape[0]
            zb_sorted = ndtri((_avg_ranks_sorted(xs) - 0.375) / (n + 0.25))
            bulk = nested_from(zb_sorted, order)
            if kind == "bulk":
                return bulk
        med = jnp.where(bad, jnp.nan, sorted_quantile(xs, 0.5))
        zf_sorted, forder = folded_rank_values_sorted(xs, order, med)
        tail = nested_from(zf_sorted, forder)
        if kind == "tail":
            return tail
        return jnp.maximum(bulk, tail)

    if impl == "hist" and kind in ("bulk", "tail", "rank"):
        chosen = hist_kernel
    elif impl == "ring" and kind in ("bulk", "tail", "rank"):
        chosen = ring_kernel
    else:
        chosen = kernel
    fn = shard_map(
        chosen,
        mesh=cfg.mesh,
        in_specs=(cfg.data_spec,),
        out_specs=cfg.param_spec,
    )
    return jax.jit(fn)


def _nested_rhat_from_chain_moments(chain_mean, chain_var, nsuper: int,
                                    degenerate):
    """Nested R-hat from global per-split-chain moments (replicated compute).

    ``chain_mean``/``chain_var``: (C_total_split, P) in chain-major order with
    superchains contiguous (the host-side permutation in
    ``rhat_nested_sharded``); the two-level B/W reduction of
    src/rhat_nested.jl:144-185 then needs no collectives at all.
    """
    ctot, nparams = chain_mean.shape
    m = ctot // nsuper
    cm = chain_mean.reshape(nsuper, m, nparams)
    cv = chain_var.reshape(nsuper, m, nparams)
    wk = jnp.mean(cv, axis=1)  # (S, P)
    sm = jnp.mean(cm, axis=1)  # (S, P) superchain means
    if m > 1:
        dm = cm - sm[:, None]
        bk = jnp.sum(dm * dm, axis=1) / (m - 1)
    else:
        bk = jnp.zeros_like(wk)
    var_within = jnp.mean(wk + bk, axis=0)
    grand = jnp.mean(sm, axis=0)
    ds_ = sm - grand[None]
    var_between = jnp.sum(ds_ * ds_, axis=0) / (nsuper - 1)
    var_between = jnp.where(degenerate, jnp.nan, var_between)
    return jnp.sqrt(1.0 + var_between / var_within)


def _nested_basic_local(xb, nsuper_local: int, split_chains: int,
                        chain_axis: str):
    """Two-level B/W reduction: local superchains, psum across shards."""
    samples = split_chains_reshape(xb, split_chains)  # (niter, c_loc, P)
    niter, c_loc, nparams = samples.shape
    m = c_loc // nsuper_local  # (split) chains per superchain
    s = samples.reshape(niter, nsuper_local, m, nparams)
    kshards = jax.lax.psum(1, chain_axis)
    nsuper = nsuper_local * kshards

    chain_mean = jnp.mean(s, axis=0)  # (Sl, m, P)
    centered = s - chain_mean[None]
    chain_var = jnp.sum(centered * centered, axis=0) / (niter - 1)
    wk = jnp.mean(chain_var, axis=1)  # (Sl, P)
    superchain_mean = jnp.mean(chain_mean, axis=1)  # (Sl, P)
    dm = chain_mean - superchain_mean[:, None]
    bk = (
        jnp.sum(dm * dm, axis=1) / (m - 1)
        if m > 1
        else jnp.zeros_like(wk)
    )
    var_within = jax.lax.psum(jnp.sum(wk + bk, axis=0), chain_axis) / nsuper
    grand = jax.lax.psum(jnp.sum(superchain_mean, axis=0), chain_axis) / nsuper
    ds_ = superchain_mean - grand[None]
    var_between = jax.lax.psum(jnp.sum(ds_ * ds_, axis=0), chain_axis) / (
        nsuper - 1
    )
    first = samples[0, 0]
    loc_same = jnp.all(samples == first[None, None], axis=(0, 1))
    glob_same = (
        (jax.lax.pmin(jnp.where(loc_same, 1, 0), chain_axis) == 1)
        & (jax.lax.pmax(first, chain_axis) == jax.lax.pmin(first, chain_axis))
    )
    var_between = jnp.where(glob_same, jnp.nan, var_between)
    return jnp.sqrt(1.0 + var_between / var_within)
