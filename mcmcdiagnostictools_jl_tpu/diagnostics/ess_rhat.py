"""ESS and R-hat — the flagship diagnostics.

Re-implements the full capability surface of the reference's ess_rhat.jl in a
single batched pipeline: split-chains gather -> fused chain moments -> batched
FFT autocovariance -> vectorized Geyer lag reduction. Everything runs under one
``jax.jit`` per (shape, kind, options) signature; no per-parameter Python loop
exists anywhere.

Kinds (reference src/ess_rhat.jl:276-311, 335-349, 438-455, 604-659):

- ``rhat``: ``"rank"`` (default) = max of bulk and tail, ``"bulk"`` = basic on
  rank-normalized draws, ``"tail"`` = bulk of draws folded around the median,
  ``"basic"`` = classic split-R-hat.
- ``ess``: ``"bulk"`` (default), ``"tail"`` (min of the symmetric
  quantile-ESS at ``tail_prob/2`` and ``1 - tail_prob/2``), ``"basic"``, or an
  estimator: ``"mean"``, ``"median"``, ``"std"``, ``"mad"``, ``Quantile(p)``.
- ``ess_rhat``: ``"rank"`` (ess=bulk-ESS, rhat=max(bulk,tail)), ``"bulk"``,
  ``"tail"`` (ess=tail-ESS, rhat=tail-R-hat), ``"basic"``.

Estimator-ESS proxies (src/ess_rhat.jl:626-659): mean -> x, median ->
indicator(x <= median), std -> (x - mean)^2, mad -> median-proxy of the folded
draws, quantile(p) -> indicator(x <= quantile_p).

Numeric contracts preserved: the split-chain remainder-discard rule, the
``(n-1)/n`` correction, the ``corrected=(nchains>1)`` between-chain variance
guard, the ``min(1/tau, log10(ntotal))`` antithetic cap, ``maxlag`` clamped to
``niter - 4``, NaN ESS + warning (R-hat still computed) when ``niter <= 4``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.autocov import mean_autocov_curve
from ..ops.fastrank import (
    DEFAULT_NBINS,
    _folded_cdf,
    build_hist_cdf,
    fast_rank_bulk_tail,
    fast_rank_normalize,
    fast_rank_normalize_flat,
    hist_quantile,
)
from ..ops.geyer import geyer_ess_from_rho
from ..ops.moments import chain_stats
from ..ops.ranknorm import (
    batched_median,
    batched_quantile,
    fold_around_median,
    folded_rank_values_sorted,
    rank_normalize,
    rank_normalize_from_sort,
    sort_with_positions,
    sorted_quantile,
)
from ..ops.seghist import split_chain_stats_from_sorted
from ..utils.layout import canonicalize, maybe_scalar
from ..utils.split import split_chains_reshape


class ESSRhat(NamedTuple):
    ess: object
    rhat: object


@dataclass(frozen=True)
class AutocovMethod:
    """Direct biased Geyer autocovariance estimator (reference
    src/ess_rhat.jl:22-38,161-179)."""

    name: str = "direct"


@dataclass(frozen=True)
class FFTAutocovMethod:
    """Batched real-FFT autocovariance estimator — what
    ``autocov_method="auto"`` resolves to (reference
    src/ess_rhat.jl:40-55,103-118,181-195)."""

    name: str = "fft"


@dataclass(frozen=True)
class BDAAutocovMethod:
    """BDA3 variogram autocovariance estimator (reference
    src/ess_rhat.jl:57-73,197-213)."""

    name: str = "bda"


@dataclass(frozen=True)
class Quantile:
    """Estimator marker for quantile-ESS / quantile-MCSE, the analogue of the
    reference's ``Base.Fix2(Statistics.quantile, p)``."""

    p: float

    def __post_init__(self):
        if not 0 < self.p < 1:
            raise ValueError("quantile probability must be in (0, 1)")


_SYMBOL_KINDS_ESS = ("bulk", "tail", "basic")
_ESTIMATOR_KINDS = ("mean", "median", "std", "mad")
_RHAT_KINDS = ("rank", "bulk", "tail", "basic")


# ``fold_impl="auto"``: the fold-sort implementation measured fastest on an
# H100 (700 W) at the exact-mode chunk (1.28M rows, 64 params): the two-axis
# decomposition took 62 ms against 537 ms for one payload lax.sort (PERF.md
# "H100 bring-up").
_FOLD_AUTO = "two_sort"


def _resolve_fold_merge(fold_impl: str = "auto") -> str | None:
    """Resolve the fold-sort implementation for tail/rank kinds.

    ``"sort"`` is one plain payload ``lax.sort``; ``"merge"`` sorts the
    folded valley with the two-axis decomposition
    (ops/ranknorm.valley_sort_2d). The two are key-bit-identical; only tie
    order differs, which the tied-average ranks absorb. ``"auto"`` is the
    measured winner, whatever the input.
    """
    if fold_impl == "sort":
        return None
    if fold_impl == "merge":
        return "two_sort"
    if fold_impl == "auto":
        return _FOLD_AUTO
    raise ValueError(f"unsupported fold_impl {fold_impl!r}")


def _method_name(autocov_method):
    """Autocovariance method name; ``"auto"`` is the batched rFFT."""
    if isinstance(
        autocov_method, (AutocovMethod, FFTAutocovMethod, BDAAutocovMethod)
    ):
        return autocov_method.name
    if autocov_method == "auto":
        return "fft"
    if isinstance(autocov_method, str) or callable(autocov_method):
        return autocov_method
    raise TypeError(f"unsupported autocov_method: {autocov_method!r}")


# ---------------------------------------------------------------------------
# proxies (src/ess_rhat.jl:626-659)
# ---------------------------------------------------------------------------


def _indicator_leq(x3, threshold):
    """float indicator of ``x <= threshold`` with NaN poisoning per slice."""
    y = (x3 <= threshold[None, None, :]).astype(x3.dtype)
    return jnp.where(jnp.isnan(threshold)[None, None, :], jnp.nan, y)


def _expectand_proxy(estimator, x3, q: float | None):
    if estimator == "mean":
        return x3
    if estimator == "median":
        return _indicator_leq(x3, batched_median(x3))
    if estimator == "std":
        mean = jnp.mean(x3, axis=(0, 1), keepdims=True)
        return (x3 - mean) ** 2
    if estimator == "mad":
        folded = fold_around_median(x3)
        return _indicator_leq(folded, batched_median(folded))
    if estimator == "quantile":
        return _indicator_leq(x3, batched_quantile(x3, q))
    raise ValueError(f"the estimator {estimator!r} is not supported by `ess`")


def _fast_expectand_proxy(estimator, x3, q: float | None, nbins: int):
    """Sort-free estimator proxies (``rank_mode="fast"``).

    Same proxy algebra as ``_expectand_proxy`` (src/ess_rhat.jl:626-659)
    with every median/quantile threshold read off the histogram CDF
    (ops/fastrank.py) instead of a sort — approximate to one bin width,
    which perturbs only which boundary elements the 0/1 indicator counts.
    mean/std never sort and share the exact code.
    """
    if estimator in ("mean", "std"):
        return _expectand_proxy(estimator, x3, q)
    d, c, p = x3.shape
    xf = x3.reshape(d * c, p)
    cdf = build_hist_cdf(xf, nbins)
    if estimator == "median":
        return _indicator_leq(x3, hist_quantile(cdf, (0.5,), nbins)[0])
    if estimator == "quantile":
        return _indicator_leq(x3, hist_quantile(cdf, (q,), nbins)[0])
    if estimator == "mad":
        med = hist_quantile(cdf, (0.5,), nbins)[0]
        folded = jnp.abs(xf - jnp.nan_to_num(med)[None, :])
        fcdf = _folded_cdf(folded, cdf, med, nbins)
        med_f = hist_quantile(fcdf, (0.5,), nbins)[0]
        med_f = jnp.where(cdf.bad, jnp.nan, med_f)
        return _indicator_leq(folded.reshape(d, c, p), med_f)
    raise ValueError(f"the estimator {estimator!r} is not supported by `ess`")


# ---------------------------------------------------------------------------
# basic kernel
# ---------------------------------------------------------------------------


def _basic_rhat(x3, split_chains: int):
    samples = split_chains_reshape(x3, split_chains)
    return chain_stats(samples).rhat


def _tail_rhat_from_sort(xs, order, med, bad, shape3, split_chains: int,
                         fold_merge: str | None = None):
    """Tail R-hat from the bulk transform's sort — no routing back.

    The folded rank-normal sample's split-chain moments are order-free, so
    they come straight off the fold sort via the weighted one-hot histogram
    (ops/seghist.py) instead of routing values back to (draw, chain) order
    with a fourth full payload sort. Numerically the R-hat of
    ``rank_normalize(|x - median|)`` (reference src/ess_rhat.jl:413-415).

    ``fold_merge``: forwarded to ``folded_rank_values_sorted``
    (``_resolve_fold_merge``).
    """
    d, c, _ = shape3
    zf_sorted, forder = folded_rank_values_sorted(xs, order, med,
                                                  merge=fold_merge)
    stats = split_chain_stats_from_sorted(zf_sorted, forder, d, c, split_chains)
    return jnp.where(bad, jnp.nan, stats.rhat)


def _basic_ess_rhat(x3, split_chains: int, maxlag: int, method, relative: bool):
    """Split -> moments -> autocov curve -> rho -> Geyer. (niter, C, P) batched.

    Mirrors the reference hot loop `_ess_rhat_basic!` (src/ess_rhat.jl:488-602)
    with the per-parameter loop replaced by the parameter axis of every kernel.
    """
    samples = split_chains_reshape(x3, split_chains)
    niter, nchains, _ = samples.shape
    ntotal = niter * nchains
    with jax.named_scope("mdt.split_moments"):
        stats = chain_stats(samples)
        centered = samples - stats.chain_mean[None]
    with jax.named_scope("mdt.autocov"):
        acov = mean_autocov_curve(centered, stats.chain_var, maxlag, method)
    with jax.named_scope("mdt.geyer"):
        inv_var_plus = 1.0 / stats.var_plus
        rho = 1.0 - (stats.w[None] - acov) * inv_var_plus[None]
        ess = geyer_ess_from_rho(rho, ntotal, relative)
    return ess, stats.rhat


# ---------------------------------------------------------------------------
# kind dispatch (jitted end-to-end; kind/options static)
# ---------------------------------------------------------------------------


def _fast_tail_rhat(z_tail, split_chains: int):
    """Tail R-hat in fast mode: ``z_tail`` is already in (draw, chain, P)
    order (no seghist routing needed — the histogram transform is in-place)."""
    return chain_stats(split_chains_reshape(z_tail, split_chains)).rhat


def _fast_kind_pipeline(
    x3, *, kind: str, split_chains: int, maxlag: int, method, relative: bool,
    q: float | None, nbins: int,
):
    """Histogram/CDF fast-mode bulk/tail/rank kinds (ops/fastrank.py).

    Zero sorts: both rank transforms happen element-in-place from the
    histogram CDF, and the tail R-hat reduces the fold transform directly in
    (draw, chain) order. Approximation bound documented in ops/fastrank.py.
    """
    if kind == "bulk":
        return _basic_ess_rhat(
            fast_rank_normalize(x3, nbins), split_chains,
            maxlag, method, relative,
        )
    d, c, p = x3.shape
    if kind == "tail":
        tail_prob = 0.1 if q is None else q
        xf = x3.reshape(d * c, p)
        cdf = build_hist_cdf(xf, nbins)
        t_lo, t_hi, med = hist_quantile(
            cdf, (tail_prob / 2, 1 - tail_prob / 2, 0.5), nbins
        )
        proxies = jnp.concatenate(
            [_indicator_leq(x3, t_lo), _indicator_leq(x3, t_hi)], axis=2
        )
        ess2, _ = _basic_ess_rhat(proxies, split_chains, maxlag, method,
                                  relative)
        ess = jnp.minimum(ess2[:p], ess2[p:])
        folded = jnp.abs(xf - jnp.nan_to_num(med)[None, :])
        z_tail, _ = fast_rank_normalize_flat(
            folded, nbins, cdf=_folded_cdf(folded, cdf, med, nbins))
        z_tail = jnp.where(cdf.bad[None, :], jnp.nan, z_tail)
        rhat_tail = _fast_tail_rhat(z_tail.reshape(d, c, p), split_chains)
        return ess, rhat_tail
    if kind == "rank":
        z_bulk, z_tail, _ = fast_rank_bulk_tail(x3, nbins)
        ess_bulk, rhat_bulk = _basic_ess_rhat(
            z_bulk, split_chains, maxlag, method, relative
        )
        rhat_tail = _fast_tail_rhat(z_tail, split_chains)
        return ess_bulk, jnp.maximum(rhat_tail, rhat_bulk)
    raise ValueError(f"unsupported fast-mode kind {kind!r}")


def _fast_rhat_pipeline(x3, *, kind: str, split_chains: int, nbins: int):
    if kind == "bulk":
        return _basic_rhat(fast_rank_normalize(x3, nbins), split_chains)
    z_bulk, z_tail, _ = fast_rank_bulk_tail(x3, nbins)
    if kind == "tail":
        return _fast_tail_rhat(z_tail, split_chains)
    if kind == "rank":
        return jnp.maximum(
            _fast_tail_rhat(z_tail, split_chains),
            _basic_rhat(z_bulk, split_chains),
        )
    raise ValueError(f"unsupported fast-mode kind {kind!r}")


@partial(
    jax.jit,
    static_argnames=(
        "kind", "split_chains", "maxlag", "method", "relative", "q",
        "param_chunk", "fold_merge", "rank_mode", "rank_nbins",
    ),
)
def _ess_rhat_pipeline(
    x3, *, kind: str, split_chains: int, maxlag: int, method, relative: bool,
    q: float | None = None, param_chunk: int | None = None,
    fold_merge: str | None = None, rank_mode: str = "exact",
    rank_nbins: int = DEFAULT_NBINS,
):
    """Full ess/rhat pipeline for one symbolic or estimator kind.

    ``kind`` in {"basic","bulk","tail","rank"} or estimator names; returns
    ``(ess, rhat)`` with NaN placeholders where a component is not computed.

    ``param_chunk`` bounds peak memory: the parameter axis is processed in
    chunks of that size with ``lax.map`` (every kernel is per-parameter
    independent, so chunking is exact).

    ``rank_mode="fast"`` routes the sort-based kinds (bulk/tail/rank) through
    the histogram/CDF transform (ops/fastrank.py) — sort-free, approximate to
    a documented bound; exact mode is the default.
    """
    nparams = x3.shape[2]
    if param_chunk is not None and nparams > param_chunk:
        # chunks are cut with dynamic_slice inside the map (one chunk-sized
        # copy at a time, not a padded full-array copy); a non-dividing last
        # chunk starts at nparams - chunk and overlaps its predecessor —
        # per-parameter independence makes the duplicated columns
        # bit-identical, and the positional scatter keeps one copy.
        nchunks = -(-nparams // param_chunk)
        starts = jnp.minimum(
            jnp.arange(nchunks) * param_chunk,
            max(nparams - param_chunk, 0),
        )

        def one_chunk(start):
            xc = jax.lax.dynamic_slice_in_dim(x3, start, param_chunk, axis=2)
            return _ess_rhat_pipeline(
                xc, kind=kind, split_chains=split_chains, maxlag=maxlag,
                method=method, relative=relative, q=q, fold_merge=fold_merge,
                rank_mode=rank_mode, rank_nbins=rank_nbins,
            )

        ess_c, rhat_c = jax.lax.map(one_chunk, starts)
        pos = (starts[:, None] + jnp.arange(param_chunk)[None, :]).ravel()
        ess = jnp.zeros(nparams, ess_c.dtype).at[pos].set(ess_c.ravel())
        rhat = jnp.zeros(nparams, rhat_c.dtype).at[pos].set(rhat_c.ravel())
        return ess, rhat
    if rank_mode == "fast" and kind in ("bulk", "tail", "rank"):
        return _fast_kind_pipeline(
            x3, kind=kind, split_chains=split_chains, maxlag=maxlag,
            method=method, relative=relative, q=q, nbins=rank_nbins,
        )
    if rank_mode == "fast" and kind in ("median", "mad", "quantile"):
        proxy = _fast_expectand_proxy(kind, x3, q, rank_nbins)
        return _basic_ess_rhat(proxy, split_chains, maxlag, method, relative)
    if kind == "basic":
        return _basic_ess_rhat(x3, split_chains, maxlag, method, relative)
    if kind == "bulk":
        return _basic_ess_rhat(
            rank_normalize(x3), split_chains, maxlag,
            method, relative,
        )
    if kind in ("mean", "median", "std", "mad", "quantile"):
        proxy = _expectand_proxy(kind, x3, q)
        return _basic_ess_rhat(proxy, split_chains, maxlag, method, relative)
    if kind == "tail":
        # one shared payload sort serves both quantile thresholds, the median,
        # and the fold transform; the two indicator-proxy pipelines run
        # stacked as one 2P-wide basic call (one autocov batch, not two)
        tail_prob = 0.1 if q is None else q
        xs, order, bad = sort_with_positions(x3)
        t_lo = jnp.where(bad, jnp.nan, sorted_quantile(xs, tail_prob / 2))
        t_hi = jnp.where(bad, jnp.nan, sorted_quantile(xs, 1 - tail_prob / 2))
        med = jnp.where(bad, jnp.nan, sorted_quantile(xs, 0.5))
        nparams = x3.shape[2]
        proxies = jnp.concatenate(
            [_indicator_leq(x3, t_lo), _indicator_leq(x3, t_hi)], axis=2
        )
        ess2, _ = _basic_ess_rhat(proxies, split_chains, maxlag, method,
                                  relative)
        ess = jnp.minimum(ess2[:nparams], ess2[nparams:])
        rhat_tail = _tail_rhat_from_sort(
            xs, order, med, bad, x3.shape, split_chains, fold_merge
        )
        return ess, rhat_tail
    if kind == "rank":
        xs, order, bad = sort_with_positions(x3)
        med = jnp.where(bad, jnp.nan, sorted_quantile(xs, 0.5))
        z = rank_normalize_from_sort(xs, order, bad)
        ess_bulk, rhat_bulk = _basic_ess_rhat(
            z.reshape(x3.shape), split_chains, maxlag, method, relative
        )
        rhat_tail = _tail_rhat_from_sort(
            xs, order, med, bad, x3.shape, split_chains, fold_merge
        )
        return ess_bulk, jnp.maximum(rhat_tail, rhat_bulk)
    raise ValueError(f"unsupported kind {kind!r}")


@partial(jax.jit, static_argnames=("kind", "split_chains", "fold_merge",
                                   "rank_mode", "rank_nbins"))
def _rhat_pipeline(x3, *, kind: str, split_chains: int,
                   fold_merge: str | None = None, rank_mode: str = "exact",
                   rank_nbins: int = DEFAULT_NBINS):
    if rank_mode == "fast" and kind in ("bulk", "tail", "rank"):
        return _fast_rhat_pipeline(x3, kind=kind, split_chains=split_chains,
                                   nbins=rank_nbins)
    if kind == "basic":
        return _basic_rhat(x3, split_chains)
    if kind == "bulk":
        return _basic_rhat(rank_normalize(x3), split_chains)
    if kind == "tail":
        xs, order, bad = sort_with_positions(x3)
        med = jnp.where(bad, jnp.nan, sorted_quantile(xs, 0.5))
        return _tail_rhat_from_sort(
            xs, order, med, bad, x3.shape, split_chains, fold_merge
        )
    if kind == "rank":
        xs, order, bad = sort_with_positions(x3)
        med = jnp.where(bad, jnp.nan, sorted_quantile(xs, 0.5))
        z = rank_normalize_from_sort(xs, order, bad)
        bulk = _basic_rhat(z.reshape(x3.shape), split_chains)
        tail = _tail_rhat_from_sort(
            xs, order, med, bad, x3.shape, split_chains, fold_merge
        )
        return jnp.maximum(tail, bulk)
    raise ValueError(f"unsupported kind {kind!r}")


# ---------------------------------------------------------------------------
# shared option handling
# ---------------------------------------------------------------------------


def _check_maxlag(maxlag: int):
    if maxlag <= 0:
        raise ValueError("maxlag must be >0.")


def _check_rank_mode(rank_mode: str):
    if rank_mode not in ("exact", "fast"):
        raise ValueError(
            f"rank_mode must be 'exact' or 'fast', got {rank_mode!r}"
        )


def _niter_after_split(ndraws: int, split_chains: int) -> int:
    return ndraws // split_chains


def _warn_short(niter: int):
    warnings.warn(
        f"number of draws after splitting must be >4 but is {niter}. "
        "ESS cannot be computed.",
        stacklevel=3,
    )


def _normalize_estimator(kind):
    """Map a public ``kind`` to (pipeline_kind, q)."""
    if isinstance(kind, Quantile):
        return "quantile", float(kind.p)
    if isinstance(kind, str):
        if kind in _SYMBOL_KINDS_ESS or kind in _ESTIMATOR_KINDS:
            return kind, None
        raise ValueError(f"the `kind` `{kind}` is not supported by `ess`")
    raise ValueError(f"the `kind` `{kind!r}` is not supported by `ess`")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def ess(
    samples,
    *,
    kind="bulk",
    relative: bool = False,
    autocov_method="auto",
    split_chains: int = 2,
    maxlag: int = 250,
    tail_prob: float = 0.1,
    param_chunk: int | None = None,
    fold_impl: str = "auto",
    rank_mode: str = "exact",
    rank_nbins: int = DEFAULT_NBINS,
):
    """Effective sample size of ``samples`` shaped ``(draws[, chains[, params...]])``.

    Mirrors the reference ``ess`` (src/ess_rhat.jl:215-311). ``kind`` is
    ``"bulk"`` (default), ``"tail"``, ``"basic"``, an estimator name
    (``"mean"``/``"median"``/``"std"``/``"mad"``), or ``Quantile(p)``.
    ``relative=True`` returns ESS / (draws*chains). Scalar for <=2-d input,
    array shaped like the parameter dims otherwise.

    ``rank_mode="fast"`` replaces EVERY sort-based transform — the
    bulk/tail rank transforms and the median/mad/quantile estimator-proxy
    thresholds — with the histogram/CDF approximation over ``rank_nbins``
    bins (ops/fastrank.py; zero sorts in the compiled graph, error bound
    documented there). ``"exact"`` (default) keeps reference bit-semantics.
    """
    _check_rank_mode(rank_mode)
    x3, pshape = canonicalize(samples)
    pipeline_kind, q = _normalize_estimator(kind)
    if pipeline_kind == "tail":
        if not 0 < tail_prob < 1:
            raise ValueError("tail_prob must be in (0, 1)")
        q = tail_prob
    _check_maxlag(maxlag)
    niter = _niter_after_split(x3.shape[0], split_chains)
    if niter <= 4:
        _warn_short(niter)
        return maybe_scalar(jnp.full(x3.shape[2], jnp.nan, x3.dtype), pshape)
    eff_maxlag = min(maxlag, niter - 4)
    ess_vals, _ = _ess_rhat_pipeline(
        x3,
        kind=pipeline_kind,
        split_chains=split_chains,
        maxlag=eff_maxlag,
        method=_method_name(autocov_method),
        relative=relative,
        q=q,
        param_chunk=param_chunk,
        fold_merge=_resolve_fold_merge(fold_impl),
        rank_mode=rank_mode,
        rank_nbins=rank_nbins,
    )
    return maybe_scalar(ess_vals, pshape)


def rhat(samples, *, kind: str = "rank", split_chains: int = 2,
         fold_impl: str = "auto", rank_mode: str = "exact",
         rank_nbins: int = DEFAULT_NBINS):
    """R-hat of ``samples`` shaped ``(draws[, chains[, params...]])``.

    Mirrors the reference ``rhat`` (src/ess_rhat.jl:313-420). ``kind`` is one
    of ``"rank"`` (default), ``"bulk"``, ``"tail"``, ``"basic"``.
    ``rank_mode="fast"`` uses the sort-free histogram/CDF rank transform
    (ops/fastrank.py).
    """
    if kind not in _RHAT_KINDS:
        raise ValueError(f"the `kind` `{kind}` is not supported by `rhat`")
    _check_rank_mode(rank_mode)
    x3, pshape = canonicalize(samples)
    vals = _rhat_pipeline(x3, kind=kind, split_chains=split_chains,
                          fold_merge=_resolve_fold_merge(fold_impl),
                          rank_mode=rank_mode, rank_nbins=rank_nbins)
    return maybe_scalar(vals, pshape)


def ess_rhat(
    samples,
    *,
    kind: str = "rank",
    relative: bool = False,
    autocov_method="auto",
    split_chains: int = 2,
    maxlag: int = 250,
    tail_prob: float = 0.1,
    param_chunk: int | None = None,
    fold_impl: str = "auto",
    rank_mode: str = "exact",
    rank_nbins: int = DEFAULT_NBINS,
):
    """Joint ESS and R-hat (more efficient than separate calls).

    Mirrors the reference ``ess_rhat`` (src/ess_rhat.jl:422-487,604-624):
    ``"rank"`` returns ess=bulk-ESS and rhat=max(bulk, tail); ``"tail"``
    returns the tail pair; plus ``"bulk"`` and ``"basic"``.
    ``rank_mode="fast"`` uses the sort-free histogram/CDF rank transform
    (ops/fastrank.py; error bound documented there); ``"exact"`` (default)
    keeps reference bit-semantics.
    """
    if kind not in _RHAT_KINDS:
        raise ValueError(f"the `kind` `{kind}` is not supported by `ess_rhat`")
    _check_rank_mode(rank_mode)
    x3, pshape = canonicalize(samples)
    _check_maxlag(maxlag)
    niter = _niter_after_split(x3.shape[0], split_chains)
    if niter <= 4:
        _warn_short(niter)
        ess_vals = jnp.full(x3.shape[2], jnp.nan, x3.dtype)
        rhat_vals = _rhat_pipeline(x3, kind=kind, split_chains=split_chains,
                                   fold_merge=_resolve_fold_merge(fold_impl),
                                   rank_mode=rank_mode, rank_nbins=rank_nbins)
        return ESSRhat(maybe_scalar(ess_vals, pshape), maybe_scalar(rhat_vals, pshape))
    eff_maxlag = min(maxlag, niter - 4)
    q = tail_prob if kind == "tail" else None
    ess_vals, rhat_vals = _ess_rhat_pipeline(
        x3,
        kind=kind,
        split_chains=split_chains,
        maxlag=eff_maxlag,
        method=_method_name(autocov_method),
        relative=relative,
        q=q,
        param_chunk=param_chunk,
        fold_merge=_resolve_fold_merge(fold_impl),
        rank_mode=rank_mode,
        rank_nbins=rank_nbins,
    )
    return ESSRhat(maybe_scalar(ess_vals, pshape), maybe_scalar(rhat_vals, pshape))


# internal helper shared with mcse
def _ess_array(x3, estimator, q, *, split_chains=2, maxlag=250, relative=False,
               autocov_method="auto", rank_mode="exact",
               rank_nbins=DEFAULT_NBINS):
    """ESS of an estimator on canonical (draws, chains, P); returns (P,)."""
    _check_rank_mode(rank_mode)
    niter = _niter_after_split(x3.shape[0], split_chains)
    if niter <= 4:
        _warn_short(niter)
        return jnp.full(x3.shape[2], jnp.nan, x3.dtype)
    eff_maxlag = min(maxlag, niter - 4)
    ess_vals, _ = _ess_rhat_pipeline(
        x3, kind=estimator, split_chains=split_chains, maxlag=eff_maxlag,
        method=_method_name(autocov_method),
        relative=relative, q=q, rank_mode=rank_mode, rank_nbins=rank_nbins,
    )
    return ess_vals
