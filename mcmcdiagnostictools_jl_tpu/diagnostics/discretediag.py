"""Convergence diagnostics for discrete (categorical) chains.

Re-derivation of the reference discretediag.jl (Deonovic & Smith 2017):
between-chain and within-chain tests for samples of a categorical variable,
with six methods:

- ``"hangartner"`` — chi^2 test of per-chain category frequencies
  (src/discretediag.jl:302-307)
- ``"weiss"`` — Hangartner chi^2 with a serial-dependence correction
  ``c = (1+phi)/(1-phi)`` (src/discretediag.jl:80-119,308-314)
- ``"DARBOOT"`` — parametric bootstrap of a DAR(1) process
  (src/discretediag.jl:187-228,315-328)
- ``"MCBOOT"`` — Markov-chain bootstrap (src/discretediag.jl:230-238,329-337)
- ``"billingsley"`` — transition-matrix chi^2 (src/discretediag.jl:130-173)
- ``"billingsleyBOOT"`` — its Markov-chain bootstrap
  (src/discretediag.jl:344-356)

Batched layout: there is no per-(parameter, chain) Python loop anywhere.
All between-chain tests (one per parameter) and all within-chain tests (one
per parameter x chain, comparing the first ``frac`` draws against the last
``frac``) run as ONE batched program each. Observed counts are flat-bincount
reductions; the category axis is padded to the max category count across
parameters (padded categories have zero counts and are masked out of every
statistic, so padding is exact). The bootstrap simulators are a jitted
``lax.scan`` over draws, vectorized over (simulations x tests x chains), and
the bootstrap chi^2 statistics are evaluated on device so only the (nsim, B)
statistic matrix ever returns to the host.

The statistics faithfully reproduce the reference's conventions, including
its time-reversed transition tensor in the diag_all path (``f[to, from,
chain]``, src/discretediag.jl:283-284) and MCBOOT's NaN statistic / 0.0
p-value (``stat`` is never assigned in the :MCBOOT branch,
src/discretediag.jl:329-337).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
from scipy.stats import chi2 as _chi2

import jax
import jax.numpy as jnp

_METHODS = ("weiss", "hangartner", "DARBOOT", "MCBOOT", "billingsley",
            "billingsleyBOOT")

# cap on the per-chunk bootstrap state (counts tensors) in bytes; nsim is
# processed in chunks so the (S, B, m[, m], d) accumulators stay bounded
_BOOT_STATE_BUDGET = 256 * 1024 * 1024


class DiscreteDiagValues(NamedTuple):
    stat: np.ndarray
    df: np.ndarray
    pvalue: np.ndarray


class DiscreteDiagResult(NamedTuple):
    between_chain: DiscreteDiagValues
    within_chain: DiscreteDiagValues


def discretediag(chains, *, frac: float = 0.3, method: str = "weiss",
                 nsim: int = 1000, rng=None) -> DiscreteDiagResult:
    """Discrete diagnostic on ``chains`` of shape (draws, chains, parameters).

    Returns between-chain values (per parameter) and within-chain values
    (parameters x chains) comparing the first ``frac`` draws against the last
    ``frac`` within each chain (src/discretediag.jl:399-424). ``rng`` seeds
    the bootstrap methods (NumPy Generator or seed).
    """
    if method not in _METHODS:
        raise ValueError(
            "`method` must be one of :" + ", :".join(_METHODS)
        )
    if not 0 < frac < 1:
        raise ValueError("`frac` must be in (0,1)")
    x = np.asarray(chains)
    if x.ndim != 3:
        raise ValueError("samples must have shape (draws, chains, parameters)")
    rng = np.random.default_rng(rng)
    num_iters, num_chains, num_vars = x.shape

    codes, m_arr = _integer_codes_batched(x)  # (n, d, P), (P,)
    m_pad = int(m_arr.max())

    # rbg keys: random_bits lowers to XLA's RngBitGenerator (the bootstrap
    # scan draws uniforms per step per (sim, test, chain) cell and threefry
    # would dominate the step); splits stay threefry-based and safe
    seeds = rng.integers(0, 2**62, size=2)
    key_b, key_w = (jax.random.key(int(s), impl="rbg") for s in seeds)

    b_stat, b_df, b_pval = _diag_batched(codes, m_arr, m_pad, method, nsim,
                                         key_b)

    # within-chain: first `frac` draws vs last `frac` draws of each chain,
    # one 2-pseudo-chain test per (parameter, chain) (src/discretediag.jl:399-424)
    n1 = round(frac * num_iters)
    start2 = round(num_iters - frac * num_iters + 1) - 1
    x1 = codes[:n1]                       # (n1, d, P)
    x2 = codes[start2:]                   # (n2, d, P)
    n_min = min(x1.shape[0], x2.shape[0])
    # tests ordered (param, chain): y_w[:, :, j*d + k] = chain k of param j
    y_w = np.stack([x1[:n_min], x2[x2.shape[0] - n_min:]], axis=1)  # (n_min, 2, d, P)
    y_w = np.ascontiguousarray(
        y_w.transpose(0, 1, 3, 2).reshape(n_min, 2, num_vars * num_chains)
    )
    # the reference's diag_all recomputes the category set from the windowed
    # data only (src/discretediag.jl:252): recode each test's codes to the
    # contiguous categories present in its two frac windows
    nw = num_vars * num_chains
    y_flat = y_w.reshape(n_min * 2, nw)  # view into y_w
    m_w = np.empty(nw, dtype=np.int64)
    for s in range(nw):
        uniq, inv = np.unique(y_flat[:, s], return_inverse=True)
        y_flat[:, s] = inv
        m_w[s] = len(uniq)
    m_pad_w = int(m_w.max())
    w_stat, w_df, w_pval = _diag_batched(y_w, m_w, m_pad_w, method, nsim,
                                         key_w)

    shape_w = (num_vars, num_chains)
    return DiscreteDiagResult(
        DiscreteDiagValues(b_stat, b_df, b_pval),
        DiscreteDiagValues(w_stat.reshape(shape_w), w_df.reshape(shape_w),
                           w_pval.reshape(shape_w)),
    )


# ---------------------------------------------------------------------------
# counting kernels
# ---------------------------------------------------------------------------


def _integer_codes_batched(x):
    """Per-parameter category codes 0..m_j-1 for x (n, d, P) (category
    labeling does not affect any of the statistics, so sorted-unique codes
    replace the reference's first-appearance dict, src/discretediag.jl:246-289)."""
    n, d, P = x.shape
    codes = np.empty((n, d, P), dtype=np.int64)
    m_arr = np.empty(P, dtype=np.int64)
    for j in range(P):
        uniq, cj = np.unique(x[:, :, j], return_inverse=True)
        codes[:, :, j] = cj.reshape(n, d)
        m_arr[j] = len(uniq)
    return codes, m_arr


def _integer_codes(x):
    """Single-parameter variant: map values to codes 0..m-1."""
    uniq, codes = np.unique(x, return_inverse=True)
    return codes.reshape(x.shape), len(uniq)


def _counts_u(y, m):
    """u[j, c] = occurrences of category j in chain c. y: (n, d) codes."""
    u, _, _ = _counts_batched(y[:, :, None], m)
    return u[0]


def _counts_v(y, m):
    """v[j, c] = self-transitions into category j in chain c."""
    _, v, _ = _counts_batched(y[:, :, None], m)
    return v[0]


def _counts_f_reversed(y, m):
    """f[to, from, c] transition tensor — the diag_all orientation
    (src/discretediag.jl:283-284)."""
    _, _, f = _counts_batched(y[:, :, None], m)
    return f[0]


def _counts_batched(y, m):
    """All observed count tensors for codes y (n, d, B) in one pass of flat
    bincounts: u (B, m, d) category counts, v (B, m, d) self-transition
    counts, f (B, m, m, d) time-reversed (to, from) transition tensors."""
    n, d, B = y.shape
    bi = np.arange(B)[None, None, :]
    ci = np.arange(d)[None, :, None]
    flat_u = (bi * m + y) * d + ci
    u = np.bincount(flat_u.ravel(), minlength=B * m * d).reshape(B, m, d)
    same = y[1:] == y[:-1]
    flat_v = (bi * m + y[1:]) * d + ci
    v = np.bincount(flat_v[same], minlength=B * m * d).reshape(B, m, d)
    pair = y[1:] * m + y[:-1]  # to * m + from
    flat_f = (bi * (m * m) + pair) * d + ci
    f = np.bincount(flat_f.ravel(), minlength=B * m * m * d).reshape(B, m, m, d)
    return u, v, f


def _batch_counts_f(y, m):
    """(from, to) transition tensors over a leading batch: y (nsim, n, d)
    -> (nsim, m, m, d). Orientation matches the reference's bootstrap
    counting (bd_inner, src/discretediag.jl:344-356)."""
    nsim, n, d = y.shape
    pair = y[:, :-1] * m + y[:, 1:]  # from * m + to
    offs = (np.arange(nsim)[:, None, None] * d + np.arange(d)[None, None, :]) * (m * m)
    counts = np.bincount((pair + offs).reshape(-1), minlength=nsim * d * m * m)
    return counts.reshape(nsim, d, m, m).transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# statistics (batch-safe NumPy; used for the observed data)
# ---------------------------------------------------------------------------


def _weiss_sub(u, v, t):
    """(phi_hat, per-chain chi^2 contributions, #nonempty categories)
    (src/discretediag.jl:80-119). Supports leading batch dims on u/v."""
    m, d = u.shape[-2], u.shape[-1]
    p1 = v.sum(axis=-1) / (d * (t - 1))  # (..., m)
    p2 = u.sum(axis=-1) / (d * t)
    nt = p1.sum(axis=-1)
    dt_ = (p2**2).sum(axis=-1)
    mp = u / t  # (..., m, d)
    ma = u.sum(axis=-1) / (d * t)  # (..., m)
    nonempty = ma > 0
    m_tot = nonempty.sum(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        contrib = (mp - ma[..., None]) ** 2 / ma[..., None]
    contrib = np.where(nonempty[..., None], contrib, 0.0)
    chi_stat = contrib.sum(axis=-2)  # (..., d)
    with np.errstate(divide="ignore", invalid="ignore"):
        phia = 1.0 + 1.0 / t - (1.0 - nt) / (1.0 - dt_)
    phia = np.clip(phia, 0.0, 1.0 - np.finfo(float).eps)
    return phia, chi_stat, m_tot


def _hangartner_stat(u, t):
    """n * sum of chi^2 contributions — hangartner_inner without the
    self-transition counts (src/discretediag.jl:9-24). Batch-safe."""
    v = np.zeros_like(u)
    _, chi_stat, m_tot = _weiss_sub(u, v, t)
    return t * chi_stat.sum(axis=-1), m_tot


def _billingsley_sub(f):
    """Transition chi^2 statistic + df + pooled transition matrix
    (src/discretediag.jl:130-173). Supports leading batch dims."""
    m, d = f.shape[-3], f.shape[-1]
    mf = f.sum(axis=-2)  # (..., m, d) outgoing totals per category/chain
    a = (mf > 0).sum(axis=-1)  # (..., m) chains where category occurs
    b = (f.sum(axis=-1) > 0).sum(axis=-1)  # (..., m) distinct successors
    with np.errstate(divide="ignore", invalid="ignore"):
        p = f / mf[..., :, None, :]  # per-chain transition probs
        mp = f.sum(axis=-1) / mf.sum(axis=-1)[..., :, None]
    mp = np.nan_to_num(mp, nan=0.0)
    active = (a * b) > 0  # (..., m)
    df = np.where(active, (a - 1) * (b - 1), 0).sum(axis=-1).astype(float)

    mask = (
        active[..., :, None, None]
        & active[..., None, :, None]
        & (mp[..., :, :, None] > 0)
        & (mf[..., :, None, :] > 0)
        & np.isfinite(p)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = mf[..., :, None, :] * (p - mp[..., :, :, None]) ** 2 / mp[..., :, :, None]
    stat = np.where(mask, terms, 0.0).sum(axis=(-3, -2, -1))
    return stat, df, mp


# ---------------------------------------------------------------------------
# batched per-test evaluation (the reference's diag_all at t = n, over all
# tests at once)
# ---------------------------------------------------------------------------


def _diag_batched(y, m_true, m_pad, method, nsim, key):
    """stat/df/pvalue vectors for codes ``y`` (n, d, B) with per-test true
    category counts ``m_true`` (B,), all categories padded to ``m_pad``
    (src/discretediag.jl:240-366 with start_iter=n, batched over tests)."""
    n, d, B = y.shape
    u, v, f = _counts_batched(y, m_pad)

    phia, chi_stat, _ = _weiss_sub(u, v, n)           # (B,), (B, d)
    hot_stat, bdf, mp = _billingsley_sub(f)           # (B,), (B,), (B, m, m)
    ca = (1.0 + phia) / (1.0 - phia)

    nan = np.full(B, np.nan)
    hang = n * chi_stat.sum(axis=-1)                  # (B,)

    if method in ("hangartner", "weiss"):
        stat = hang if method == "hangartner" else hang / ca
        df0 = ((m_true - 1) * (d - 1)).astype(float)
        with np.errstate(invalid="ignore"):
            pval = np.where((m_true > 1) & ~np.isnan(stat),
                            _chi2.sf(stat, np.maximum(df0, 1e-300)), np.nan)
        return stat, df0, pval

    if method == "billingsley":
        with np.errstate(invalid="ignore"):
            pval = np.where((bdf > 0) & ~np.isnan(hot_stat),
                            _chi2.sf(hot_stat, np.maximum(bdf, 1e-300)), np.nan)
        return hot_stat, bdf, pval

    # bootstrap methods: simulate on device, stats on device, reduce on host
    phat = u.sum(axis=-1) / np.maximum(u.sum(axis=(-2, -1)), 1)[..., None]
    if method == "DARBOOT":
        bstats = _bootstrap_stats(key, n, d, m_pad, nsim, "dar", "hang",
                                  phia=phia, phat=phat, mp=mp, m_true=m_true)
        stat = hang
    elif method == "MCBOOT":
        bstats = _bootstrap_stats(key, n, d, m_pad, nsim, "mc", "hang",
                                  phia=phia, phat=phat, mp=mp, m_true=m_true)
        # reference quirk: `stat` is never assigned in the :MCBOOT branch, so
        # the reported statistic is NaN and `mean(NaN <= x)` is 0.0
        # (src/discretediag.jl:329-337)
        stat = nan
    else:  # billingsleyBOOT
        bstats = _bootstrap_stats(key, n, d, m_pad, nsim, "mc", "bill",
                                  phia=phia, phat=phat, mp=mp, m_true=m_true)
        with np.errstate(divide="ignore", invalid="ignore"):
            stat = hot_stat
            hang = hot_stat / bdf  # compared against bootstrap stat/df ratios

    valid = ~np.isnan(bstats)                          # (nsim, B)
    nvalid = valid.sum(axis=0)
    cnt = np.maximum(nvalid, 1)
    # all-NaN bootstrap column -> NaN (the reference's mean over an empty
    # NaN-filtered vector, src/discretediag.jl:315-337), not 0.0
    df0 = np.where(nvalid > 0,
                   np.where(valid, bstats, 0.0).sum(axis=0) / cnt, np.nan)
    cmp_stat = hang if method != "MCBOOT" else nan
    with np.errstate(invalid="ignore"):
        pval = np.where(
            nvalid > 0,
            np.where(valid, cmp_stat[None, :] <= bstats, False)
            .sum(axis=0) / cnt,
            np.nan)
    return stat, df0, pval


# ---------------------------------------------------------------------------
# bootstrap simulation + statistics (device-side)
# ---------------------------------------------------------------------------


def _bootstrap_stats(key, n, d, m, nsim, kind, stat_kind, *, phia, phat, mp,
                     m_true):
    """Bootstrap statistic matrix (nsim, B): simulate ``nsim`` replicas of
    each of the B tests (DAR(1) or Markov chains, src/discretediag.jl:187-238)
    and evaluate the hangartner or billingsley statistic of each replica on
    device. nsim is chunked so the count accumulators stay under the state
    budget."""
    B = phat.shape[0]
    state_elems = B * m * d * (m if stat_kind == "bill" else 1)
    chunk = max(1, min(nsim, _BOOT_STATE_BUDGET // (8 * max(state_elems, 1))))
    nchunks = -(-nsim // chunk)

    cdf_fresh = np.cumsum(phat, axis=-1)
    # pooled transition matrix rows normalized; zero rows hold their state
    rowsum = mp.sum(axis=-1, keepdims=True)
    safe = np.where(rowsum > 0, mp / np.where(rowsum > 0, rowsum, 1.0), 0.0)
    cdf_trans = np.cumsum(safe, axis=-1)
    zero_row = (rowsum[..., 0] == 0)

    f32 = jnp.float32
    args = (jnp.asarray(phia, f32), jnp.asarray(cdf_fresh, f32),
            jnp.asarray(cdf_trans, f32), jnp.asarray(zero_row),
            jnp.asarray(m_true, jnp.int32))
    out = []
    for sub in jax.random.split(key, nchunks):
        out.append(np.asarray(
            _boot_chunk(sub, *args, n=n, d=d, m=m, S=chunk, kind=kind,
                        stat_kind=stat_kind)))
    return np.concatenate(out, axis=0)[:nsim]


@partial(jax.jit,
         static_argnames=("n", "d", "m", "S", "kind", "stat_kind"))
def _boot_chunk(key, phia, cdf_fresh, cdf_trans, zero_row, m_true, *, n, d, m,
                S, kind, stat_kind):
    """One nsim-chunk of bootstrap replicas: lax.scan over the n draws with
    state (prev codes, count accumulator), fully vectorized over
    (S sims, B tests, d chains). Returns the (S, B) statistic matrix.

    Layout: every state tensor keeps the big (S, B) axes minor-most — codes
    (d, S, B), category counts (d, m, S, B), transition counts
    (d, m, m, S, B) — so the contiguous axis is sims x tests, not the tiny
    chain/category axes."""
    B = phia.shape[0]
    cats = jnp.arange(m, dtype=jnp.int32)

    def onehot(c):  # (d, S, B) codes -> (d, m, S, B) indicator
        return c[:, None] == cats[None, :, None, None]

    cdf_fresh_t = cdf_fresh.T  # (m, B)

    def fresh_draw(u):  # categorical from per-test cdf (m, B); u (d, S, B)
        # clamp per test to m_true-1, not the static pad m-1: f32 cumsum CDFs
        # can end ~1 ulp below 1.0, and a uniform in that gap must not select
        # a padded out-of-support category (absorbing in MC mode)
        return jnp.minimum(
            jnp.sum(u[:, None] > cdf_fresh_t[None, :, None, :],
                    axis=1).astype(jnp.int32),
            m_true[None, None, :] - 1)

    keys = jax.random.split(key, n)
    u0 = jax.random.uniform(keys[0], (d, S, B), dtype=jnp.float32)
    if kind == "dar":
        prev0 = fresh_draw(u0)
    else:
        mt = m_true[None, None, :]
        prev0 = jnp.minimum((u0 * mt.astype(jnp.float32)).astype(jnp.int32),
                            mt - 1)

    if stat_kind == "bill":
        # only the (from, to) transition counts feed the statistic
        acc0 = jnp.zeros((d, m, m, S, B), dtype=jnp.int32)
    else:
        acc0 = onehot(prev0).astype(jnp.int32)

    cdf_trans_t = cdf_trans.transpose(1, 2, 0)  # (m_from, m_to, B)
    zero_row_t = zero_row.T.astype(jnp.float32)  # (m, B)

    def step(carry, key_t):
        prev, acc = carry
        if kind == "dar":
            u12 = jax.random.uniform(key_t, (2, d, S, B), dtype=jnp.float32)
            fresh = fresh_draw(u12[0])
            keep = u12[1] <= phia[None, None, :].astype(jnp.float32)
            new = jnp.where(keep, prev, fresh)
            oh_prev = None
        else:
            u1 = jax.random.uniform(key_t, (d, S, B), dtype=jnp.float32)
            oh_prev = onehot(prev).astype(jnp.float32)  # (d, m, S, B)
            # the one-hot selects f32 CDF rows: full precision keeps the
            # selected values bit-exact
            rowcdf = jnp.einsum("dmsb,mkb->dksb", oh_prev, cdf_trans_t,
                                precision=jax.lax.Precision.HIGHEST)
            zr = jnp.einsum("dmsb,mb->dsb", oh_prev, zero_row_t,
                            precision=jax.lax.Precision.HIGHEST)
            nxt = jnp.minimum(
                jnp.sum(u1[:, None] > rowcdf, axis=1).astype(jnp.int32),
                m_true[None, None, :] - 1)
            new = jnp.where(zr > 0, prev, nxt)
        oh_new = onehot(new)
        if stat_kind == "bill":
            # (from, to) orientation, matching the reference's bd_inner
            acc = acc + (oh_prev[:, :, None].astype(bool)
                         & oh_new[:, None]).astype(jnp.int32)
        else:
            acc = acc + oh_new.astype(jnp.int32)
        return (new, acc), None

    (_, acc), _ = jax.lax.scan(step, (prev0, acc0), keys[1:])

    if stat_kind == "hang":
        return _hangartner_jnp(acc.astype(jnp.float32), n)
    s_b, d_b = _billingsley_jnp(acc.astype(jnp.float32))
    return s_b / d_b  # 0/0 -> NaN, s/0 -> inf (reference nan-filter semantics)


def _hangartner_jnp(u, t):
    """Device-side hangartner statistic from counts u (d, m, S, B)."""
    d = u.shape[0]
    ma = u.sum(axis=0) / (d * t)  # (m, S, B)
    nonempty = ma > 0
    denom = jnp.where(nonempty, ma, 1.0)
    contrib = jnp.where(nonempty[None],
                        (u / t - ma[None]) ** 2 / denom[None], 0.0)
    return t * contrib.sum(axis=(0, 1))  # (S, B)


def _billingsley_jnp(f):
    """Device-side billingsley statistic + df from transition counts
    f (d, m_from, m_to, S, B)."""
    mf = f.sum(axis=2)  # (d, m, S, B) outgoing totals per category/chain
    a = (mf > 0).sum(axis=0)  # (m, S, B) chains where category occurs
    b = (f.sum(axis=0) > 0).sum(axis=1)  # (m, S, B) distinct successors
    mf_safe = jnp.where(mf > 0, mf, 1.0)
    p = f / mf_safe[:, :, None]  # (d, m, m, S, B)
    fsum_d = f.sum(axis=0)  # (m, m, S, B)
    mft = mf.sum(axis=0)  # (m, S, B)
    mp = fsum_d / jnp.where(mft > 0, mft, 1.0)[:, None]  # (m, m, S, B)
    active = (a * b) > 0  # (m, S, B)
    df = jnp.where(active, (a - 1) * (b - 1), 0).sum(axis=0).astype(f.dtype)
    mask = (active[:, None] & active[None, :]
            & (mp > 0))[None] & (mf[:, :, None] > 0)
    mp_safe = jnp.where(mp > 0, mp, 1.0)
    terms = mf[:, :, None] * (p - mp[None]) ** 2 / mp_safe[None]
    stat = jnp.where(mask, terms, 0.0).sum(axis=(0, 1, 2))  # (S, B)
    return stat, df
