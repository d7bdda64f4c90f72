"""Fast-mode (histogram/CDF) rank transform: bound verification vs exact.

The fast mode (ops/fastrank.py) replaces the exact sort-based rank pipeline
with a fixed-width histogram CDF + mean-anchored within-bin interpolation.
These tests pin its documented contract:

- point masses (ties) and singleton bins are EXACT (tied-average ranks);
- continuous samples stay within the occupancy/n quantile bound, which at
  default nbins makes ESS/R-hat track the exact kind to <0.1%;
- ranks are weakly monotone in the value; NaN poisoning, constant slices and
  the degenerate guards match the exact path.
"""

import numpy as np
import pytest

import mcmcdiagnostictools_jl_tpu as mdt
from mcmcdiagnostictools_jl_tpu.ops.fastrank import (
    DEFAULT_NBINS,
    build_hist_cdf,
    fast_rank_normalize,
    hist_quantile,
    interpolated_ranks,
)
from mcmcdiagnostictools_jl_tpu.ops.ranknorm import (
    batched_quantile,
    rank_normalize,
    tiedrank,
)


class TestRankValues:
    def test_continuous_rank_bound(self, rng):
        """|rank_fast - rank_exact| <= max mixed-bin occupancy."""
        x = rng.standard_normal((4000, 4))
        cdf = build_hist_cdf(x, DEFAULT_NBINS)
        rfast = np.asarray(interpolated_ranks(x, cdf, DEFAULT_NBINS))
        rexact = np.asarray(tiedrank(x))
        occ = np.max(np.asarray(cdf.counts), axis=0)
        assert np.all(np.abs(rfast - rexact) <= occ[None, :] + 0.5)

    def test_discrete_ties_exact(self, rng):
        """Point masses: tied-average ranks are exact (not just bounded)."""
        x = rng.integers(0, 7, size=(3000, 3)).astype(float)
        cdf = build_hist_cdf(x, DEFAULT_NBINS)
        rfast = np.asarray(interpolated_ranks(x, cdf, DEFAULT_NBINS))
        rexact = np.asarray(tiedrank(x))
        # exact up to the f32 rounding of the stored bin-mean anchor
        np.testing.assert_allclose(rfast, rexact, rtol=0, atol=1e-3)

    def test_discrete_z_exact(self, rng):
        x = rng.integers(0, 5, size=(500, 4, 3)).astype(float)
        np.testing.assert_allclose(
            np.asarray(fast_rank_normalize(x)),
            np.asarray(rank_normalize(x)),
            atol=1e-9,
        )

    def test_singletons_exact_when_bins_sparse(self, rng):
        """Values spaced wider than a bin: every bin is a singleton -> exact
        ranks (the mean anchor equals the element's own frac)."""
        base = np.linspace(-3.0, 3.0, 200)
        jitter = rng.uniform(-1e-4, 1e-4, size=(200, 2))
        x = rng.permuted(base[:, None] + jitter, axis=0)
        cdf = build_hist_cdf(x, DEFAULT_NBINS)
        rfast = np.asarray(interpolated_ranks(x, cdf, DEFAULT_NBINS))
        rexact = np.asarray(tiedrank(x))
        np.testing.assert_allclose(rfast, rexact, atol=1e-3)

    def test_monotone_in_value(self, rng):
        x = np.sort(rng.standard_normal(5000))[:, None]
        cdf = build_hist_cdf(x, 256)
        r = np.asarray(interpolated_ranks(x, cdf, 256))[:, 0]
        assert np.all(np.diff(r) >= -1e-6)

    def test_mixed_continuous_and_point_mass(self, rng):
        """A heavy point mass inside a continuous sample stays exact for the
        tied group and bounded for the rest."""
        cont = rng.standard_normal(2000)
        x = np.concatenate([cont, np.full(1000, 0.5)])[:, None]
        cdf = build_hist_cdf(x, DEFAULT_NBINS)
        rfast = np.asarray(interpolated_ranks(x, cdf, DEFAULT_NBINS))[:, 0]
        rexact = np.asarray(tiedrank(x))[:, 0]
        tied = x[:, 0] == 0.5
        # tied group: exact up to the few continuous values sharing the bin
        assert np.max(np.abs(rfast[tied] - rexact[tied])) <= 5.0
        occ = np.max(np.asarray(cdf.counts))
        assert np.all(np.abs(rfast - rexact) <= occ + 0.5)


class TestHistQuantile:
    def test_continuous_quantiles(self, rng):
        x = rng.standard_normal((20_000, 3))
        cdf = build_hist_cdf(x, DEFAULT_NBINS)
        qs = (0.05, 0.5, 0.95)
        approx = np.asarray(hist_quantile(cdf, qs, DEFAULT_NBINS))
        for i, q in enumerate(qs):
            exact = np.asarray(batched_quantile(x[:, None, :], q))
            width = np.asarray((cdf.hi - cdf.lo)) / DEFAULT_NBINS
            assert np.all(np.abs(approx[i] - exact) <= width + 1e-9)

    def test_discrete_median(self, rng):
        x = rng.integers(0, 3, size=(999, 2)).astype(float)
        cdf = build_hist_cdf(x, DEFAULT_NBINS)
        med = np.asarray(hist_quantile(cdf, (0.5,), DEFAULT_NBINS))[0]
        exact = np.median(x, axis=0)
        width = np.asarray((cdf.hi - cdf.lo)) / DEFAULT_NBINS
        assert np.all(np.abs(med - exact) <= width + 1e-9)


class TestDiagnosticsParity:
    @pytest.mark.parametrize("kind", ["rank", "bulk", "tail"])
    def test_ess_rhat_tracks_exact(self, rng, kind):
        x = rng.standard_normal((4000, 8, 5)) * 1.7 + 0.3
        a = mdt.ess_rhat(x, kind=kind)
        b = mdt.ess_rhat(x, kind=kind, rank_mode="fast")
        tol = 5e-3 if kind == "tail" else 1e-3  # tail thresholds approximate
        np.testing.assert_allclose(
            np.asarray(b.ess), np.asarray(a.ess), rtol=tol
        )
        np.testing.assert_allclose(
            np.asarray(b.rhat), np.asarray(a.rhat), atol=1e-4
        )

    def test_rhat_fast(self, rng):
        x = rng.standard_normal((2000, 4, 3))
        np.testing.assert_allclose(
            np.asarray(mdt.rhat(x, rank_mode="fast")),
            np.asarray(mdt.rhat(x)),
            atol=1e-4,
        )

    def test_ess_fast(self, rng):
        x = rng.standard_normal((2000, 4, 3))
        np.testing.assert_allclose(
            np.asarray(mdt.ess(x, rank_mode="fast")),
            np.asarray(mdt.ess(x)),
            rtol=1e-3,
        )

    def test_nan_poisoning(self, rng):
        x = rng.standard_normal((1000, 4, 3))
        x[17, 2, 1] = np.nan
        r = mdt.ess_rhat(x, kind="rank", rank_mode="fast")
        assert np.isnan(np.asarray(r.ess)[1]) and np.isnan(np.asarray(r.rhat)[1])
        assert np.all(np.isfinite(np.asarray(r.ess)[[0, 2]]))

    def test_constant_slice_nan(self, rng):
        x = rng.standard_normal((1000, 4, 2))
        x[:, :, 1] = 2.5
        r = mdt.ess_rhat(x, kind="rank", rank_mode="fast")
        assert np.isnan(np.asarray(r.ess)[1]) and np.isnan(np.asarray(r.rhat)[1])

    def test_param_chunk_consistent(self, rng):
        x = rng.standard_normal((1000, 4, 6)).astype(np.float32)
        a = mdt.ess_rhat(x, kind="rank", rank_mode="fast")
        b = mdt.ess_rhat(x, kind="rank", rank_mode="fast", param_chunk=2)
        np.testing.assert_allclose(np.asarray(a.ess), np.asarray(b.ess),
                                   rtol=1e-6)

    def test_invalid_rank_mode(self, rng):
        x = rng.standard_normal((100, 4))
        with pytest.raises(ValueError, match="rank_mode"):
            mdt.ess_rhat(x, rank_mode="banana")
        with pytest.raises(ValueError, match="rank_mode"):
            mdt.rhat(x, rank_mode="banana")
        with pytest.raises(ValueError, match="rank_mode"):
            mdt.ess(x, rank_mode="banana")

    @pytest.mark.parametrize("kind", ["median", "mad", "q25", "q90"])
    def test_estimator_kinds_track_exact(self, rng, kind):
        """Fast mode covers the estimator proxies (median/mad/quantile) via
        histogram thresholds — bound: the 0/1 indicator differs from exact
        only on the few boundary elements within one bin of the threshold."""
        k = {"median": "median", "mad": "mad",
             "q25": mdt.Quantile(0.25), "q90": mdt.Quantile(0.9)}[kind]
        x = rng.standard_normal((4000, 8, 4)) * 1.3 - 0.2
        a = np.asarray(mdt.ess(x, kind=k))
        b = np.asarray(mdt.ess(x, kind=k, rank_mode="fast"))
        np.testing.assert_allclose(b, a, rtol=2e-2)

    def test_estimator_kind_discrete_exact(self, rng):
        """Point masses: the histogram median is the exact median, so the
        indicator proxy — and hence the ESS — matches exact bitwise."""
        x = rng.integers(0, 7, size=(2000, 4, 3)).astype(float)
        a = np.asarray(mdt.ess(x, kind="median"))
        b = np.asarray(mdt.ess(x, kind="median", rank_mode="fast"))
        np.testing.assert_allclose(b, a, rtol=1e-12)

    def test_fast_mode_pipeline_has_zero_sorts(self):
        """The north-star contract: a rank_mode='fast' pass compiles to a
        graph with NO sort primitive for ANY kind."""
        import jax
        import jax.numpy as jnp

        from mcmcdiagnostictools_jl_tpu.diagnostics.ess_rhat import (
            _ess_rhat_pipeline,
        )

        x = jnp.zeros((400, 4, 3))
        for kind in ("rank", "bulk", "tail", "basic", "mean", "std",
                     "median", "mad", "quantile"):
            q = 0.25 if kind in ("quantile", "tail") else None
            jaxpr = jax.make_jaxpr(
                lambda y, kind=kind, q=q: _ess_rhat_pipeline(
                    y, kind=kind, split_chains=2, maxlag=50, method="fft",
                    relative=False, q=q, rank_mode="fast",
                )
            )(x)
            # match the sort PRIMITIVE application ("= sort["), not gather's
            # indices_are_sorted parameter
            assert "= sort[" not in str(jaxpr), f"kind={kind} still sorts"

    def test_mcse_fast_has_zero_sorts(self):
        import jax
        import jax.numpy as jnp

        from mcmcdiagnostictools_jl_tpu.diagnostics.mcse import (
            _mcse_quantile_from_ess_fast,
        )

        x = jnp.zeros((400, 4, 3))
        s = jnp.full((3,), 100.0)
        jaxpr = jax.make_jaxpr(
            lambda y, se: _mcse_quantile_from_ess_fast(
                y, 0.25, se, nbins=1024
            )
        )(x, s)
        assert "= sort[" not in str(jaxpr)

    def test_ar1_statistical_sanity(self, rng):
        """Fast-mode ESS on an AR(1) chain stays within a few percent of the
        exact kind (both estimate the same asymptotic quantity)."""
        from conftest import ar1

        x = ar1(rng, 0.7, 1.0, (8000, 4, 2))
        e = np.asarray(mdt.ess(x, kind="bulk"))
        f = np.asarray(mdt.ess(x, kind="bulk", rank_mode="fast"))
        np.testing.assert_allclose(f, e, rtol=1e-2)


class TestFoldedCDF:
    """The fold transform's histogram range is DERIVED from the bulk CDF
    (lo=0, hi=max(hi-med, med-lo)) — pin the edge geometries."""

    @pytest.mark.parametrize("skew", ["min_heavy", "max_heavy", "symmetric"])
    def test_median_at_extremes(self, rng, skew):
        n = 4000
        if skew == "min_heavy":  # median == min
            x = np.concatenate([np.zeros(3 * n // 4), rng.uniform(0, 1, n // 4)])
        elif skew == "max_heavy":  # median == max
            x = np.concatenate([rng.uniform(0, 1, n // 4), np.ones(3 * n // 4)])
        else:
            x = rng.standard_normal(n)
        x = rng.permuted(x).reshape(-1, 4, 1)
        a = mdt.ess_rhat(x, kind="tail")
        b = mdt.ess_rhat(x, kind="tail", rank_mode="fast")
        # folded values must stay in range: finite outputs, tracking exact
        # .item() (not float(...)): ndim-1 size-1 conversion is a NumPy
        # DeprecationWarning on 1.25+ and a hard error on future releases
        assert np.isfinite(np.asarray(b.rhat).item())
        np.testing.assert_allclose(np.asarray(b.rhat).item(),
                                   np.asarray(a.rhat).item(), atol=5e-3)

    def test_constant_column_still_nan(self, rng):
        x = rng.standard_normal((1000, 4, 2))
        x[:, :, 0] = 7.0
        r = mdt.ess_rhat(x, kind="tail", rank_mode="fast")
        assert np.isnan(np.asarray(r.rhat)[0])
        assert np.isfinite(np.asarray(r.rhat)[1])


class TestDtypeGating:
    """Sub-f32 inputs must keep full bin resolution through the upcasting
    ``_bin_coords``."""

    def test_bf16_bin_coords_full_resolution(self, rng):
        """bf16 inputs upcast before the bin arithmetic: the bin index must
        match the f32 computation exactly (bf16 coordinates would quantize
        4096 bins to ~16-bin granularity)."""
        import jax.numpy as jnp

        from mcmcdiagnostictools_jl_tpu.ops.fastrank import _bin_coords

        x32 = rng.standard_normal((4096, 2)).astype(np.float32)
        xb = jnp.asarray(x32).astype(jnp.bfloat16)
        x32 = np.asarray(xb, dtype=np.float32)  # the values bf16 represents
        # bf16-representable range endpoints, identical on both sides
        lo_b = jnp.min(xb, axis=0)
        hi_b = jnp.max(xb, axis=0)
        b_ref, _ = _bin_coords(jnp.asarray(x32),
                               lo_b.astype(jnp.float32),
                               hi_b.astype(jnp.float32), 4096)
        b_bf, _ = _bin_coords(xb, lo_b, hi_b, 4096)
        np.testing.assert_array_equal(np.asarray(b_ref), np.asarray(b_bf))

    def test_bf16_end_to_end(self, rng):
        """ess_rhat(..., rank_mode='fast') on bf16 input runs and tracks the
        f32 fast result."""
        import jax.numpy as jnp

        x = rng.standard_normal((2000, 4, 3)).astype(np.float32)
        a = mdt.ess_rhat(x, kind="rank", rank_mode="fast")
        b = mdt.ess_rhat(jnp.asarray(x).astype(jnp.bfloat16), kind="rank",
                         rank_mode="fast")
        np.testing.assert_allclose(np.asarray(b.ess, dtype=np.float64),
                                   np.asarray(a.ess), rtol=0.05)


class TestHistogramOracle:
    """The scatter histogram and the gather lookup against NumPy."""

    @staticmethod
    def _grid_sample(rng, n, p, dtype):
        # values on a 1/1024 grid inside [0, 1] with both ends present, so
        # lo = 0, hi = 1 and every bin edge is exact in binary: the library's
        # bins and np.histogram's must agree element for element
        x = rng.integers(0, 1024 * 8, size=(n, p)) / (1024.0 * 8)
        x[0], x[1] = 0.0, 1.0
        return x.astype(dtype)

    @pytest.mark.parametrize("n,p", [(333, 3), (5000, 7), (70_000, 2)])
    def test_counts_match_np_histogram(self, rng, n, p):
        x = self._grid_sample(rng, n, p, np.float32)
        cdf = build_hist_cdf(x, 1024)
        counts = np.asarray(cdf.counts)
        for j in range(p):
            want, _ = np.histogram(x[:, j], bins=1024, range=(0.0, 1.0))
            np.testing.assert_array_equal(counts[:, j], want)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_prefix_counts_exact_beyond_2_11(self, rng, dtype):
        """cum is an exact integer prefix for n well above 2^11 (an f32
        lookup through a TF32 matmul would round these)."""
        n = 3 * 2**15 + 17
        x = self._grid_sample(rng, n, 2, dtype)
        cdf = build_hist_cdf(x, 1024)
        cum = np.asarray(cdf.cum)
        for j in range(2):
            want, _ = np.histogram(x[:, j], bins=1024, range=(0.0, 1.0))
            np.testing.assert_array_equal(
                cum[:, j], np.concatenate([[0], np.cumsum(want)]))
        assert cum.dtype == np.dtype(dtype)

    def test_anchor_is_clamped_bin_mean(self, rng):
        from mcmcdiagnostictools_jl_tpu.ops.fastrank import _bin_coords

        x = rng.standard_normal((4000, 3))
        cdf = build_hist_cdf(x, 256)
        b, frac = (np.asarray(v) for v in
                   _bin_coords(x, cdf.lo, cdf.hi, 256))
        fm = np.asarray(cdf.fm)
        for j in range(3):
            cnt = np.bincount(b[:, j], minlength=256)
            s1 = np.bincount(b[:, j], weights=frac[:, j], minlength=256)
            want = np.where(cnt > 0, s1 / np.maximum(cnt, 1), 0.5)
            np.testing.assert_allclose(fm[:, j], want, rtol=1e-12, atol=1e-15)

    def test_point_values(self, rng):
        """``point`` holds the common value of all-equal bins, NaN in
        mixed and empty bins."""
        x = np.concatenate([np.full(500, 0.25), rng.uniform(0.5, 1.0, 4500),
                            [0.0]])[:, None]
        cdf = build_hist_cdf(x, 64)
        point = np.asarray(cdf.point)[:, 0]
        assert point[16] == 0.25  # 0.25 * 64 = bin 16, pure
        assert point[0] == 0.0  # singleton
        assert np.isnan(point[40])  # mixed continuous bin
        assert np.isnan(point[8])  # empty bin

    def test_quantile_of_point_mass_is_exact(self, rng):
        x = rng.poisson(3.0, size=(20_001, 2)).astype(np.float32)
        cdf = build_hist_cdf(x, DEFAULT_NBINS)
        for q in (0.05, 0.5, 0.95):
            got = np.asarray(hist_quantile(cdf, (q,), DEFAULT_NBINS))[0]
            want = np.quantile(x, q, axis=0)
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_tied_ranks_exact_any_order(self, rng, dtype):
        """Integer-valued draws: every bin is a point mass and the ranks
        equal the tied-average ranks, whatever order the frac sums were
        accumulated in (the anchor clamp makes this order-free)."""
        x = rng.poisson(3.0, size=(60_000, 3)).astype(dtype)
        x[:, 1] = x[:, 1] * 0.1 + 1e3  # non-integer frac inside each bin
        cdf = build_hist_cdf(x, DEFAULT_NBINS)
        rfast = np.asarray(interpolated_ranks(x, cdf, DEFAULT_NBINS))
        rexact = np.asarray(tiedrank(x.astype(np.float64)))
        np.testing.assert_allclose(rfast, rexact, rtol=0, atol=0.05)

    @pytest.mark.parametrize("n,p", [(1000, 3), (777, 5)])
    def test_lookup_matches_take_along_axis(self, rng, n, p):
        from mcmcdiagnostictools_jl_tpu.ops.fastrank import lookup_bins

        b = rng.integers(0, 64, size=(n, p)).astype(np.int32)
        tables = rng.standard_normal((64, p, 3))
        got = np.asarray(lookup_bins(b, tables))
        for w in range(3):
            np.testing.assert_array_equal(
                got[w], np.take_along_axis(tables[:, :, w], b, axis=0))

    def test_nan_column_flagged_and_others_intact(self, rng):
        x = rng.standard_normal((3000, 3))
        x[17, 1] = np.nan
        cdf = build_hist_cdf(x, 512)
        np.testing.assert_array_equal(np.asarray(cdf.bad), [False, True, False])
        clean = build_hist_cdf(x[:, [0, 2]], 512)
        np.testing.assert_array_equal(np.asarray(cdf.cum)[:, [0, 2]],
                                      np.asarray(clean.cum))

    def test_constant_column_exact_tied_rank(self, rng):
        x = rng.standard_normal((2001, 2))
        x[:, 0] = -4.5
        cdf = build_hist_cdf(x, 512)
        r = np.asarray(interpolated_ranks(x, cdf, 512))
        np.testing.assert_array_equal(r[:, 0], np.full(2001, 1001.0))
        assert float(np.asarray(cdf.cum)[-1, 0]) == 2001.0
