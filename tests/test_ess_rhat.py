"""Parity and behavior tests for ess / rhat / ess_rhat.

Mirrors the reference test strategy (test/ess_rhat.jl): type/shape contracts,
internal cross-consistency, statistical sanity on synthetic chains, and error
paths — with numeric parity checked against the independent NumPy oracle in
ref_impl.py.
"""

import numpy as np
import pytest

import ref_impl
import mcmcdiagnostictools_jl_tpu as mdt
from mcmcdiagnostictools_jl_tpu import (
    AutocovMethod,
    BDAAutocovMethod,
    FFTAutocovMethod,
    Quantile,
)

TOL = dict(rtol=1e-9, atol=1e-9)


class TestParityAgainstOracle:
    @pytest.mark.parametrize("shape", [(1000, 4), (1000, 4, 3), (237, 3, 2, 2)])
    @pytest.mark.parametrize("kind", ["basic", "bulk", "tail", "rank"])
    def test_ess_rhat_kinds(self, rng, shape, kind):
        x = ref_impl.rank_normalize(rng.standard_normal(shape)) * 1.3 + 0.2
        got = mdt.ess_rhat(x, kind=kind)
        want_ess, want_rhat = ref_impl.ess_rhat(x, kind=kind)
        np.testing.assert_allclose(np.asarray(got.ess), want_ess, **TOL)
        np.testing.assert_allclose(np.asarray(got.rhat), want_rhat, **TOL)

    @pytest.mark.parametrize("kind", ["bulk", "tail", "basic", "mean", "median",
                                      "std", "mad"])
    def test_ess_kinds(self, rng, kind):
        x = rng.standard_normal((800, 4, 3))
        got = np.asarray(mdt.ess(x, kind=kind))
        want = ref_impl.ess(x, kind=kind)
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("p", [0.1, 0.25, 0.75, 0.9])
    def test_ess_quantile(self, rng, p):
        x = rng.standard_normal((800, 4, 3))
        got = np.asarray(mdt.ess(x, kind=Quantile(p)))
        want = ref_impl.ess(x, kind="quantile", q=p)
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("kind", ["rank", "bulk", "tail", "basic"])
    def test_rhat_kinds(self, rng, kind):
        x = rng.standard_normal((1000, 4, 5)) * 2.0 + 1.0
        got = np.asarray(mdt.rhat(x, kind=kind))
        want = ref_impl.rhat(x, kind=kind)
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("split_chains", [1, 2, 3])
    def test_split_chains(self, rng, split_chains):
        x = rng.standard_normal((1001, 4, 2))
        got = mdt.ess_rhat(x, kind="basic", split_chains=split_chains)
        want_ess, want_rhat = ref_impl.ess_rhat_basic(x, split_chains=split_chains)
        np.testing.assert_allclose(np.asarray(got.ess), want_ess, **TOL)
        np.testing.assert_allclose(np.asarray(got.rhat), want_rhat, **TOL)

    @pytest.mark.parametrize("maxlag", [1, 2, 3, 7, 50, 250])
    def test_maxlag(self, rng, maxlag):
        x = ref_impl.ar1_matrix(rng, 0.7, 1.0, (300, 4, 2))
        got = np.asarray(mdt.ess(x, kind="basic", maxlag=maxlag))
        want = ref_impl.ess(x, kind="basic", maxlag=maxlag)
        np.testing.assert_allclose(got, want, **TOL)

    def test_relative(self, rng):
        x = rng.standard_normal((500, 4, 2))
        got = np.asarray(mdt.ess(x, kind="basic", relative=True))
        want = ref_impl.ess(x, kind="basic", relative=True)
        np.testing.assert_allclose(got, want, **TOL)
        abs_got = np.asarray(mdt.ess(x, kind="basic"))
        np.testing.assert_allclose(abs_got, got * 500 * 4, **TOL)

    def test_autocorrelated_chains(self, rng):
        # strong autocorrelation: the Geyer truncation actually engages
        for phi in (0.3, 0.7, 0.9, -0.3):
            x = ref_impl.ar1_matrix(rng, phi, 1.0, (1000, 4, 3))
            got = mdt.ess_rhat(x, kind="rank")
            want_ess, want_rhat = ref_impl.ess_rhat(x, kind="rank")
            np.testing.assert_allclose(np.asarray(got.ess), want_ess, **TOL)
            np.testing.assert_allclose(np.asarray(got.rhat), want_rhat, **TOL)


class TestAutocovMethods:
    def test_methods_agree(self, rng):
        x = ref_impl.ar1_matrix(rng, 0.5, 1.0, (500, 4, 3))
        base = np.asarray(mdt.ess(x, kind="basic", autocov_method=FFTAutocovMethod()))
        direct = np.asarray(mdt.ess(x, kind="basic", autocov_method=AutocovMethod()))
        np.testing.assert_allclose(direct, base, rtol=1e-8)

    @pytest.mark.slow
    def test_bda_larger_variance_iid(self, rng):
        # BDA variogram estimator has larger variance on iid data
        # (reference test/ess_rhat.jl:238)
        x = rng.standard_normal((10000, 10, 40))
        e_std = np.asarray(mdt.ess(x, kind="basic", autocov_method=AutocovMethod()))
        e_bda = np.asarray(mdt.ess(x, kind="basic", autocov_method=BDAAutocovMethod()))
        assert np.var(e_bda) > np.var(e_std)

    def test_custom_callable_method(self, rng):
        # the open extension point: a user-supplied autocov curve callable
        from mcmcdiagnostictools_jl_tpu.ops.autocov import _mean_autocov_fft

        x = rng.standard_normal((400, 4))
        got = np.asarray(
            mdt.ess(x, kind="basic", autocov_method=lambda c, v, L: _mean_autocov_fft(c, v, L))
        )
        want = np.asarray(mdt.ess(x, kind="basic"))
        np.testing.assert_allclose(got, want, rtol=1e-12)


class TestShapesAndTypes:
    def test_vector_input_scalar_output(self, rng):
        x = rng.standard_normal(1000)
        assert isinstance(mdt.ess(x), float)
        assert isinstance(mdt.rhat(x), float)
        r = mdt.ess_rhat(x)
        assert isinstance(r.ess, float) and isinstance(r.rhat, float)

    def test_matrix_input_scalar_output(self, rng):
        x = rng.standard_normal((1000, 4))
        assert isinstance(mdt.ess(x), float)

    @pytest.mark.parametrize("pshape", [(3,), (3, 2), (2, 3, 4)])
    def test_param_shape_preserved(self, rng, pshape):
        x = rng.standard_normal((400, 4) + pshape)
        r = mdt.ess_rhat(x)
        assert np.asarray(r.ess).shape == pshape
        assert np.asarray(r.rhat).shape == pshape

    def test_int_input_promotes(self):
        x = np.arange(4000).reshape(1000, 4) % 97
        e = mdt.ess(x)
        assert isinstance(e, float) and np.isfinite(e)

    def test_consistency_with_slices(self, rng):
        # results for a parameter slice equal results computed alone
        # (reference test/ess_rhat.jl:167-204)
        x = rng.standard_normal((500, 4, 3))
        full = mdt.ess_rhat(x)
        for p in range(3):
            single = mdt.ess_rhat(x[:, :, p])
            np.testing.assert_allclose(np.asarray(full.ess)[p], single.ess, rtol=1e-11)
            np.testing.assert_allclose(np.asarray(full.rhat)[p], single.rhat, rtol=1e-11)

    def test_ess_equals_ess_rhat_component(self, rng):
        x = rng.standard_normal((500, 4, 3))
        for kind in ("bulk", "tail", "basic"):
            e = np.asarray(mdt.ess(x, kind=kind))
            er = np.asarray(mdt.ess_rhat(x, kind=kind).ess)
            np.testing.assert_allclose(e, er, rtol=1e-12)
        for kind in ("rank", "bulk", "tail", "basic"):
            r = np.asarray(mdt.rhat(x, kind=kind))
            rr = np.asarray(mdt.ess_rhat(x, kind=kind).rhat)
            np.testing.assert_allclose(r, rr, rtol=1e-12)


class TestStatisticalBehavior:
    def test_iid_ess_near_ntotal(self, rng):
        # reference test/ess_rhat.jl:210-240
        x = rng.standard_normal((10000, 10, 10))
        e = np.asarray(mdt.ess(x))
        ntotal = 10000 * 10
        assert np.all(np.abs(e - ntotal) < 0.1 * ntotal)
        r = np.asarray(mdt.rhat(x))
        assert np.all(np.abs(r - 1) < 0.01)

    def test_identical_samples_nan(self):
        # reference test/ess_rhat.jl:242-257
        x = np.full((100, 4), 2.5)
        r = mdt.ess_rhat(x)
        assert np.isnan(r.ess) and np.isnan(r.rhat)
        assert np.isnan(mdt.ess(x, kind="basic"))
        assert np.isnan(mdt.rhat(x, kind="basic"))

    def test_antithetic_cap(self, rng):
        # perfectly anticorrelated chains: ESS capped at ntotal*log10(ntotal)
        # (reference test/ess_rhat.jl:314-327)
        n = 1000
        base = rng.standard_normal((n // 2, 4))
        x = np.empty((n, 4))
        x[0::2] = base
        x[1::2] = -base
        e = mdt.ess(x, kind="basic")
        ntotal = n * 4
        assert e <= ntotal * np.log10(ntotal) * (1 + 1e-10)

    def test_mixed_locations_rhat_large(self, rng):
        # shifted chains must be flagged (reference test/ess_rhat.jl:268-276)
        x = rng.standard_normal((1000, 4))
        x[:, 2:] += 10.0
        assert mdt.rhat(x) > 1.5
        x_trend = np.concatenate([x[:, :2], x[:, :2] + 10.0], axis=0)
        assert mdt.rhat(x_trend) > 1.5  # within-chain shift caught by splitting

    def test_scale_mismatch_only_tail_flags(self, rng):
        # chains with different scales: bulk rhat ~ 1, tail rhat large
        # (reference test/ess_rhat.jl:337-364)
        x = rng.standard_normal((2000, 4))
        x[:, 0] *= 10.0
        assert mdt.rhat(x, kind="tail") > 1.05
        assert mdt.rhat(x, kind="bulk") < 1.05

    def test_nan_poisons_parameter(self, rng):
        x = rng.standard_normal((500, 4, 3))
        x[10, 1, 1] = np.nan
        r = mdt.ess_rhat(x)
        assert np.isnan(np.asarray(r.ess)[1]) and np.isnan(np.asarray(r.rhat)[1])
        assert np.all(np.isfinite(np.asarray(r.ess)[[0, 2]]))
        assert np.all(np.isfinite(np.asarray(r.rhat)[[0, 2]]))


class TestErrorsAndWarnings:
    def test_unknown_kind(self, rng):
        x = rng.standard_normal((100, 4))
        with pytest.raises(ValueError):
            mdt.ess(x, kind="rank")  # rank not supported by ess
        with pytest.raises(ValueError):
            mdt.rhat(x, kind="foo")
        with pytest.raises(ValueError):
            mdt.ess_rhat(x, kind="foo")

    def test_bad_maxlag(self, rng):
        x = rng.standard_normal((100, 4))
        with pytest.raises(ValueError):
            mdt.ess(x, maxlag=0)
        with pytest.raises(ValueError):
            mdt.ess_rhat(x, maxlag=-1)

    def test_short_chain_warns_nan_ess_but_rhat(self, rng):
        x = rng.standard_normal((8, 4))  # niter after split = 4 -> too short
        with pytest.warns(UserWarning, match="ESS cannot be computed"):
            r = mdt.ess_rhat(x)
        assert np.isnan(r.ess)
        assert np.isfinite(r.rhat)

    def test_bad_quantile(self):
        with pytest.raises(ValueError):
            Quantile(1.5)


class TestParamChunking:
    @pytest.mark.parametrize("chunk", [1, 2, 3, 5])
    def test_chunked_equals_unchunked(self, rng, chunk):
        x = rng.standard_normal((300, 4, 7))
        full = mdt.ess_rhat(x, kind="rank")
        chunked = mdt.ess_rhat(x, kind="rank", param_chunk=chunk)
        np.testing.assert_allclose(np.asarray(chunked.ess), np.asarray(full.ess),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(chunked.rhat), np.asarray(full.rhat),
                                   rtol=1e-12)

    def test_chunked_ess_estimators(self, rng):
        x = rng.standard_normal((300, 4, 7))
        a = np.asarray(mdt.ess(x, kind="std", param_chunk=2))
        b = np.asarray(mdt.ess(x, kind="std"))
        np.testing.assert_allclose(a, b, rtol=1e-12)


class TestJitEagerParity:
    @pytest.mark.slow
    def test_disable_jit_same_results(self, rng):
        # the "race detection" analogue of SURVEY.md section 5: compiled and
        # eager execution must agree
        import jax

        x = rng.standard_normal((200, 4, 2))
        with_jit = mdt.ess_rhat(x, kind="rank")
        with jax.disable_jit():
            without = mdt.ess_rhat(x, kind="rank")
        np.testing.assert_allclose(np.asarray(with_jit.ess),
                                   np.asarray(without.ess), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(with_jit.rhat),
                                   np.asarray(without.rhat), rtol=1e-10)
