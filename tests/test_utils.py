"""Tests for layout/split/index utilities against reference contracts
(reference test/utils.jl)."""

import numpy as np
import pytest

import ref_impl
from mcmcdiagnostictools_jl_tpu.utils.split import (
    split_chains_reshape,
    split_draw_indices,
)
from mcmcdiagnostictools_jl_tpu.utils.indices import (
    shuffle_split_stratified,
    split_chain_indices,
    unique_indices,
)
from mcmcdiagnostictools_jl_tpu.ops.ranknorm import (
    batched_quantile,
    fold_around_median,
    rank_normalize,
    tiedrank,
)


class TestSplitDrawIndices:
    def test_even(self):
        idx = split_draw_indices(50, 2)
        assert idx.shape == (2, 25)
        np.testing.assert_array_equal(idx.reshape(-1), np.arange(50))

    def test_odd_two_splits(self):
        # reference test/utils.jl:39-46: 51 rows, 2 splits -> rows 1:25 and 27:51
        idx = split_draw_indices(51, 2)
        np.testing.assert_array_equal(idx[0], np.arange(0, 25))
        np.testing.assert_array_equal(idx[1], np.arange(26, 51))

    def test_three_splits_rem2(self):
        # reference test/utils.jl:49-52: 50 rows, 3 splits -> 1:16, 18:33, 35:50
        idx = split_draw_indices(50, 3)
        np.testing.assert_array_equal(idx[0], np.arange(0, 16))
        np.testing.assert_array_equal(idx[1], np.arange(17, 33))
        np.testing.assert_array_equal(idx[2], np.arange(34, 50))

    def test_three_splits_rem1(self):
        # reference test/utils.jl:53-55: 49 rows, 3 splits -> 1:16, 18:33, 34:49
        idx = split_draw_indices(49, 3)
        np.testing.assert_array_equal(idx[0], np.arange(0, 16))
        np.testing.assert_array_equal(idx[1], np.arange(17, 33))
        np.testing.assert_array_equal(idx[2], np.arange(33, 49))

    @pytest.mark.parametrize("ndraws,split", [(50, 2), (51, 2), (50, 3), (49, 3)])
    def test_matches_oracle(self, rng, ndraws, split):
        x = rng.standard_normal((ndraws, 4))
        ours = np.asarray(split_chains_reshape(x[:, :, None], split))[:, :, 0]
        ref = ref_impl.split_matrix(x, split)
        np.testing.assert_array_equal(ours, ref)


class TestUniqueIndices:
    def test_sorted_and_complete(self, rng):
        x = rng.integers(11, 15, size=100)
        uniques, indices = unique_indices(x)
        assert np.all(np.diff(uniques) > 0)
        all_inds = np.sort(np.concatenate(indices))
        np.testing.assert_array_equal(all_inds, np.arange(100))
        for u, inds in zip(uniques, indices):
            assert np.all(x[inds] == u)


class TestSplitChainIndices:
    def test_identity_split1(self):
        c = np.array([2, 2, 1, 3, 4, 3, 4, 1, 2, 1, 4, 3, 3, 2, 4, 3, 4, 1, 4, 1])
        np.testing.assert_array_equal(split_chain_indices(c, 1), c)

    @pytest.mark.parametrize("split", [2, 3])
    def test_non_greedy_partition(self, split):
        # earlier splits receive the remainder draws (reference test/utils.jl:58-82)
        c = np.array([2, 2, 1, 3, 4, 3, 4, 1, 2, 1, 4, 3, 3, 2, 4, 3, 4, 1, 4, 1])
        cnew = split_chain_indices(c, split)
        assert set(np.unique(cnew)) == set(range(1, cnew.max() + 1))
        uniques, indices = unique_indices(c)
        _, indices_new = unique_indices(cnew)
        for i in range(len(uniques)):
            group = indices_new[i * split : (i + 1) * split]
            lens = [len(g) for g in group]
            assert lens == sorted(lens, reverse=True)
            np.testing.assert_array_equal(indices[i], np.concatenate(group))


class TestShuffleSplitStratified:
    @pytest.mark.parametrize("frac", [0.3, 0.5, 0.7])
    def test_class_balance(self, rng, frac):
        c = rng.integers(1, 5, size=100)
        inds1, inds2 = shuffle_split_stratified(rng, c, frac)
        both = np.sort(np.concatenate([inds1, inds2]))
        np.testing.assert_array_equal(both, np.arange(100))
        _, indices = unique_indices(c)
        for inds in indices:
            common = np.intersect1d(inds1, inds)
            assert len(common) == round(frac * len(inds))


class TestTiedrank:
    def test_matches_scipy(self, rng):
        from scipy.stats import rankdata

        x = rng.integers(0, 10, size=(200, 5)).astype(np.float64)
        ours = np.asarray(tiedrank(x))
        ref = np.stack([rankdata(x[:, j], method="average") for j in range(5)], axis=1)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=0)

    def test_no_ties(self, rng):
        x = rng.standard_normal((100, 3))
        ours = np.asarray(tiedrank(x))
        ref = np.argsort(np.argsort(x, axis=0), axis=0) + 1
        np.testing.assert_allclose(ours, ref)


    @pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
    def test_unpermute_inverts_the_payload_sort(self, rng, dtype):
        """The scatter that routes sorted values back equals NumPy's
        inverse permutation, for float and integer payloads."""
        from mcmcdiagnostictools_jl_tpu.ops.ranknorm import _unpermute

        order = np.stack([rng.permutation(333) for _ in range(4)], axis=1)
        values = rng.integers(-50, 50, size=(333, 4)).astype(dtype)
        want = np.empty_like(values)
        np.put_along_axis(want, order, values, axis=0)
        got = np.asarray(_unpermute(order.astype(np.int32), values))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == values.dtype


class TestRankNormalize:
    @pytest.mark.parametrize("shape", [(1000, 1, 1), (1000, 4, 1), (1000, 4, 8)])
    def test_matches_oracle(self, rng, shape):
        x = rng.exponential(size=shape)
        ours = np.asarray(rank_normalize(x))
        ref = ref_impl.rank_normalize(x)
        np.testing.assert_allclose(ours, ref.reshape(shape), rtol=1e-12, atol=1e-12)

    def test_mean_std(self, rng):
        # reference test/utils.jl:98-107: mean ~ 0, std ~ 1
        x = rng.exponential(size=(1000, 4, 8))
        z = np.asarray(rank_normalize(x))
        assert np.allclose(z.mean(axis=(0, 1)), 0, atol=1e-13)
        assert np.allclose(z.std(axis=(0, 1), ddof=1), 1, rtol=1e-2)

    def test_nan_poisons_slice(self, rng):
        x = rng.standard_normal((100, 4, 3))
        x[0, 0, 1] = np.nan
        z = np.asarray(rank_normalize(x))
        assert np.all(np.isnan(z[:, :, 1]))
        assert not np.any(np.isnan(z[:, :, [0, 2]]))


class TestFoldQuantile:
    def test_fold_matches_oracle(self, rng):
        x = rng.random((1000, 4, 8))
        ours = np.asarray(fold_around_median(x))
        ref = ref_impl.fold_around_median(x)
        np.testing.assert_allclose(ours, ref, rtol=1e-14, atol=1e-14)

    @pytest.mark.parametrize("p", [0.025, 0.25, 0.5, 0.75, 0.975])
    def test_quantile_type7(self, rng, p):
        x = rng.standard_normal((337, 3, 5))
        ours = np.asarray(batched_quantile(x, p))
        ref = np.quantile(x.reshape(-1, 5).reshape(337 * 3, 5), p, axis=0)
        np.testing.assert_allclose(ours, ref, rtol=1e-14, atol=1e-14)


class TestFoldedMergeTransforms:
    """The merge-based folded rank transform == the independent one."""

    def test_rank_bulk_tail_vs_independent(self, rng):
        import jax.numpy as jnp
        from mcmcdiagnostictools_jl_tpu.ops.ranknorm import (
            fold_around_median,
            rank_bulk_tail_transforms,
            rank_normalize,
        )

        x = rng.standard_normal((257, 3, 5))
        x[rng.random(x.shape) < 0.15] = 1.25  # heavy ties
        x3 = jnp.asarray(x)
        z, zf, med = rank_bulk_tail_transforms(x3)
        np.testing.assert_array_equal(np.asarray(z), np.asarray(rank_normalize(x3)))
        ref = rank_normalize(fold_around_median(x3))
        np.testing.assert_array_equal(np.asarray(zf), np.asarray(ref))
