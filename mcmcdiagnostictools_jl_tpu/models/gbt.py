"""On-device histogram gradient-boosted trees for the R* diagnostic.

The reference delegates classification to external MLJ models (EvoTrees /
XGBoost, src/rstar.jl:47-57). This is the default on-device classifier: a
jitted multiclass softmax GBT built from matrix products rather than
scatters:

- quantile-binned features (static ``n_bins``),
- **shared-structure multi-output trees** (the "multi-output tree" strategy of
  modern XGBoost/LightGBM): ONE tree per boosting round whose structure is
  shared by all classes and whose leaves carry K-dimensional logit updates.
  The split gain is the per-class gain summed over classes. Node assignment
  is shared, so gradient/hessian histograms for ALL classes accumulate in a
  single matmul,
- **matmul histograms**: the (node, bin) one-hot matrix ``(n, nodes*bins)``
  is contracted against the stacked gradient/hessian matrix ``(n, 2K)`` at
  full f32 precision — one pass per feature via ``lax.scan`` (a scatter-add
  histogram is the untried alternative on the GPU, ROADMAP A1),
- trees grown level-by-level (oblivious layout): every node of a level splits
  simultaneously, so the forest state is fixed-shape arrays and the training
  loop is a ``lax.scan`` over rounds — no data-dependent Python control flow,
  one compiled graph.

Complexity per round: ``max_depth * F`` matmuls of shape
``(n, nodes*bins) x (n, 2K)`` plus one dense softmax over ``(n, K)`` — zero
scatters, zero gathers beyond per-level routing.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class GBTState(NamedTuple):
    split_feature: jnp.ndarray  # (rounds, inner_nodes) int32
    split_bin: jnp.ndarray  # (rounds, inner_nodes) int32
    leaf_value: jnp.ndarray  # (rounds, leaves, K) float32
    bin_edges: jnp.ndarray  # (features, n_bins-1) quantile bin edges
    num_classes: int


@dataclass(frozen=True)
class GBTClassifier:
    """Histogram GBT classifier implementing the R* classifier protocol.

    ``fit(X, y, num_classes) -> state``; ``predict_proba(state, X) -> (n, K)``;
    ``predict(state, X) -> labels``. ``probabilistic`` selects which R*
    algorithm applies (1: deterministic, 2: Poisson-binomial distribution).
    """

    n_rounds: int = 100
    learning_rate: float = 0.1
    max_depth: int = 3
    n_bins: int = 64
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    probabilistic: bool = True
    # class-chunked streaming mode for the many-chain regime: 0 = auto
    # (engage when materializing the (n, 2K) gradient matrix would exceed
    # ~600 MB), -1 = never, else the chunk width in classes
    class_chunk: int = 0

    def _chunk_width(self, n: int, num_classes: int) -> int:
        """Class-chunk width for the streaming path; 0 = dense path."""
        if self.class_chunk == -1:
            return 0
        if self.class_chunk > 0:
            return min(self.class_chunk, num_classes)
        return 256 if n * num_classes > 150_000_000 else 0

    def fit(self, x, y, num_classes: int, verbosity: int = 0) -> GBTState:
        x = jnp.asarray(x, jnp.float32)
        y = jnp.asarray(y, jnp.int32)
        edges = _quantile_bin_edges(x, self.n_bins)
        binned = _bin_features(x, edges)  # (n, F) int32
        kc = self._chunk_width(binned.shape[0], num_classes)
        if kc:
            sf, sb, lv = _fit_gbt_bigk(
                binned, y,
                num_classes=num_classes,
                n_rounds=self.n_rounds,
                learning_rate=self.learning_rate,
                max_depth=self.max_depth,
                n_bins=self.n_bins,
                reg_lambda=self.reg_lambda,
                min_child_weight=self.min_child_weight,
                class_chunk=kc,
            )
        else:
            sf, sb, lv = _fit_gbt(
                binned,
                y,
                num_classes=num_classes,
                n_rounds=self.n_rounds,
                learning_rate=self.learning_rate,
                max_depth=self.max_depth,
                n_bins=self.n_bins,
                reg_lambda=self.reg_lambda,
                min_child_weight=self.min_child_weight,
            )
        if verbosity > 0:
            print(
                f"GBTClassifier: fitted {self.n_rounds} multi-output trees "
                f"({num_classes} classes, depth {self.max_depth})"
            )
        return GBTState(sf, sb, lv, edges, num_classes)

    def predict_logits(self, state: GBTState, x):
        binned = _bin_features(jnp.asarray(x, jnp.float32), state.bin_edges)
        return _predict_logits(
            binned, state.split_feature, state.split_bin, state.leaf_value,
            self.max_depth,
        )

    def predict_proba(self, state: GBTState, x):
        return jax.nn.softmax(self.predict_logits(state, x), axis=-1)

    def predict(self, state: GBTState, x):
        binned = _bin_features(jnp.asarray(x, jnp.float32), state.bin_edges)
        kc = self._chunk_width(binned.shape[0], state.num_classes)
        if kc:
            pred, _ = _predict_stats_bigk(
                binned, state.split_feature, state.split_bin,
                state.leaf_value, jnp.zeros(binned.shape[0], jnp.int32),
                self.max_depth, kc,
            )
            return pred
        return jnp.argmax(self.predict_logits(state, x), axis=-1)

    def predict_true_proba(self, state: GBTState, x, y):
        """Per-row softmax probability of the true class ``y`` — the only
        quantity the probabilistic R* needs (src/rstar.jl:249-265); streams
        over class chunks so the (n, K) probability matrix is never
        materialized at many-chain scale."""
        binned = _bin_features(jnp.asarray(x, jnp.float32), state.bin_edges)
        y = jnp.asarray(y, jnp.int32)
        kc = self._chunk_width(binned.shape[0], state.num_classes)
        if kc:
            _, p_true = _predict_stats_bigk(
                binned, state.split_feature, state.split_bin,
                state.leaf_value, y, self.max_depth, kc,
            )
            return p_true
        proba = jax.nn.softmax(self.predict_logits(state, x), axis=-1)
        return jnp.take_along_axis(proba, y[:, None], axis=1)[:, 0]


def deterministic(classifier: GBTClassifier) -> GBTClassifier:
    """Mode-predicting version (the reference's ``Pipeline(...; predict_mode)``
    construction, src/rstar.jl:198-209)."""
    from dataclasses import replace

    return replace(classifier, probabilistic=False)


@dataclass(frozen=True)
class ShardedGBTClassifier(GBTClassifier):
    """Data-parallel GBT fit over a device mesh (BASELINE config 5 scale).

    Rows are sharded across all devices (or ``devices``); per-level
    gradient/hessian histograms and leaf sums are each ONE ``psum`` of
    per-shard partials (the histogram einsum in ``_fit_gbt_core`` is a row
    sum), after which split selection runs replicated — so the fitted forest
    is numerically identical to the single-device fit up to f32 reduction
    order. Bin edges come from a host-side quantile pass over the full
    training sample (a gathered sketch in the multi-host setting).
    """

    devices: tuple = ()

    def fit(self, x, y, num_classes: int, verbosity: int = 0) -> GBTState:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        devices = list(self.devices) if self.devices else jax.devices()
        ndev = len(devices)
        x = jnp.asarray(x, jnp.float32)
        y = jnp.asarray(y, jnp.int32)
        edges = _quantile_bin_edges(x, self.n_bins)
        binned = _bin_features(x, edges)  # (n, F) int32
        n = binned.shape[0]
        pad = (-n) % ndev
        w = jnp.concatenate(
            [jnp.ones(n, jnp.float32), jnp.zeros(pad, jnp.float32)]
        )
        if pad:
            binned = jnp.concatenate(
                [binned, jnp.zeros((pad, binned.shape[1]), jnp.int32)]
            )
            y = jnp.concatenate([y, jnp.zeros(pad, jnp.int32)])
        mesh = Mesh(np.asarray(devices), ("rows",))
        row_sharding = NamedSharding(mesh, P("rows"))
        binned, y, w = (
            jax.device_put(a, row_sharding) for a in (binned, y, w)
        )
        fn = jax.shard_map(
            partial(
                _fit_gbt_core,
                num_classes=num_classes,
                n_rounds=self.n_rounds,
                learning_rate=self.learning_rate,
                max_depth=self.max_depth,
                n_bins=self.n_bins,
                reg_lambda=self.reg_lambda,
                min_child_weight=self.min_child_weight,
                axis_name="rows",
            ),
            mesh=mesh,
            in_specs=(P("rows"), P("rows"), P("rows")),
            out_specs=(P(), P(), P()),
        )
        sf, sb, lv = jax.jit(fn)(binned, y, w)
        if verbosity > 0:
            print(
                f"ShardedGBTClassifier: fitted {self.n_rounds} multi-output "
                f"trees ({num_classes} classes) over {ndev} devices"
            )
        return GBTState(sf, sb, lv, edges, num_classes)


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


def _quantile_bin_edges(x, n_bins: int):
    """(F, n_bins-1) per-feature quantile edges from the training data."""
    qs = jnp.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return jnp.quantile(x, qs, axis=0).T  # (F, n_bins-1)


def _bin_features(x, edges):
    """Digitize features into [0, n_bins) via the quantile edges."""
    # edges: (F, B-1); x: (n, F) -> count of edges < x
    return jnp.sum(x[:, :, None] > edges[None, :, :], axis=2).astype(jnp.int32)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=(
        "num_classes", "n_rounds", "learning_rate", "max_depth", "n_bins",
        "reg_lambda", "min_child_weight",
    ),
)
def _fit_gbt(binned, y, *, num_classes, n_rounds, learning_rate, max_depth,
             n_bins, reg_lambda, min_child_weight):
    return _fit_gbt_core(
        binned, y, jnp.ones(binned.shape[0], jnp.float32),
        num_classes=num_classes, n_rounds=n_rounds,
        learning_rate=learning_rate, max_depth=max_depth, n_bins=n_bins,
        reg_lambda=reg_lambda, min_child_weight=min_child_weight,
    )


def _fit_gbt_core(binned, y, w, *, num_classes, n_rounds, learning_rate,
                  max_depth, n_bins, reg_lambda, min_child_weight,
                  axis_name=None):
    """GBT training loop over (possibly row-sharded) ``binned`` rows.

    ``w``: (n,) row weights — 0.0 marks padding rows added to make the row
    count divide across shards; they contribute nothing to histograms or leaf
    sums. ``axis_name``: when set, rows are a shard_map shard of that mesh
    axis and every row reduction (histogram, leaf sums) is one ``psum`` of
    per-shard partials — the data-parallel fit of the reference's classifier
    seam (src/rstar.jl:47-57) over a device mesh. All post-histogram compute
    (split selection, leaf values) is replicated-identical on every shard.
    """
    psum = (
        (lambda t: jax.lax.psum(t, axis_name)) if axis_name else (lambda t: t)
    )
    n, nfeat = binned.shape
    inner = 2**max_depth - 1
    leaves = 2**max_depth
    k = num_classes
    onehot = jax.nn.one_hot(y, k, dtype=jnp.float32)  # (n, K)

    def grow_tree(gh):
        """Grow one shared-structure tree on stacked grads/hessians gh (n, 2K).

        Returns (split_feature (inner,), split_bin (inner,),
        leaf_value (leaves, K), node (n,))."""
        node = jnp.zeros((n,), jnp.int32)  # node id within current level
        feat_out = jnp.zeros((inner,), jnp.int32)
        bin_out = jnp.zeros((inner,), jnp.int32)

        # level-by-level growth; max_depth is small and static, so the Python
        # loop unrolls into one fixed graph with per-level histogram shapes
        for depth in range(max_depth):
            n_nodes = 2**depth
            level_offset = 2**depth - 1

            # (node, feature, bin) one-hot against stacked grads: ONE
            # contraction accumulates the histograms of every class, node,
            # feature, and bin simultaneously. Features are chunked only when
            # the one-hot would exceed ~256 MB; the common case is one chunk
            # (a single flat einsum keeps the HLO small — nested scans inside
            # the rounds scan compile slowly).
            cols_per_feat = n_nodes * n_bins
            max_feats = max(
                1, (256 * 1024 * 1024) // (4 * n * cols_per_feat)
            )
            hist_parts = []
            for f0 in range(0, nfeat, max_feats):
                fs = slice(f0, min(f0 + max_feats, nfeat))
                nf = fs.stop - fs.start
                seg = (
                    node[:, None] * n_bins + binned[:, fs]
                )  # (n, nf) in [0, nodes*B)
                oh = jax.nn.one_hot(
                    seg, cols_per_feat, dtype=jnp.float32
                )  # (n, nf, nodes*B)
                hist_parts.append(
                    jnp.einsum(
                        "nfc,nk->fck", oh, gh,
                        precision=jax.lax.Precision.HIGHEST,
                    )
                )  # (nf, nodes*B, 2K)
            hists = (
                hist_parts[0] if len(hist_parts) == 1
                else jnp.concatenate(hist_parts, axis=0)
            )
            hists = psum(hists)  # cross-shard row reduction
            # (F, nodes*B, 2K) -> (nodes, F, B, 2K)
            hist = hists.reshape(nfeat, n_nodes, n_bins, 2 * k).transpose(
                1, 0, 2, 3
            )
            gl = jnp.cumsum(hist[..., :k], axis=2)  # left sums at split bin b
            hl = jnp.cumsum(hist[..., k:], axis=2)
            gtot = gl[:, :, -1:, :]
            htot = hl[:, :, -1:, :]
            gr = gtot - gl
            hr = htot - hl
            # multi-output gain: per-class gain summed over classes
            gain = jnp.sum(
                gl**2 / (hl + reg_lambda)
                + gr**2 / (hr + reg_lambda)
                - gtot**2 / (htot + reg_lambda),
                axis=3,
            )  # (nodes, F, B)
            hl_sum = jnp.sum(hl, axis=3)
            hr_sum = jnp.sum(hr, axis=3)
            valid = (hl_sum >= min_child_weight) & (hr_sum >= min_child_weight)
            gain = jnp.where(valid, gain, -jnp.inf)
            gain = gain[:, :, :-1]  # split "<= bin b" for b < B-1
            flat_gain = gain.reshape(n_nodes, -1)
            best = jnp.argmax(flat_gain, axis=1)  # (n_nodes,)
            best_gain = jnp.take_along_axis(flat_gain, best[:, None], axis=1)[:, 0]
            bf = (best // (n_bins - 1)).astype(jnp.int32)
            bb = (best % (n_bins - 1)).astype(jnp.int32)
            # no-gain nodes: degenerate split sending everything left
            usable = jnp.isfinite(best_gain) & (best_gain > 0)
            bb = jnp.where(usable, bb, n_bins - 1)  # all bins <= B-1 -> left
            feat_out = jax.lax.dynamic_update_slice(feat_out, bf, (level_offset,))
            bin_out = jax.lax.dynamic_update_slice(bin_out, bb, (level_offset,))
            # route samples
            xf = jnp.take_along_axis(binned, bf[node][:, None], axis=1)[:, 0]
            go_right = xf > bb[node]
            node = node * 2 + go_right.astype(jnp.int32)

        # K-dim leaf values from the final node assignment (matmul, no scatter)
        leaf_oh = jax.nn.one_hot(node, leaves, dtype=jnp.float32)  # (n, leaves)
        sums = psum(jnp.einsum(
            "nl,nk->lk", leaf_oh, gh, precision=jax.lax.Precision.HIGHEST
        ))  # (leaves, 2K)
        leaf_value = -learning_rate * sums[:, :k] / (sums[:, k:] + reg_lambda)
        return feat_out, bin_out, leaf_value, node

    def round_step(logits, _):
        p = jax.nn.softmax(logits, axis=1)  # (n, K)
        g = p - onehot
        h = p * (1.0 - p)
        feats, bins_, leaf_vals, node = grow_tree(
            jnp.concatenate([g, h], axis=1) * w[:, None]
        )
        logits = logits + leaf_vals[node]  # (n, K) gather by shared node id
        return logits, (feats, bins_, leaf_vals)

    logits0 = jnp.zeros((n, k), jnp.float32)
    if axis_name:
        # rows are a mesh shard: mark the carry varying over the row axis
        pcast = getattr(jax.lax, "pcast", None)
        logits0 = (
            pcast(logits0, (axis_name,), to="varying")
            if pcast is not None
            else jax.lax.pvary(logits0, (axis_name,))
        )
    _, (sf, sb, lv) = jax.lax.scan(round_step, logits0, None, length=n_rounds)
    return sf, sb, lv  # (rounds, inner), (rounds, inner), (rounds, leaves, K)


# ---------------------------------------------------------------------------
# class-chunked streaming fit — the many-chain regime (K ~ 2e4 classes)
# ---------------------------------------------------------------------------
#
# At BASELINE config-5 scale (1e4 chains -> 2e4 split-chain classes, ~1e6
# rows) the dense fit would materialize the (n, 2K) gradient matrix and the
# (n, K) logits — O(100 GB), beyond one card's memory. The streaming fit
# never materializes either:
#
# - the forest state is the pair (OH, LV): OH (n, rounds*leaves) is the
#   bf16 one-hot of each row's leaf per past round, LV (rounds*leaves, Kpad)
#   the leaf logit-updates. Any class-chunk of the logits is ONE matmul
#   ``OH @ LV[:, c0:c0+kc]`` — exact (0/1 entries, f32 leaf values at full
#   precision, f32 accumulation),
# - per round: one streaming pass accumulates the softmax normalizer Z, then
#   each level accumulates split gains chunk-by-chunk (the per-class
#   histogram cumsums reduce to (nodes, F, B) gain partials before the next
#   chunk arrives), and a final pass writes the leaf values,
# - memory: O(n*rounds*leaves + n*kc) instead of O(n*K).
#
# Numerics match the dense path up to the unshifted exp (logits are clipped
# to +-50, safe in f32 for K <= ~1e6 classes).


@partial(
    jax.jit,
    static_argnames=(
        "num_classes", "n_rounds", "learning_rate", "max_depth", "n_bins",
        "reg_lambda", "min_child_weight", "class_chunk",
    ),
)
def _fit_gbt_bigk(binned, y, *, num_classes, n_rounds, learning_rate,
                  max_depth, n_bins, reg_lambda, min_child_weight,
                  class_chunk):
    n, nfeat = binned.shape
    inner = 2**max_depth - 1
    leaves = 2**max_depth
    k = num_classes
    kc = class_chunk
    nch = -(-k // kc)
    kpad = nch * kc
    rl = n_rounds * leaves
    karange = jnp.arange(kc, dtype=jnp.int32)

    def logits_chunk(oh_hist, lv_all, c0):
        lvc = jax.lax.dynamic_slice(lv_all, (0, c0), (rl, kc))
        out = jnp.dot(oh_hist, lvc, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        return jnp.clip(out, -50.0, 50.0)

    def kmask(c0):
        return (c0 + karange) < k  # (kc,) valid-class mask

    def grad_chunk(oh_hist, lv_all, zinv, c0):
        lg = logits_chunk(oh_hist, lv_all, c0)
        p = jnp.where(kmask(c0)[None, :], jnp.exp(lg) * zinv[:, None], 0.0)
        onehot = ((y - c0)[:, None] == karange[None, :]).astype(jnp.float32)
        return p - onehot, p * (1.0 - p)

    def round_step(carry, r):
        oh_hist, lv_all = carry

        def zbody(i, zacc):
            lg = logits_chunk(oh_hist, lv_all, i * kc)
            return zacc + jnp.sum(
                jnp.where(kmask(i * kc)[None, :], jnp.exp(lg), 0.0), axis=1
            )

        z = jax.lax.fori_loop(0, nch, zbody, jnp.zeros((n,), jnp.float32))
        zinv = 1.0 / z

        node = jnp.zeros((n,), jnp.int32)
        feat_out = jnp.zeros((inner,), jnp.int32)
        bin_out = jnp.zeros((inner,), jnp.int32)
        for depth in range(max_depth):
            n_nodes = 2**depth
            level_offset = 2**depth - 1
            cols = n_nodes * n_bins
            seg = node[:, None] * n_bins + binned  # (n, F)

            def hbody(i, acc, seg=seg, cols=cols, n_nodes=n_nodes):
                gain_acc, hl_acc, hr_acc = acc
                g, h = grad_chunk(oh_hist, lv_all, zinv, i * kc)
                gh = jnp.concatenate([g, h], axis=1)  # (n, 2kc)
                seg_oh = jax.nn.one_hot(seg, cols, dtype=jnp.float32)
                hist = jnp.einsum(
                    "nfc,nk->fck", seg_oh, gh,
                    precision=jax.lax.Precision.HIGHEST,
                ).reshape(nfeat, n_nodes, n_bins, 2 * kc).transpose(1, 0, 2, 3)
                gl = jnp.cumsum(hist[..., :kc], axis=2)
                hl = jnp.cumsum(hist[..., kc:], axis=2)
                gtot = gl[:, :, -1:, :]
                htot = hl[:, :, -1:, :]
                gr = gtot - gl
                hr = htot - hl
                gain_c = jnp.sum(
                    gl**2 / (hl + reg_lambda)
                    + gr**2 / (hr + reg_lambda)
                    - gtot**2 / (htot + reg_lambda),
                    axis=3,
                )
                return (
                    gain_acc + gain_c,
                    hl_acc + hl.sum(axis=3),
                    hr_acc + hr.sum(axis=3),
                )

            zero = jnp.zeros((n_nodes, nfeat, n_bins), jnp.float32)
            gain, hl_sum, hr_sum = jax.lax.fori_loop(
                0, nch, hbody, (zero, zero, zero)
            )
            valid = (hl_sum >= min_child_weight) & (hr_sum >= min_child_weight)
            gain = jnp.where(valid, gain, -jnp.inf)[:, :, :-1]
            flat_gain = gain.reshape(n_nodes, -1)
            best = jnp.argmax(flat_gain, axis=1)
            best_gain = jnp.take_along_axis(flat_gain, best[:, None], axis=1)[
                :, 0
            ]
            bf = (best // (n_bins - 1)).astype(jnp.int32)
            bb = (best % (n_bins - 1)).astype(jnp.int32)
            usable = jnp.isfinite(best_gain) & (best_gain > 0)
            bb = jnp.where(usable, bb, n_bins - 1)
            feat_out = jax.lax.dynamic_update_slice(
                feat_out, bf, (level_offset,)
            )
            bin_out = jax.lax.dynamic_update_slice(bin_out, bb, (level_offset,))
            xf = jnp.take_along_axis(binned, bf[node][:, None], axis=1)[:, 0]
            node = node * 2 + (xf > bb[node]).astype(jnp.int32)

        leaf_oh = jax.nn.one_hot(node, leaves, dtype=jnp.float32)

        def lbody(i, lv_blk):
            c0 = i * kc
            g, h = grad_chunk(oh_hist, lv_all, zinv, c0)
            gs = jnp.einsum(
                "nl,nk->lk", leaf_oh, g, precision=jax.lax.Precision.HIGHEST
            )
            hs = jnp.einsum(
                "nl,nk->lk", leaf_oh, h, precision=jax.lax.Precision.HIGHEST
            )
            leaf_c = -learning_rate * gs / (hs + reg_lambda)
            return jax.lax.dynamic_update_slice(lv_blk, leaf_c, (0, c0))

        lv_blk = jax.lax.fori_loop(
            0, nch, lbody, jnp.zeros((leaves, kpad), jnp.float32)
        )
        lv_all = jax.lax.dynamic_update_slice(lv_all, lv_blk, (r * leaves, 0))
        oh_hist = jax.lax.dynamic_update_slice(
            oh_hist, leaf_oh.astype(jnp.bfloat16), (0, r * leaves)
        )
        return (oh_hist, lv_all), (feat_out, bin_out)

    oh0 = jnp.zeros((n, rl), jnp.bfloat16)
    lv0 = jnp.zeros((rl, kpad), jnp.float32)
    (_, lv_all), (sf, sb) = jax.lax.scan(
        round_step, (oh0, lv0), jnp.arange(n_rounds)
    )
    lv = lv_all.reshape(n_rounds, leaves, kpad)[:, :, :k]
    return sf, sb, lv


@partial(jax.jit, static_argnames=("max_depth", "class_chunk"))
def _predict_stats_bigk(binned, split_feature, split_bin, leaf_value, y,
                        max_depth: int, class_chunk: int):
    """Streaming prediction stats: ``(argmax label, P(true class y))``.

    Online logsumexp + running argmax over class chunks — never materializes
    the (n, K) logit/probability matrix.
    """
    n = binned.shape[0]
    n_rounds, leaves, k = leaf_value.shape
    kc = class_chunk
    nch = -(-k // kc)
    kpad = nch * kc
    rl = n_rounds * leaves

    def route(carry, tree):
        sf, sb = tree
        node = jnp.zeros((n,), jnp.int32)
        for depth in range(max_depth):
            offset = 2**depth - 1
            idx = offset + node
            f = sf[idx]
            b = sb[idx]
            xf = jnp.take_along_axis(binned, f[:, None], axis=1)[:, 0]
            node = node * 2 + (xf > b).astype(jnp.int32)
        return carry, node

    _, nodes = jax.lax.scan(route, None, (split_feature, split_bin))
    oh_hist = (
        jax.nn.one_hot(nodes, leaves, dtype=jnp.bfloat16)
        .transpose(1, 0, 2)
        .reshape(n, rl)
    )
    lv_flat = jnp.pad(leaf_value.reshape(rl, k), ((0, 0), (0, kpad - k)))
    karange = jnp.arange(kc, dtype=jnp.int32)

    def body(i, carry):
        m, s, best_val, best_idx, tl = carry
        c0 = i * kc
        lvc = jax.lax.dynamic_slice(lv_flat, (0, c0), (rl, kc))
        lg = jnp.clip(
            jnp.dot(oh_hist, lvc, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST),
            -50.0, 50.0,
        )
        km = (c0 + karange) < k
        lgm = jnp.where(km[None, :], lg, -jnp.inf)
        cmax = jnp.max(lgm, axis=1)
        carg = jnp.argmax(lgm, axis=1).astype(jnp.int32) + c0
        new_m = jnp.maximum(m, cmax)
        s = s * jnp.exp(m - new_m) + jnp.sum(
            jnp.where(km[None, :], jnp.exp(lg - new_m[:, None]), 0.0), axis=1
        )
        upd = cmax > best_val
        best_val = jnp.where(upd, cmax, best_val)
        best_idx = jnp.where(upd, carg, best_idx)
        in_chunk = (y >= c0) & (y < c0 + kc)
        ysel = jnp.clip(y - c0, 0, kc - 1)
        tval = jnp.take_along_axis(lg, ysel[:, None], axis=1)[:, 0]
        tl = jnp.where(in_chunk, tval, tl)
        return (new_m, s, best_val, best_idx, tl)

    neg = jnp.full((n,), -jnp.inf, jnp.float32)
    carry = (
        neg, jnp.zeros((n,), jnp.float32), neg,
        jnp.zeros((n,), jnp.int32), jnp.zeros((n,), jnp.float32),
    )
    m, s, _, best_idx, tl = jax.lax.fori_loop(0, nch, body, carry)
    return best_idx, jnp.exp(tl - m) / s


@partial(jax.jit, static_argnames=("max_depth",))
def _predict_logits(binned, split_feature, split_bin, leaf_value, max_depth: int):
    n = binned.shape[0]
    k = leaf_value.shape[-1]

    def per_round(logits, tree):
        sf, sb, lv = tree  # (inner,), (inner,), (leaves, K)
        node = jnp.zeros((n,), jnp.int32)
        for depth in range(max_depth):
            offset = 2**depth - 1
            idx = offset + node
            f = sf[idx]
            b = sb[idx]
            xf = jnp.take_along_axis(binned, f[:, None], axis=1)[:, 0]
            node = node * 2 + (xf > b).astype(jnp.int32)
        return logits + lv[node], None

    logits0 = jnp.zeros((n, k), jnp.float32)
    logits, _ = jax.lax.scan(
        per_round, logits0, (split_feature, split_bin, leaf_value)
    )
    return logits
