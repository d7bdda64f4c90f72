"""Microbench: rank-kind pipeline stages whose implementation is a choice.

- autocovariance at the headline's split shape (5000 draws x 256 split
  chains x 256 params): batched rFFT ("fft", what ``autocov_method="auto"``
  runs) against the direct lag scan ("direct");
- the exact mode's fold sort at its chunk shape (N = 1.28M rows, P = 64):
  one payload ``lax.sort`` (``fold_impl="sort"``) against the two-axis
  valley decomposition (``fold_impl="merge"``, ops/ranknorm.valley_sort_2d);
- the whole rank-kind ESS/R-hat at 10k x 128 x 256 in both modes.

    python benchmarks/micro_rankpipe.py
"""
from __future__ import annotations

import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import mcmcdiagnostictools_jl_tpu as mdt
from bench import describe_device
from mcmcdiagnostictools_jl_tpu.ops.autocov import mean_autocov_curve
from mcmcdiagnostictools_jl_tpu.ops.moments import chain_stats
from mcmcdiagnostictools_jl_tpu.ops.ranknorm import (
    folded_rank_values_sorted,
    sort_with_positions,
    sorted_quantile,
)


def timeit(label, fn, *args, reps=5):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ms = sorted(ts)[len(ts) // 2] * 1e3
    print(f"{label:44s} first {first:7.2f} s  median {ms:9.3f} ms", flush=True)
    return ms


@partial(jax.jit, static_argnames=("method",))
def autocov(samples, method):
    stats = chain_stats(samples)
    centered = samples - stats.chain_mean[None]
    return mean_autocov_curve(centered, stats.chain_var, 250, method)


@jax.jit
def bulk_sort(xf):
    xs, order, _ = sort_with_positions(xf[:, None, :])
    return xs, order, sorted_quantile(xs, 0.5)


@partial(jax.jit, static_argnames=("merge",))
def fold(xs, order, med, merge):
    return folded_rank_values_sorted(xs, order, med, merge=merge)


def main():
    print("device:", json.dumps(describe_device()), flush=True)
    rng = np.random.default_rng(0)
    x = jax.device_put(
        rng.standard_normal((10_000, 128, 256)).astype(np.float32))
    split = jnp.concatenate([x[:5000], x[5000:]], axis=1)  # (5000, 256, 256)
    print("== autocov at (5000, 256, 256), maxlag 250", flush=True)
    for method in ("fft", "direct"):
        timeit(f"autocov {method}", autocov, split, method)
    a = np.asarray(autocov(split, "fft"))
    b = np.asarray(autocov(split, "direct"))
    print("  fft vs direct max abs diff:", float(np.max(np.abs(a - b))),
          flush=True)
    del split

    print("== exact fold sort at (1.28M, 64)", flush=True)
    xf = x[:, :, :64].reshape(-1, 64)
    xs, order, med = jax.block_until_ready(bulk_sort(xf))
    for label, merge in (("sort", None), ("merge", "two_sort")):
        timeit(f"fold {label}", fold, xs, order, med, merge)
    za, _ = fold(xs, order, med, None)
    zb, _ = fold(xs, order, med, "two_sort")
    print("  sort vs merge z equal:",
          bool(np.array_equal(np.asarray(za), np.asarray(zb))), flush=True)
    del xs, order, xf

    print("== ess_rhat(kind='rank') at (10000, 128, 256)", flush=True)
    for label, kw in (("exact", {}), ("exact fold merge", {"fold_impl": "merge"}),
                      ("exact fold sort", {"fold_impl": "sort"}),
                      ("fast", {"rank_mode": "fast"})):
        timeit(f"ess_rhat {label}",
               lambda kw=kw: mdt.ess_rhat(x, kind="rank", **kw))


if __name__ == "__main__":
    main()
