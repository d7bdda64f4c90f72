"""Microbench: histogram/CDF rank-transform building blocks.

Compares formulations of the fast-mode rank transform's two passes at the
bench.py sample (N = draws*chains = 1.28M rows) for P = 256 and P = 64:

histogram (per-column bin statistics over K = 4096 bins):
  - scatter       ops/fastrank.histogram_moments: int32 counts, frac sum and
                  member min/max, one scatter each (the library's path)
  - scatter2      counts and frac sum only (the cost of the min/max pair)
  - radix matmul  digit one-hots (chunk, 64, P) x (chunk, 64, P) contracted
                  per row chunk: bf16 for the counts, f32 at HIGHEST
                  precision for the frac sums

per-element lookup of three (K, P) tables at (N, P) bins:
  - gather        ops/fastrank.lookup_bins (the library's path)
  - radix matmul  coarse one-hot x table block at HIGHEST, then fine select

reference points: one read of the sample (a column sum), the bin-coordinate
pass, and one payload sort (what fast mode removes).

    python benchmarks/micro_hist.py
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from bench import describe_device
from mcmcdiagnostictools_jl_tpu.ops.fastrank import (
    _bin_coords,
    column_minmax,
    histogram_moments,
    lookup_bins,
)

K = 4096
KF = 64
CHUNK = 8192
HIGHEST = jax.lax.Precision.HIGHEST


def timeit(label, fn, *args, reps=5):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ms = sorted(ts)[len(ts) // 2] * 1e3
    print(f"{label:44s} first {compile_s:7.2f} s  median {ms:9.3f} ms",
          flush=True)
    return ms


@jax.jit
def read_once(xf):
    return jnp.sum(xf, axis=0)


@jax.jit
def sort_pair(xf):
    iota = jax.lax.broadcasted_iota(jnp.int32, xf.shape, 0)
    return jax.lax.sort((xf, iota), dimension=0, num_keys=1, is_stable=False)


@jax.jit
def bins(xf):
    lo, hi, _ = column_minmax(xf)
    return _bin_coords(xf, lo, hi, K)


@jax.jit
def hist_scatter(xf, b, frac):
    return histogram_moments(xf, b, frac, K)


@jax.jit
def hist_scatter2(b, frac):
    cols = jax.lax.broadcasted_iota(jnp.int32, b.shape, 1)
    p = b.shape[1]
    cnt = jnp.zeros((K, p), jnp.int32).at[b, cols].add(1)
    s1 = jnp.zeros((K, p), frac.dtype).at[b, cols].add(frac)
    return cnt, s1


@jax.jit
def hist_radix(b, frac):
    n, p = b.shape
    kc = K // KF
    npad = (-n) % CHUNK
    b = jnp.pad(b, ((0, npad), (0, 0)), constant_values=K)
    frac = jnp.pad(frac, ((0, npad), (0, 0)))
    bc = b.reshape(-1, CHUNK, p)
    fr = frac.reshape(-1, CHUNK, p)
    iota_c = jnp.arange(kc, dtype=jnp.int32)
    iota_f = jnp.arange(KF, dtype=jnp.int32)

    def body(carry, op):
        cnt_acc, s1_acc = carry
        bi, fi = op
        ac = (bi // KF)[:, None, :] == iota_c[None, :, None]
        af = (bi % KF)[:, None, :] == iota_f[None, :, None]
        cnt = jnp.einsum("ikp,ifp->kfp", ac.astype(jnp.bfloat16),
                         af.astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32)
        s1 = jnp.einsum("ikp,ifp->kfp", jnp.where(ac, fi[:, None, :], 0.0),
                        af.astype(jnp.float32), precision=HIGHEST)
        return (cnt_acc + cnt, s1_acc + s1), None

    zero = jnp.zeros((kc, KF, p), jnp.float32)
    (cnt, s1), _ = jax.lax.scan(body, (zero, zero), (bc, fr))
    return cnt.reshape(K, p), s1.reshape(K, p)


@jax.jit
def lookup_gather(b, tables):
    return lookup_bins(b, tables)


@jax.jit
def lookup_radix(b, tables):
    n, p = b.shape
    w = tables.shape[-1]
    kc = K // KF
    t = jnp.moveaxis(tables, -1, 0).reshape(w, kc, KF, p)
    t = t.transpose(1, 0, 2, 3).reshape(kc, w * KF, p)
    npad = (-n) % CHUNK
    bc = jnp.pad(b, ((0, npad), (0, 0))).reshape(-1, CHUNK, p)
    iota_c = jnp.arange(kc, dtype=jnp.int32)
    iota_f = jnp.arange(KF, dtype=jnp.int32)

    def body(_, bi):
        ac = ((bi // KF)[:, None, :] == iota_c[None, :, None]).astype(
            jnp.float32)
        rows = jnp.einsum("ikp,kqp->iqp", ac, t, precision=HIGHEST)
        rows = rows.reshape(CHUNK, w, KF, p)
        af = ((bi % KF)[:, None, :] == iota_f[None, :, None]).astype(
            jnp.float32)
        return None, jnp.einsum("iwfp,ifp->wip", rows, af, precision=HIGHEST)

    _, out = jax.lax.scan(body, None, bc)
    return jnp.moveaxis(out, 1, 0).reshape(w, -1, p)[:, :n, :]


def main():
    print("device:", json.dumps(describe_device()), flush=True)
    rng = np.random.default_rng(0)
    for p in (256, 64):
        n = 10_000 * 128
        print(f"== N={n} P={p} K={K} f32", flush=True)
        xf = jax.device_put(rng.standard_normal((n, p)).astype(np.float32))
        timeit("read once (column sum)", read_once, xf)
        timeit("bin coordinates (min/max + bins)", bins, xf)
        b, frac = jax.block_until_ready(bins(xf))
        timeit("hist scatter (cnt, s1, vmin, vmax)", hist_scatter, xf, b, frac)
        timeit("hist scatter (cnt, s1 only)", hist_scatter2, b, frac)
        timeit("hist radix matmul (HIGHEST s1)", hist_radix, b, frac)
        cnt, s1 = hist_scatter2(b, frac)
        tables = jnp.stack([jnp.cumsum(cnt, 0).astype(jnp.float32),
                            cnt.astype(jnp.float32), s1], axis=-1)
        timeit("lookup gather (3 tables)", lookup_gather, b, tables)
        timeit("lookup radix matmul (HIGHEST)", lookup_radix, b, tables)
        timeit("payload sort (f32 key, i32 payload)", sort_pair, xf)
        c1, s_1 = (np.asarray(v) for v in hist_scatter2(b, frac))
        c2, s_2 = (np.asarray(v) for v in hist_radix(b, frac))
        print("  hist counts scatter == radix:", np.array_equal(c1, c2),
              " s1 max abs diff:", float(np.max(np.abs(s_1 - s_2))),
              flush=True)
        l1 = np.asarray(lookup_gather(b, tables))
        l2 = np.asarray(lookup_radix(b, tables))
        print("  lookup gather == radix:", np.array_equal(l1, l2),
              " max abs diff:", float(np.max(np.abs(l1 - l2))), flush=True)
        del xf, b, frac


if __name__ == "__main__":
    main()
