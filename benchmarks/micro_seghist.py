"""Microbench: weighted one-hot histogram (per-column segment moments) vs a
full inverse payload sort — the replacement for the fold-inverse sort in
the rank pipeline.

Shapes: N = draws*chains = 1.28M, P = 64 params/chunk, S = 256 split chains.
"""
from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _scalarize(x):
    return jnp.sum(x[:8])


def _force(out):
    return jax.block_until_ready(out)


def timeit(fn, *args, reps=5):
    _force(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _force(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


N, P, S = 1_280_000, 64, 256
rng = np.random.default_rng(0)
vals = jax.device_put(rng.standard_normal((N, P)).astype(np.float32))
segs = jax.device_put(rng.integers(0, S, (N, P)).astype(np.int32))
order = jax.device_put(
    np.stack([rng.permutation(N) for _ in range(P)], axis=1).astype(np.int32)
)


@partial(jax.jit, static_argnames=("tile", "nseg"))
def hist_einsum(values, seg, *, tile: int, nseg: int):
    """lax.map over row tiles; einsum('np,nps->sp') per tile."""
    nt = values.shape[0] // tile
    v = values[: nt * tile].reshape(nt, tile, P)
    s = seg[: nt * tile].reshape(nt, tile, P)
    ks = jnp.arange(nseg, dtype=jnp.int32)

    def one(args):
        vt, st = args
        onehot = (st[:, :, None] == ks[None, None, :]).astype(vt.dtype)
        a = jnp.einsum("np,nps->sp", vt, onehot)
        b = jnp.einsum("np,nps->sp", vt * vt, onehot)
        return a, b

    a, b = jax.lax.map(one, (v, s))
    return a.sum(0), b.sum(0)


@partial(jax.jit, static_argnames=("tile", "nseg"))
def hist_dot(values, seg, *, tile: int, nseg: int):
    """Batched M=2 matmul per tile: (P,2,T) @ (P,T,S) -> (P,2,S)."""
    nt = values.shape[0] // tile
    v = values[: nt * tile].reshape(nt, tile, P)
    s = seg[: nt * tile].reshape(nt, tile, P)
    ks = jnp.arange(nseg, dtype=jnp.int32)

    def one(args):
        vt, st = args
        onehot = (st[:, :, None] == ks[None, None, :]).astype(vt.dtype)
        oh = jnp.moveaxis(onehot, 0, 1)  # (P, T, S)
        vv = jnp.stack([vt, vt * vt], axis=0)  # (2, T, P)
        vv = jnp.moveaxis(vv, 2, 0)  # (P, 2, T)
        out = jax.lax.dot_general(
            vv, oh, (((2,), (1,)), ((0,), (0,)))
        )  # (P, 2, S)
        return out

    out = jax.lax.map(one, (v, s)).sum(0)
    return out[:, 0].T, out[:, 1].T


@jax.jit
def inverse_sort(order, values):
    return jax.lax.sort((order, values), dimension=0, num_keys=1, is_stable=False)


@jax.jit
def plain_sort(values):
    iota = jax.lax.broadcasted_iota(jnp.int32, values.shape, 0)
    return jax.lax.sort((values, iota), dimension=0, num_keys=1, is_stable=False)


@jax.jit
def sort_bf16(values):
    iota = jax.lax.broadcasted_iota(jnp.int32, values.shape, 0)
    return jax.lax.sort(
        (values.astype(jnp.bfloat16), iota), dimension=0, num_keys=1, is_stable=False
    )


if __name__ == "__main__":
    print("inverse payload sort (i32,f32):", timeit(inverse_sort, order, vals))
    print("plain key sort (f32,i32):      ", timeit(plain_sort, vals))
    print("bf16-key sort (bf16,i32):      ", timeit(sort_bf16, vals))
    for tile in (1024, 2048, 4096):
        try:
            t = timeit(lambda v, s: hist_einsum(v, s, tile=tile, nseg=S), vals, segs)
            print(f"hist_einsum tile={tile}:        ", t)
        except Exception as e:
            print(f"hist_einsum tile={tile}: FAIL {type(e).__name__}: {str(e)[:120]}")
    for tile in (1024, 2048, 4096):
        try:
            t = timeit(lambda v, s: hist_dot(v, s, tile=tile, nseg=S), vals, segs)
            print(f"hist_dot tile={tile}:           ", t)
        except Exception as e:
            print(f"hist_dot tile={tile}: FAIL {type(e).__name__}: {str(e)[:120]}")
    # correctness spot check
    a, b = hist_einsum(vals, segs, tile=2048, nseg=S)
    va = np.asarray(vals)[: (N // 2048) * 2048]
    sa = np.asarray(segs)[: (N // 2048) * 2048]
    ref = np.zeros((S, P), np.float64)
    np.add.at(ref, (sa[:, 0], np.zeros(va.shape[0], int)), va[:, 0])
    print("sum col0 max err:", np.abs(np.asarray(a)[:, 0] - ref[:, 0]).max())
