"""Smoke run of the diagnostics engine on the GPU, checked against the
repository's plain references.

    python chip_smoke.py            # one GPU: phases 1-4
    python chip_smoke.py --multi    # four GPUs: the sharded path only

Phases (default):

1. device: JAX's device and the card's name and power limit;
2. headline: ``ess_rhat(kind="rank")`` at 10k draws x 128 chains x 256
   params f32, exact mode against the f64 NumPy oracle (tests/ref_impl.py)
   on a column subset, fast mode against exact; warm and first-call times;
3. precision detector: the same shape with integer-valued draws, where the
   fast mode must reproduce the exact tied-average ranks — any lookup or
   count computed at reduced precision breaks the equality;
4. the rest of the public surface at the sizes of benchmarks/suite.py
   configs 1-3 and 5.

``--multi`` runs the chain-sharded pipelines on four GPUs and compares each
with a one-GPU run of the same call in this process.

Every check prints one line; the last line of a run that passed every check
is ``{"ok": true, "device": {...}}``. Without a GPU, or when any check fails,
the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np

HEADLINE = (10_000, 128, 256)  # draws, chains, params (bench.py, suite config 4)
ORACLE_COLS = (0, 37, 73, 110, 146, 183, 240, 255)  # 240+ have a shifted chain

# Tolerances (f32 on the card):
# - exact mode vs the f64 oracle: the ranks are exact; what differs is f32
#   rounding in the moments and the FFT autocovariance (~1e-6 relative) and
#   its amplification through the Geyer truncation — R-hat abs 1e-4, ESS
#   rel 1e-3;
# - fast vs exact: the documented fast-mode bound (ops/fastrank.py), as the
#   in-repo tests pin it — ESS rel 1e-3, R-hat abs 1e-4;
# - integer-valued draws: fast must equal exact up to f32 rounding — rel 1e-5.
EXACT_RHAT_ATOL, EXACT_ESS_RTOL = 1e-4, 1e-3
FAST_ESS_RTOL, FAST_RHAT_ATOL = 1e-3, 1e-4
TIES_RTOL = 1e-5


class Checks:
    """Collects check results; a failed check fails the run at the end."""

    def __init__(self):
        self.failed = []

    def __call__(self, name: str, ok: bool, detail: str = "") -> None:
        print(f"  [{'pass' if ok else 'FAIL'}] {name} {detail}", flush=True)
        if not ok:
            self.failed.append(name)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


def _timed_call(fn, warm: int = 3):
    """(first-call seconds, warm median seconds of ``warm`` runs, result)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, sorted(times)[len(times) // 2], out


def ar1_sample(seed: int, shape, shift_last: int = 16):
    """Device-generated AR(1) draws, unit marginal variance, with the
    autocorrelation rising from 0 to 0.9 across the parameters; chain 0 of
    the last ``shift_last`` parameters is shifted by 3 so their R-hat
    exceeds 1."""
    import jax
    import jax.numpy as jnp

    draws, chains, params = shape

    @jax.jit
    def make(key):
        phi = jnp.linspace(0.0, 0.9, params, dtype=jnp.float32)
        eps = jax.random.normal(key, shape, jnp.float32)

        def step(prev, e):
            nxt = phi * prev + jnp.sqrt(1.0 - phi * phi) * e
            return nxt, nxt

        _, xs = jax.lax.scan(step, eps[0], eps)
        shift = jnp.zeros((chains, params), jnp.float32)
        shift = shift.at[0, params - shift_last:].set(3.0)
        return xs + shift[None]

    return make(jax.random.key(seed))


def phase_device(expect: int) -> dict:
    import jax

    from bench import describe_device

    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    print("devices:", devices, flush=True)
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {info['platform']!r}")
    if info["count"] < expect:
        raise SystemExit(f"need {expect} GPUs, JAX sees {info['count']}")
    card = describe_device()["nvidia_smi"]
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    return info


def phase_headline(check: Checks, shape=HEADLINE, cols=ORACLE_COLS):
    import ref_impl

    import mcmcdiagnostictools_jl_tpu as mdt

    print(f"== headline: ess_rhat(kind='rank') at {shape} f32", flush=True)
    x = ar1_sample(0, shape)
    t1, tw, exact = _timed_call(lambda: mdt.ess_rhat(x, kind="rank"))
    print(f"  exact: first call {t1:.3f} s, warm {tw:.4f} s", flush=True)
    t1, tw, fast = _timed_call(
        lambda: mdt.ess_rhat(x, kind="rank", rank_mode="fast"))
    print(f"  fast:  first call {t1:.3f} s, warm {tw:.4f} s", flush=True)
    ess_e, rhat_e = np.asarray(exact.ess), np.asarray(exact.rhat)
    ess_f, rhat_f = np.asarray(fast.ess), np.asarray(fast.rhat)
    check("shapes and finite values",
          ess_e.shape == (shape[2],) and ess_f.shape == (shape[2],)
          and all(np.all(np.isfinite(v))
                  for v in (ess_e, rhat_e, ess_f, rhat_f)))
    check("shifted-chain columns flagged (rhat > 1.01)",
          bool(np.all(rhat_e[-16:] > 1.01)),
          f"min {rhat_e[-16:].min():.4f}")
    sub = np.asarray(x[:, :, list(cols)], np.float64)
    ess_r, rhat_r = ref_impl.ess_rhat(sub, kind="rank")
    d_rhat = _abs(rhat_e[list(cols)], rhat_r)
    d_ess = _rel(ess_e[list(cols)], ess_r)
    check("exact vs f64 oracle: rhat", d_rhat <= EXACT_RHAT_ATOL,
          f"max abs {d_rhat:.3e} (limit {EXACT_RHAT_ATOL:g})")
    check("exact vs f64 oracle: ess", d_ess <= EXACT_ESS_RTOL,
          f"max rel {d_ess:.3e} (limit {EXACT_ESS_RTOL:g})")
    d_ess = _rel(ess_f, ess_e)
    d_rhat = _abs(rhat_f, rhat_e)
    check("fast vs exact: ess", d_ess <= FAST_ESS_RTOL,
          f"max rel {d_ess:.3e} (limit {FAST_ESS_RTOL:g})")
    check("fast vs exact: rhat", d_rhat <= FAST_RHAT_ATOL,
          f"max abs {d_rhat:.3e} (limit {FAST_RHAT_ATOL:g})")


def phase_ties(check: Checks, shape=HEADLINE):
    import jax
    import jax.numpy as jnp

    import mcmcdiagnostictools_jl_tpu as mdt

    print(f"== precision detector: Poisson(3) draws as f32 at {shape}",
          flush=True)
    x = jax.jit(lambda k: jax.random.poisson(k, 3.0, shape).astype(
        jnp.float32))(jax.random.key(1))
    exact = mdt.ess_rhat(x, kind="rank")
    fast = mdt.ess_rhat(x, kind="rank", rank_mode="fast")
    d_ess = _rel(fast.ess, exact.ess)
    d_rhat = _rel(fast.rhat, exact.rhat)
    check("ties: fast ess == exact", d_ess <= TIES_RTOL,
          f"max rel {d_ess:.3e} (limit {TIES_RTOL:g})")
    check("ties: fast rhat == exact", d_rhat <= TIES_RTOL,
          f"max rel {d_rhat:.3e} (limit {TIES_RTOL:g})")
    tail_e = mdt.ess(x, kind="tail")
    tail_f = mdt.ess(x, kind="tail", rank_mode="fast")
    d_tail = _rel(tail_f, tail_e)
    check("ties: fast tail ess == exact", d_tail <= TIES_RTOL,
          f"max rel {d_tail:.3e} (limit {TIES_RTOL:g})")


def phase_surface(check: Checks, scale: float = 1.0):
    """suite.py configs 1-3 and 5; ``scale`` < 1 shrinks them for a CPU
    rehearsal."""
    import jax
    import ref_impl

    import mcmcdiagnostictools_jl_tpu as mdt
    from mcmcdiagnostictools_jl_tpu.models import (
        GBTClassifier,
        eight_schools_logpdf,
        hmc_sample,
    )

    def n(v):
        return max(int(v * scale), 8)

    rng = np.random.default_rng(0)
    print("== config 1: ess_rhat / tail ess, 1000 draws x 4 chains", flush=True)
    x1 = rng.standard_normal((1000, 4, 1)).astype(np.float32)
    r = mdt.ess_rhat(x1, kind="rank")
    e, rh = ref_impl.ess_rhat(x1.astype(np.float64), kind="rank")
    check("config 1 ess_rhat vs oracle",
          _rel(r.ess, e) <= EXACT_ESS_RTOL and _abs(r.rhat, rh) <= 1e-5,
          f"ess rel {_rel(r.ess, e):.2e}, rhat abs {_abs(r.rhat, rh):.2e}")
    t = mdt.ess(x1, kind="tail")
    t_ref = ref_impl.ess(x1.astype(np.float64), kind="tail")
    check("config 1 tail ess vs oracle", _rel(t, t_ref) <= EXACT_ESS_RTOL,
          f"rel {_rel(t, t_ref):.2e}")

    print("== config 2: mcse + bfmi on the eight-schools HMC trace",
          flush=True)
    init = jax.random.normal(jax.random.PRNGKey(2), (8, 10)) * 0.5
    trace = hmc_sample(eight_schools_logpdf, init, jax.random.PRNGKey(3),
                       num_samples=1000, step_size=0.2, max_leapfrog=16)
    xs = np.asarray(trace.samples, np.float32)
    x64 = xs.astype(np.float64)
    for label, got, want in (
        ("mean", mdt.mcse(xs), ref_impl.mcse_mean(x64)),
        ("std", mdt.mcse(xs, kind="std"), ref_impl.mcse_std(x64)),
        ("Quantile(0.25)", mdt.mcse(xs, kind=mdt.Quantile(0.25)),
         ref_impl.mcse_quantile(x64, 0.25)),
    ):
        d = _rel(got, want)
        check(f"mcse {label} vs oracle", d <= 1e-3, f"max rel {d:.2e}")
    q_exact = mdt.mcse(xs, kind=mdt.Quantile(0.25))
    q_fast = mdt.mcse(xs, kind=mdt.Quantile(0.25), rank_mode="fast")
    # no documented bound yet for the fast quantile MCSE (ROADMAP B5):
    # held to 10 %, twice the deviation recorded for this trace before
    d = _rel(q_fast, q_exact)
    check("mcse Quantile(0.25) fast vs exact", d <= 0.1, f"max rel {d:.2e}")
    energy = np.asarray(trace.energy, np.float32)
    e64 = energy.astype(np.float64)
    want = (np.sum(np.diff(e64, axis=0) ** 2, axis=0)
            / np.sum((e64 - e64.mean(axis=0)) ** 2, axis=0))
    d = _rel(mdt.bfmi(energy), want)
    check("bfmi vs NumPy formula", d <= 1e-4, f"max rel {d:.2e}")

    print("== config 3: classical suite, 10k draws x 8 chains x 100 params",
          flush=True)
    x3 = rng.standard_normal((n(10_000), 8, n(100))).astype(np.float32)
    g = mdt.gelmandiag(x3)
    g_ref = ref_impl.gelmandiag(x3.astype(np.float64))[:2]
    check("gelmandiag psrf vs oracle", _rel(g.psrf, g_ref[0]) <= 1e-4,
          f"max rel {_rel(g.psrf, g_ref[0]):.2e}")
    check("gelmandiag psrfci vs oracle", _rel(g.psrfci, g_ref[1]) <= 1e-4,
          f"max rel {_rel(g.psrfci, g_ref[1]):.2e}")
    gm = mdt.gelmandiag_multivariate(x3)
    gm_ref = ref_impl.gelman_multivariate(x3.astype(np.float64))
    d = abs(gm.psrfmultivariate - gm_ref[2]) / gm_ref[2]
    check("gelmandiag_multivariate vs oracle", d <= 1e-4, f"rel {d:.2e}")
    series = ((0, 0), (3, x3.shape[2] // 2), (7, x3.shape[2] - 1))
    gw = mdt.gewekediag(x3)
    ok = all(np.isfinite(np.asarray(v)).all() for v in gw)
    for c, p in series:
        one = mdt.gewekediag(x3[:, c, p])
        ok &= abs(float(gw[0][c, p]) - float(one[0])) <= 1e-4
    check("gewekediag batched finite and == scalar path", ok)
    hd = mdt.heideldiag(x3)
    ok = all(np.isfinite(np.asarray(v, float)).all() for v in hd)
    for c, p in series:
        one = mdt.heideldiag(x3[:, c, p])
        ok &= abs(float(hd.halfwidth[c, p]) - float(one.halfwidth)) <= 1e-4
    check("heideldiag batched finite and == scalar path", ok)
    rf = mdt.rafterydiag(x3)
    ok = all(np.isfinite(np.asarray(v, float)).all() for v in rf)
    for c, p in series:
        one = mdt.rafterydiag(x3[:, c, p])
        ok &= float(rf[0][c, p]) == float(one[0])
    check("rafterydiag batched finite and == scalar path", ok)
    xd = np.digitize(x3, [-1.0, 0.0, 1.0])
    for method in ("weiss", "billingsleyBOOT"):
        dd = mdt.discretediag(xd, method=method, nsim=1000, rng=0)
        b = dd.between_chain
        ok = (np.isfinite(b.stat).all() and np.all((b.pvalue >= 0)
              & (b.pvalue <= 1)))
        # iid draws: between-chain p-values are uniform, so their mean is
        # near 1/2 (0.2-0.8 leaves room for 100 noisy draws)
        mean_p = float(np.mean(b.pvalue))
        check(f"discretediag {method} finite, p-values in [0,1], mean p "
              "near 1/2", ok and 0.2 < mean_p < 0.8, f"mean p {mean_p:.3f}")

    print("== config 5: nested R-hat + R* over 10k chains", flush=True)
    nchains = n(10_000)
    x5 = rng.standard_normal((100, nchains, 4)).astype(np.float32)
    ids = np.repeat(np.arange(100), nchains // 100)
    rn = mdt.rhat_nested(x5, ids)
    rn_ref = ref_impl.rhat_nested(x5.astype(np.float64), ids)
    d = _abs(rn, rn_ref)
    check("rhat_nested vs oracle", d <= 1e-5, f"max abs {d:.2e}")
    dist = mdt.rstar(GBTClassifier(n_rounds=20, n_bins=32, class_chunk=256),
                     x5, rng=0)
    mean = float(dist.mean())
    check("rstar on iid chains: mean near 1", abs(mean - 1) < 0.1,
          f"mean {mean:.4f}")
    # a shifted chain is a 2-of-16-class signal at 8 chains; among 2e4
    # classes it would sit below the quantile bins' resolution
    x8 = rng.standard_normal((1000, 8, 4)).astype(np.float32)
    x8[:, 0, :] += 2.0
    dist = mdt.rstar(GBTClassifier(n_rounds=20, n_bins=32), x8, rng=0)
    mean = float(dist.mean())
    # on iid chains the mean's spread here is ~0.08, so 1.3 is > 3 sigma
    check("rstar with one shifted chain: mean clearly above 1", mean > 1.3,
          f"mean {mean:.4f}")


def phase_multi(check: Checks, shape=HEADLINE, nested_chains=10_000,
                ndev: int = 4):
    """Sharded pipelines on ``ndev`` devices vs one-device runs."""
    import jax

    import mcmcdiagnostictools_jl_tpu as mdt
    from mcmcdiagnostictools_jl_tpu.models.gbt import (
        GBTClassifier,
        ShardedGBTClassifier,
    )
    from mcmcdiagnostictools_jl_tpu.parallel import (
        ess_rhat_sharded,
        make_mesh,
        rhat_nested_sharded,
    )

    devices = jax.devices()[:ndev]
    print(f"== sharded ess_rhat at {shape} f32 on {ndev} devices", flush=True)
    x = ar1_sample(0, shape)
    single = {
        "exact": jax.block_until_ready(mdt.ess_rhat(x, kind="rank")),
        "fast": jax.block_until_ready(
            mdt.ess_rhat(x, kind="rank", rank_mode="fast")),
    }
    hist_ref = None
    for chains_, params_ in ((ndev, 1), (ndev // 2, 2)):
        cfg = make_mesh(chains_, params_, devices=devices)
        used = {d for d in cfg.mesh.devices.flat}
        check(f"mesh {chains_}x{params_} spans {ndev} distinct devices",
              len(used) == ndev)
        for impl in ("gather", "ring", "hist"):
            t1, tw, r = _timed_call(lambda impl=impl, cfg=cfg: ess_rhat_sharded(
                x, cfg, kind="rank", rank_impl=impl), warm=1)
            ref = single["fast" if impl == "hist" else "exact"]
            d_ess = _rel(r.ess, ref.ess)
            d_rhat = _abs(r.rhat, ref.rhat)
            print(f"  mesh {chains_}x{params_} {impl}: first {t1:.3f} s, "
                  f"warm {tw:.4f} s", flush=True)
            shards = {s.device for s in r.ess.addressable_shards}
            check(f"mesh {chains_}x{params_} {impl} vs one device",
                  d_ess <= 1e-3 and d_rhat <= 1e-5 and len(shards) > 1,
                  f"ess rel {d_ess:.2e} (1e-3), rhat abs {d_rhat:.2e} "
                  f"(1e-5), result on {len(shards)} devices")
            if impl == "hist" and params_ == 1:
                hist_ref = r

    cfg = make_mesh(ndev, 1, devices=devices)
    rs = mdt.ess_rhat_streaming(np.asarray(x), param_chunk=64, mesh_cfg=cfg)
    d = _rel(rs.ess, hist_ref.ess)
    check("streaming onto the mesh vs sharded hist", d <= 1e-5,
          f"ess rel {d:.2e} (1e-5)")

    print(f"== sharded nested R-hat, 100 draws x {nested_chains} chains",
          flush=True)
    rng = np.random.default_rng(5)
    x5 = rng.standard_normal((100, nested_chains, 4)).astype(np.float32)
    ids = np.repeat(np.arange(100), nested_chains // 100)
    want = np.asarray(mdt.rhat_nested(x5, ids))
    got = np.asarray(rhat_nested_sharded(x5, ids, cfg))
    d = _abs(got, want)
    check("rhat_nested_sharded vs one device", d <= 1e-5, f"max abs {d:.2e}")

    print("== ShardedGBTClassifier fit vs one device", flush=True)
    xg = rng.standard_normal((20_000, 4)).astype(np.float32)
    yg = rng.integers(0, 16, 20_000)
    xg[:, 0] += yg * 0.3
    one = GBTClassifier(n_rounds=10, n_bins=32)
    many = ShardedGBTClassifier(n_rounds=10, n_bins=32, devices=tuple(devices))
    s1 = one.fit(xg, yg, 16)
    s2 = many.fit(xg, yg, 16)
    same = (np.array_equal(np.asarray(s1.split_feature),
                           np.asarray(s2.split_feature))
            and np.array_equal(np.asarray(s1.split_bin),
                               np.asarray(s2.split_bin)))
    d = _abs(s1.leaf_value, s2.leaf_value)
    check("sharded GBT: same splits, leaf values within 1e-5",
          same and d <= 1e-5, f"leaf max abs {d:.2e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the sharded path on four GPUs instead")
    args = ap.parse_args()

    from mcmcdiagnostictools_jl_tpu.utils.profiling import (
        enable_compilation_cache,
    )

    ndev = 4 if args.multi else 1
    info = phase_device(ndev)
    enable_compilation_cache()
    check = Checks()
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(check, ndev=ndev)
    else:
        phase_headline(check)
        phase_ties(check)
        phase_surface(check)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if check.failed:
        raise SystemExit(f"{len(check.failed)} check(s) failed: "
                         + "; ".join(check.failed))
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
