"""Benchmark harness for the five BASELINE.json configurations.

Writes one JSON report with wall times and derived throughputs. Run on the
accelerator (f32):

    python benchmarks/suite.py [--out benchmarks/report.json]

Configs (BASELINE.md):
1. rank-normalized split-R-hat + bulk/tail ESS, 4 chains x 1000 draws iid
2. MCSE (mean/std/quantile) + BFMI on a stored 8-chain HMC 8-schools trace
3. full classical suite batched over 100 params x 8 chains x 10k draws
   (discretediag at FULL scale: 100 params, nsim=1000)
4. large batched ESS/R-hat: 1000 params x 128 chains x 10k draws, exact
   and histogram-fast rank modes, plus the streaming executor
5. many-chain regime: nested R-hat + R* over 10k chains (one device here;
   the multi-device variant runs via parallel.ess_rhat_sharded)

Every config runs in its OWN SUBPROCESS, one at a time, and this parent
process never imports JAX: only one process holds the device at a time,
and a failure in one config cannot poison another's device state. Results
MERGE into the existing report (a failed re-run records its error under
``last_error`` but never overwrites a previously valid entry); the report is
flushed after every config, and the run exits non-zero if any config failed.
Each result names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CONFIG_TIMEOUT_S = 2400.0


def _force(out):
    """Wait until every array in ``out`` is computed."""
    import jax

    return jax.block_until_ready(out)


def _timed(fn, repeats: int = 3):
    """Median wall of ``repeats`` runs after one warm-up run."""
    out = _force(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = _force(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def config1():
    import mcmcdiagnostictools_jl_tpu as mdt

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1000, 4)).astype(np.float32)
    dt, r = _timed(lambda: mdt.ess_rhat(x, kind="rank"))
    dt_tail, _ = _timed(lambda: mdt.ess(x, kind="tail"))
    return {
        "wall_s_rank": dt, "wall_s_tail_ess": dt_tail,
        "ess": float(np.asarray(r.ess)), "rhat": float(np.asarray(r.rhat)),
    }


def config2():
    import jax
    import mcmcdiagnostictools_jl_tpu as mdt
    from mcmcdiagnostictools_jl_tpu.models import eight_schools_logpdf, hmc_sample

    init = jax.random.normal(jax.random.PRNGKey(2), (8, 10)) * 0.5
    trace = hmc_sample(eight_schools_logpdf, init, jax.random.PRNGKey(3),
                       num_samples=1000, step_size=0.2, max_leapfrog=16)
    x = np.asarray(trace.samples, dtype=np.float32)
    energy = np.asarray(trace.energy, dtype=np.float32)
    dt_mean, _ = _timed(lambda: mdt.mcse(x))
    dt_std, _ = _timed(lambda: mdt.mcse(x, kind="std"))
    dt_q, rq = _timed(lambda: mdt.mcse(x, kind=mdt.Quantile(0.25)))
    # the sort-free fast path (histogram thresholds + two-pass zoomed
    # inverse ECDF) on the same call, with its deviation recorded
    dt_qf, rqf = _timed(
        lambda: mdt.mcse(x, kind=mdt.Quantile(0.25), rank_mode="fast")
    )
    dt_mf, _ = _timed(lambda: mdt.mcse(x, kind="median", rank_mode="fast"))
    dt_bfmi, b = _timed(lambda: mdt.bfmi(energy))
    rel = np.max(np.abs(np.asarray(rqf) / np.asarray(rq) - 1.0))
    return {
        "wall_s_mcse_mean": dt_mean, "wall_s_mcse_std": dt_std,
        "wall_s_mcse_quantile": dt_q,
        "wall_s_mcse_quantile_fast": dt_qf,
        "wall_s_mcse_median_fast": dt_mf,
        "mcse_quantile_fast_max_rel_dev": float(rel),
        "wall_s_bfmi": dt_bfmi,
        "bfmi_min": float(np.min(np.asarray(b))),
    }


def config3():
    import mcmcdiagnostictools_jl_tpu as mdt
    from mcmcdiagnostictools_jl_tpu.diagnostics.batch import (
        gewekediag_batch, heideldiag_batch, rafterydiag_batch,
    )

    rng = np.random.default_rng(0)
    x = rng.standard_normal((10_000, 8, 100)).astype(np.float32)
    out = {}
    t0 = time.perf_counter()
    gewekediag_batch(x)
    out["wall_s_geweke_batch_cold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gewekediag_batch(x)
    out["wall_s_geweke_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    heideldiag_batch(x)
    out["wall_s_heidel_batch_cold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    heideldiag_batch(x)
    out["wall_s_heidel_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rafterydiag_batch(x)  # vectorized host path, all 800 series
    out["wall_s_raftery_800series"] = time.perf_counter() - t0
    # discretediag at FULL config-3 scale (100 params, nsim=1000)
    from mcmcdiagnostictools_jl_tpu.diagnostics.discretediag import discretediag
    xd = np.digitize(x, [-1.0, 0.0, 1.0])  # 4-category codes, all 100 params
    t0 = time.perf_counter()
    discretediag(xd, nsim=1000)
    out["wall_s_discretediag_weiss_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    discretediag(xd, method="billingsleyBOOT", nsim=1000)
    out["wall_s_discretediag_billingsleyBOOT_full"] = time.perf_counter() - t0
    dt, _ = _timed(lambda: mdt.gelmandiag(x))
    out["wall_s_gelman"] = dt
    return out


def config4(params: int = 1000):
    """The large batched ESS/R-hat config.

    ``device_put`` is asynchronous, so the input is transferred once and
    blocked on before any timed run.
    """
    import jax
    import mcmcdiagnostictools_jl_tpu as mdt

    rng = np.random.default_rng(0)
    host = rng.standard_normal((10_000, 128, params)).astype(np.float32)
    results = {"params": params}
    t0 = time.perf_counter()
    cur = jax.device_put(host)
    cur.block_until_ready()
    results["device_put_s"] = time.perf_counter() - t0
    del host

    def measure(label, run, chunk, repeats=2):
        _force(run(cur, chunk))  # compile + warmup
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            _force(run(cur, chunk))
            times.append(time.perf_counter() - t0)
        dt = sorted(times)[len(times) // 2]
        results[f"wall_s_rank_{label}"] = dt
        results[f"param_draws_per_s_{label}"] = 10_000 * params / dt

    measure("exact",
            lambda x, c: mdt.ess_rhat(x, kind="rank", param_chunk=c), 64)
    measure("fast",
            lambda x, c: mdt.ess_rhat(x, kind="rank", rank_mode="fast",
                                      param_chunk=c), 128)

    # streaming executor: ingestion + compute via the double-buffered
    # param-chunk pipeline — the execution model for larger-than-device
    # arrays. Wall includes ALL host->device transfer; the fetch/wait split
    # records the overlap achieved.
    del cur
    host2 = rng.standard_normal((10_000, 128, params)).astype(np.float32)
    warm = mdt.ess_rhat_streaming(host2[:, :, :128], param_chunk=128)
    np.asarray(warm.ess)  # compile the chunk shape
    t0 = time.perf_counter()
    r, stats = mdt.ess_rhat_streaming(host2, param_chunk=128,
                                      return_stats=True)
    np.asarray(r.ess)
    dt = time.perf_counter() - t0
    results["wall_s_stream_fast_incl_ingest"] = dt
    results["stream_fetch_s_sum"] = round(sum(stats.fetch_s), 2)
    results["stream_wait_s_sum"] = round(sum(stats.wait_s), 2)
    results["stream_chunks"] = stats.n_chunks
    return results


def config5():
    import mcmcdiagnostictools_jl_tpu as mdt
    from mcmcdiagnostictools_jl_tpu.models import GBTClassifier

    rng = np.random.default_rng(0)
    nchains, ndraws, nparams = 10_000, 100, 4
    x = rng.standard_normal((ndraws, nchains, nparams)).astype(np.float32)
    ids = np.repeat(np.arange(100), 100)  # 100 superchains x 100 chains
    dt_nested, r = _timed(lambda: mdt.rhat_nested(x, ids))
    t0 = time.perf_counter()
    # full-scale R*: 1e4 chains -> 2e4 split-chain classes through the
    # class-chunked streaming GBT (models/gbt.py, never materializes the
    # (n, K) logit matrix)
    dist = mdt.rstar(
        GBTClassifier(n_rounds=20, n_bins=32, class_chunk=256), x, rng=0
    )
    dt_rstar = time.perf_counter() - t0
    return {
        "wall_s_nested_rhat_10k_chains": dt_nested,
        "nested_rhat_max": float(np.max(np.asarray(r))),
        "wall_s_rstar_10k_chains_incl_compile": dt_rstar,
        "rstar_mean": float(dist.mean()),
    }


CONFIGS = {"1": config1, "2": config2, "3": config3, "4": config4,
           "5": config5}


def _run_one(key: str) -> None:
    """Subprocess entry: run one config, print its JSON on the last line.
    A failing config raises, so the child exits non-zero."""
    from bench import describe_device

    device = describe_device()
    print("device:", json.dumps(device), flush=True)
    t0 = time.perf_counter()
    result = CONFIGS[key]()
    result["total_s_incl_compile"] = time.perf_counter() - t0
    result["device"] = device
    print("RESULT:" + json.dumps(result), flush=True)


def _merge(report: dict, key: str, new: dict) -> None:
    """Merge a config result: never overwrite a valid entry with a failure."""
    old = report["configs"].get(key)
    if "error" in new and old and "error" not in old:
        old["last_error"] = new["error"]
        old["last_error_total_s"] = new.get("total_s_incl_compile")
        return
    report["configs"][key] = new


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="benchmarks/report.json")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--timeout", type=float, default=CONFIG_TIMEOUT_S)
    ap.add_argument("--_one", default=None, help="internal: run one config")
    args = ap.parse_args()

    if args._one is not None:
        _run_one(args._one)
        return

    report = {"configs": {}}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            try:
                report = json.load(fh)
            except json.JSONDecodeError:
                pass
    report.setdefault("configs", {})

    def run_subprocess(key):
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--_one", key],
                capture_output=True, text=True, timeout=args.timeout,
            )
        except subprocess.TimeoutExpired:
            return {"error": f"timeout after {args.timeout}s"}
        lines = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
        if proc.returncode == 0 and lines:
            return json.loads(lines[-1][len("RESULT:"):])
        return {"error": f"exit {proc.returncode}; stderr tail: "
                + proc.stderr[-300:]}

    failed = []
    for key in args.configs.split(","):
        result = run_subprocess(key)
        if "error" in result:
            failed.append(key)
        _merge(report, key, result)
        print(f"config {key}: {json.dumps(result)}", flush=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
    print("wrote", args.out)
    if failed:
        raise SystemExit(f"configs failed: {','.join(failed)}")


if __name__ == "__main__":
    main()
