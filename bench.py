"""Benchmark: rank-kind ESS + R-hat throughput on one device.

Prints the device on earlier lines and ONE JSON line last:
{"metric", "value", "unit", "vs_baseline", ...}.

- Workload: BASELINE.md config 4 on one device — 10k draws x 128 chains x
  256 params, f32, kind="rank". Headline = rank_mode="fast" (the
  histogram/CDF fast mode, ops/fastrank.py: sort-free, error bound
  documented and tested); wall_s_exact records the exact-sort mode on the
  same input.
- value: parameter-draws per second (params * draws / wall_s), median of 3
  timed runs after a warmup/compile run.
- vs_baseline: ratio against a single-core NumPy/SciPy float64 implementation
  of the same rank-kind pipeline (tests/ref_impl.py), whose per-element
  throughput is measured on a small config and scaled — the only available
  reference point, since the upstream library publishes no numbers
  (BASELINE.md).

Any failure propagates: the workload never shrinks to make a run succeed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

DRAWS = 10_000
CHAINS = 128
PARAMS = 256
# exact mode processes the parameter axis in chunks of this many columns
EXACT_PARAM_CHUNK = 64
BASELINE_DRAWS, BASELINE_CHAINS, BASELINE_PARAMS = 2_000, 8, 4


def _baseline_throughput() -> float:
    """Single-core NumPy f64 rank-kind ESS+R-hat throughput (param-draws/s).

    Cached in baseline_cache.json so vs_baseline is stable across runs
    (host load would otherwise jitter the denominator); delete the file to
    re-measure.
    """
    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "baseline_cache.json")
    if os.path.exists(cache):
        with open(cache) as fh:
            return json.load(fh)["numpy_rank_param_draws_per_s"]
    sys.path.insert(0, os.path.join(root, "tests"))
    import ref_impl

    rng = np.random.default_rng(0)
    x = rng.standard_normal((BASELINE_DRAWS, BASELINE_CHAINS, BASELINE_PARAMS))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ref_impl.ess_rhat(x, kind="rank")
        times.append(time.perf_counter() - t0)
    value = BASELINE_DRAWS * BASELINE_PARAMS / sorted(times)[1]
    with open(cache, "w") as fh:
        json.dump({"numpy_rank_param_draws_per_s": value}, fh)
    return value


def describe_device() -> dict:
    """The device JAX runs on, plus the card's name and power limit from
    ``nvidia-smi`` where there is one. Printed before any result."""
    import jax

    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    if info["platform"] == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        info["nvidia_smi"] = smi.stdout.strip()
    return info


def main() -> None:
    import jax
    import mcmcdiagnostictools_jl_tpu as mdt
    from mcmcdiagnostictools_jl_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    device = describe_device()
    print("device:", json.dumps(device), flush=True)
    rng = np.random.default_rng(0)
    x = jax.device_put(
        rng.standard_normal((DRAWS, CHAINS, PARAMS)).astype(np.float32)
    ).block_until_ready()

    def run_mode(**kw):
        mdt.ess_rhat(x, kind="rank", **kw).ess.block_until_ready()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            mdt.ess_rhat(x, kind="rank", **kw).ess.block_until_ready()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    dt_fast = run_mode(rank_mode="fast")
    dt_exact = run_mode(param_chunk=EXACT_PARAM_CHUNK)
    value = DRAWS * PARAMS / dt_fast
    baseline = _baseline_throughput()
    print(
        json.dumps(
            {
                "metric": "ess_rhat_rank_throughput_1chip",
                "value": round(value, 1),
                "unit": "param-draws/s",
                "vs_baseline": round(value / baseline, 2),
                "config": f"{DRAWS}x{CHAINS}x{PARAMS} f32",
                "mode": "fast(hist)",
                "wall_s": round(dt_fast, 4),
                "wall_s_exact": round(dt_exact, 4),
                "param_draws_per_s_exact": round(DRAWS * PARAMS / dt_exact, 1),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
