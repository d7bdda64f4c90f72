"""Weak-scaling harness: work-scaled throughput over 1..N virtual devices.

The BASELINE metric is "diagnostic throughput ...; scaling efficiency 1 -> N
hosts". This harness measures the sharded pipelines on an N-virtual-device
CPU mesh
(``--xla_force_host_platform_device_count``), **work-scaled** — every device
keeps the same (draws, chains_local, params) block while the total chain
count grows with N.

Interpretation on this box: all virtual devices share the host's physical
cores (2 here), so total compute grows ~linearly with N while the silicon
does not — the compute-serialized ideal wall is ``N * T1``. The collective /
orchestration overhead of the sharded formulation is therefore

    overhead(N) = T_N / (N * T_1)        (1.0 = free collectives)

and the number a real pod would care about — per-device work + collective
cost staying flat as chains scale — is what ``overhead`` tracks.

Measurements run in ``--rounds`` independent interleaved rounds (every config measured once per round, in
round-robin order, so host-load drift hits all configs alike); the report
records per-config median/min/max across rounds and derives overhead from
the MIN wall (least scheduling noise on a 2-core box). The ``hist`` rank
impl (one-psum histogram rank) joins gather/ring. The independent
cross-check for collective cost is ``benchmarks/multihost.py`` (real
N-process collectives). Its numbers are CPU numbers, not device metrics.
Run:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py [--out benchmarks/scaling.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np


def _timed_once(fn):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="benchmarks/scaling.json")
    ap.add_argument("--draws", type=int, default=5000)
    ap.add_argument("--chains-per-dev", type=int, default=8)
    ap.add_argument("--params", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import jax

    jax.config.update(
        "jax_default_device", jax.local_devices(backend="cpu")[0]
    )
    from mcmcdiagnostictools_jl_tpu.parallel import (
        ess_rhat_sharded,
        make_mesh,
        rhat_nested_sharded,
    )

    cpu = jax.local_devices(backend="cpu")
    d, c_loc, p = args.draws, args.chains_per_dev, args.params
    rng = np.random.default_rng(0)
    scales = [k for k in (1, 2, 4, 8) if k <= len(cpu)]

    # one input + mesh per scale, shared by every config and round (shapes
    # fixed -> jit caches persist across rounds)
    inputs, cfgs, ids_by_k = {}, {}, {}
    for k in scales:
        inputs[k] = rng.standard_normal((d, k * c_loc, p)).astype(np.float32)
        cfgs[k] = make_mesh(k, 1, devices=cpu[:k])
        ids_by_k[k] = np.repeat(np.arange(2 * k), c_loc // 2)

    def make_fn(name, impl, k):
        x, cfg = inputs[k], cfgs[k]
        if name == "ess_rhat_rank":
            return lambda: ess_rhat_sharded(x, cfg, kind="rank",
                                            rank_impl=impl)
        ids = ids_by_k[k]
        return lambda: rhat_nested_sharded(x, ids, cfg, kind="rank",
                                           rank_impl=impl)

    configs = [
        (name, impl, k)
        for name in ("ess_rhat_rank", "rhat_nested_rank")
        for impl in ("gather", "ring", "hist")
        for k in scales
    ]

    # warmup/compile pass (excluded from timing)
    for name, impl, k in configs:
        jax.block_until_ready(make_fn(name, impl, k)())
        print(f"compiled {name}/{impl} N={k}", flush=True)

    walls = {c: [] for c in configs}
    for rnd in range(args.rounds):
        for cfg_key in configs:
            walls[cfg_key].append(_timed_once(make_fn(*cfg_key)))
        print(f"round {rnd + 1}/{args.rounds} done", flush=True)

    report = {
        "host_cores": os.cpu_count(),
        "virtual_devices": len(cpu),
        "per_device_block": [d, c_loc, p],
        "mode": "weak scaling (chains grow with devices)",
        "rounds": args.rounds,
        "runs": {},
    }
    for name in ("ess_rhat_rank", "rhat_nested_rank"):
        for impl in ("gather", "ring", "hist"):
            per_k = {}
            for k in scales:
                ts = walls[(name, impl, k)]
                per_k[k] = {
                    "median": sorted(ts)[len(ts) // 2],
                    "min": min(ts),
                    "max": max(ts),
                    "rounds": ts,
                }
            t1 = per_k[scales[0]]["min"]
            report["runs"][f"{name}_{impl}"] = {
                "wall_s": per_k,
                "overhead_vs_serialized_ideal_min": {
                    k: per_k[k]["min"] / (k * t1) for k in scales
                },
                "total_chain_draw_params_per_s_min": {
                    k: d * (k * c_loc) * p / per_k[k]["min"] for k in scales
                },
            }
            ks = ", ".join(
                f"N={k}: {per_k[k]['min']:.2f}s" for k in scales
            )
            print(f"{name}/{impl}: {ks}", flush=True)

    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2, default=str)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
