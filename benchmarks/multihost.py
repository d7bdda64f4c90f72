"""True multi-process (multi-host) scaling harness via ``jax.distributed``.

``benchmarks/scaling.py`` measures the sharded pipelines on N *virtual
devices inside one process* — it validates collectives and measures their
overhead, but every device shares one Python runtime. This harness runs the
REAL multi-host code path: N separate processes, each owning one CPU device,
joined through ``jax.distributed.initialize`` — the same mechanism that
connects accelerator hosts. The sharded diagnostics run unchanged: the
global (chains-sharded) mesh spans all processes, inputs are built with
``jax.make_array_from_callback`` (each process materializes only its own
chain shard, exactly like chains staying where the sampler left them), and
every cross-chain statistic rides the psum/all_gather/ppermute collectives
inside ``ess_rhat_sharded``.

The workers run on the CPU only (``JAX_PLATFORMS=cpu``, one device each):
on a GPU machine N processes on one card would each reserve most of its
memory. ``jax.devices()`` in a worker is exactly the N-process global CPU
device list.

Usage (parent spawns the workers):

    python benchmarks/multihost.py --procs 2 [--out benchmarks/multihost.json]

Weak scaling: the per-process block (draws x chains_local x params) is held
fixed while total chains grow with the process count, mirroring scaling.py so
the two harnesses' numbers are directly comparable. Worker 0 ASSERTS the
N-process sharded result matches a single-process run of the same global
sample (rel ESS error < 1e-3, abs R-hat error < 1e-5 — float32 collective
reassociation tolerance) and exits nonzero on violation; the parent checks
every worker's exit code.

No reference counterpart: the reference is single-process
(/root/reference/src has no distributed code; SURVEY.md section 5).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

DRAWS, CHAINS_LOCAL, PARAMS = 5000, 8, 16
PORT = 17835
ESS_RTOL = 1e-3
RHAT_ATOL = 1e-5


def _worker(num_procs: int, pid: int, port: int) -> None:
    import jax

    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_procs,
        process_id=pid,
    )
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mcmcdiagnostictools_jl_tpu.parallel import ess_rhat_sharded, make_mesh

    devices = jax.devices()
    assert len(devices) == num_procs, (
        f"expected {num_procs} global devices, got {devices}"
    )
    cfg = make_mesh(chain_shards=num_procs, param_shards=1, devices=devices)

    # same-seeded global sample; make_array_from_callback materializes only
    # this process's chain shard on its local device
    total_chains = CHAINS_LOCAL * num_procs
    rng = np.random.default_rng(0)
    xg = (rng.standard_normal((DRAWS, total_chains, PARAMS)) * 1.3
          ).astype(np.float32)
    sharding = NamedSharding(cfg.mesh, cfg.data_spec)
    x = jax.make_array_from_callback(xg.shape, sharding, lambda idx: xg[idx])

    def run():
        r = ess_rhat_sharded(x, cfg, kind="rank")
        # results are replicated over the chain axis: every process holds the
        # full vectors in its addressable shard
        ess = np.asarray(r.ess.addressable_data(0))
        rhat = np.asarray(r.rhat.addressable_data(0))
        return ess, rhat

    multihost_utils.sync_global_devices("warmup-start")
    ess, rhat = run()  # compile + warmup
    multihost_utils.sync_global_devices("timing-start")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        multihost_utils.sync_global_devices("timing-step")
        times.append(time.perf_counter() - t0)
    wall = sorted(times)[1]

    # ---- attribution probes (round-5 verdict ask 7) -------------------
    # The weak-scaling walls mix three things: per-device compute growth
    # (the gather impl re-sorts ALL chains per device), collective cost,
    # and HOST CORE OVERSUBSCRIPTION (N worker processes share this
    # machine's physical cores). Two local-only probes separate them:
    # the same per-process block computed with NO collectives, (a) by all
    # workers simultaneously (inherits the contention), (b) by worker 0
    # alone (no contention). sharded-vs-(a) isolates collectives+global
    # growth; (a)-vs-(b) isolates oversubscription.
    import mcmcdiagnostictools_jl_tpu as mdt

    x_local = jax.device_put(
        xg[:, pid * CHAINS_LOCAL:(pid + 1) * CHAINS_LOCAL, :],
        jax.local_devices()[0],
    )

    def run_local():
        r = mdt.ess_rhat(x_local, kind="rank")
        np.asarray(r.ess)

    run_local()  # compile
    multihost_utils.sync_global_devices("local-all-start")
    t0 = time.perf_counter()
    run_local()
    local_all_busy = time.perf_counter() - t0
    multihost_utils.sync_global_devices("local-all-done")
    if pid == 0:
        t0 = time.perf_counter()
        run_local()
        local_solo = time.perf_counter() - t0
    multihost_utils.sync_global_devices("local-solo-done")

    if pid == 0:
        # parity: single-process oracle on the identical global sample
        # (mdt already imported by the probe section above)
        ref = mdt.ess_rhat(xg, kind="rank")
        err_ess = float(np.max(np.abs(ess - np.asarray(ref.ess))
                               / np.asarray(ref.ess)))
        err_rhat = float(np.max(np.abs(rhat - np.asarray(ref.rhat))))
        print(json.dumps({
            "procs": num_procs,
            "global_shape": [DRAWS, total_chains, PARAMS],
            "wall_s": wall,
            "local_block_all_procs_busy_s": local_all_busy,
            "local_block_solo_s": local_solo,
            "rel_err_ess_vs_single_process": err_ess,
            "abs_err_rhat_vs_single_process": err_rhat,
        }), flush=True)
        assert err_ess < ESS_RTOL, (
            f"multi-host ESS diverged from single-process: {err_ess}"
        )
        assert err_rhat < RHAT_ATOL, (
            f"multi-host R-hat diverged from single-process: {err_rhat}"
        )
    jax.distributed.shutdown()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--_worker", type=int, default=None, help="internal")
    ap.add_argument("--_port", type=int, default=PORT, help="internal")
    args = ap.parse_args()

    if args._worker is not None:
        _worker(args.procs, args._worker, args._port)
        return

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # one device per process — no virtual devices
    procs = []
    errfiles = []
    try:
        for pid in range(args.procs):
            ef = tempfile.NamedTemporaryFile(
                mode="w+", prefix=f"multihost{pid}_", suffix=".err",
                delete=False,
            )
            errfiles.append(ef)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--procs", str(args.procs), "--_worker", str(pid),
                 "--_port", str(args._port)],
                stdout=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
                stderr=ef, env=env, text=True,
            ))
        out, _ = procs[0].communicate(timeout=args.timeout)
        for p in procs[1:]:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()

    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for i in failed:
            errfiles[i].seek(0)
            tail = errfiles[i].read()[-2000:]
            print(f"--- worker {i} exit {procs[i].returncode} stderr tail ---\n"
                  f"{tail}", file=sys.stderr)
        raise SystemExit(f"multihost workers failed: {failed}")

    lines = [l for l in out.splitlines() if l.startswith("{")]
    if not lines:
        print(f"worker 0 produced no JSON; stdout:\n{out[-2000:]}",
              file=sys.stderr)
        raise SystemExit(1)
    result = json.loads(lines[-1])
    result["parity_asserted"] = {"ess_rtol": ESS_RTOL, "rhat_atol": RHAT_ATOL}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)


if __name__ == "__main__":
    main()
