"""Out-of-core / streaming execution over the parameter axis.

The BASELINE north-star workload (1e4 chains x 1e4 draws x 1e3 params, f32)
is a 400 GB array — more than four 80 GB cards hold, so the "whole array
device-resident" execution model (SURVEY.md section 5 invariant: draws never
shard) cannot hold it. Every kernel in this library is per-parameter
independent, which makes the parameter axis the natural streaming axis:
process P in chunks, with the host->device transfer of chunk k+1 overlapping
the compute of chunk k (double buffering). Peak device memory is two chunks
regardless of P, and the wall approaches ``max(total_transfer,
total_compute)`` instead of their sum.

Two entry points:

- :func:`stream_param_chunks` — the generic executor: any jitted pipeline
  mapping a device chunk ``(draws, chains, param_chunk)`` to a pytree of
  ``(param_chunk,)``-shaped outputs, driven over a host array / memmap / or
  a ``source(start, size)`` callable (e.g. reading chunks from disk or an
  object store — the array never needs to exist in host RAM either).
- :func:`ess_rhat_streaming` — ESS + R-hat (the rank/bulk/tail/basic
  kinds of ``ess_rhat``, exact or fast rank mode) over a larger-than-HBM
  sample.

The reference has no counterpart (it is a single-host in-memory library);
it serves the BASELINE.json north-star workload.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import numpy as np

from .diagnostics.ess_rhat import (
    DEFAULT_NBINS,
    ESSRhat,
    _check_rank_mode,
    _ess_rhat_pipeline,
    _method_name,
)


@dataclass
class StreamStats:
    """Per-run pipeline accounting for the double-buffered executor.

    ``fetch_s``: host-side time spent slicing + issuing each chunk's
    ``device_put`` (the transfer itself continues in the background).
    ``wait_s``: time blocked on each chunk's outputs — this is where the
    NEXT chunk's transfer overlaps compute. ``wall_s``: end-to-end.
    A well-overlapped run has ``wall_s ~= max(transfer, compute) + one
    chunk's pipeline fill``, not the sum.
    """

    n_chunks: int = 0
    param_chunk: int = 0
    wall_s: float = 0.0
    fetch_s: list = field(default_factory=list)
    wait_s: list = field(default_factory=list)


def _make_source(source, nparams):
    """Normalize the input to ``(source_fn, nparams, pshape)``.

    Arrays (incl. np.memmap) stream via contiguous slices of the last axis;
    callables are used as-is: ``source(start, size) -> (draws, chains,
    size)`` host array. ``pshape`` is the original trailing parameter shape
    for arrays (``()`` for 2-d input — scalar-output semantics, matching
    ``ess_rhat``) and ``None`` for callables (results stay flat).
    """
    if callable(source):
        if nparams is None:
            raise ValueError("nparams is required with a callable source")
        return source, int(nparams), None, None
    arr = source
    if arr.ndim < 2:
        raise ValueError("streaming expects (draws, chains[, params...])")
    pshape = arr.shape[2:]
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim > 3:
        arr = arr.reshape(arr.shape[0], arr.shape[1], -1)

    def slice_source(start, size):
        return np.ascontiguousarray(arr[:, :, start:start + size])

    return slice_source, int(arr.shape[2]), pshape, arr.shape[:2]


def stream_param_chunks(fn, source, *, nparams=None, param_chunk: int = 256,
                        return_stats: bool = False, sharding=None):
    """Drive ``fn`` over parameter chunks with double-buffered H2D transfer.

    ``fn(device_chunk) -> pytree of (param_chunk,) arrays`` must be
    per-parameter independent (every kernel in this library is) and is
    typically a jitted pipeline — one executable serves all chunks because
    the ragged final chunk is zero-padded to ``param_chunk`` (constant
    columns compute NaN harmlessly and are sliced off).

    Schedule per chunk k: dispatch compute(k) (async) -> slice + issue
    ``device_put`` of chunk k+1 (host copy overlaps compute k; the transfer
    continues in the background) -> block on chunk k's outputs (transfer
    k+1 overlaps this wait) -> drop chunk k's buffer. Peak device footprint
    is two chunks + the (P,)-sized outputs. A zero-parameter source is an
    error (the output structure of ``fn`` is unknown without running it).

    ``sharding``: optional ``jax.sharding.Sharding`` for the device chunks —
    pass ``NamedSharding(cfg.mesh, cfg.data_spec)`` to stream chunks onto a
    (chains x params) mesh and drive a SHARDED pipeline (the north-star
    execution model: chains sharded across chips, parameters streamed
    through them; see ``ess_rhat_streaming(mesh_cfg=...)``). Results stay
    flat over the parameter axis (this is the generic executor).
    """
    src, nparams, _, _ = _make_source(source, nparams)
    if nparams <= 0:
        raise ValueError("streaming requires at least one parameter")
    starts = list(range(0, nparams, param_chunk))
    stats = StreamStats(n_chunks=len(starts), param_chunk=param_chunk)

    def fetch(k):
        t0 = time.perf_counter()
        start = starts[k]
        size = min(param_chunk, nparams - start)
        host = np.asarray(src(start, size))
        if host.shape[2] != size:
            raise ValueError(
                f"source returned {host.shape[2]} params for chunk "
                f"[{start}:{start + size})"
            )
        if size < param_chunk:
            host = np.pad(host, ((0, 0), (0, 0), (0, param_chunk - size)))
        dev = jax.device_put(host, sharding)
        stats.fetch_s.append(time.perf_counter() - t0)
        return dev

    t_run = time.perf_counter()
    results = []
    dev = fetch(0)
    for k in range(len(starts)):
        out = fn(dev)  # async dispatch; queues behind chunk k's transfer
        if k + 1 < len(starts):
            nxt = fetch(k + 1)  # host copy + H2D issue overlap compute k
        else:
            nxt = None
        t0 = time.perf_counter()
        # host readback (tiny, (param_chunk,)-sized) both forces completion
        # and releases this chunk's input buffer for reuse
        host_out = jax.tree_util.tree_map(np.asarray, out)
        stats.wait_s.append(time.perf_counter() - t0)
        results.append(host_out)
        dev = nxt
    stats.wall_s = time.perf_counter() - t_run

    merged = jax.tree_util.tree_map(
        lambda *leaves: np.concatenate(leaves)[:nparams], *results
    )
    if return_stats:
        return merged, stats
    return merged


def ess_rhat_streaming(
    source,
    *,
    nparams: int | None = None,
    param_chunk: int = 256,
    kind: str = "rank",
    split_chains: int = 2,
    maxlag: int = 250,
    autocov_method="auto",
    relative: bool = False,
    tail_prob: float = 0.1,
    rank_mode: str = "fast",
    rank_nbins: int = DEFAULT_NBINS,
    dtype=np.float32,
    return_stats: bool = False,
    mesh_cfg=None,
    rank_impl: str | None = None,
):
    """ESS + R-hat over a sample too large for device memory.

    ``source`` is a host array / np.memmap shaped ``(draws, chains,
    params...)`` or a callable ``source(start, size)`` yielding host chunks
    (then ``nparams`` is required; results are then flat ``(nparams,)``
    since no parameter shape is known). Array inputs keep ``ess_rhat``'s
    output semantics: trailing parameter shape preserved, scalars for 2-d
    input. Chunking is exact (every kernel is per-parameter independent).
    Defaults to the f32 histogram fast mode — the streaming regime is the
    throughput regime; pass ``rank_mode="exact"`` for the sort-based
    reference semantics.

    ``mesh_cfg``: a ``parallel.MeshConfig`` to stream onto a
    (chains x params) device mesh — each chunk is ``device_put`` with the
    mesh sharding and runs the SHARDED pipeline. This is the full
    north-star execution model: chains sharded across chips, parameters
    streamed through them, nothing ever fully resident. ``rank_impl``
    selects the mesh pipeline's rank transform and must agree with
    ``rank_mode``: it defaults to ``"hist"`` (the distributed fast mode)
    under ``rank_mode="fast"`` and ``"gather"`` under ``"exact"``;
    without ``mesh_cfg`` it must be left unset.

    With ``return_stats=True`` also returns a :class:`StreamStats` with the
    per-chunk fetch/wait split showing the transfer/compute overlap.
    """
    if kind not in ("rank", "bulk", "tail", "basic"):
        raise ValueError(
            f"the `kind` `{kind}` is not supported by `ess_rhat_streaming`"
        )
    _check_rank_mode(rank_mode)
    if mesh_cfg is None and rank_impl is not None:
        raise ValueError("rank_impl only applies with mesh_cfg; use "
                         "rank_mode to pick fast vs exact")
    src, nparams, pshape, dims = _make_source(source, nparams)
    if dims is None:
        # callable source: one single-column read discovers (draws, chains)
        dims = np.asarray(src(0, 1)).shape[:2]
    ndraws, nchains = dims
    niter = ndraws // split_chains
    if niter <= 4:
        raise ValueError("streaming ess_rhat requires >4 draws per split "
                         "chain")
    eff_maxlag = min(maxlag, niter - 4)
    method = _method_name(autocov_method)

    def cast_source(start, size):
        return np.asarray(src(start, size), dtype=dtype)

    sharding = None
    if mesh_cfg is not None:
        from jax.sharding import NamedSharding

        from .parallel.sharded import build_sharded_ess_rhat_fn

        if rank_impl is None:
            rank_impl = "hist" if rank_mode == "fast" else "gather"
        if rank_impl not in ("gather", "ring", "hist"):
            raise ValueError(
                f"streaming rank_impl must be resolved, got {rank_impl!r}"
            )
        if (rank_mode == "fast") != (rank_impl == "hist"):
            raise ValueError(
                f"rank_mode={rank_mode!r} conflicts with "
                f"rank_impl={rank_impl!r}: 'hist' IS the fast mode on a "
                "mesh; 'gather'/'ring' are the exact transforms"
            )
        sharding = NamedSharding(mesh_cfg.mesh, mesh_cfg.data_spec)
        fn = build_sharded_ess_rhat_fn(
            mesh_cfg, kind=kind, split_chains=split_chains,
            eff_maxlag=eff_maxlag, method=method, relative=relative,
            q=(tail_prob if kind == "tail" else None),
            rank_impl=rank_impl, rank_nbins=rank_nbins,
        )
    else:
        q = tail_prob if kind == "tail" else None

        def fn(chunk):
            return _ess_rhat_pipeline(
                chunk, kind=kind, split_chains=split_chains,
                maxlag=eff_maxlag, method=method, relative=relative, q=q,
                rank_mode=rank_mode, rank_nbins=rank_nbins,
            )

    out = stream_param_chunks(
        fn, cast_source, nparams=nparams, param_chunk=param_chunk,
        return_stats=return_stats, sharding=sharding,
    )
    if return_stats:
        (ess, rhat), stats = out
    else:
        ess, rhat = out
    if pshape is not None:
        # restore ess_rhat's output contract: param shape kept, 0-d arrays
        # (with .dtype etc., like maybe_scalar's output) for
        # sample-dims-only input
        ess = ess.reshape(pshape)
        rhat = rhat.reshape(pshape)
    if return_stats:
        return ESSRhat(ess, rhat), stats
    return ESSRhat(ess, rhat)
