"""Device mesh construction for sharded diagnostics.

The canonical mesh is 2-d: the ``chains`` axis shards the chain dimension
(chains stay wherever the sampler left them — data-parallel flavour) and the
``params`` axis shards the parameter dimension (tensor-parallel flavour,
splitting the batched kernels' parameter axis). The draw axis is never
sharded: FFT
autocovariance needs each chain's full series locally (SURVEY.md section 5,
the design invariant).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chains"
PARAM_AXIS = "params"


@dataclass(frozen=True)
class MeshConfig:
    mesh: Mesh
    chain_axis: str = CHAIN_AXIS
    param_axis: str = PARAM_AXIS

    @property
    def data_spec(self) -> P:
        """PartitionSpec for canonical (draws, chains, params) arrays."""
        return P(None, self.chain_axis, self.param_axis)

    @property
    def param_spec(self) -> P:
        """PartitionSpec for per-parameter results; replicated over chains."""
        return P(self.param_axis)


def make_mesh(
    chain_shards: int | None = None,
    param_shards: int = 1,
    devices=None,
) -> MeshConfig:
    """Build a ``(chains, params)`` mesh over ``devices``.

    Defaults to all available devices on the chain axis (the common case:
    chains sharded across chips as the sampler produced them, parameters
    replicated within each chip's batch).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if chain_shards is None:
        chain_shards = n // param_shards
    if chain_shards * param_shards != n:
        raise ValueError(
            f"chain_shards * param_shards must equal the device count "
            f"({chain_shards} * {param_shards} != {n})"
        )
    arr = np.asarray(devices).reshape(chain_shards, param_shards)
    return MeshConfig(Mesh(arr, (CHAIN_AXIS, PARAM_AXIS)))


def shard_canonical(x3, cfg: MeshConfig):
    """Place a canonical (draws, chains, P) array on the mesh."""
    return jax.device_put(x3, NamedSharding(cfg.mesh, cfg.data_spec))
