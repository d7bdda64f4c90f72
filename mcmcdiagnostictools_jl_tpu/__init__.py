"""MCMC diagnostics engine on JAX/XLA.

A from-scratch JAX/XLA implementation of the full capability surface of
MCMCDiagnosticTools.jl (v0.3.19), batched for an accelerator:

- Canonical data layout ``(draws, chains[, parameters...])`` — sample dims first,
  arbitrary trailing parameter dims (reference src/utils.jl:197-211).
- Everything is batched over the flattened parameter axis: one sort kernel, one
  batched real-FFT autocovariance kernel, one lag-axis Geyer reduction — no
  per-parameter Python loops in the hot path.
- Multi-chip execution via ``jax.sharding.Mesh`` + ``shard_map`` with psum /
  all_gather collectives (see ``mcmcdiagnostictools_jl_tpu.parallel``).

Public API (the same 16 names exported by the reference,
src/MCMCDiagnosticTools.jl:17-25):

``bfmi``, ``discretediag``, ``ess``, ``ess_rhat``, ``rhat``, ``rhat_nested``,
``AutocovMethod``, ``FFTAutocovMethod``, ``BDAAutocovMethod``, ``gelmandiag``,
``gelmandiag_multivariate``, ``gewekediag``, ``heideldiag``, ``mcse``,
``rafterydiag``, ``rstar``.

Differences from the reference, by design:

- ``missing`` semantics are expressed with NaN: any NaN inside a parameter slice
  poisons that parameter's outputs (mirrors reference src/ess_rhat.jl:519-523).
- Estimator ``kind``s are strings (``"mean"``, ``"median"``, ``"std"``, ``"mad"``)
  or ``Quantile(p)`` instead of Julia function objects.
- The default autocovariance method is the batched FFT method; the direct
  and BDA estimators are provided for parity and agree to float tolerance.
"""

from .diagnostics.bfmi import bfmi
from .diagnostics.ess_rhat import (
    AutocovMethod,
    BDAAutocovMethod,
    FFTAutocovMethod,
    Quantile,
    ess,
    ess_rhat,
    rhat,
)
from .diagnostics.rhat_nested import rhat_nested
from .diagnostics.mcse import mcse
from .diagnostics.gelmandiag import gelmandiag, gelmandiag_multivariate
from .diagnostics.gewekediag import gewekediag
from .diagnostics.heideldiag import heideldiag
from .diagnostics.rafterydiag import rafterydiag
from .diagnostics.discretediag import discretediag
from .diagnostics.rstar import rstar
from .streaming import ess_rhat_streaming, stream_param_chunks

__version__ = "0.1.0"

__all__ = [
    "bfmi",
    "discretediag",
    "ess",
    "ess_rhat",
    "rhat",
    "rhat_nested",
    "AutocovMethod",
    "FFTAutocovMethod",
    "BDAAutocovMethod",
    "Quantile",
    "gelmandiag",
    "gelmandiag_multivariate",
    "gewekediag",
    "heideldiag",
    "mcse",
    "rafterydiag",
    "rstar",
    # extras with no reference counterpart
    "ess_rhat_streaming",
    "stream_param_chunks",
]
