"""Geweke (1991) convergence diagnostic.

``z = (mean(first window) - mean(last window)) / hypot(mcse1, mcse2)`` with
windows of the first ``first`` and last ``last`` fractions of the draws, and
``p = erfc(|z| / sqrt(2))`` (reference src/gewekediag.jl:19-35). MCSE of each
window is computed with ``split_chains=1``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from .mcse import mcse


class GewekeResult(NamedTuple):
    zscore: float
    pvalue: float


def gewekediag(x, *, first: float = 0.1, last: float = 0.5, **mcse_kwargs):
    """Geweke diagnostic of ``x`` shaped ``(draws[, chains[, params...]])``.

    1-d input reproduces the reference scalar semantics bit-for-bit
    (src/gewekediag.jl:19); N-d input dispatches every (chain, parameter)
    series through the batched kernel (diagnostics/batch.py — one
    fused jit, not draws*chains Python round trips) and returns arrays
    shaped ``(chains, *params)``. ``mcse_kwargs`` are forwarded to
    :func:`mcse` (e.g. ``maxlag``, ``autocov_method``).
    """
    if not 0 < first < 1:
        raise ValueError("`first` is not in (0, 1)")
    if not 0 < last < 1:
        raise ValueError("`last` is not in (0, 1)")
    if first + last > 1:
        raise ValueError("`first` and `last` proportions overlap")
    x = np.asarray(x, dtype=float)
    if x.ndim != 1:
        from .batch import gewekediag_batch

        return gewekediag_batch(x, first=first, last=last, **mcse_kwargs)
    n = len(x)
    x1 = x[: round(first * n)]
    # 1-based start round(n - last*n + 1) (banker's rounding matches Julia)
    x2 = x[round(n - last * n + 1) - 1 : n]
    s1 = float(np.asarray(mcse(x1.reshape(-1, 1, 1), split_chains=1, **mcse_kwargs))[0])
    s2 = float(np.asarray(mcse(x2.reshape(-1, 1, 1), split_chains=1, **mcse_kwargs))[0])
    s = math.hypot(s1, s2)
    z = (float(np.mean(x1)) - float(np.mean(x2))) / s
    p = math.erfc(abs(z) / math.sqrt(2))
    return GewekeResult(zscore=z, pvalue=p)
