"""Compact jitted HMC sampler — the built-in integration-test fixture.

The reference's integration test runs DynamicHMC NUTS on a 50-dim Cauchy
posterior and checks that bulk-ESS is healthy while tail-ESS is poor
(test/ess_rhat.jl:28-36,377-399, ~2.5 min on CI). This module provides the
JAX replacement: a jittered-trajectory Hamiltonian Monte Carlo sampler
(leapfrog + Metropolis correction, trajectory length randomized per draw to
avoid resonances), vmapped over chains and scanned over draws — one XLA
program, gradients via ``jax.grad``.

Also produces the Hamiltonian energy trace consumed by :func:`bfmi` and the
stored-trace benchmark configs (BASELINE.md config 2).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


class HMCTrace(NamedTuple):
    samples: jnp.ndarray  # (draws, chains, dim)
    energy: jnp.ndarray  # (draws, chains) Hamiltonian at accepted states
    accept_rate: jnp.ndarray  # (chains,)


@partial(jax.jit, static_argnames=("logpdf", "num_samples", "max_leapfrog"))
def hmc_sample(
    logpdf,
    init,
    key,
    *,
    num_samples: int,
    step_size: float,
    max_leapfrog: int = 32,
) -> HMCTrace:
    """Sample with jittered-trajectory HMC.

    ``logpdf(x) -> scalar`` is the unnormalized target over ``dim``-vectors;
    ``init`` is ``(chains, dim)``. Each draw runs a leapfrog trajectory of
    uniformly random length in [1, max_leapfrog] with unit mass matrix.
    """
    nchains, dim = init.shape
    grad = jax.grad(logpdf)

    def potential(x):
        return -logpdf(x)

    pot_grad = jax.grad(potential)

    def one_step(x, key):
        k_mom, k_len, k_acc = jax.random.split(key, 3)
        p0 = jax.random.normal(k_mom, (dim,))
        nsteps = jax.random.randint(k_len, (), 1, max_leapfrog + 1)

        def leapfrog(i, carry):
            x, p = carry
            do = i < nsteps
            p_half = p - 0.5 * step_size * pot_grad(x)
            x_new = x + step_size * p_half
            p_new = p_half - 0.5 * step_size * pot_grad(x_new)
            return (
                jnp.where(do, x_new, x),
                jnp.where(do, p_new, p),
            )

        xp, pp = jax.lax.fori_loop(0, max_leapfrog, leapfrog, (x, p0))
        h0 = potential(x) + 0.5 * jnp.dot(p0, p0, precision=_HIGHEST)
        h1 = potential(xp) + 0.5 * jnp.dot(pp, pp, precision=_HIGHEST)
        log_accept = jnp.minimum(0.0, h0 - h1)
        accept = jnp.log(jax.random.uniform(k_acc, ())) < log_accept
        x_next = jnp.where(accept, xp, x)
        energy = jnp.where(accept, h1, h0)
        return x_next, energy, accept

    def chain_scan(x0, keys):
        def body(x, key):
            x_next, energy, accept = one_step(x, key)
            return x_next, (x_next, energy, accept)

        _, (xs, es, acc) = jax.lax.scan(body, x0, keys)
        return xs, es, acc

    keys = jax.random.split(key, nchains * num_samples).reshape(
        nchains, num_samples, 2
    )
    xs, es, acc = jax.vmap(chain_scan)(init, keys)  # (chains, draws, ...)
    return HMCTrace(
        samples=jnp.moveaxis(xs, 0, 1),
        energy=jnp.moveaxis(es, 0, 1),
        accept_rate=jnp.mean(acc, axis=1),
    )


def cauchy_logpdf(x):
    """Product of independent standard Cauchy densities — the heavy-tailed
    target of the reference integration test."""
    return -jnp.sum(jnp.log1p(x * x))


def eight_schools_logpdf(params):
    """Non-centered 8-schools posterior: params = (mu, log_tau, z_1..z_8).

    The classic hierarchical example used by BASELINE.md config 2.
    """
    y = jnp.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = jnp.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    mu, log_tau, z = params[0], params[1], params[2:]
    tau = jnp.exp(log_tau)
    theta = mu + tau * z
    lp = -0.5 * jnp.sum(((y - theta) / sigma) ** 2)
    lp += -0.5 * jnp.sum(z * z)  # z ~ N(0,1)
    lp += -0.5 * (mu / 5.0) ** 2  # mu ~ N(0,5)
    lp += -0.5 * (log_tau / 5.0) ** 2 + log_tau  # half-normal-ish tau, +jacobian
    return lp
