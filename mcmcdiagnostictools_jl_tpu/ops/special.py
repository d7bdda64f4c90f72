"""Special functions JAX lacks, implemented device-side.

The reference leans on StatsFuns/SpecialFunctions/Distributions for a handful
of scalar special functions (SURVEY.md section 7 "Hard parts"):

- ``betaincinv`` — inverse regularized incomplete beta (quantile-MCSE Beta
  error distribution, src/mcse.jl:106-109; F-distribution quantiles for the
  Gelman PSRF CI, src/gelmandiag.jl:47).
- ``fdist_quantile`` — F-distribution quantile via the beta inverse.
- ``besselk_quarter`` — modified Bessel K_{1/4} for the Cramer-von Mises
  p-value series (src/heideldiag.jl:56-68).
- ``pcramer`` — asymptotic Cramer-von Mises CDF (Csorgo & Faraway 1996).

All are batched, jittable, and validated against SciPy in the test suite.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import betainc, betaln, gammaln, ndtri

# f32 only: switch to the Cornish-Fisher normal expansion above this
# min(a, b). The bisection's accuracy in f32 dies with the parameter size —
# betaln(a, b) ~ -(a+b) H(a/(a+b)) reaches magnitudes whose f32 ULP is a
# sizable EXPONENT error (ULP(1.1e5) ~ 0.008 -> betainc off by ~1%), which
# at the MCSE scale (a, b ~ ESS ~ 1e5) shifted quantile-MCSE order
# statistics by ~30 ranks. The expansion's sigma-relative error is
# ~0.7/min(a,b) (measured vs SciPy; the skew term vanishes at the +-1-sigma
# points MCSE evaluates), crossing the f32 bisection error near 2e3.
_F32_ASYM_MIN = 2000.0


def betaincinv(a, b, y, *, n_bisect: int = 70, n_newton: int = 4):
    """Inverse of the regularized incomplete beta function ``I_x(a, b) = y``.

    Bisection to ~2^-70 followed by Newton polish — robust for the moderate
    (a, b) ranges produced by quantile-MCSE (a,b ~ ESS) and F-quantiles
    (a,b = df/2). Fully batched; NaN inputs propagate. In f32,
    large-parameter inverses (min(a, b) >= 2e3) use a Cornish-Fisher
    normal expansion instead — see ``_F32_ASYM_MIN``. Python scalars follow
    the x64 flag; array inputs keep their own precision.
    """
    a, b, y = jnp.broadcast_arrays(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(y)
    )
    dtype = jnp.result_type(a, b, y, jnp.float32)
    a, b, y = a.astype(dtype), b.astype(dtype), y.astype(dtype)

    big = None
    if dtype == jnp.float32:
        s = a + b
        mu = a / s
        sig = jnp.sqrt(a * b / (s * s * (s + 1.0)))
        z = ndtri(y)
        g1 = 2.0 * (b - a) * jnp.sqrt(s + 1.0) / ((s + 2.0) * jnp.sqrt(a * b))
        x_asym = jnp.clip(mu + sig * (z + g1 * (z * z - 1.0) / 6.0), 0.0, 1.0)
        big = jnp.minimum(a, b) >= _F32_ASYM_MIN
        # keep the (dead) bisection branch cheap and finite
        a = jnp.where(big, 1.0, a)
        b = jnp.where(big, 1.0, b)

    lo = jnp.zeros_like(y)
    hi = jnp.ones_like(y)

    def bisect_body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        below = betainc(a, b, mid) < y
        return jnp.where(below, mid, lo), jnp.where(below, hi, mid)

    lo, hi = jax.lax.fori_loop(0, n_bisect, bisect_body, (lo, hi))
    x = 0.5 * (lo + hi)

    # Newton polish: f(x) = I_x(a,b) - y, f'(x) = x^(a-1)(1-x)^(b-1)/B(a,b)
    log_norm = betaln(a, b)

    def newton_body(_, x):
        f = betainc(a, b, x) - y
        logpdf = (a - 1) * jnp.log(x) + (b - 1) * jnp.log1p(-x) - log_norm
        step = f * jnp.exp(-logpdf)
        xn = x - step
        ok = (xn > 0) & (xn < 1) & jnp.isfinite(xn)
        return jnp.where(ok, xn, x)

    x = jax.lax.fori_loop(0, n_newton, newton_body, x)
    if big is not None:
        x = jnp.where(big, x_asym, x)
    x = jnp.where(y <= 0, 0.0, jnp.where(y >= 1, 1.0, x))
    return jnp.where(jnp.isnan(a) | jnp.isnan(b) | jnp.isnan(y), jnp.nan, x)


def fdist_quantile(d1, d2, q):
    """Quantile of the F(d1, d2) distribution.

    ``y = betaincinv(d1/2, d2/2, q)``; ``x = d2 * y / (d1 * (1 - y))``.
    Used for the Gelman-Rubin PSRF upper CI (src/gelmandiag.jl:47).
    """
    d1 = jnp.asarray(d1)
    d2 = jnp.asarray(d2)
    y = betaincinv(d1 / 2, d2 / 2, q)
    return d2 * y / (d1 * (1.0 - y))


def besselk_quarter(x):
    """Modified Bessel function of the second kind K_{1/4}(x), x > 0.

    Exponentially convergent trapezoidal rule on
    ``K_nu(x) = int_0^inf exp(-x cosh t) cosh(nu t) dt`` — accurate to ~1e-14
    for x in [1e-6, 700], the range reached by ``pcramer`` arguments. Batched
    over ``x``.
    """
    x = jnp.asarray(x)
    dtype = jnp.result_type(x, jnp.float32)
    x = x.astype(dtype)
    h = 0.05
    n = 400  # t up to 20: exp(-x*cosh(20)) underflows for any x >= 1e-8
    t = jnp.arange(n + 1, dtype=dtype) * h
    cosh_t = jnp.cosh(t)
    cosh_vt = jnp.cosh(0.25 * t)
    w = jnp.full((n + 1,), h, dtype).at[0].set(h / 2)
    # clip the exponent to avoid inf*0 NaNs for large x*cosh(t)
    expo = jnp.clip(x[..., None] * cosh_t, max=745.0)
    vals = jnp.exp(-expo) * cosh_vt * w
    res = jnp.sum(vals, axis=-1)
    return jnp.where(x > 0, res, jnp.nan)


_GAMMA_K_HALF = tuple(
    float(v)
    for v in (
        1.7724538509055160273,  # gamma(0.5)
        0.8862269254527580137,  # gamma(1.5)
        1.3293403881791370205,  # gamma(2.5)
        3.3233509704478425512,  # gamma(3.5)
    )
)


def pcramer(q):
    """Asymptotic CDF of the Cramer-von Mises statistic.

    Four-term series of Csorgo & Faraway (1996), as used by the reference
    (src/heideldiag.jl:56-68). Batched over ``q``.
    """
    q = jnp.asarray(q)
    dtype = jnp.result_type(q, jnp.float32)
    q = q.astype(dtype)
    p = jnp.zeros_like(q)
    for k in range(4):
        c1 = 4.0 * k + 1.0
        c2 = c1 * c1 / (16.0 * q)
        term = (
            _GAMMA_K_HALF[k]
            / float(_factorial(k))
            * jnp.sqrt(c1)
            * jnp.exp(-c2)
            * besselk_quarter(c2)
        )
        p = p + term
    return p / (jnp.pi**1.5 * jnp.sqrt(q))


def _factorial(k: int) -> int:
    out = 1
    for i in range(2, k + 1):
        out *= i
    return out
