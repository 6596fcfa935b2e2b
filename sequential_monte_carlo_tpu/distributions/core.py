"""Pure-JAX distribution kit (L0).

The reference delegates all sampling / density evaluation to Distributions.jl
(see /root/reference/src/state_space_models.jl — ``Normal``, ``MvNormal``,
``TupleProduct`` usage at state_space_models.jl:91,104,180,237-260 and the prior
constructions in README.md:81-85). This module provides the array-first
equivalent: every distribution is a pytree of arrays with vectorized
``sample(key, sample_shape)`` / ``log_prob(x)`` / ``in_support(x)`` that
broadcast over arbitrary batch shapes, so a whole particle cloud (or a whole
θ-cloud of models) evaluates as one fused XLA program — no per-particle loop.

Conventions (matching Distributions.jl):
  * ``Normal(loc, scale)`` — ``scale`` is the standard deviation.
  * ``LogNormal(mu, sigma)`` — parameters of the underlying normal.
  * ``Uniform(low, high)``; ``TruncatedNormal(loc, scale, low, high)``.
  * Univariate distributions have scalar event shape; batching comes from
    broadcasting their parameter arrays.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtr, ndtri

from ..utils.struct import pytree_dataclass

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _bshape(*xs):
    return jnp.broadcast_shapes(*(jnp.shape(x) for x in xs))


@pytree_dataclass
class Normal:
    """Univariate normal N(loc, scale²); ``scale`` is the std deviation."""

    loc: jax.Array
    scale: jax.Array

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = jax.random.normal(key, shape, dtype=jnp.result_type(float))
        return self.loc + self.scale * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - jnp.log(self.scale) - _HALF_LOG_2PI

    def in_support(self, x):
        return jnp.isfinite(x)

    def mean(self):
        return jnp.broadcast_to(self.loc, self.batch_shape)

    def variance(self):
        return jnp.broadcast_to(self.scale**2, self.batch_shape)

    def quantile(self, p):
        return self.loc + self.scale * ndtri(p)


@pytree_dataclass
class LogNormal:
    """log X ~ N(mu, sigma²). Matches Distributions.jl ``LogNormal()`` defaults
    mu=0, sigma=1 (used in the reference prior, README.md:83-84)."""

    mu: jax.Array
    sigma: jax.Array

    @property
    def batch_shape(self):
        return _bshape(self.mu, self.sigma)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = jax.random.normal(key, shape, dtype=jnp.result_type(float))
        return jnp.exp(self.mu + self.sigma * eps)

    def log_prob(self, x):
        safe_x = jnp.where(x > 0, x, 1.0)
        lx = jnp.log(safe_x)
        z = (lx - self.mu) / self.sigma
        lp = -0.5 * z * z - jnp.log(self.sigma) - _HALF_LOG_2PI - lx
        return jnp.where(x > 0, lp, -jnp.inf)

    def in_support(self, x):
        return x > 0

    def mean(self):
        return jnp.exp(self.mu + 0.5 * self.sigma**2)

    def quantile(self, p):
        return jnp.exp(self.mu + self.sigma * ndtri(p))


@pytree_dataclass
class Uniform:
    low: jax.Array
    high: jax.Array

    @property
    def batch_shape(self):
        return _bshape(self.low, self.high)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = jax.random.uniform(key, shape, dtype=jnp.result_type(float))
        return self.low + (self.high - self.low) * u

    def log_prob(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return jnp.where(inside, -jnp.log(self.high - self.low), -jnp.inf)

    def in_support(self, x):
        return (x >= self.low) & (x <= self.high)

    def mean(self):
        return 0.5 * (self.low + self.high)

    def quantile(self, p):
        return self.low + (self.high - self.low) * p


@pytree_dataclass
class TruncatedNormal:
    """N(loc, scale²) truncated to [low, high].

    Matches Distributions.jl ``TruncatedNormal(mu, sigma, a, b)`` used in the
    reference prior (README.md:82). Sampling via inverse-CDF — branch-free and
    vectorized.
    """

    loc: jax.Array
    scale: jax.Array
    low: jax.Array
    high: jax.Array

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale, self.low, self.high)

    def _cdf_bounds(self):
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        return ndtr(a), ndtr(b)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        fa, fb = self._cdf_bounds()
        u = jax.random.uniform(key, shape, dtype=jnp.result_type(float))
        # keep strictly inside (0,1) for ndtri stability
        p = jnp.clip(fa + u * (fb - fa), 1e-7, 1.0 - 1e-7)
        return self.loc + self.scale * ndtri(p)

    def log_prob(self, x):
        fa, fb = self._cdf_bounds()
        z = (x - self.loc) / self.scale
        lp = (
            -0.5 * z * z
            - jnp.log(self.scale)
            - _HALF_LOG_2PI
            - jnp.log(fb - fa)
        )
        inside = (x >= self.low) & (x <= self.high)
        return jnp.where(inside, lp, -jnp.inf)

    def in_support(self, x):
        return (x >= self.low) & (x <= self.high)

    def mean(self):
        fa, fb = self._cdf_bounds()
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        phi = lambda t: jnp.exp(-0.5 * t * t) / math.sqrt(2 * math.pi)
        return self.loc + self.scale * (phi(a) - phi(b)) / (fb - fa)

    def variance(self):
        """σ²·[1 + (αφ(α) − βφ(β))/Z − ((φ(α) − φ(β))/Z)²] with
        Z = Φ(β) − Φ(α); the t·φ(t) terms vanish at infinite bounds."""
        fa, fb = self._cdf_bounds()
        z = fb - fa
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        phi = lambda t: jnp.exp(-0.5 * t * t) / math.sqrt(2 * math.pi)
        tphi = lambda t: jnp.where(jnp.isfinite(t), t * phi(t), 0.0)
        m1 = (phi(a) - phi(b)) / z
        return self.scale**2 * (1.0 + (tphi(a) - tphi(b)) / z - m1 * m1)

    def quantile(self, p):
        """Inverse CDF: loc + σ·Φ⁻¹(Φ(α) + p·Z) — the exact inverse of the
        sampling path, so sample(key) ≡ quantile(U)."""
        fa, fb = self._cdf_bounds()
        q = jnp.clip(fa + p * (fb - fa), 1e-7, 1.0 - 1e-7)
        return self.loc + self.scale * ndtri(q)


@pytree_dataclass
class Product:
    """IID/independent product over the trailing axis of a batched univariate.

    ``Product(Normal(locs, scales))`` with trailing axis k gives a distribution
    with event shape (k,): ``log_prob`` sums the component log-densities over
    the last axis. This is the vectorized analog of Distributions.jl
    ``product_distribution`` (README.md:81-85).
    """

    base: object  # univariate distribution with trailing component axis

    @property
    def batch_shape(self):
        return self.base.batch_shape[:-1]

    @property
    def event_dim(self):
        return self.base.batch_shape[-1]

    def sample(self, key, sample_shape=()):
        return self.base.sample(key, sample_shape)

    def log_prob(self, x):
        return jnp.sum(self.base.log_prob(x), axis=-1)

    def in_support(self, x):
        return jnp.all(self.base.in_support(x), axis=-1)

    def mean(self):
        return self.base.mean()

    def quantile(self, p):
        return self.base.quantile(p)


@pytree_dataclass
class TupleProduct:
    """Product over a heterogeneous tuple of univariate distributions.

    The reference calls an (undefined — see SURVEY.md §0.2) ``TupleProduct`` at
    state_space_models.jl:237,254 for the 3-dim UC-SV state: ``rand`` stacks the
    component draws into a length-k vector and ``logpdf`` sums the component
    log-densities. Components may themselves carry identical batch shapes
    (e.g. per-particle parameters), in which case the stacked draw has shape
    ``batch + (k,)``.
    """

    components: tuple

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(*(c.batch_shape for c in self.components))

    @property
    def event_dim(self):
        return len(self.components)

    def sample(self, key, sample_shape=()):
        keys = jax.random.split(key, len(self.components))
        draws = [
            jnp.broadcast_to(
                c.sample(k, sample_shape),
                tuple(sample_shape) + self.batch_shape,
            )
            for c, k in zip(self.components, keys)
        ]
        return jnp.stack(draws, axis=-1)

    def log_prob(self, x):
        lps = [c.log_prob(x[..., i]) for i, c in enumerate(self.components)]
        return sum(lps)

    def in_support(self, x):
        ok = [c.in_support(x[..., i]) for i, c in enumerate(self.components)]
        out = ok[0]
        for o in ok[1:]:
            out = out & o
        return out

    def mean(self):
        means = [
            jnp.broadcast_to(c.mean(), self.batch_shape) for c in self.components
        ]
        return jnp.stack(means, axis=-1)

    def quantile(self, p):
        qs = [c.quantile(p) for c in self.components]
        return jnp.stack(qs, axis=-1)


def product_distribution(dists):
    """Distributions.jl-style ``product_distribution([...])`` — builds a
    :class:`TupleProduct` over the given univariate components (README.md:81-85)."""
    return TupleProduct(tuple(dists))
