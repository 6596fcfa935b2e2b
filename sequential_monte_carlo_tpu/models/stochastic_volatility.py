"""Canonical stochastic-volatility SSM (BASELINE.md config 2).

Not present in the reference model zoo but required by the north-star
benchmark set ("bootstrap filter on stochastic-volatility SSM (nonlinear obs
density), 4096 particles" — BASELINE.json configs[1]). Standard AR(1)
log-volatility model:

  x_1 ~ N(mu, sigma² / (1 − phi²))
  x_t ~ N(mu + phi (x_{t-1} − mu), sigma²)
  y_t ~ N(0, exp(x_t))               (nonlinear observation density)
"""
from __future__ import annotations

import jax.numpy as jnp

from ..distributions import Normal, Product
from ..utils.struct import pytree_dataclass


@pytree_dataclass
class StochasticVolatilityModel:
    mu: jnp.ndarray
    phi: jnp.ndarray
    sigma: jnp.ndarray  # std of log-vol innovations

    @property
    def state_dim(self) -> int:
        return 1

    def initial_distribution(self):
        scale = self.sigma / jnp.sqrt(1.0 - self.phi**2)
        return Product(
            Normal(
                jnp.reshape(self.mu, (-1,))[:1],
                jnp.reshape(scale, (-1,))[:1],
            )
        )

    def transition_distribution(self, x):
        loc = self.mu + self.phi * (x - self.mu)
        return Product(Normal(loc, jnp.broadcast_to(self.sigma, loc.shape)))

    def observation_distribution(self, x):
        return Normal(jnp.zeros(x.shape[:-1]), jnp.exp(0.5 * x[..., 0]))


def stochastic_volatility(mu=-1.0, phi=0.95, sigma=0.3):
    f = lambda v: jnp.asarray(v, dtype=jnp.result_type(float))
    return StochasticVolatilityModel(mu=f(mu), phi=f(phi), sigma=f(sigma))


def sv_model(theta):
    """θ ↦ SV model with θ = (mu, phi, sigma)."""
    return StochasticVolatilityModel(mu=theta[0], phi=theta[1], sigma=theta[2])
