"""Adaptive random-walk Metropolis kernel for θ-rejuvenation (L3).

≡ ``random_walk_kernel`` (/root/reference/src/smc_samplers.jl:87-101): a
scaled empirical-covariance RW proposal from the current θ-cloud with

  * scale 2.83² (univariate) / 2.83²/dθ (multivariate),
  * a degenerate-covariance floor (‖cov‖_F < 1e-8 → 1e-2·I),
  * jitter 1e-10·I,
  * per-chain-step annealing factors 0.5·reverse(1:chain) multiplying the
    proposal *covariance* (smc_samplers.jl:109,114).

The batched formulation precomputes one Cholesky factor of the kernel covariance
and draws all M proposals as a single (M,dθ)@(dθ,dθ) matmul.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import SMCConfig


def empirical_cov(theta: jax.Array) -> jax.Array:
    """Unweighted sample covariance of the θ-cloud (M, dθ) → (dθ, dθ),
    matching Julia ``cov`` (corrected, divide by M−1)."""
    m = theta.shape[0]
    centered = theta - jnp.mean(theta, axis=0, keepdims=True)
    return (centered.T @ centered) / (m - 1)


def rw_kernel_cov(theta: jax.Array, config: SMCConfig) -> jax.Array:
    """The kernel covariance Σ with floor and jitter ≡ smc_samplers.jl:88-98."""
    d = theta.shape[-1]
    cov = empirical_cov(theta)
    scale = config.rw_scale / d if d > 1 else config.rw_scale
    eye = jnp.eye(d, dtype=theta.dtype)
    degenerate = jnp.linalg.norm(cov) < config.cov_floor_norm
    sigma = jnp.where(
        degenerate,
        config.cov_floor_value * eye,
        scale * cov + config.cov_jitter * eye,
    )
    return sigma


def anneal_scales(config: SMCConfig) -> jnp.ndarray:
    """Proposal-covariance multipliers per chain step:
    0.5·reverse(1:chain) → e.g. chain=3 ⇒ [1.5, 1.0, 0.5] (:109)."""
    c = config.chain
    return config.anneal_base * jnp.arange(c, 0, -1, dtype=jnp.result_type(float))


def propose(key: jax.Array, theta: jax.Array, chol_sigma: jax.Array, scale) -> jax.Array:
    """Draw θ' = θ + √scale · L ε for the whole cloud in one matmul.

    ``MvNormal(θ, scale·Σ)`` with Σ = L Lᵀ (smc_samplers.jl:92,100)."""
    eps = jax.random.normal(key, theta.shape, dtype=theta.dtype)
    return theta + jnp.sqrt(scale) * (eps @ chol_sigma.T)


def kernel_chol(sigma: jax.Array) -> jax.Array:
    """Cholesky of the kernel covariance; Σ is floored/jittered so this is
    well-defined."""
    return jnp.linalg.cholesky(sigma)
