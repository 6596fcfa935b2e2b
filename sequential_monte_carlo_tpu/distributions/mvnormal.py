"""Multivariate normal with possibly-singular covariance.

The reference uses Distributions.jl ``MvNormal(A*x, Q)`` for multivariate
linear-Gaussian transitions (state_space_models.jl:164-170) and needs a
*singular* Q for the Hodrick–Prescott model (Q = [[1/λ,0],[0,0]],
state_space_models.jl:197).

Implementation: a Cholesky factorization drives the full-rank fast path
(accurate and cheap in f32); when the matrix is singular the Cholesky
produces non-finite entries and we select a symmetric-eigendecomposition
path with eigenvalues clipped at zero — sampling works for any PSD
covariance and ``log_prob`` becomes the Gaussian density on the support
subspace (pseudo-inverse + pseudo-determinant), coinciding with the usual
density at full rank. Both paths compute the Mahalanobis form in the factor
basis (no explicit inverse reconstruction), which keeps f32 error at the
~1e-6 level instead of ~1e-3.

Matmuls here are the matrix-unit path: a particle cloud of shape (N, dx) propagates
as one (N, dx)@(dx, dx) matmul.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from ..utils.struct import pytree_dataclass, static_field

_LOG_2PI = math.log(2.0 * math.pi)
_EIG_TOL = 1e-10


def _eig_parts(cov):
    """(v, w_clipped, nonzero_mask) of a PSD matrix via eigh."""
    w, v = jnp.linalg.eigh(cov)
    w = jnp.clip(w, 0.0)
    tol = _EIG_TOL * jnp.maximum(jnp.max(w, axis=-1, keepdims=True), 1.0)
    return v, w, w > tol


@pytree_dataclass
class MvNormal:
    """N(mean, cov) over R^k; ``mean`` (..., k), ``cov`` (..., k, k) PSD.

    ``allow_singular`` (static): when True (default), both Cholesky and eigh
    paths are computed and selected per-matrix — needed for the
    Hodrick–Prescott singular Q. Set False for known-full-rank covariances
    to skip the eigh entirely (a silent 2× cost at larger event dims)."""

    mean_: jax.Array
    cov: jax.Array
    allow_singular: bool = static_field(default=True)

    @property
    def event_dim(self):
        return self.cov.shape[-1]

    @property
    def batch_shape(self):
        return jnp.broadcast_shapes(self.mean_.shape[:-1], self.cov.shape[:-2])

    def _factor(self):
        """A matrix F with F Fᵀ = cov: Cholesky when it exists, else the
        eigen square root (columns v_i √w_i)."""
        L = jnp.linalg.cholesky(self.cov)
        if not self.allow_singular:
            return L
        chol_ok = jnp.all(jnp.isfinite(L), axis=(-2, -1), keepdims=True)
        v, w, _ = _eig_parts(self.cov)
        eig_sqrt = v * jnp.sqrt(w)[..., None, :]
        return jnp.where(chol_ok, jnp.nan_to_num(L), eig_sqrt)

    def sample(self, key, sample_shape=()):
        F = self._factor()
        shape = tuple(sample_shape) + self.batch_shape + (self.event_dim,)
        eps = jax.random.normal(key, shape, dtype=jnp.result_type(float))
        return self.mean_ + jnp.einsum("...ij,...j->...i", F, eps)

    def log_prob(self, x):
        d = x - self.mean_

        # full-rank path: triangular solve against the Cholesky factor
        L = jnp.linalg.cholesky(self.cov)
        if not self.allow_singular:
            L_inv = solve_triangular(
                L, jnp.broadcast_to(jnp.eye(self.event_dim), L.shape), lower=True
            )
            z = jnp.einsum("...ij,...j->...i", L_inv, d)
            logdet = 2.0 * jnp.sum(
                jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
            )
            return -0.5 * (
                self.event_dim * _LOG_2PI + logdet + jnp.sum(z * z, axis=-1)
            )

        chol_ok = jnp.all(jnp.isfinite(L), axis=(-2, -1))
        L_safe = jnp.where(chol_ok[..., None, None], jnp.nan_to_num(L, nan=1.0), jnp.eye(self.event_dim))
        # invert the (tiny) factor once, then broadcast over the x batch
        L_inv = solve_triangular(L_safe, jnp.broadcast_to(jnp.eye(self.event_dim), L_safe.shape), lower=True)
        z = jnp.einsum("...ij,...j->...i", L_inv, d)
        maha_c = jnp.sum(z * z, axis=-1)
        logdet_c = 2.0 * jnp.sum(
            jnp.log(jnp.abs(jnp.diagonal(L_safe, axis1=-2, axis2=-1))), axis=-1
        )

        # singular path: Mahalanobis in the eigenbasis over the support
        v, w, nz = _eig_parts(self.cov)
        u = jnp.einsum("...ji,...j->...i", v, d)
        inv_w = jnp.where(nz, 1.0 / jnp.where(nz, w, 1.0), 0.0)
        maha_e = jnp.sum(u * u * inv_w, axis=-1)
        logdet_e = jnp.sum(jnp.where(nz, jnp.log(jnp.where(nz, w, 1.0)), 0.0), axis=-1)
        rank = jnp.sum(nz, axis=-1)

        maha = jnp.where(chol_ok, maha_c, maha_e)
        logdet = jnp.where(chol_ok, logdet_c, logdet_e)
        k = jnp.where(chol_ok, float(self.event_dim), rank)
        return -0.5 * (k * _LOG_2PI + logdet + maha)

    def in_support(self, x):
        return jnp.all(jnp.isfinite(x), axis=-1)

    def mean(self):
        return jnp.broadcast_to(self.mean_, self.batch_shape + (self.event_dim,))
