"""Linear-Gaussian state-space models (L1 model zoo).

Reimplements the reference's ``LinearModel{AT,BT,QT,RT,XT,ΣT}`` family
(/root/reference/src/state_space_models.jl:46-209) as one model type
holding matrix-shaped parameters ``A (dx,dx)``, ``B (dx,)`` (univariate
observation, as the reference assumes — state_space_models.jl:61-65),
variances ``Q (dx,dx)`` and scalar ``R``, with a Python-level dx==1 fast path
that keeps the whole univariate filter elementwise (no eigendecompositions).

  x_t ~ N(A x_{t-1}, Q)        (state_space_models.jl:88-92, 163-170)
  y_t ~ N(B·x_t,     R)        (state_space_models.jl:95-100, 172-179)
  x_1 ~ N(x0, Σ0)              (state_space_models.jl:102-105, 181-185)

Note Q, R, Σ0 are *variances* (the reference passes ``sqrt(Q)`` etc. to
``Normal``). Constructors mirror the reference's:
``UnivariateLinearGaussian`` (:74-78), ``MultivariateLinearGaussian``
(:137-157), ``unobserved_components`` (:119-128), ``hodrick_prescott``
(:193-202 — singular Q, handled by the eigh-based MvNormal).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..distributions import MvNormal, Normal, Product
from ..utils.struct import pytree_dataclass


@pytree_dataclass
class LinearGaussianModel:
    A: jnp.ndarray  # (dx, dx)
    B: jnp.ndarray  # (dx,) — univariate observation row
    Q: jnp.ndarray  # (dx, dx) state-noise covariance (may be singular)
    R: jnp.ndarray  # () observation-noise variance
    x0: jnp.ndarray  # (dx,)
    sigma0: jnp.ndarray  # (dx, dx)

    @property
    def state_dim(self) -> int:
        return self.A.shape[-1]

    def initial_distribution(self):
        if self.state_dim == 1:
            return Product(
                Normal(self.x0, jnp.sqrt(self.sigma0[..., 0]))
            )
        return MvNormal(self.x0, self.sigma0)

    def transition_distribution(self, x):
        if self.state_dim == 1:
            loc = self.A[..., 0, :] * x
            return Product(Normal(loc, jnp.sqrt(self.Q[..., 0, :])))
        loc = jnp.einsum("...ij,...j->...i", self.A, x)
        return MvNormal(loc, self.Q)

    def observation_distribution(self, x):
        loc = jnp.einsum("...i,...i->...", self.B, x)
        return Normal(loc, jnp.sqrt(self.R))


def _as_matrix(v, dx):
    v = jnp.asarray(v, dtype=jnp.result_type(float))
    if v.ndim == 0:
        return v.reshape(1, 1) if dx == 1 else v * jnp.eye(dx)
    return v


def univariate_linear_gaussian(A, B, Q, R, x0=0.0, sigma0=1.0):
    """≡ ``UnivariateLinearGaussian`` (state_space_models.jl:74-78):
    scalar-parameter LG model stored with dx = 1."""
    f = lambda v: jnp.asarray(v, dtype=jnp.result_type(float))
    return LinearGaussianModel(
        A=f(A).reshape(1, 1),
        B=f(B).reshape(1),
        Q=f(Q).reshape(1, 1),
        R=f(R),
        x0=f(x0).reshape(1),
        sigma0=f(sigma0).reshape(1, 1),
    )


def multivariate_linear_gaussian(A, B, Q, R, X0=None, Sigma0=None):
    """≡ ``MultivariateLinearGaussian`` (state_space_models.jl:137-157)."""
    A = jnp.asarray(A, dtype=jnp.result_type(float))
    dx = A.shape[0]
    B = jnp.asarray(B, dtype=jnp.result_type(float)).reshape(dx)
    Q = _as_matrix(Q, dx)
    R = jnp.asarray(R, dtype=jnp.result_type(float)).reshape(())
    X0 = jnp.zeros(dx) if X0 is None else jnp.asarray(X0, dtype=jnp.result_type(float))
    Sigma0 = jnp.eye(dx) if Sigma0 is None else _as_matrix(Sigma0, dx)
    return LinearGaussianModel(A=A, B=B, Q=Q, R=R, x0=X0, sigma0=Sigma0)


def unobserved_components(sigma_eps, sigma_eta, x0):
    """Local-level UC model ≡ state_space_models.jl:119-128:
    x_t ~ N(x_{t-1}, σε), y_t ~ N(x_t, ση), x_1 ~ N(x0, σε)."""
    return univariate_linear_gaussian(
        A=1.0, B=1.0, Q=sigma_eps, R=sigma_eta, x0=x0, sigma0=sigma_eps
    )


def hodrick_prescott(lam, y, init_cov=1000.0):
    """HP-filter model ≡ state_space_models.jl:193-202. Companion form with a
    *singular* Q — exercised by the eigh-based MvNormal sampler."""
    y = jnp.asarray(y, dtype=jnp.result_type(float))
    return multivariate_linear_gaussian(
        A=jnp.array([[2.0, -1.0], [1.0, 0.0]]),
        B=jnp.array([1.0, 0.0]),
        Q=jnp.array([[1.0 / lam, 0.0], [0.0, 0.0]]),
        R=1.0,
        X0=jnp.stack([3.0 * y[0] - 2.0 * y[1], 2.0 * y[0] - y[1]]),
        Sigma0=init_cov * jnp.eye(2),
    )


def uc_model(theta):
    """θ ↦ UC model with θ = (x0, σε, ση) — the parameterization used by the
    inflation example's ``uc_mod``/``uc_prior`` (examples/inflation_example.jl:28-36:
    prior = [Normal(3,2) for the level, Uniform(0,4)² for the variances])."""
    return unobserved_components(sigma_eps=theta[1], sigma_eta=theta[2], x0=theta[0])


def lg_model(theta):
    """θ ↦ univariate LG with A=θ₀, B=1, Q=θ₁, R=θ₂, x0=0 — the README's
    ``lg_mod(θ) = StateSpaceModel(LinearGaussian(θ[1],1.0,θ[2],θ[3],0.0),(1,1))``
    (README.md:12-15) used in the golden density-tempered run."""
    return univariate_linear_gaussian(A=theta[0], B=1.0, Q=theta[1], R=theta[2], x0=0.0)
