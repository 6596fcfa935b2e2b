"""Exact Kalman filter for linear-Gaussian SSMs (L2 oracle).

≡ /root/reference/src/kalman_filter.jl. The reference has a univariate-scalar
specialization (:29-53) and a multivariate-state / univariate-observation one
(:3-27); here a single ``lax.scan`` over T covers both (dx is a static shape,
and the univariate observation makes every "inversion" a scalar divide — no
linear solves, so the whole filter is a handful of elementwise ops per step).

Per step (predict / update / likelihood, kalman_filter.jl:10-26):

  x̂ = A x,  P̂ = A P Aᵀ + Q
  s  = B P̂ Bᵀ + R,  Δ = y − B x̂
  x' = x̂ + P̂ Bᵀ s⁻¹ Δ,  P' = P̂ − P̂ Bᵀ s⁻¹ B P̂
  ℓ  = −½ (log 2π + log s + Δ²/s)

``log_likelihood`` accumulates ℓ over T starting from (x0, Σ0)
(kalman_filter.jl:55-70). A ``vmap`` over a stacked θ-cloud of models gives
the batched Kalman bank used by IBIS (SURVEY.md §7.4).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.linear_gaussian import LinearGaussianModel

import math

_LOG_2PI = math.log(2.0 * math.pi)


class KalmanState(NamedTuple):
    mean: jax.Array  # (dx,)
    cov: jax.Array  # (dx, dx)


class KalmanStep(NamedTuple):
    state: KalmanState
    log_lik: jax.Array  # scalar per-step log p(y_t | y_{1:t-1})
    predicted: KalmanState  # one-step-ahead (x̂, P̂) — the RTS smoother's input


def kalman_init(model: LinearGaussianModel) -> KalmanState:
    """Prior state before seeing any data — (x0, Σ0), kalman_filter.jl:60-61."""
    return KalmanState(model.x0, model.sigma0)


def kalman_step(model: LinearGaussianModel, state: KalmanState, y) -> KalmanStep:
    """One predict/update/likelihood step ≡ kalman_filter.jl:3-27."""
    A, B, Q, R = model.A, model.B, model.Q, model.R
    x, P = state

    # predict
    x = A @ x
    P = A @ P @ A.T + Q
    predicted = KalmanState(x, P)

    # innovation (univariate observation ⇒ scalar s)
    PBt = P @ B  # (dx,)
    s = B @ PBt + R
    delta = y - B @ x

    # update
    gain = PBt / s
    x = x + gain * delta
    P = P - jnp.outer(gain, PBt)

    log_lik = -0.5 * (_LOG_2PI + jnp.log(s) + delta * delta / s)
    return KalmanStep(KalmanState(x, P), log_lik, predicted)


def kalman_filter(model: LinearGaussianModel, y: jax.Array):
    """Filter the full sequence; returns (means (T,dx), covs (T,dx,dx),
    per-step logliks (T,), logZ)."""
    def step(state, yt):
        out = kalman_step(model, state, yt)
        return out.state, (out.state.mean, out.state.cov, out.log_lik)

    _, (means, covs, logliks) = jax.lax.scan(step, kalman_init(model), y)
    return means, covs, logliks, jnp.sum(logliks)


def kalman_log_likelihood(model: LinearGaussianModel, y: jax.Array):
    """≡ ``log_likelihood(y, model)`` (kalman_filter.jl:55-70): returns the
    final (mean, cov) and the accumulated logZ."""
    def step(state, yt):
        out = kalman_step(model, state, yt)
        return out.state, out.log_lik

    final, logliks = jax.lax.scan(step, kalman_init(model), y)
    return final, jnp.sum(logliks)


def kalman_log_likelihood_masked(model: LinearGaussianModel, y: jax.Array, mask: jax.Array):
    """Masked variant for rejuvenation over a growing prefix y[:t] under a
    static shape (SURVEY.md §7 hard part (a)): steps with mask 0 are identity."""
    def step(state, ym):
        yt, mt = ym
        out = kalman_step(model, state, yt)
        new = jax.tree_util.tree_map(
            lambda a, b: jnp.where(mt > 0, a, b), out.state, state
        )
        return new, jnp.where(mt > 0, out.log_lik, 0.0)

    final, logliks = jax.lax.scan(step, kalman_init(model), (y, mask))
    return final, jnp.sum(logliks)
