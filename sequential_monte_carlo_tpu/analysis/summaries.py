"""Posterior summaries (L4) — weighted quantiles, predictive moments, trends.

≡ /root/reference/src/plotting_utils.jl:94-157 (``observation_dist``,
``estimated_trend``, ``quantile`` for IBIS and SMC) and the per-step summary
collectors in the inflation example (examples/inflation_example.jl:39-55,
241-253). All summaries are pure jittable array programs so they can run
inside the online scan as ``collect_fn``s.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..distributions import Normal
from ..samplers.base import IBISState, SMC2State


def weighted_quantile(x: jax.Array, w: jax.Array, ps) -> jax.Array:
    """Inverse-CDF quantiles of a weighted sample.

    ≡ Julia ``quantile(x, weights(w), p)`` (examples/inflation_example.jl:45-46)
    up to interpolation convention; vectorized sort + searchsorted.
    """
    ps = jnp.asarray(ps)
    order = jnp.argsort(x)
    xs = x[order]
    ws = w[order]
    cdf = jnp.cumsum(ws)
    cdf = cdf / cdf[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, ps, side="left"), 0, x.shape[0] - 1)
    return xs[idx]


def weighted_quantile_binned(x: jax.Array, w: jax.Array, ps,
                             bins: int = 128) -> jax.Array:
    """Sort-free weighted quantiles via a fixed-grid histogram CDF.

    Same estimand as :func:`weighted_quantile` but O(N·K) compare-reduce
    work instead of an O(N log N) sort — built for per-step
    ``collect_fn`` use inside the online scan, where sorting the full
    (M, N) cloud every step would dominate the flagship example's
    wall-clock. Bin masses are accumulated with one
    fused compare+reduce, the CDF is inverted on the K edges and linearly
    interpolated inside the landing bin; max error is one bin width of the
    per-row particle range (K=128 ⇒ <1% of the range, far below the
    Monte-Carlo error of the cloud itself).

    Supports leading batch dims on ``x``/``w`` (e.g. (M, N)); ``ps`` is a
    1-D probability vector appended as the trailing output axis.
    """
    ps = jnp.asarray(ps, dtype=x.dtype)
    lo = jnp.min(x, axis=-1, keepdims=True)
    hi = jnp.max(x, axis=-1, keepdims=True)
    span = jnp.maximum(hi - lo, jnp.asarray(1e-12, x.dtype))
    # bin index per particle, one-hot mass accumulation (fused by XLA —
    # the (..., N, K) one-hot is never materialized at f32 width)
    idx = jnp.clip(
        ((x - lo) / span * bins).astype(jnp.int32), 0, bins - 1
    )
    one_hot = (idx[..., None] == jnp.arange(bins)).astype(x.dtype)
    mass = jnp.einsum("...n,...nk->...k", w, one_hot)
    cdf = jnp.cumsum(mass, axis=-1)
    total = cdf[..., -1:]
    cdf = cdf / jnp.maximum(total, jnp.asarray(1e-30, x.dtype))
    # invert: k(p) = first bin with cdf ≥ p  (compare-sum, no searchsorted)
    k = jnp.sum(
        (cdf[..., :, None] < ps[..., None, :]).astype(jnp.int32), axis=-2
    )
    k = jnp.clip(k, 0, bins - 1)
    cdf_pad = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)
    cdf_lo = jnp.take_along_axis(cdf_pad, k, axis=-1)
    m_k = jnp.take_along_axis(
        mass / jnp.maximum(total, jnp.asarray(1e-30, x.dtype)), k, axis=-1
    )
    frac = jnp.clip(
        (ps - cdf_lo) / jnp.maximum(m_k, jnp.asarray(1e-12, x.dtype)), 0.0, 1.0
    )
    width = span / bins
    return lo + (k.astype(x.dtype) + frac) * width


def weighted_mean(x: jax.Array, w: jax.Array) -> jax.Array:
    return jnp.sum(w * x, axis=-1)


def weighted_var(x: jax.Array, w: jax.Array) -> jax.Array:
    mu = weighted_mean(x, w)
    return jnp.sum(w * (x - mu[..., None]) ** 2, axis=-1)


# -- SMC² (particle-cloud) summaries ----------------------------------------

def state_quantiles(state: SMC2State, ps, component: int = 0,
                    method: str = "binned") -> jax.Array:
    """ω-averaged per-θ weighted quantiles of one state component.

    ≡ ``get_quantiles_uc`` / ``get_quantiles_ucsv``
    (examples/inflation_example.jl:39-55, 241-253): quantiles of each θ's
    cloud under its particle weights, averaged under the θ-weights ω.

    ``method``: "binned" (default — sort-free histogram inversion, built
    for per-step collection inside the online scan) or "sort" (exact
    inverse-CDF via a full sort).
    """
    omega = jax.nn.softmax(state.log_omega)
    x = state.particles[..., component]
    if method == "binned":
        per_theta = weighted_quantile_binned(x, jnp.exp(state.log_w), ps)
    else:
        per_theta = jax.vmap(
            lambda xx, lw: weighted_quantile(xx, jnp.exp(lw), ps)
        )(x, state.log_w)
    return omega @ per_theta


def cycle_quantiles(state: SMC2State, yt, ps, component: int = 0,
                    method: str = "binned") -> jax.Array:
    """Quantiles of the cycle y_t − x_t (examples/inflation_example.jl:46)."""
    omega = jax.nn.softmax(state.log_omega)
    x = yt - state.particles[..., component]
    if method == "binned":
        per_theta = weighted_quantile_binned(x, jnp.exp(state.log_w), ps)
    else:
        per_theta = jax.vmap(
            lambda xx, lw: weighted_quantile(xx, jnp.exp(lw), ps)
        )(x, state.log_w)
    return omega @ per_theta


def state_variance(state: SMC2State, component: int = 0) -> jax.Array:
    """ω-averaged per-θ weighted variance of a state component
    (examples/inflation_example.jl:47)."""
    omega = jax.nn.softmax(state.log_omega)
    per_theta = jax.vmap(weighted_var)(
        state.particles[..., component], jnp.exp(state.log_w)
    )
    return omega @ per_theta


def estimated_trend(state: SMC2State, model_fn) -> jax.Array:
    """Σ_m ω_m · E[y | x̄_m, θ_m] ≡ estimated_trend(smc::SMC)
    (plotting_utils.jl:116-124): the observation mean at each θ's
    weighted-mean state."""
    omega = jax.nn.softmax(state.log_omega)

    def per_theta(theta, x, lw):
        xbar = jnp.sum(jnp.exp(lw)[:, None] * x, axis=0)
        return model_fn(theta).observation_distribution(xbar).mean()

    means = jax.vmap(per_theta)(state.theta, state.particles, state.log_w)
    return omega @ means


def predictive_quantiles(state: SMC2State, model_fn, ps) -> jax.Array:
    """ω-mixture of per-θ observation quantiles at the weighted-mean state
    ≡ quantile(smc::SMC, p) (plotting_utils.jl:140-157)."""
    ps = jnp.sort(jnp.asarray(ps))
    omega = jax.nn.softmax(state.log_omega)

    def per_theta(theta, x, lw):
        xbar = jnp.sum(jnp.exp(lw)[:, None] * x, axis=0)
        return model_fn(theta).observation_distribution(xbar).quantile(ps)

    qs = jax.vmap(per_theta)(state.theta, state.particles, state.log_w)
    return omega @ qs


# -- IBIS (exact-Gaussian) summaries ----------------------------------------

def observation_dist(state: IBISState, model_fn):
    """ω-weighted moment-matched predictive N(ȳ, Σ̄) from the Kalman states
    ≡ observation_dist(ibis) (plotting_utils.jl:94-112)."""
    omega = jax.nn.softmax(state.log_omega)

    def per_theta(theta, mean, cov):
        m = model_fn(theta)
        ym = jnp.einsum("i,i->", m.B, mean)
        sm = jnp.einsum("i,ij,j->", m.B, cov, m.B) + m.R
        return ym, sm

    ys, ss = jax.vmap(per_theta)(state.theta, state.mean, state.cov)
    return omega @ ys, omega @ ss


def ibis_estimated_trend(state: IBISState, model_fn) -> jax.Array:
    """≡ estimated_trend(ibis) (plotting_utils.jl:114)."""
    return observation_dist(state, model_fn)[0]


def ibis_predictive_quantiles(state: IBISState, model_fn, ps) -> jax.Array:
    """Analytic Gaussian quantiles of the predictive
    ≡ quantile(ibis, p) (plotting_utils.jl:128-137)."""
    ps = jnp.sort(jnp.asarray(ps))
    y, s = observation_dist(state, model_fn)
    return Normal(y, jnp.sqrt(s)).quantile(ps)


# -- θ-posterior histograms --------------------------------------------------

def posterior_histograms(key, state, n_samples: int = 10_000, bins: int = 50):
    """Weighted resample of the θ-cloud → per-dimension histograms
    ≡ construct_histograms (plotting_utils.jl:5-37). Returns a list of
    (counts, edges) pairs (host-side numpy)."""
    import numpy as np

    omega = jax.nn.softmax(state.log_omega)
    idx = jax.random.choice(
        key, state.theta.shape[0], shape=(n_samples,), p=omega
    )
    draws = np.asarray(state.theta[idx])
    return [np.histogram(draws[:, i], bins=bins) for i in range(draws.shape[1])]
