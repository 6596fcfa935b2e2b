"""Particle filters (L2): bootstrap & guided, fully vectorized over particles.

Reimplements /root/reference/src/particles.jl:28-147 array-first. The
reference's per-particle loops (particles.jl:96-99, 122-125) become one fused
propagate+reweight over the whole (N, dx) cloud; the full-sequence likelihood
(``log_likelihood``, particles.jl:132-147) is a single ``lax.scan`` over T.

Differences by design (SURVEY.md §7.3):
  * **Adaptive resampling.** The reference resamples unconditionally every
    step (multinomial, particles.jl:17-19,117). Here resampling triggers when
    ESS < τ·N; τ=1 with scheme="multinomial" reproduces the reference
    exactly. Weights carry between steps in log space when no resample fires:
    the incremental evidence is p̂(y_t|y_{1:t-1}) = log Σ exp(lw_i + g_i)
    with lw the normalized log-weights, which reduces to the reference's
    "log mean weight" (particles.jl:10) in the always-resample case.
  * **Static shapes.** A masked variant scans the full padded history with a
    0/1 time mask — how rejuvenation over the growing prefix y[1:t−1]
    (smc_samplers.jl:317) stays inside one compiled program.
  * **Reproducibility.** Per-step derived PRNG keys, no global RNG.

The guided filter (particles.jl:55-84) takes a proposal with
``initial(model)`` / ``step(model, x_prev)``; weights get the
transition−proposal correction (particles.jl:73-79). The reference's init
correction is internally inconsistent (SURVEY.md §2.11); we implement the
correct importance weight log p0(x) + g(y|x) − log q0(x).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .resampling import get_resampler
from .weights import log_normalize

__all__ = [
    "ParticleState",
    "PFConfig",
    "Proposal",
    "pf_init",
    "pf_step",
    "log_likelihood",
    "log_likelihood_masked",
    "apf_step",
    "apf_log_likelihood",
    "filter_sequence",
]


class ParticleState(NamedTuple):
    particles: jax.Array  # (N, dx)
    log_weights: jax.Array  # (N,) normalized: logsumexp == 0


class PFConfig(NamedTuple):
    """Static filter configuration (hashable — safe as a jit static arg)."""

    resampling: str = "systematic"
    ess_threshold: float = 1.0  # resample when ESS < τ·N; 1.0 ≡ reference
    # guided-PF proposal (a ``Proposal``; None = bootstrap). Carried on the
    # config so the batched L2.5 layer and the L3 samplers (SMC² /
    # density-tempered inner filters, VERDICT r4 #6) thread it without new
    # plumbing: SMCConfig(inner=PFConfig(..., proposal=p)). The per-filter
    # L2 API (``pf_step(..., proposal=)``) still takes it explicitly and
    # falls back to this field.
    proposal: object = None
    # inner-filter algorithm for the BATCHED layer (and hence the
    # samplers): "bootstrap" (default; ``proposal`` makes it guided) or
    # "apf" — the auxiliary particle filter's transition-mean lookahead
    # (Pitt & Shephard 1999; ≡ the single-filter ``apf_step``), batched
    # over all M clouds with the lookahead density gathered alongside the
    # particles. APF resamples by construction every step and is not
    # defined for the elastic padded-N mode.
    algorithm: str = "bootstrap"


class Proposal(NamedTuple):
    """Guided-PF proposal: q0(model) and q(model, x_prev)."""

    initial: Callable  # model -> Distribution over (dx,)
    step: Callable  # (model, x_prev (...,dx)) -> Distribution


class PFStepOut(NamedTuple):
    state: ParticleState
    log_mean: jax.Array  # incremental evidence log p̂(y_t | y_{1:t-1})
    ess: jax.Array  # ESS of the post-reweight normalized weights


def pf_init(
    key: jax.Array,
    model,
    n: int,
    y0: jax.Array,
    proposal: Optional[Proposal] = None,
) -> PFStepOut:
    """Initialize at t=1 ≡ bootstrap_filter / particle_filter init
    (particles.jl:87-105, 28-53)."""
    k_draw, _ = jax.random.split(key)
    if proposal is None:
        x = model.initial_distribution().sample(k_draw, (n,))
        logw = model.observation_distribution(x).log_prob(y0)
    else:
        q0 = proposal.initial(model)
        x = q0.sample(k_draw, (n,))
        logw = (
            model.observation_distribution(x).log_prob(y0)
            + model.initial_distribution().log_prob(x)
            - q0.log_prob(x)
        )
    log_mean, log_norm, ess = log_normalize(logw)
    return PFStepOut(ParticleState(x, log_norm), log_mean, ess)


def pf_step(
    key: jax.Array,
    model,
    state: ParticleState,
    y: jax.Array,
    config: PFConfig = PFConfig(),
    proposal: Optional[Proposal] = None,
) -> PFStepOut:
    """One filter step ≡ bootstrap_filter! / particle_filter!
    (particles.jl:107-129, 55-84): (maybe-)resample → propagate → reweight."""
    if proposal is None:
        proposal = config.proposal
    n = state.particles.shape[0]
    k_res, k_prop = jax.random.split(key)

    x, lw = state
    w = jnp.exp(lw)

    # -- resample (select formulation: vmap-friendly, one gather either way)
    ancestors = get_resampler(config.resampling)(k_res, w)
    if config.ess_threshold >= 1.0:
        do_resample = jnp.asarray(True)
    else:
        ess_prev = 1.0 / jnp.sum(w * w)
        do_resample = ess_prev < config.ess_threshold * n
    ancestors = jnp.where(do_resample, ancestors, jnp.arange(n, dtype=jnp.int32))
    xp = jnp.take(x, ancestors, axis=0)
    lw = jnp.where(do_resample, jnp.full_like(lw, -jnp.log(float(n))), lw)

    # -- propagate + reweight (fused elementwise over the cloud)
    if proposal is None:
        x_new = model.transition_distribution(xp).sample(k_prop)
        incr = model.observation_distribution(x_new).log_prob(y)
    else:
        q = proposal.step(model, xp)
        x_new = q.sample(k_prop)
        incr = (
            model.observation_distribution(x_new).log_prob(y)
            + model.transition_distribution(xp).log_prob(x_new)
            - q.log_prob(x_new)
        )

    # Incremental evidence: lw already carries the 1/N prior-weight
    # normalization (logsumexp(lw) == 0), so p̂(y_t|y_{1:t-1}) = Σ w_i g_i
    # = logsumexp(lw + incr) — no extra 1/N factor. Always-resample reduces
    # to the reference's "log mean weight" (particles.jl:10).
    tot = lw + incr
    maxw = jnp.max(tot)
    maxw = jnp.where(jnp.isfinite(maxw), maxw, 0.0)
    lse = maxw + jnp.log(jnp.sum(jnp.exp(tot - maxw)))
    log_norm = tot - lse
    ess = 1.0 / jnp.sum(jnp.exp(2.0 * log_norm))
    return PFStepOut(ParticleState(x_new, log_norm), lse, ess)


def log_likelihood(
    key: jax.Array,
    model,
    n: int,
    y: jax.Array,
    config: PFConfig = PFConfig(),
    proposal: Optional[Proposal] = None,
):
    """Full-sequence marginal-likelihood estimate ≡ particles.jl:132-147.

    Returns (final ParticleState, logZ). One ``lax.scan`` over T.
    """
    if proposal is None:
        proposal = config.proposal
    k0, k_scan = jax.random.split(key)
    init = pf_init(k0, model, n, y[0], proposal)

    def step(carry, inp):
        st, acc = carry
        k, yt = inp
        out = pf_step(k, model, st, yt, config, proposal)
        return (out.state, acc + out.log_mean), None

    keys = jax.random.split(k_scan, y.shape[0] - 1)
    (state, logz), _ = jax.lax.scan(step, (init.state, init.log_mean), (keys, y[1:]))
    return state, logz


def log_likelihood_masked(
    key: jax.Array,
    model,
    n: int,
    y: jax.Array,
    mask: jax.Array,
    config: PFConfig = PFConfig(),
    proposal: Optional[Proposal] = None,
):
    """logZ over the masked prefix of a padded series (static shape).

    ``mask`` is (T,) with 1s on observed steps; mask[0] must be 1. Masked
    steps leave the particle state untouched and contribute 0 evidence —
    the in-graph form of the reference's ``y[1:(t-1)]`` slicing
    (smc_samplers.jl:317,223).
    """
    if proposal is None:
        proposal = config.proposal
    k0, k_scan = jax.random.split(key)
    init = pf_init(k0, model, n, y[0], proposal)

    def step(carry, inp):
        st, acc = carry
        k, yt, mt = inp
        out = pf_step(k, model, st, yt, config, proposal)
        new_state = jax.tree_util.tree_map(
            lambda a, b: jnp.where(mt > 0, a, b), out.state, st
        )
        return (new_state, acc + jnp.where(mt > 0, out.log_mean, 0.0)), None

    keys = jax.random.split(k_scan, y.shape[0] - 1)
    (state, logz), _ = jax.lax.scan(
        step, (init.state, init.log_mean), (keys, y[1:], mask[1:])
    )
    return state, logz


def apf_step(
    key: jax.Array,
    model,
    state: ParticleState,
    y: jax.Array,
    config: PFConfig = PFConfig(),
) -> PFStepOut:
    """Auxiliary particle filter step (Pitt & Shephard 1999).

    Not in the reference (whose filters are bootstrap/guided only,
    particles.jl:28-129) but part of the target capability set
    (BASELINE.json north star: "bootstrap/auxiliary particle filters").
    First-stage weights look ahead through the transition mean:

      λ_i ∝ w_i · g(y_t | μ_i),  μ_i = E[x_t | x_{t-1,i}]

    resample by λ, propagate, then correct: w'_j = g(y_t|x'_j) / g(y_t|μ_{a_j}).
    The evidence increment uses the standard APF estimator
    p̂(y_t|y_{1:t-1}) = (Σ_i w_i g(y_t|μ_i)) · (1/N Σ_j w'_j).
    """
    n = state.particles.shape[0]
    k_res, k_prop = jax.random.split(key)
    x, lw = state

    # first stage: lookahead weights through the transition mean
    mu = model.transition_distribution(x).mean()
    log_g_mu = model.observation_distribution(mu).log_prob(y)
    log_lambda = lw + log_g_mu
    lam_mean, lam_norm, _ = log_normalize(log_lambda)

    ancestors = get_resampler(config.resampling)(k_res, jnp.exp(lam_norm))
    xp = jnp.take(x, ancestors, axis=0)
    log_g_mu_a = jnp.take(log_g_mu, ancestors, axis=0)

    # second stage: propagate + correction weights
    x_new = model.transition_distribution(xp).sample(k_prop)
    corr = model.observation_distribution(x_new).log_prob(y) - log_g_mu_a

    corr_mean, log_norm, ess = log_normalize(corr)
    # p̂(y_t|·) = logsumexp(lw + g_mu) + log mean(corr)
    log_mean = lam_mean + jnp.log(float(n)) + corr_mean
    return PFStepOut(ParticleState(x_new, log_norm), log_mean, ess)


def apf_log_likelihood(
    key: jax.Array,
    model,
    n: int,
    y: jax.Array,
    config: PFConfig = PFConfig(),
):
    """Full-sequence APF marginal likelihood (lax.scan over T)."""
    k0, k_scan = jax.random.split(key)
    init = pf_init(k0, model, n, y[0])

    def step(carry, inp):
        st, acc = carry
        k, yt = inp
        out = apf_step(k, model, st, yt, config)
        return (out.state, acc + out.log_mean), None

    keys = jax.random.split(k_scan, y.shape[0] - 1)
    (state, logz), _ = jax.lax.scan(step, (init.state, init.log_mean), (keys, y[1:]))
    return state, logz


def filter_sequence(
    key: jax.Array,
    model,
    n: int,
    y: jax.Array,
    config: PFConfig = PFConfig(),
    proposal: Optional[Proposal] = None,
    summarize: Optional[Callable] = None,
):
    """Filter the whole sequence, returning per-step telemetry.

    ``summarize(state) -> pytree`` is applied at every step (e.g. weighted
    quantiles — the README's bootstrap-filter workflow, README.md:33-60,
    with the telemetry returned as arrays instead of @printf lines,
    SURVEY.md §5.1). Returns (final_state, logZ, per-step dict).
    """
    if proposal is None:
        proposal = config.proposal
    k0, k_scan = jax.random.split(key)
    init = pf_init(k0, model, n, y[0], proposal)

    def emit(out):
        d = {"log_mean": out.log_mean, "ess": out.ess}
        if summarize is not None:
            d["summary"] = summarize(out.state)
        return d

    def step(st, inp):
        k, yt = inp
        out = pf_step(k, model, st, yt, config, proposal)
        return out.state, emit(out)

    keys = jax.random.split(k_scan, y.shape[0] - 1)
    state, tail = jax.lax.scan(step, init.state, (keys, y[1:]))
    head = emit(init)
    series = jax.tree_util.tree_map(
        lambda h, t: jnp.concatenate([h[None], t], axis=0), head, tail
    )
    logz = jnp.sum(series["log_mean"])
    return state, logz, series
