"""Batched (θ-cloud-level) particle filtering — L2.5 (SURVEY.md §7.4).

The per-θ API in ``particle_filter.py`` is the reference semantics; this
module is the performance layer the samplers actually call: the whole
(M, N) particle tensor steps as one program — vmapped ``searchsorted`` +
``take`` for resample+gather, vmapped ``transition_distribution(x).sample``
for propagate — and XLA fuses each stage.

RNG note: the batched path draws its resampling uniforms as one (M, N)
tensor rather than M per-θ streams, so results differ bitwise from
``vmap(pf_step)`` while remaining exact draws of the same scheme.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .particle_filter import PFConfig, pf_init
from .resampling import (
    get_resampler,
    search_ancestors,
    stratified_uniforms,
    systematic_uniforms,
)

__all__ = [
    "BatchedPFOut",
    "batched_pf_init",
    "batched_pf_step",
    "batched_log_likelihood_masked",
    "batched_log_likelihood",
    "gather_ancestors",
]


class BatchedPFOut(NamedTuple):
    particles: jax.Array  # (M, N, dx)
    log_weights: jax.Array  # (M, N) normalized per row
    log_mean: jax.Array  # (M,) incremental evidence per θ
    ess: jax.Array  # (M,)


def _row_normalize(logw, log_n=None):
    """Per-row log-sum-exp normalize; returns (log_norm, lse, ess). With
    ``log_n`` given, lse is shifted to the log-MEAN (evidence) form."""
    maxw = jnp.max(logw, axis=-1, keepdims=True)
    maxw = jnp.where(jnp.isfinite(maxw), maxw, 0.0)
    lse = maxw + jnp.log(jnp.sum(jnp.exp(logw - maxw), axis=-1, keepdims=True))
    log_norm = logw - lse
    ess = 1.0 / jnp.sum(jnp.exp(2.0 * log_norm), axis=-1)
    log_mean = jnp.squeeze(lse, -1)
    if log_n is not None:
        log_mean = log_mean - log_n
    return log_norm, log_mean, ess


def batched_pf_init(key, models, n, m, y0, active_n=None,
                    config: PFConfig = PFConfig()):
    """vmapped pf_init over the stacked model pytree.

    ``active_n`` (traced int32 scalar): live-particle count for the
    padded-N in-graph-exchange formulation — slots ≥ active_n carry
    log-weight −inf and the evidence normalizes by active_n, not n
    (the static-shape form of the reference's N-doubling,
    smc_samplers.jl:163-189).

    ``config.proposal``: guided init — draws from ``proposal.initial`` with
    the importance correction (≡ pf_init's guided branch, VERDICT r4 #6)."""
    proposal = config.proposal
    keys = jax.random.split(key, m)
    if active_n is None:
        outs = jax.vmap(lambda k, mod: pf_init(k, mod, n, y0, proposal))(
            keys, models
        )
        return BatchedPFOut(
            outs.state.particles, outs.state.log_weights, outs.log_mean, outs.ess
        )

    def draw_one(k, mod):
        kd = jax.random.split(k)[0]
        if proposal is None:
            x = mod.initial_distribution().sample(kd, (n,))
            lw = mod.observation_distribution(x).log_prob(y0)
        else:
            q0 = proposal.initial(mod)
            x = q0.sample(kd, (n,))
            lw = (
                mod.observation_distribution(x).log_prob(y0)
                + mod.initial_distribution().log_prob(x)
                - q0.log_prob(x)
            )
        return x, lw

    x, logw = jax.vmap(draw_one)(keys, models)
    live = jnp.arange(n) < active_n
    logw = jnp.where(live[None, :], logw, -jnp.inf)
    log_n = jnp.log(active_n.astype(logw.dtype))
    log_norm, log_mean, ess = _row_normalize(logw, log_n)
    return BatchedPFOut(x, log_norm, log_mean, ess)


def _elastic_sorted_u(k_res, config, m, n, active_n, dtype):
    """Sorted uniform grids over the LIVE prefix: u_i = (i + offset)/active_n,
    tail entries clamped just below 1 so every output stays covered (tail
    slots duplicate the last live ancestor; their weights are re-masked)."""
    if config.resampling in ("systematic", "residual_systematic"):
        make_u = systematic_uniforms
    else:  # stratified
        make_u = stratified_uniforms
    u = make_u(k_res, m, n, dtype, count=active_n.astype(dtype))
    return jnp.minimum(u, jnp.asarray(1.0 - 1e-7, dtype))


def gather_ancestors(particles, ancestors):
    """Row-wise gather: out[m, i] = particles[m, ancestors[m, i]]."""
    return jax.vmap(lambda x, a: jnp.take(x, a, axis=0))(particles, ancestors)


def _resample_gather(k_res, config, particles, w, active_n):
    """The resample+gather stage of :func:`batched_pf_step`: draw the
    scheme's uniforms and gather every row's ancestors. Factored out so
    the adaptive-resampling path can put the WHOLE stage under a
    ``lax.cond`` (VERDICT r4 #2)."""
    m, n, dx = particles.shape
    if active_n is None:
        keys = jax.random.split(k_res, m)
        anc = jax.vmap(
            lambda k, ww: get_resampler(config.resampling)(k, ww)
        )(keys, w)
        return gather_ancestors(particles, anc)
    # elastic XLA path: uniforms over the live prefix + inverse CDF
    # (the masked tail has zero mass, so only live slots are drawn)
    if config.resampling == "multinomial":
        u = jax.random.uniform(k_res, (m, n), dtype=w.dtype)
    else:
        u = _elastic_sorted_u(k_res, config, m, n, active_n, w.dtype)
    cdf = jnp.cumsum(w, axis=-1)
    cdf = cdf / cdf[..., -1:]
    return gather_ancestors(particles, jax.vmap(search_ancestors)(cdf, u))


def _batched_apf_step(key, models, particles, log_w, y, config: PFConfig):
    """Batched auxiliary particle filter step ≡ M× ``apf_step``
    (Pitt & Shephard 1999; VERDICT r4 #6's optional lookahead).

    First-stage λ-weights look ahead through the transition mean; the
    per-ancestor lookahead density is appended to the particles as one
    extra component plane so the resample-by-λ gather moves both with the
    same ancestors. Second stage propagates and applies the correction
    weights; the evidence increment is the standard APF estimator."""
    m, n, dx = particles.shape
    k_res, k_prop = jax.random.split(key)
    log_n = jnp.log(jnp.asarray(float(n), dtype=log_w.dtype))

    with jax.named_scope("apf_lookahead"):
        mu = jax.vmap(
            lambda mod, x: mod.transition_distribution(x).mean()
        )(models, particles)
        log_g_mu = jax.vmap(
            lambda mod, mm: mod.observation_distribution(mm).log_prob(y)
        )(models, mu)
        lam_norm, lam_mean, _ = _row_normalize(log_w + log_g_mu, log_n)

    with jax.named_scope("apf_resample"):
        # gather particles AND the lookahead density by the λ-ancestors in
        # one pass: ride log_g_mu as an extra component plane
        aug = jnp.concatenate([particles, log_g_mu[..., None]], axis=-1)
        gathered = _resample_gather(k_res, config, aug, jnp.exp(lam_norm),
                                    None)
        xp = gathered[..., :dx]
        log_g_mu_a = gathered[..., dx]

    with jax.named_scope("apf_propagate"):
        keys_p = jax.random.split(k_prop, m)
        x_new = jax.vmap(
            lambda k, mod, x: mod.transition_distribution(x).sample(k)
        )(keys_p, models, xp)
        incr = jax.vmap(
            lambda mod, x: mod.observation_distribution(x).log_prob(y)
        )(models, x_new)

    with jax.named_scope("apf_normalize"):
        corr = incr - log_g_mu_a
        log_norm, corr_mean, ess = _row_normalize(corr, log_n)
        # p̂(y_t|·) = logsumexp(lw + g_mu) + log mean(corr) ≡ apf_step
        log_mean = lam_mean + log_n + corr_mean
    return BatchedPFOut(x_new, log_norm, log_mean, ess)


def batched_pf_step(key, models, particles, log_w, y,
                    config: PFConfig = PFConfig(), active_n=None):
    """One filter step for all M clouds ≡ M× particles.jl:107-129.

    ``active_n``: see :func:`batched_pf_init` — padded-N elastic mode.
    ``config.proposal``: guided propagate+reweight (VERDICT r4 #6).
    ``config.algorithm == "apf"``: auxiliary-PF lookahead step
    (:func:`_batched_apf_step`); requires the fixed-N mode."""
    if config.algorithm not in ("bootstrap", "apf"):
        raise ValueError(
            f"unknown algorithm {config.algorithm!r}; one of "
            "['bootstrap', 'apf']"
        )
    if config.algorithm == "apf":
        if active_n is not None:
            raise ValueError(
                "algorithm='apf' is not defined for the elastic padded-N "
                "mode (use elastic_pad='grow' samplers or bootstrap)"
            )
        if config.proposal is not None:
            raise ValueError(
                "algorithm='apf' propagates from the transition (the "
                "lookahead replaces the proposal role); proposal= "
                "composes with the bootstrap algorithm only"
            )
        if config.ess_threshold < 1.0:
            raise ValueError(
                "algorithm='apf' resamples by construction every step "
                "(the first-stage lookahead IS the resample); "
                "ess_threshold < 1 composes with the bootstrap "
                "algorithm only"
            )
        return _batched_apf_step(key, models, particles, log_w, y, config)
    m, n, dx = particles.shape
    proposal = config.proposal
    k_res, k_prop = jax.random.split(key)
    w = jnp.exp(log_w)

    with jax.named_scope("pf_resample"):
        if active_n is None:
            log_n = jnp.log(jnp.asarray(float(n), dtype=log_w.dtype))
            reset_lw = jnp.full_like(log_w, -log_n)
            n_live = n
        else:
            log_n = jnp.log(active_n.astype(log_w.dtype))
            live = (jnp.arange(n) < active_n)[None, :]
            reset_lw = jnp.where(live, -log_n, -jnp.inf)
            n_live = active_n
        adaptive = config.ess_threshold < 1.0
        if not adaptive:
            xp = _resample_gather(k_res, config, particles, w, active_n)
            lw = reset_lw
        else:
            # ESS-triggered resampling (reference resamples unconditionally,
            # particles.jl:17-19,117 — DEVIATIONS.md §3). The whole
            # resample+gather stage sits under ONE lax.cond on "any row
            # fires": steps where no trigger fires skip the uniforms, the
            # gather, and the selects entirely (VERDICT r4 #2 — the old
            # select formulation ran the full gather and then discarded
            # it). Rows that didn't fire
            # keep their particles/weights via the per-row select inside
            # the live branch, so results are bitwise-identical to the
            # select formulation at every step.
            ess_prev = 1.0 / jnp.sum(w * w, axis=-1)
            do = (ess_prev < config.ess_threshold * n_live)[:, None]

            def fire(_):
                gathered = _resample_gather(
                    k_res, config, particles, w, active_n
                )
                return (
                    jnp.where(do[..., None], gathered, particles),
                    jnp.where(do, reset_lw, log_w),
                )

            xp, lw = jax.lax.cond(
                jnp.any(do), fire, lambda _: (particles, log_w), None
            )

    with jax.named_scope("pf_propagate"):
        keys_p = jax.random.split(k_prop, m)
        if proposal is None:
            x_new = jax.vmap(
                lambda k, mod, x: mod.transition_distribution(x).sample(k)
            )(keys_p, models, xp)
            with jax.named_scope("pf_reweight"):
                incr = jax.vmap(
                    lambda mod, x: mod.observation_distribution(x).log_prob(y)
                )(models, x_new)
        else:
            # guided: q(x_t | x_{t-1}) with the transition−proposal
            # importance correction ≡ particles.jl:55-84, batched
            def prop_one(k, mod, xp_):
                q = proposal.step(mod, xp_)
                xn = q.sample(k)
                inc = (
                    mod.observation_distribution(xn).log_prob(y)
                    + mod.transition_distribution(xp_).log_prob(xn)
                    - q.log_prob(xn)
                )
                return xn, inc

            x_new, incr = jax.vmap(prop_one)(keys_p, models, xp)

    with jax.named_scope("pf_normalize"):
        if active_n is not None:
            # keep the dead tail at exactly −inf (guards −inf + NaN)
            live = (jnp.arange(n) < active_n)[None, :]
            incr = jnp.where(live, incr, 0.0)
        log_norm, log_mean, ess = _row_normalize(lw + incr)
    return BatchedPFOut(x_new, log_norm, log_mean, ess)


def batched_log_likelihood_masked(key, models, n, m, y, mask,
                                  config: PFConfig = PFConfig(),
                                  active_n=None):
    """Masked-prefix logZ for all M θ at once — the rejuvenation inner loop
    (≡ M× particles.jl:132-147 over y[1:t])."""
    k0, k_scan = jax.random.split(key)
    init = batched_pf_init(k0, models, n, m, y[0], active_n, config)

    # The mask is shared across the whole batch, so the skip is a lax.cond
    # at the top of the scan body: masked-off steps execute NOTHING (unlike
    # a select formulation, which would burn the full step). Rejuvenation
    # over y[1:t] therefore costs O(t), not O(T) — the reference's growing-
    # slice cost profile (smc_samplers.jl:317) under a static shape.
    def step(carry, inp):
        k, yt, mt = inp

        def live(c):
            particles, log_w, acc = c
            out = batched_pf_step(
                k, models, particles, log_w, yt, config, active_n
            )
            return (out.particles, out.log_weights, acc + out.log_mean)

        return jax.lax.cond(mt > 0, live, lambda c: c, carry), None

    keys = jax.random.split(k_scan, y.shape[0] - 1)
    (particles, log_w, logz), _ = jax.lax.scan(
        step,
        (init.particles, init.log_weights, init.log_mean),
        (keys, y[1:], mask[1:]),
    )
    return particles, log_w, logz


def batched_log_likelihood(key, models, n, m, y, config: PFConfig = PFConfig(),
                           active_n=None):
    """Full-sequence batched logZ (density-tempered init, exchange refilter)."""
    mask = jnp.ones_like(y)
    return batched_log_likelihood_masked(
        key, models, n, m, y, mask, config, active_n
    )
