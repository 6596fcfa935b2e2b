"""Particle Gibbs (L3): joint θ + x_{1:T} inference by Gibbs sweeps of
conditional SMC and complete-data Metropolis–Hastings (Andrieu, Doucet &
Holenstein 2010, JRSS-B, §2.4-2.5).

Beyond-reference capability, completing the PMCMC family next to the
reference's PMMH-within-SMC rejuvenation
(/root/reference/src/smc_samplers.jl:103-148): where PMMH re-runs a FULL
inner particle filter per θ-proposal (O(N·T) per MCMC step), particle
Gibbs alternates

    x_{1:T} ~ CSMC(x_prev; θ)                 (ops/csmc.py — invariant for
                                               p(x_{1:T} | y, θ), any N ≥ 2)
    θ       ~ MH targeting p(θ | x_{1:T}, y)  (complete-data likelihood —
                                               O(T) per MCMC step, no filter)

so θ moves cost O(T) instead of O(N·T). The complete-data density
log p(θ) + log μ_θ(x_1) + Σ log f_θ(x_t|x_{t-1}) + Σ log g_θ(y_t|x_t)
is three vectorized ``log_prob`` sweeps over the stored path.

Array-first: the whole chain is ONE ``lax.scan`` over sweeps (static
shapes; the CSMC forward pass and the MH chain are nested scans), so a
full PG run is a single compiled program with per-sweep θ draws returned
as arrays — no Python-loop MCMC.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.csmc import csmc_sweep
from ..ops.smoothing import SmoothedCloud, forward_clouds, \
    sample_smoothed_paths
from ..ops.particle_filter import PFConfig

__all__ = ["PGConfig", "PGResult", "complete_data_log_prob",
           "particle_gibbs"]


class PGConfig(NamedTuple):
    """Static particle-Gibbs configuration (hashable)."""

    n_particles: int = 256  # N: CSMC cloud size
    sweeps: int = 500  # Gibbs sweeps (= retained θ draws)
    chain: int = 1  # complete-data MH steps per sweep
    method: str = "bs"  # CSMC path draw: "bs" backward sampling | "as" PGAS
    rw_scale: float = 0.25  # initial θ-proposal std, × prior marginal std
    collect_paths: bool = False  # also return every sweep's trajectory
    # diminishing-adaptation step-size scaling (Andrieu & Thoms 2008 §4.3):
    # the proposal stds are multiplied by a global λ updated per sweep,
    # log λ += γ_s · (acc_s − target_accept), γ_s = s^{-0.6}. Vanishing
    # adaptation preserves ergodicity; the complete-data conditional
    # tightens like 1/√T, which no fixed prior-scaled default can track.
    target_accept: float = 0.234
    adapt: bool = True


class PGResult(NamedTuple):
    theta: jax.Array  # (sweeps, dθ) — the θ chain
    acc_ratio: jax.Array  # scalar: mean complete-data MH acceptance
    final_path: jax.Array  # (T, dx) — last retained trajectory
    paths: Optional[jax.Array] = None  # (sweeps, T, dx) if collect_paths


def complete_data_log_prob(model, x, y):
    """log p(x_{1:T}, y_{1:T} | θ) for a single trajectory.

    ``x`` is (T, dx), ``y`` is (T, ...). Three vectorized density sweeps —
    the O(T) quantity that makes PG's θ-updates filter-free.
    """
    lp = model.initial_distribution().log_prob(x[0])
    lp = lp + jnp.sum(model.transition_distribution(x[:-1]).log_prob(x[1:]))
    lp = lp + jnp.sum(model.observation_distribution(x).log_prob(y))
    return lp


def particle_gibbs(key, model_fn, prior, y,
                   config: PGConfig = PGConfig(),
                   theta0=None, rw_sigma=None) -> PGResult:
    """Run a particle-Gibbs chain.

    Args:
      model_fn: θ ↦ StateSpaceModel (same constructor contract as SMC2).
      prior: Distribution over θ with sample/log_prob/in_support.
      y: (T, ...) observations.
      theta0: optional (dθ,) start; default draws from the prior.
      rw_sigma: optional (dθ,) base MH proposal stds; default
        ``config.rw_scale ×`` the prior's empirical marginal stds
        (from 1024 prior draws — computed once, host-side). With
        ``config.adapt`` (default) the effective scale is λ·rw_sigma
        with λ tuned toward ``target_accept`` by diminishing adaptation.

    Returns a :class:`PGResult`; discard an initial burn-in of
    ``result.theta`` before summarizing (PG is MCMC, not SMC — draws are
    correlated and the chain starts at ``theta0``).
    """
    if config.chain < 1:
        raise ValueError(
            f"config.chain must be >= 1 (got {config.chain}); for pure "
            "CSMC state sampling at fixed theta, iterate ops.csmc_sweep "
            "directly"
        )
    n, sweeps = config.n_particles, config.sweeps
    k_init, k_path0, k_run = jax.random.split(key, 3)

    if theta0 is None:
        theta0 = prior.sample(k_init)
    theta0 = jnp.asarray(theta0)
    if rw_sigma is None:
        draws = prior.sample(jax.random.key(0), (1024,))
        rw_sigma = config.rw_scale * jnp.std(draws, axis=0)
    rw_sigma = jnp.broadcast_to(jnp.asarray(rw_sigma), theta0.shape)
    d_theta = theta0.shape[0]

    # initial retained path: one unconditional forward filter at θ0 +
    # one backward-sampling draw (a draw from p̂(x_{1:T} | y, θ0) — a
    # proper over-dispersed start for the Gibbs chain)
    k_f, k_b = jax.random.split(k_path0)
    model0 = model_fn(theta0)
    xs, lw, _ = forward_clouds(k_f, model0, n, y, PFConfig("multinomial"))
    cloud0 = SmoothedCloud(xs, lw, lw, jnp.float32(0.0))
    path0 = sample_smoothed_paths(k_b, cloud0, model0, 1)[:, 0, :]

    def mh_chain(key, theta, path, lam):
        """``config.chain`` complete-data MH steps at the current path."""
        lp0 = prior.log_prob(theta) + complete_data_log_prob(
            model_fn(theta), path, y
        )
        lp0 = jnp.where(jnp.isfinite(lp0), lp0, -jnp.inf)

        def step(carry, k):
            th, lp, n_acc = carry
            k_prop, k_acc = jax.random.split(k)
            prop = th + lam * rw_sigma * jax.random.normal(k_prop, (d_theta,))
            ok = prior.in_support(prop)
            lp_prop = jnp.where(
                ok,
                prior.log_prob(prop)
                + complete_data_log_prob(model_fn(prop), path, y),
                -jnp.inf,
            )
            lp_prop = jnp.where(jnp.isfinite(lp_prop), lp_prop, -jnp.inf)
            # degeneracy guard ≡ smc_samplers.jl:129
            accept = (lp_prop > -jnp.inf) & (
                jnp.log(jax.random.uniform(k_acc)) < lp_prop - lp
            )
            th = jnp.where(accept, prop, th)
            lp = jnp.where(accept, lp_prop, lp)
            return (th, lp, n_acc + accept.astype(jnp.float32)), None

        (theta, _, n_acc), _ = jax.lax.scan(
            step, (theta, lp0, jnp.float32(0.0)),
            jax.random.split(key, config.chain),
        )
        return theta, n_acc / config.chain

    def sweep(carry, inp):
        theta, path, log_lam = carry
        s, k = inp
        k_theta, k_csmc = jax.random.split(k)
        lam = jnp.exp(log_lam)
        theta, acc = mh_chain(k_theta, theta, path, lam)  # θ | x, y
        if config.adapt:
            gamma = (s + 1.0) ** -0.6
            log_lam = log_lam + gamma * (acc - config.target_accept)
        out = csmc_sweep(
            k_csmc, model_fn(theta), n, y, path, method=config.method
        )  # x | θ, y
        emit = {"theta": theta, "acc": acc}
        if config.collect_paths:
            emit["path"] = out.path
        return (theta, out.path, log_lam), emit

    (_, final_path, _), series = jax.lax.scan(
        sweep, (theta0, path0, jnp.float32(0.0)),
        (jnp.arange(sweeps, dtype=jnp.float32), jax.random.split(k_run, sweeps)),
    )
    return PGResult(
        theta=series["theta"],
        acc_ratio=jnp.mean(series["acc"]),
        final_path=final_path,
        paths=series.get("path"),
    )
