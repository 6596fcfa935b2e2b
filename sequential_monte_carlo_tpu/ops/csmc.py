"""Conditional SMC (L2): the invariant particle-filter kernel behind
particle Gibbs (Andrieu, Doucet & Holenstein 2010, JRSS-B, §2.4).

Beyond-reference capability: the reference's only PMCMC machinery is the
PMMH rejuvenation inside its SMC samplers
(/root/reference/src/smc_samplers.jl:103-148); it has no conditional SMC
and no Gibbs-style state update. CSMC completes the PMCMC family: a
Markov kernel on trajectory space that leaves p(x_{1:T} | y_{1:T}, θ)
invariant for ANY number of particles N ≥ 2, which is what makes
particle Gibbs (``samplers/particle_gibbs.py``) a valid θ+x sampler.

Array-first shape: the conditional forward pass is one ``lax.scan`` over T,
fully vectorized over the N-cloud (no per-particle loops); pinning the
reference trajectory into slot 0 is a static ``.at[0].set`` — no dynamic
shapes, no data-dependent control flow. Path extraction is either

- ``method="bs"``: backward sampling (Whiteley 2010 discussion of AD&H;
  Lindsten & Schön 2013, §5.4) — reuse the FFBS backward-sampling scan
  from :mod:`.smoothing` on the stored clouds. Mixes fastest; needs a
  pointwise-evaluable transition density (every model in the zoo has one).
- ``method="as"``: ancestor sampling (PGAS, Lindsten, Jordan & Schön
  2014) — the reference slot's ancestor is redrawn each step from
  w_{t-1} · f(x_t^ref | x_{t-1}), and the new path is the ancestral
  lineage of a terminal draw (a reverse index-trace scan).

Free-slot resampling is conditional MULTINOMIAL (iid categorical draws),
the form for which the pinned-slot conditional distribution is exactly
the unconditioned resampler's — the invariance proof of AD&H §4.3 applies
verbatim. Low-variance schemes (systematic/stratified) need a dedicated
conditional construction and are deliberately NOT accepted here.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .resampling import multinomial
from .smoothing import SmoothedCloud, sample_smoothed_paths
from .weights import log_normalize

__all__ = ["CSMCOut", "csmc_forward", "csmc_sweep"]


class CSMCOut(NamedTuple):
    path: jax.Array  # (T, dx) — the freshly drawn trajectory
    cloud: SmoothedCloud  # forward clouds + filtered weights
    ancestors: jax.Array  # (T-1, N) int32 ancestor indices
    log_z: jax.Array  # scalar: the conditional filter's logZ estimate


def csmc_forward(key, model, n: int, y, ref_path,
                 ancestor_sampling: bool = False):
    """Conditional bootstrap-PF forward pass with slot 0 pinned to
    ``ref_path``.

    Args:
      ref_path: (T, dx) the conditioned ("retained") trajectory.
      ancestor_sampling: redraw slot 0's ancestor from
        w_{t-1} · f(ref_t | x_{t-1}) each step (PGAS).

    Returns (SmoothedCloud, ancestors (T-1, N) int32). The cloud's
    ``filter_log_weights`` are the per-step normalized conditional-filter
    weights; ``log_z`` accumulates the incremental evidence (diagnostic —
    CSMC is not an unbiased logZ estimator).
    """
    k0, k_scan = jax.random.split(key)
    x = model.initial_distribution().sample(k0, (n,))
    x = x.at[0].set(ref_path[0])
    logw = model.observation_distribution(x).log_prob(y[0])
    log_mean, lw, _ = log_normalize(logw)

    def step(carry, inp):
        x, lw, acc = carry
        k, yt, ref_t = inp
        k_res, k_as, k_prop = jax.random.split(k, 3)
        # free slots: iid categorical = conditional multinomial (AD&H §4.3).
        # Inverse-CDF on iid uniforms (ops.resampling.multinomial) — same
        # law as jax.random.categorical(shape=(n,)) but O(N log N) instead
        # of that primitive's (N, N) Gumbel materialization.
        anc = multinomial(k_res, jnp.exp(lw))
        if ancestor_sampling:
            log_as = lw + model.transition_distribution(x).log_prob(ref_t)
            a0 = jax.random.categorical(k_as, log_as).astype(jnp.int32)
        else:
            a0 = jnp.int32(0)
        anc = anc.at[0].set(a0)
        xp = jnp.take(x, anc, axis=0)
        x_new = model.transition_distribution(xp).sample(k_prop)
        x_new = x_new.at[0].set(ref_t)
        logw_new = model.observation_distribution(x_new).log_prob(yt)
        log_mean_t, lw_new, _ = log_normalize(logw_new)
        return (x_new, lw_new, acc + log_mean_t), (x_new, lw_new, anc)

    keys = jax.random.split(k_scan, y.shape[0] - 1)
    (_, _, log_z), (xs_tail, lw_tail, anc) = jax.lax.scan(
        step, (x, lw, log_mean), (keys, y[1:], ref_path[1:])
    )
    xs = jnp.concatenate([x[None], xs_tail], axis=0)
    lws = jnp.concatenate([lw[None], lw_tail], axis=0)
    return SmoothedCloud(xs, lws, lws, log_z), anc


def _trace_lineage(key, cloud: SmoothedCloud, ancestors):
    """Ancestral path of a terminal index drawn from the filtered
    weights at T — a reverse index-trace ``lax.scan``."""
    b_T = jax.random.categorical(
        key, cloud.filter_log_weights[-1]
    ).astype(jnp.int32)

    def bstep(b, anc_t):
        b_prev = anc_t[b]
        return b_prev, b_prev

    _, idx_tail = jax.lax.scan(bstep, b_T, ancestors, reverse=True)
    idx = jnp.concatenate([idx_tail, b_T[None]], axis=0)
    return jax.vmap(lambda xt, i: xt[i])(cloud.particles, idx)


def csmc_sweep(key, model, n: int, y, ref_path,
               method: str = "bs") -> CSMCOut:
    """One CSMC kernel application: ref_path → a fresh trajectory draw.

    The returned ``path`` is one step of a Markov chain whose invariant
    distribution is p(x_{1:T} | y_{1:T}) under ``model`` — for any N ≥ 2.

    Args:
      method: "bs" — forward pass without ancestor sampling, path by
        backward sampling (best mixing); "as" — PGAS forward pass, path
        by ancestral tracing.
    """
    if method not in ("bs", "as"):
        raise ValueError(f"unknown method {method!r}; one of ['bs', 'as']")
    k_fwd, k_path = jax.random.split(key)
    cloud, anc = csmc_forward(
        k_fwd, model, n, y, ref_path, ancestor_sampling=(method == "as")
    )
    if method == "bs":
        path = sample_smoothed_paths(k_path, cloud, model, 1)[:, 0, :]
    else:
        path = _trace_lineage(k_path, cloud, anc)
    return CSMCOut(path=path, cloud=cloud, ancestors=anc,
                   log_z=cloud.log_z)
