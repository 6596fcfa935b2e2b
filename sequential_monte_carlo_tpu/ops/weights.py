"""Log-weight normalization and effective-sample-size math.

Mirrors the reference's ``normalize`` (/root/reference/src/particles.jl:5-15,
and its missing twin ``reweight`` — SURVEY.md §0.2): a max-shifted log-sum-exp
returning

  * ``log_mean``  = max + log Σ exp(w − max) − log N   (log *mean* unnormalized
    weight — the per-step incremental evidence),
  * ``w``         = normalized linear weights,
  * ``ess``       = 1 / Σ w²  (absolute, in [1, N]).

Everything is a pure reduction — XLA fuses these into the surrounding
propagate/reweight kernel. An ``axis_name`` variant performs the same
reduction across a sharded particle axis with ``psum``/``pmax`` collectives,
replacing the reference's single-process assumption (SURVEY.md §5.8).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Normalized(NamedTuple):
    log_mean: jax.Array  # scalar (or batch): log of mean unnormalized weight
    weights: jax.Array  # normalized linear weights, same shape as input
    ess: jax.Array  # effective sample size in [1, N]


def normalize(log_w: jax.Array, axis: int = -1) -> Normalized:
    """Normalize log-weights along ``axis`` (batched along all other axes)."""
    n = log_w.shape[axis]
    maxw = jnp.max(log_w, axis=axis, keepdims=True)
    # guard fully-degenerate (-inf) weight vectors
    maxw = jnp.where(jnp.isfinite(maxw), maxw, 0.0)
    w = jnp.exp(log_w - maxw)
    sumw = jnp.sum(w, axis=axis, keepdims=True)
    log_mean = jnp.squeeze(maxw, axis) + jnp.log(jnp.squeeze(sumw, axis)) - jnp.log(float(n))
    w = w / sumw
    ess = 1.0 / jnp.sum(w * w, axis=axis)
    return Normalized(log_mean, w, ess)


def log_normalize(log_w: jax.Array, axis: int = -1):
    """Return (log_mean, normalized log-weights, ess) — the log-space variant
    used in the filter scan carry (numerically preferable to linear weights)."""
    n = log_w.shape[axis]
    maxw = jnp.max(log_w, axis=axis, keepdims=True)
    maxw = jnp.where(jnp.isfinite(maxw), maxw, 0.0)
    shifted = log_w - maxw
    lse = jnp.log(jnp.sum(jnp.exp(shifted), axis=axis, keepdims=True))
    log_norm = shifted - lse
    log_mean = jnp.squeeze(maxw + lse, axis) - jnp.log(float(n))
    ess = 1.0 / jnp.sum(jnp.exp(2.0 * log_norm), axis=axis)
    return log_mean, log_norm, ess


def ess_from_log_weights(log_w: jax.Array, axis: int = -1) -> jax.Array:
    """ESS = 1/Σw² of the normalized weights, computed stably in log space."""
    lw = log_w - jax.scipy.special.logsumexp(log_w, axis=axis, keepdims=True)
    return 1.0 / jnp.sum(jnp.exp(2.0 * lw), axis=axis)


# API-parity alias: the reference calls the identical operation ``reweight``
# at the sampler layer (missing from its tree — SURVEY.md §0.2; call sites
# smc_samplers.jl:62,183,232,249,265,298,338, ibis.jl:61,144,187).
reweight = normalize


# -- sharded variants (particle axis split over a mesh axis) -----------------

def normalize_sharded(log_w: jax.Array, axis_name: str) -> Normalized:
    """``normalize`` across a mesh axis: each shard holds a slice of the
    particle axis in its trailing dim; reductions ride ``pmax``/``psum`` over
    ICI. Total particle count = local_n * axis_size."""
    local_n = log_w.shape[-1]
    n = local_n * jax.lax.psum(1, axis_name)
    maxw = jax.lax.pmax(jnp.max(log_w, axis=-1, keepdims=True), axis_name)
    maxw = jnp.where(jnp.isfinite(maxw), maxw, 0.0)
    w = jnp.exp(log_w - maxw)
    sumw = jax.lax.psum(jnp.sum(w, axis=-1, keepdims=True), axis_name)
    log_mean = jnp.squeeze(maxw, -1) + jnp.log(jnp.squeeze(sumw, -1)) - jnp.log(n * 1.0)
    w = w / sumw
    ess = 1.0 / jax.lax.psum(jnp.sum(w * w, axis=-1), axis_name)
    return Normalized(log_mean, w, ess)
