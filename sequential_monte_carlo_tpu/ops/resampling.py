"""Resampling schemes as vectorized ancestor-index computations.

The reference has *only* multinomial resampling via StatsBase
(``sample(1:N, Weights(w), N)``, /root/reference/src/particles.jl:17-19) and
resamples unconditionally every filter step. Here each scheme is a pure
function ``(key, weights, n) -> ancestors`` built from a cumulative sum plus a
vectorized ``searchsorted`` — no sequential O(N) loop, so XLA fuses it with
the surrounding gather. Systematic / stratified (Kitagawa) are the default
schemes (single sorted-uniform grid ⇒ monotone searchsorted); multinomial is
kept for behavioral parity with the reference.

All schemes are unbiased: E[#offspring of particle i] = n·w_i.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "multinomial",
    "systematic",
    "stratified",
    "residual",
    "residual_systematic",
    "search_ancestors",
    "systematic_uniforms",
    "stratified_uniforms",
    "get_resampler",
    "resample",
]


def search_ancestors(cdf: jax.Array, u: jax.Array) -> jax.Array:
    """Ancestor indices of uniforms ``u`` under a normalized 1-D CDF: the
    first i with cdf[i] >= u, clipped to the last index. searchsorted
    vectorizes to a fixed log2(N)-step binary search."""
    idx = jnp.searchsorted(cdf, u, side="left")
    return jnp.clip(idx, 0, cdf.shape[-1] - 1).astype(jnp.int32)


def _inverse_cdf(u: jax.Array, weights: jax.Array) -> jax.Array:
    """Map sorted-or-not uniforms u ∈ [0,1) to ancestor indices via the
    weight CDF."""
    cdf = jnp.cumsum(weights, axis=-1)
    # guard rounding: force the last CDF entry to cover u→1
    cdf = cdf / cdf[..., -1:]
    return search_ancestors(cdf, u)


def multinomial(key, weights, n=None):
    """IID draws from Categorical(w) — parity with particles.jl:17-19."""
    n = n or weights.shape[-1]
    u = jax.random.uniform(key, (n,), dtype=weights.dtype)
    return _inverse_cdf(u, weights)


def systematic(key, weights, n=None):
    """Single uniform offset, stride-1/n grid: u_i = (i + u0)/n.

    Lowest-variance O(N) scheme; the grid is already sorted so the
    searchsorted is monotone.
    """
    n = n or weights.shape[-1]
    u0 = jax.random.uniform(key, (), dtype=weights.dtype)
    u = (jnp.arange(n, dtype=weights.dtype) + u0) / n
    return _inverse_cdf(u, weights)


def stratified(key, weights, n=None):
    """One uniform per stratum: u_i = (i + v_i)/n, v_i ~ U[0,1)."""
    n = n or weights.shape[-1]
    v = jax.random.uniform(key, (n,), dtype=weights.dtype)
    u = (jnp.arange(n, dtype=weights.dtype) + v) / n
    return _inverse_cdf(u, weights)


def systematic_uniforms(key, m, n, dtype=jnp.float32, count=None):
    """Per-row systematic grids u_i = (i + u0)/count (one u0 per row),
    (m, n). ``count`` (default n; may be traced) is the number of strata,
    so entries i ≥ count fall at or beyond 1."""
    u0 = jax.random.uniform(key, (m, 1), dtype=dtype)
    i = jnp.arange(n, dtype=dtype)[None, :]
    return (i + u0) / (n if count is None else count)


def stratified_uniforms(key, m, n, dtype=jnp.float32, count=None):
    """Per-row stratified grids u_i = (i + v_i)/count, (m, n); ``count`` as
    in :func:`systematic_uniforms`."""
    v = jax.random.uniform(key, (m, n), dtype=dtype)
    i = jnp.arange(n, dtype=dtype)[None, :]
    return (i + v) / (n if count is None else count)


def _counts_to_ancestors(counts, n):
    """Sorted ancestor vector from offspring counts (Σcounts = n): index i
    repeated counts[i] times, via cumsum + searchsorted (static shape)."""
    cum = jnp.cumsum(counts)
    k = jnp.arange(n, dtype=cum.dtype)
    return jnp.searchsorted(cum, k, side="right").astype(jnp.int32)


def residual(key, weights, n=None):
    """Residual (remainder-multinomial) resampling — Liu & Chen (1998).

    Deterministically copies ``floor(n·w_i)`` offspring of every particle,
    then draws the remaining ``R = n − Σ floor(n·w_i)`` offspring by
    multinomial sampling from the fractional remainders
    ``r_i ∝ n·w_i − floor(n·w_i)``. Unbiased, and strictly lower offspring
    variance than plain multinomial. Static-shape formulation: n uniforms
    are drawn and the first R (a traced count) are masked live; offspring
    counts assemble by scatter-add and convert to a sorted ancestor vector.

    Note this is NOT equivalent to :func:`systematic`: the multinomial
    remainder can give a particle up to floor+R offspring, while systematic
    caps every count at ceil(n·w_i). (The reference has no residual scheme
    at all — its only resampler is multinomial, particles.jl:17-19.)
    """
    size = weights.shape[-1]
    n = n or size
    w = weights / jnp.sum(weights)
    nw = n * w
    floor = jnp.floor(nw)
    resid = nw - floor
    n_det = jnp.sum(floor).astype(jnp.int32)  # Σ floor(n·w) ≤ n

    # multinomial on the remainders; only the first R = n − n_det draws live
    cdf = jnp.cumsum(resid)
    cdf = cdf / jnp.maximum(cdf[-1], jnp.finfo(w.dtype).tiny)
    u = jax.random.uniform(key, (n,), dtype=w.dtype)
    draws = jnp.clip(jnp.searchsorted(cdf, u, side="left"), 0, size - 1)
    live = (jnp.arange(n) < (n - n_det)).astype(jnp.int32)
    res_counts = jnp.zeros(size, dtype=jnp.int32).at[draws].add(live)

    return _counts_to_ancestors(floor.astype(jnp.int32) + res_counts, n)


def residual_systematic(key, weights, n=None):
    """Residual resampling with a *systematic* pass on the fractional part.

    Identical in distribution — in fact pointwise identical for the same
    uniform — to plain :func:`systematic`. Proof: with a_i = n·w_i,
    S_i = Σ_{j≤i} a_j and integer F_i = Σ_{j≤i} floor(a_j), the systematic
    count is ⌊S_i − u⌋ − ⌊S_{i−1} − u⌋ = (F_i − F_{i−1}) +
    (⌊Sr_i − u⌋ − ⌊Sr_{i−1} − u⌋) where Sr is the cumsum of the fractional
    parts — exactly floor(a_i) deterministic copies plus a systematic pass
    over the remainders. Kept as a named alias; for the distinct
    remainder-multinomial scheme use ``"residual"`` (:func:`residual`).
    """
    return systematic(key, weights, n)


def metropolis(key, weights, n=None, n_iters: int = 16):
    """Metropolis resampler (Murray, arXiv:1202.6163 — PAPERS.md).

    Collective-free: each output runs a short independent Metropolis chain
    over ancestor candidates, accepting j over i with prob w_j/w_i. Needs no
    CDF/prefix-sum at all — every op is elementwise — at the cost of a small,
    controllable bias that decays geometrically in ``n_iters``. The
    scale-out option for sharded particle axes where even one all_gather is
    too much; default schemes remain exact.
    """
    n = n or weights.shape[-1]
    size = weights.shape[-1]
    k_start, k_chain = jax.random.split(key)
    idx = jax.random.randint(k_start, (n,), 0, size)

    def body(carry, k):
        idx = carry
        k_prop, k_acc = jax.random.split(k)
        prop = jax.random.randint(k_prop, (n,), 0, size)
        u = jax.random.uniform(k_acc, (n,), dtype=weights.dtype)
        ratio = weights[prop] / jnp.maximum(weights[idx], 1e-38)
        idx = jnp.where(u < ratio, prop, idx)
        return idx, None

    keys = jax.random.split(k_chain, n_iters)
    idx, _ = jax.lax.scan(body, idx, keys)
    return idx.astype(jnp.int32)


_SCHEMES = {
    "multinomial": multinomial,
    "systematic": systematic,
    "stratified": stratified,
    "residual": residual,
    "residual_systematic": residual_systematic,
    "metropolis": metropolis,
}


def get_resampler(name: str):
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(
            f"unknown resampling scheme {name!r}; one of {sorted(_SCHEMES)}"
        ) from None


def resample(key, weights, n=None, scheme: str = "multinomial"):
    """Ancestor indices for the given scheme. Default scheme matches the
    reference (multinomial, particles.jl:17-19)."""
    return get_resampler(scheme)(key, weights, n)


@partial(jax.jit, static_argnames=("scheme",))
def resample_jit(key, weights, scheme: str = "systematic"):
    return resample(key, weights, scheme=scheme)
