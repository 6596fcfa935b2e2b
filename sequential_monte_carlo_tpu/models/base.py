"""State-space-model protocol and ancestral simulation (L1).

The reference defines the SSM contract as three distribution-valued methods —
``initial_dist(m)``, ``transition(m, x)``, ``observation(m, x)`` — plus
``preallocate`` / ``get_types`` (/root/reference/src/state_space_models.jl:9,30-42).
The array-first contract is the same three densities as *pure functions over
arrays*:

  * states always carry a trailing state-dim axis: a particle cloud is
    ``(N, dx)``, a θ-batched cloud is ``(M, N, dx)`` — static shapes that XLA
    tiles onto the device;
  * each method must broadcast over arbitrary leading batch axes (the filters
    never loop over particles);
  * models are pytrees of parameter arrays, so a whole θ-cloud of models is a
    single stacked model pytree and ``vmap`` turns the per-θ filter into one
    (M, N, T) program.

``preallocate``/``get_types`` are unnecessary: shapes/dtypes are static.
``simulate`` (state_space_models.jl:11-28) becomes a ``lax.scan`` over T with
split PRNG keys — bitwise reproducible, unlike the reference's global RNG.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import jax
import jax.numpy as jnp


@runtime_checkable
class StateSpaceModel(Protocol):
    """Duck-typed SSM: any pytree with these members qualifies."""

    @property
    def state_dim(self) -> int:  # static
        ...

    def initial_distribution(self):
        """Distribution over the initial state, event shape (dx,)."""

    def transition_distribution(self, x):
        """Distribution over x_t given x_{t-1} = x (..., dx)."""

    def observation_distribution(self, x):
        """Distribution over scalar y_t given x_t = x (..., dx)."""


def simulate(key: jax.Array, model: StateSpaceModel, T: int):
    """Draw (x_{1:T}, y_{1:T}) ancestrally — ≡ state_space_models.jl:11-28.

    Returns ``x`` of shape (T, dx) and ``y`` of shape (T,).
    """
    k_init, k_scan = jax.random.split(key)
    kx0, ky0 = jax.random.split(k_init)
    x0 = model.initial_distribution().sample(kx0)
    y0 = model.observation_distribution(x0).sample(ky0)

    def step(x_prev, k):
        kx, ky = jax.random.split(k)
        x = model.transition_distribution(x_prev).sample(kx)
        y = model.observation_distribution(x).sample(ky)
        return x, (x, y)

    keys = jax.random.split(k_scan, T - 1)
    _, (xs, ys) = jax.lax.scan(step, x0, keys)
    x = jnp.concatenate([x0[None], xs], axis=0)
    y = jnp.concatenate([y0[None], ys], axis=0)
    return x, y
