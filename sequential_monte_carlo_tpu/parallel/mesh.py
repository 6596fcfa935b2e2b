"""Device meshes for SMC (L-1 in the layer map, SURVEY.md §1).

The reference's entire parallelism story is ``Threads.@threads`` over the M
θ-particles (smc_samplers.jl:112,174,223; ibis.jl:95 — SURVEY.md §2
parallelism inventory). The replacement is a 2-D device mesh:

  * axis ``"theta"``    — θ-particles sharded across hosts/chips (DCN/ICI);
    embarrassingly parallel except θ-resampling and the global ESS, which
    are O(M) scalars per step;
  * axis ``"particle"`` — each θ's state-particle cloud sharded across the
    chips of one host (ICI); normalize/ESS ride ``psum``, resampling uses
    gathers.

Shardings are expressed as ``NamedSharding`` annotations on the sampler
state; XLA/GSPMD inserts the collectives (the scaling-book recipe: pick a
mesh, annotate, let XLA partition).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

THETA_AXIS = "theta"
PARTICLE_AXIS = "particle"


def make_mesh(n_theta_shards: int | None = None, n_particle_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (theta, particle) mesh over the available devices."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if n_theta_shards is None:
        n_theta_shards = n // n_particle_shards
    if n_theta_shards * n_particle_shards != n:
        raise ValueError(
            f"mesh {n_theta_shards}x{n_particle_shards} != {n} devices"
        )
    arr = np.asarray(devices).reshape(n_theta_shards, n_particle_shards)
    return Mesh(arr, (THETA_AXIS, PARTICLE_AXIS))


def smc2_state_shardings(mesh: Mesh):
    """NamedSharding for every leaf of an SMC2State: θ-quantities over the
    theta axis, particle clouds over (theta, particle), scalars replicated."""
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    from ..samplers.base import SMC2State

    return SMC2State(
        theta=s(THETA_AXIS, None),
        log_omega=s(THETA_AXIS),
        particles=s(THETA_AXIS, PARTICLE_AXIS, None),
        log_w=s(THETA_AXIS, PARTICLE_AXIS),
        log_z=s(THETA_AXIS),
        ess=s(),
        acc_ratio=s(),
        key=s(),
        t=s(),
        active_n=s(),
        exchange_pending=s(),
    )


def ibis_state_shardings(mesh: Mesh):
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    from ..samplers.base import IBISState

    return IBISState(
        theta=s(THETA_AXIS, None),
        log_omega=s(THETA_AXIS),
        mean=s(THETA_AXIS, None),
        cov=s(THETA_AXIS, None, None),
        log_z=s(THETA_AXIS),
        ess=s(),
        acc_ratio=s(),
        key=s(),
        t=s(),
    )


def shard_state(state, shardings):
    """Place a sampler state onto the mesh with the given shardings."""
    return jax.tree_util.tree_map(
        lambda x, sh: jax.device_put(x, sh), state, shardings
    )
