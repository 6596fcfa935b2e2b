"""Multi-host launcher (L-1/L4): θ-particles sharded across processes.

The reference's entire parallelism story is single-process
``Threads.@threads`` over the M θ-particles
(/root/reference/src/smc_samplers.jl:112,174,223; /root/reference/src/ibis.jl:95).
The replacement at the *host* level (SURVEY.md §5.8, §7.6): each
process owns one host's chips, ``jax.distributed`` wires the processes into
one global device set, and the (theta, particle) mesh spans them —
θ-particles shard across hosts over DCN, each θ's inner particle cloud stays
on one host's chips over ICI. Per-step cross-host traffic is O(M) scalars
(the θ-ESS / log-evidence reductions), so scaling is sync-bound, not
bandwidth-bound.

Typical SLURM/GCE launch (same program on every host)::

    from sequential_monte_carlo_tpu.parallel import (
        initialize_distributed, make_global_mesh, ShardedSMC2)

    initialize_distributed()          # env-driven on SLURM clusters
    mesh = make_global_mesh()         # θ across hosts, particles within
    sharded = ShardedSMC2(SMC2(model_fn, prior, cfg), mesh)
    state = sharded.init(jax.random.key(0), y)   # y replicated on all hosts
    state, info = sharded.step(state, y)

Every process executes the same jitted program; GSPMD keeps each process's
shard local. Checkpoint/restore composes: ``utils/checkpoint.py`` +
``sharded.reshard`` place a restored state back onto the global mesh.

The 2-process CPU integration test (tests/test_multihost.py) launches two
local processes against a localhost coordinator and asserts both compute
identical posterior statistics on a (hosts=2) × (local devices) mesh.
"""
from __future__ import annotations

import os

import jax

from .mesh import make_mesh

__all__ = [
    "initialize_distributed",
    "make_global_mesh",
    "process_info",
]


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """``jax.distributed.initialize`` with env-var fallbacks.

    On SLURM clusters all arguments auto-detect (pass nothing).
    For manual/CPU launches set the standard env vars or pass explicitly:
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``.
    Safe to call once per process, before any other jax API touches devices.
    """
    if jax.distributed.is_initialized():
        return  # already initialized
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    nproc = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    if nproc is not None:
        kwargs["num_processes"] = int(nproc)
    pid = process_id if process_id is not None else os.environ.get("JAX_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def make_global_mesh(n_particle_shards: int | None = None):
    """(theta, particle) mesh over ALL processes' devices.

    The θ-axis spans hosts (``jax.devices()`` orders devices process-major,
    so contiguous θ-shards live on one host and cross-host traffic stays on
    the O(M)-scalar θ-reductions); the particle axis subdivides each host's
    local chips. ``n_particle_shards`` defaults to 1 (whole clouds local —
    the right choice up to the reference's N=8192).
    """
    n_particle_shards = n_particle_shards or 1
    devices = jax.devices()
    n = len(devices)
    if n % n_particle_shards:
        raise ValueError(
            f"{n} global devices not divisible by particle shards "
            f"{n_particle_shards}"
        )
    if n_particle_shards > 1 and jax.process_count() > 1:
        per_host = len(jax.local_devices())
        if per_host % n_particle_shards:
            raise ValueError(
                "particle shards must divide the per-host device count "
                f"({per_host}) so clouds never straddle DCN"
            )
    return make_mesh(
        n_theta_shards=n // n_particle_shards,
        n_particle_shards=n_particle_shards,
        devices=devices,
    )


def process_info() -> dict:
    """Topology snapshot for logging/diagnostics."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
        "backend": jax.default_backend(),
    }
