"""Worker for the 2-process multi-host integration test (SURVEY.md §5.8).

Launched twice by tests/test_multihost.py against a localhost coordinator:
each process owns 4 virtual CPU devices; the global mesh is (theta=8,
particle=1) spanning both processes — the CPU-backend stand-in for a 2-host
deployment. Runs ShardedSMC2 end-to-end and prints a JSON line of posterior
statistics; the parent asserts both processes agree.

Usage: python multihost_worker.py <coordinator_addr> <process_id> <n_proc>
"""
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    addr, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import sequential_monte_carlo_tpu as smc
    from sequential_monte_carlo_tpu.parallel import (
        ShardedSMC2,
        initialize_distributed,
        make_global_mesh,
        process_info,
    )

    initialize_distributed(
        coordinator_address=addr, num_processes=nproc, process_id=pid
    )
    info = process_info()
    assert info["process_count"] == nproc, info
    assert info["global_device_count"] == 4 * nproc, info

    mesh = make_global_mesh()  # θ across both processes
    assert mesh.shape["theta"] == 4 * nproc

    prior = smc.product_distribution(
        [
            smc.TruncatedNormal(jnp.asarray(0.0), jnp.asarray(1.0),
                                jnp.asarray(-1.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
        ]
    )
    # identical data on every process (same seed, process-local compute)
    m_true = smc.lg_model(jnp.array([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(1998), m_true, 24)
    y = np.asarray(y)  # numpy input → implicitly replicated across processes

    cfg = smc.SMCConfig(n_particles=64, n_theta=32, chain=2, ess_threshold=0.5)
    sharded = ShardedSMC2(smc.SMC2(smc.lg_model, prior, cfg), mesh)
    state = sharded.init(jax.random.key(0), y)
    for _ in range(1, y.shape[0]):
        state, _ = sharded.step(state, y)

    from sequential_monte_carlo_tpu.samplers.smc2 import expected_parameters

    # replicate the sharded results for host read-out
    theta_hat = np.asarray(
        jax.jit(expected_parameters, out_shardings=None)(state)
    )
    print(json.dumps({
        "process": pid,
        "ess": float(state.ess),
        "t": int(state.t),
        "theta_hat": [round(float(v), 6) for v in theta_hat],
    }), flush=True)


if __name__ == "__main__":
    main()
