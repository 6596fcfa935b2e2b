"""Particle-Gibbs throughput (capability row — the reference has
no PMCMC sampler to baseline against; /root/reference's only MCMC is the
PMMH rejuvenation inside its SMC samplers, smc_samplers.jl:103-148).

One compiled program: the whole chain (sweeps × [CSMC forward scan over
T + backward-sampling scan + complete-data MH chain]) is a single
``lax.scan``. Reports wall-clock, sweeps/s, and particle-steps/s
(sweeps · T · N — each sweep's forward pass does the work of one full
particle filter).

Usage: python benchmarks/bench_pg.py [--n 8192] [--t 241] [--sweeps 50]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--t", type=int, default=241)
    p.add_argument("--sweeps", type=int, default=50)
    p.add_argument("--chain", type=int, default=3)
    p.add_argument("--method", default="bs", choices=["bs", "as"])
    args = p.parse_args()

    os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"),
    )
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

    import jax
    import jax.numpy as jnp
    import numpy as np

    import sequential_monte_carlo_tpu as smc

    rng = np.random.default_rng(1998)
    y = jnp.asarray(
        3.0 + np.cumsum(rng.normal(0, 0.3, args.t))
        + rng.normal(0, 0.5, args.t),
        dtype=jnp.float32,
    )
    prior = smc.product_distribution(
        [
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.Normal(jnp.asarray(3.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
        ]
    )
    cfg = smc.PGConfig(
        n_particles=args.n, sweeps=args.sweeps, chain=args.chain,
        method=args.method,
    )

    # Two dispatch modes, both timed (code-review r5 asked for whole-run
    # jit): one outer jit over the whole chain vs dispatching the
    # already-compiled setup scans + sweeps scan as separate executions.
    # The headline is the faster mode; both are reported so the comparison
    # stays auditable.
    def run_eager(k):
        return smc.particle_gibbs(k, smc.ucsv_model, prior, y, cfg)

    run_jit = jax.jit(run_eager)

    def timed(fn):
        res = fn(jax.random.key(0))
        jax.block_until_ready(res.theta)  # warm compile
        t0 = time.perf_counter()
        res = fn(jax.random.key(1))
        jax.block_until_ready(res.theta)
        return time.perf_counter() - t0, res

    dt_eager, res = timed(run_eager)
    dt_jit, res_j = timed(run_jit)
    dt = min(dt_eager, dt_jit)

    assert bool(jnp.isfinite(res.theta).all())
    assert bool(jnp.isfinite(res_j.theta).all())
    print(json.dumps({
        "metric": f"pg_ucsv_N{args.n}_T{args.t}_{args.method}",
        "wallclock_s": round(dt, 3),
        "sweeps_per_s": round(args.sweeps / dt, 2),
        "particle_steps_per_s": round(args.sweeps * args.t * args.n / dt),
        "acc_ratio": round(float(res.acc_ratio), 3),
        "eager_dispatch_s": round(dt_eager, 3),
        "whole_jit_s": round(dt_jit, 3),
    }))


if __name__ == "__main__":
    main()
