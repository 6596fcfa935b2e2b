"""Benchmark suite — the five BASELINE.json north-star configs.

Prints one JSON line per config, each naming its backend. Runs on the
default JAX backend (the GPU where there is one; `JAX_PLATFORMS=cpu` for
the CPU). Sizes can be scaled down with --scale for smoke runs.

  1. bootstrap PF, 1024 particles, univariate LG (θ=[.5,.9,.8], T=100):
     logZ vs exact Kalman
  2. bootstrap PF, stochastic-volatility SSM, 4096 particles,
     ESS-triggered systematic resampling: particle-steps/s
  3. batched log_likelihood: 512 parallel PFs on LG: throughput
  4. density-tempered SMC 512×1024 + 3 MCMC steps, LG prior:
     posterior moments + wall-clock
  5. online SMC² UC-SV 512×1024 (T=241): wall-clock (also bench.py headline)
"""
from __future__ import annotations

import argparse
import json
import os
import time

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
)

import jax
import jax.numpy as jnp
import numpy as np

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import sequential_monte_carlo_tpu as smc  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def lg_prior():
    return smc.product_distribution(
        [
            smc.TruncatedNormal(jnp.asarray(0.0), jnp.asarray(1.0),
                                jnp.asarray(-1.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
        ]
    )


def timeit(fn, repeats=3):
    out = fn()
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=float, default=1.0)
    args = p.parse_args()
    s = args.scale

    backend = jax.default_backend()

    # ---- config 1: PF logZ vs Kalman --------------------------------------
    m = smc.lg_model(jnp.array([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(1998), m, 100)
    (_, _), kz = smc.kalman_log_likelihood(m, y)
    n1 = max(int(1024 * s), 64)
    reps = 16
    keys = jax.random.split(jax.random.key(0), reps)
    f1 = jax.jit(jax.vmap(lambda k: smc.log_likelihood(k, m, n1, y)[1]))
    dt, zs = timeit(lambda: f1(keys))
    zs = np.asarray(zs)
    emit(
        config="pf_lg_logz_vs_kalman",
        backend=backend,
        n_particles=n1,
        kalman_logz=float(kz),
        pf_logz_mean=float(zs.mean()),
        pf_logz_se=float(zs.std(ddof=1) / np.sqrt(reps)),
        abs_err_in_se=float(abs(zs.mean() - float(kz)) / (zs.std(ddof=1) / np.sqrt(reps))),
    )

    # ---- config 2: SV PF throughput ---------------------------------------
    sv = smc.stochastic_volatility()
    _, ysv = smc.simulate(jax.random.key(1), sv, 200)
    n2 = max(int(4096 * s), 128)
    cfg2 = smc.PFConfig("systematic", 0.5)
    f2 = jax.jit(lambda k: smc.log_likelihood(k, sv, n2, ysv, cfg2)[1])
    dt, _ = timeit(lambda: f2(jax.random.key(2)))
    emit(
        config="pf_sv_ess_triggered_systematic",
        backend=backend,
        n_particles=n2,
        T=200,
        wallclock_s=round(dt, 4),
        particle_steps_per_s=round(n2 * 200 / dt),
    )

    # ---- config 3: 512 parallel PFs ---------------------------------------
    m3 = max(int(512 * s), 16)
    n3 = max(int(1024 * s), 64)
    theta = lg_prior().sample(jax.random.key(3), (m3,))
    models = jax.vmap(smc.lg_model)(theta)
    f3 = jax.jit(
        lambda k: smc.batched_log_likelihood(k, models, n3, m3, y)[2]
    )
    dt, _ = timeit(lambda: f3(jax.random.key(4)))
    emit(
        config="batched_512_parallel_pfs_lg",
        backend=backend,
        m=m3,
        n=n3,
        T=100,
        wallclock_s=round(dt, 4),
        particle_steps_per_s=round(m3 * n3 * 100 / dt),
    )

    # ---- config 4: density-tempered SMC -----------------------------------
    m4 = max(int(512 * s), 16)
    n4 = max(int(1024 * s), 64)
    sampler = smc.SMC2(
        smc.lg_model, lg_prior(),
        smc.SMCConfig(n_particles=n4, n_theta=m4, chain=3, ess_threshold=0.5),
    )
    # compile warm-up (separate key), then time a fresh execution — same
    # discipline as config 5 / bench.py.
    state, trace = smc.density_tempered(sampler, jax.random.key(50), y)
    jax.block_until_ready(state.theta)
    t0 = time.perf_counter()
    state, trace = smc.density_tempered(sampler, jax.random.key(5), y)
    jax.block_until_ready(state.theta)
    dt = time.perf_counter() - t0
    emit(
        config="density_tempered_lg",
        backend=backend,
        m=m4,
        n=n4,
        wallclock_s=round(dt, 2),
        n_temper_stages=len(trace),
        posterior_mean=[round(float(v), 4) for v in np.asarray(smc.expected_parameters(state))],
        kalman_ref_available=True,
    )

    # ---- config 5: online SMC² UC-SV (headline — see bench.py) ------------
    rng = np.random.default_rng(1998)
    T5 = 241
    y5 = jnp.asarray(
        3.0 + np.cumsum(rng.normal(0, 0.3, T5)) + rng.normal(0, 0.5, T5),
        dtype=jnp.float32,
    )
    ucsv_prior = smc.product_distribution(
        [
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.Normal(jnp.asarray(3.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
        ]
    )
    m5 = max(int(512 * s), 16)
    n5 = max(int(1024 * s), 64)
    sampler5 = smc.SMC2(
        smc.ucsv_model, ucsv_prior,
        smc.SMCConfig(n_particles=n5, n_theta=m5, chain=5, ess_threshold=0.5),
    )
    f5 = lambda k: sampler5.run(k, y5)[0]
    dt, state5 = timeit(lambda: f5(jax.random.key(6)), repeats=2)
    emit(
        config="smc2_ucsv_online",
        backend=backend,
        m=m5,
        n=n5,
        T=T5,
        wallclock_s=round(dt, 3),
        final_ess=round(float(state5.ess), 1),
        cpu_baseline_s=435.1,
        speedup_vs_cpu_baseline=round(435.1 / dt, 1) if s == 1.0 else None,
    )


if __name__ == "__main__":
    main()
