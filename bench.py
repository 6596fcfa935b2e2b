"""Headline benchmark: online SMC² on the UC-SV model at BOTH reference
sizes — 512 θ × 1024 state particles (headline) and the reference's
flagship 512 θ × 8192 (examples/inflation_example.jl:255-267;
BASELINE.md north-star config 5), T=241.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "runs": [...], "spread": N,
   "flagship": {"metric": ..., "value": N, "vs_baseline": N, ...}}

The primary fields are the 512×1024 headline; the "flagship" object
carries the 512×8192 run (VERDICT r3 #6). ``value`` is best-of-k;
``runs``/``spread`` carry every timed run, because the seed's trajectory
(its rejuvenation count) moves the wall-clock (VERDICT r4 #8): headline
k=3, flagship k=2.

``vs_baseline`` is the speedup over the reference-faithful CPU baseline
measured with benchmarks/baseline_numpy.py (per-θ NumPy loop ≡ the Julia
reference's structure, full T=241 runs, no extrapolation) on a CPU host:
435.1 s at N=1024, 2109.2 s at the reference's flagship N=8192. See
BASELINE.md.

Usage: python bench.py [--m 512] [--n 1024] [--t 241] [--no-flagship]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


# benchmarks/baseline_numpy.py full-run wall-clocks, keyed by (M, N)
BASELINE_CPU_WALLCLOCK_S = {
    (512, 1024): 435.1,
    (512, 8192): 2109.2,
}


def _measure(smc, jax, jnp, y, m, n, t, chain, repeats, inner_ess=1.0):
    """Compile-warm + best-of-``repeats`` timed runs.

    Returns (runs, ok) with ``runs`` the list of per-run wall-clocks, so
    the JSON reports best-of-k PLUS the spread (VERDICT r4 #8)."""
    prior = smc.product_distribution(
        [
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.Normal(jnp.asarray(3.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
        ]
    )
    cfg = smc.SMCConfig(
        n_particles=n, n_theta=m, chain=chain, ess_threshold=0.5,
        inner=smc.PFConfig("systematic", inner_ess),
    )
    sampler = smc.SMC2(smc.ucsv_model, prior, cfg)

    # compile warm-up (separate key so the timed run is a fresh execution)
    state, infos = sampler.run(jax.random.key(99), y)
    jax.block_until_ready(state)

    runs = []
    for r in range(repeats):
        t0 = time.perf_counter()
        state, infos = sampler.run(jax.random.key(r), y)
        jax.block_until_ready(state)
        runs.append(round(time.perf_counter() - t0, 4))
    return runs, bool(jnp.isfinite(state.ess))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--t", type=int, default=241)
    p.add_argument("--chain", type=int, default=5)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--flagship-repeats", type=int, default=2)
    p.add_argument("--no-flagship", action="store_true",
                   help="skip the 512x8192 flagship config")
    p.add_argument("--inner-ess", type=float, default=1.0,
                   help="inner-PF ESS resampling threshold (1.0 = "
                        "reference-parity always-resample, the recorded "
                        "baseline; <1 measures the adaptive lax.cond "
                        "skip mode, VERDICT r4 #2 — NOT the driver "
                        "headline, statistics differ)")
    p.add_argument("--flagship-n", type=int, default=8192)
    args = p.parse_args()

    # Persistent compilation cache: JAX_COMPILATION_CACHE_DIR if set,
    # otherwise a fixed directory in the repo (the path is part of the key).
    os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
    )
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

    import jax
    import jax.numpy as jnp
    import numpy as np

    import sequential_monte_carlo_tpu as smc

    print(f"bench: device {jax.devices()[0].device_kind}", file=sys.stderr,
          flush=True)

    # same synthetic inflation-like series as the CPU baseline
    rng = np.random.default_rng(1998)
    y = jnp.asarray(
        3.0 + np.cumsum(rng.normal(0, 0.3, args.t)) + rng.normal(0, 0.5, args.t),
        dtype=jnp.float32,
    )

    runs, ok = _measure(
        smc, jax, jnp, y, args.m, args.n, args.t, args.chain, args.repeats,
        args.inner_ess,
    )
    if not ok:
        print(json.dumps({"metric": "smc2_ucsv_wallclock", "value": -1,
                          "unit": "s", "vs_baseline": 0.0,
                          "error": "non-finite ESS"}))
        sys.exit(1)

    best = min(runs)
    baseline = BASELINE_CPU_WALLCLOCK_S.get((args.m, args.n))
    suffix = "" if args.inner_ess >= 1.0 else f"_adaptive{args.inner_ess}"
    result = {
        "metric": f"smc2_ucsv_{args.m}x{args.n}_T{args.t}_wallclock{suffix}",
        "value": round(best, 4),
        "unit": "s",
        "vs_baseline": round(baseline / best, 2) if baseline else 0.0,
        # every timed run + spread (VERDICT r4 #8)
        "runs": runs,
        "spread": round(max(runs) - best, 4),
    }

    if not args.no_flagship and args.flagship_n != args.n:
        fruns, fok = _measure(
            smc, jax, jnp, y, args.m, args.flagship_n, args.t, args.chain,
            args.flagship_repeats, args.inner_ess,
        )
        fbest = min(fruns)
        fbaseline = BASELINE_CPU_WALLCLOCK_S.get((args.m, args.flagship_n))
        result["flagship"] = {
            "metric": (
                f"smc2_ucsv_{args.m}x{args.flagship_n}_T{args.t}"
                f"_wallclock{suffix}"
            ),
            "value": round(fbest, 4) if fok else -1,
            "unit": "s",
            "vs_baseline": (
                round(fbaseline / fbest, 2) if (fok and fbaseline) else 0.0
            ),
            "runs": fruns,
            "spread": round(max(fruns) - fbest, 4),
        }

    print(json.dumps(result))


if __name__ == "__main__":
    main()
