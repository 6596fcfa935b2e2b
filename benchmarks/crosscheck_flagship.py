"""Flagship statistical cross-check (VERDICT r3 #8, calibrated r5):
density-tempered SMC vs online SMC² on the SAME UC-SV data at the same
(M, N).

There is no exact oracle for UC-SV (nonlinear/heteroskedastic), so the
flagship posterior is pinned the way the reference pins its own golden
runs (/root/reference/src/smc_samplers.jl:197-220): two INDEPENDENT
samplers — the batch density-tempered algorithm (Duan–Fulop) and the
online SMC² (Chopin) — must land on the same θ-posterior within
Monte-Carlo error. Agreement is asserted per-dimension on the posterior
mean, scaled by the pooled posterior std: |Δmean| ≤ tol·sd.

The tolerance is CALIBRATED, not a-priori (VERDICT r4 #4): ``--calibrate
K`` runs K seed-pairs at the current size, measures the empirical
seed-to-seed spread σ_Δ of the between-sampler delta per dimension, and
writes it to ``benchmarks/crosscheck_calibration.json``. The main check
then asserts |Δ| ≤ 3·σ_Δ·√(M_cal/M) per dimension — the √M factor
rescales the quick-size (M=64) calibration to the run's θ-count (both
samplers' θ̂ MC error scales ~1/√ESS_θ and ESS_θ tracks M at matched
config; the inner-N difference is not rescaled, which is conservative:
larger N at flagship only shrinks the inner-filter noise). ``--tol`` still
forces a flat tolerance; without it and without a calibration file the
legacy 0.5·sd default applies.

Runs on the vendored PCE series (the flagship example's data). Opt-in
slow check:

  python benchmarks/crosscheck_flagship.py [--m 512] [--n 8192] [--quick]
  python benchmarks/crosscheck_flagship.py --quick --calibrate 8
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import sequential_monte_carlo_tpu as smc

HERE = os.path.dirname(os.path.abspath(__file__))
PCE = os.path.join(HERE, os.pardir, "examples", "data", "pce_inflation.csv")
CALIBRATION = os.path.join(HERE, "crosscheck_calibration.json")


def ucsv_prior():
    return smc.product_distribution(
        [
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.Normal(jnp.asarray(3.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
        ]
    )


def weighted_moments(theta, log_omega):
    w = np.asarray(jax.nn.softmax(log_omega))
    th = np.asarray(theta)
    mean = w @ th
    var = w @ (th - mean) ** 2
    return mean, np.sqrt(var)


def run_pair(y, cfg, prior, key_online, key_batch):
    """One (SMC², density-tempered) pair; returns moments + wall times."""
    t0 = time.time()
    smc2 = smc.SMC2(smc.ucsv_model, prior, cfg)
    s_online, _ = smc2.run_segmented(key_online, y, segment_size=16)
    jax.block_until_ready(s_online.log_omega)
    t_online = time.time() - t0
    m_on, sd_on = weighted_moments(s_online.theta, s_online.log_omega)

    t0 = time.time()
    s_batch, stages = smc.density_tempered(
        smc.SMC2(smc.ucsv_model, prior, cfg), key_batch, y
    )
    jax.block_until_ready(s_batch.log_omega)
    t_batch = time.time() - t0
    m_bt, sd_bt = weighted_moments(s_batch.theta, s_batch.log_omega)
    return m_on, sd_on, t_online, m_bt, sd_bt, t_batch


def tolerance_sd(args, t_run):
    """Per-dimension tolerance in pooled-sd units: calibrated 3·σ_Δ scaled
    by √(M_cal/M) when a calibration file exists, else the flat legacy
    default (or --tol override). The M rescale is empirically validated
    and larger inner N only shrinks σ_Δ (BASELINE.md). T and chain are
    NOT rescaled — the production calibration is therefore run at the
    FLAGSHIP's T and chain (T=241, chain=5; N=1024 conservative), after a
    measured negative: a too-weak config (N=256, chain=2) at T=241 has
    σ_Δ up to ~10·sd because the samplers themselves degenerate over the
    long series — a calibration only transfers between configs of
    comparable sampler adequacy (BASELINE.md round 5). Any remaining
    size mismatch is annotated in the printed tol_source."""
    if args.tol is not None:
        return np.full(4, args.tol), "flat (--tol)"
    if os.path.exists(CALIBRATION):
        with open(CALIBRATION) as f:
            cal = json.load(f)
        scale = float(np.sqrt(cal["m"] / args.m))
        tol = 3.0 * np.asarray(cal["sigma_delta_sd"]) * scale
        src = (
            f"3·σ_Δ(seed, {cal['seeds']} pairs at M={cal['m']}) · "
            f"√({cal['m']}/{args.m})"
        )
        mism = []
        if cal.get("n") != args.n:
            mism.append(f"N {cal.get('n')}→{args.n}")
        if cal.get("t") is not None and cal["t"] != t_run:
            mism.append(f"T {cal['t']}→{t_run}")
        if mism:
            src += f" [not rescaled for: {', '.join(mism)}]"
        return tol, src
    return np.full(4, 0.5), "legacy default (no calibration file)"


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--chain", type=int, default=5)
    p.add_argument("--tol", type=float, default=None,
                   help="flat override: |Δ posterior mean| ≤ tol · sd")
    p.add_argument("--quick", action="store_true",
                   help="small sizes for a CPU smoke run")
    p.add_argument("--calibrate", type=int, default=0, metavar="K",
                   help="run K seed-pairs, write the empirical σ_Δ "
                        "calibration file, and exit (VERDICT r4 #4)")
    p.add_argument("--cal-out", default=CALIBRATION,
                   help="calibration output path (point elsewhere for "
                        "scaling-validation runs at other sizes, so the "
                        "production calibration file is not overwritten)")
    p.add_argument("--t-max", type=int, default=0,
                   help="truncate the series to this many steps "
                        "(0 = full; --quick implies 60)")
    args = p.parse_args()
    if args.quick:
        args.m, args.n, args.chain = 64, 256, 2
        if args.t_max == 0:
            args.t_max = 60
        if args.tol is None and not os.path.exists(CALIBRATION):
            # pre-calibration guard: without the measured seed spread the
            # flat 0.5·sd fallback would flag pure noise at M=64 (the
            # calibrated σ_Δ here is up to ~0.94·sd)
            args.tol = 1.25

    import csv

    with open(PCE) as f:
        rows = list(csv.DictReader(f))
    y = jnp.asarray([float(r["value"]) for r in rows], dtype=jnp.float32)
    if args.t_max:
        y = y[: args.t_max]

    cfg = smc.SMCConfig(
        n_particles=args.n, n_theta=args.m, chain=args.chain,
        ess_threshold=0.5,
    )
    prior = ucsv_prior()

    if args.calibrate:
        deltas, sds = [], []
        t0 = time.time()
        for s in range(args.calibrate):
            m_on, sd_on, _, m_bt, sd_bt, _ = run_pair(
                y, cfg, prior,
                jax.random.key(1000 + s), jax.random.key(2000 + s),
            )
            sd_pool = np.sqrt(0.5 * (sd_on**2 + sd_bt**2))
            deltas.append((m_on - m_bt) / sd_pool)
            sds.append(sd_pool)
            print(f"calibrate seed {s}: delta_in_sd="
                  f"{[round(float(v), 3) for v in deltas[-1]]}",
                  file=sys.stderr, flush=True)
        sigma = np.std(np.asarray(deltas), axis=0, ddof=1)
        out = {
            "m": args.m, "n": args.n, "chain": args.chain,
            "t": int(y.shape[0]),
            "seeds": args.calibrate,
            "sigma_delta_sd": [round(float(v), 4) for v in sigma],
            "mean_delta_sd": [
                round(float(v), 4) for v in np.asarray(deltas).mean(0)
            ],
            "wallclock_s": round(time.time() - t0, 1),
        }
        with open(args.cal_out, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))
        return

    m_on, sd_on, t_online, m_bt, sd_bt, t_batch = run_pair(
        y, cfg, prior, jax.random.key(1998), jax.random.key(4242)
    )
    sd_pool = np.sqrt(0.5 * (sd_on**2 + sd_bt**2))
    delta = np.abs(m_on - m_bt) / sd_pool
    tol, tol_src = tolerance_sd(args, int(y.shape[0]))
    ok = bool((delta <= tol).all())
    print(json.dumps({
        "metric": f"ucsv_flagship_crosscheck_{args.m}x{args.n}",
        "theta_smc2": [round(float(v), 4) for v in m_on],
        "theta_density_tempered": [round(float(v), 4) for v in m_bt],
        "posterior_sd": [round(float(v), 4) for v in sd_pool],
        "delta_in_sd": [round(float(v), 3) for v in delta],
        "tol_sd": [round(float(v), 3) for v in tol],
        "tol_source": tol_src,
        "agree": ok,
        "t_smc2_s": round(t_online, 1),
        "t_density_tempered_s": round(t_batch, 1),
    }))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
