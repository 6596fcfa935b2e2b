"""Reference-faithful CPU baseline for the headline SMC² workload.

The Julia reference publishes no timings and Julia is not installed in this
image (SURVEY.md §6), so the CPU baseline is reconstructed here: a NumPy
implementation with the *same computational structure* as the reference —
a Python loop over the M θ-particles calling a per-θ bootstrap filter step
(vectorized over N, as Julia's compiled loops effectively are), multinomial
resampling every step, PMMH rejuvenation re-running full-history filters
per θ (smc_samplers.jl:103-148,308-340). Run it on the CPU of the bench
machine to produce the wall-clock the accelerator build is compared against:

    python benchmarks/baseline_numpy.py [--t 241] [--m 512] [--n 1024]

Prints a JSON line with the measured wall-clock and derived particle-steps/s.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


# ---- UC-SV model (≡ state_space_models.jl:215-263), vectorized over N ----

def ucsv_init(rng, theta, n):
    gamma, x0, ls_e0, ls_n0 = theta
    x = np.empty((n, 3))
    x[:, 0] = rng.normal(x0, np.exp(0.5 * ls_e0), n)
    x[:, 1] = rng.normal(ls_e0, gamma, n)
    x[:, 2] = rng.normal(ls_n0, gamma, n)
    return x


def ucsv_propagate(rng, theta, x):
    gamma = theta[0]
    out = np.empty_like(x)
    out[:, 0] = x[:, 0] + np.exp(0.5 * x[:, 1]) * rng.standard_normal(len(x))
    out[:, 1] = x[:, 1] + gamma * rng.standard_normal(len(x))
    out[:, 2] = x[:, 2] + gamma * rng.standard_normal(len(x))
    return out


def ucsv_obs_logpdf(x, y):
    s = np.exp(0.5 * x[:, 2])
    z = (y - x[:, 0]) / s
    return -0.5 * z * z - np.log(s) - 0.5 * np.log(2 * np.pi)


def normalize(logw):
    maxw = logw.max()
    w = np.exp(logw - maxw)
    sumw = w.sum()
    log_mu = maxw + np.log(sumw) - np.log(len(logw))
    return log_mu, w / sumw


def bootstrap_step(rng, theta, x, w, y):
    a = rng.choice(len(w), size=len(w), p=w)  # multinomial (particles.jl:17)
    xp = x[a]
    xn = ucsv_propagate(rng, theta, xp)
    log_mu, w = normalize(ucsv_obs_logpdf(xn, y))
    return xn, w, log_mu


def run_smc2(y, m, n, chain, seed=0, max_steps=None, ess_threshold=0.5):
    """Online SMC² with per-θ Python loop ≡ smc_samplers.jl:288-340."""
    rng = np.random.default_rng(seed)
    T = len(y) if max_steps is None else max_steps
    theta = np.stack(
        [
            rng.uniform(0, 1, m),
            rng.normal(3, 2, m),
            rng.uniform(0, 2, m),
            rng.uniform(0, 2, m),
        ],
        axis=1,
    )
    xs, ws, logw = [], [], np.zeros(m)
    for j in range(m):
        x = ucsv_init(rng, theta[j], n)
        mu, w = normalize(ucsv_obs_logpdf(x, y[0]))
        xs.append(x)
        ws.append(w)
        logw[j] = mu
    logz = logw.copy()
    particle_steps = m * n

    for t in range(1, T):
        _, omega = normalize(logw)
        ess = 1.0 / np.sum(omega**2)
        if ess < ess_threshold * m:
            # θ-resample + (priced) rejuvenation: chain full-history refilters
            a = rng.choice(m, size=m, p=omega)
            theta = theta[a]
            xs = [xs[j] for j in a]
            ws = [ws[j] for j in a]
            logz = logz[a]
            for _ in range(chain):
                for j in range(m):
                    x = ucsv_init(rng, theta[j], n)
                    _, w = normalize(ucsv_obs_logpdf(x, y[0]))
                    for s in range(1, t):
                        x, w, _ = bootstrap_step(rng, theta[j], x, w, y[s])
                    particle_steps += n * t
            logw = np.zeros(m)
        for j in range(m):
            xs[j], ws[j], mu = bootstrap_step(rng, theta[j], xs[j], ws[j], y[t])
            logw[j] += mu
            logz[j] += mu
        particle_steps += m * n
    return particle_steps


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--t", type=int, default=241)
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--chain", type=int, default=5)
    p.add_argument("--measure-steps", type=int, default=None,
                   help="time a prefix and extrapolate linearly in T")
    args = p.parse_args()

    rng = np.random.default_rng(1998)
    # synthetic inflation-like series (same scale as PCE pc1)
    y = 3.0 + np.cumsum(rng.normal(0, 0.3, args.t)) + rng.normal(0, 0.5, args.t)

    measure = args.measure_steps or args.t
    t0 = time.perf_counter()
    steps = run_smc2(y, args.m, args.n, args.chain, max_steps=measure)
    dt = time.perf_counter() - t0
    scale = args.t / measure
    result = {
        "workload": f"smc2_ucsv_{args.m}x{args.n}_T{args.t}",
        "wallclock_s": dt * scale,
        "measured_prefix_T": measure,
        "particle_steps_per_s": steps / dt,
        "backend": "numpy-cpu (reference-faithful per-theta loop)",
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
