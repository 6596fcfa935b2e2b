"""End-to-end inflation example — UC and UC-SV models on PCE inflation.

≡ /root/reference/examples/inflation_example.jl, the reference's acceptance
pipeline (SURVEY.md §3.5): quarterly PCE inflation 1960–2020 (T=241), online
SMC² on (1) a local-level UC model (N=1024, M=512, chain=3, ess=0.5) and
(2) the Stock–Watson UC-SV model (N=8192, M=512, chain=5), collecting per-t
ω-weighted trend/cycle quantiles and variances; then a plain bootstrap PF at
the posterior-mean θ; finally trend/cycle band plots and the log
variance-ratio var(P(x,θ|y)) / var(P(x|y,θ)).

Data: the reference pulls FRED ``PCECTPI`` (pc1 units) at run time
(inflation_example.jl:12-23). This image is zero-egress, so
``data/pce_inflation.csv`` is a *synthetic stand-in* with the same span,
frequency and qualitative shape (Great-Inflation hump + disinflation),
generated deterministically — swap in the real CSV for production runs.

Run (sizes reduced by default so the example finishes quickly on CPU):

  python examples/inflation_example.py            # quick sizes
  python examples/inflation_example.py --full     # reference sizes
"""
from __future__ import annotations

import argparse
import csv
import os
import time

import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import sequential_monte_carlo_tpu as smc  # noqa: E402
from sequential_monte_carlo_tpu.analysis import (
    posterior_histograms,
    state_quantiles,
    state_variance,
    weighted_quantile,
)
from sequential_monte_carlo_tpu.analysis.plotting import (
    plot_filtered_band,
    plot_histograms,
    plot_variance_ratio,
)

HERE = os.path.dirname(os.path.abspath(__file__))
PS = jnp.array([0.25, 0.5, 0.75])
# stamped on every figure: the vendored series is NOT the FRED PCECTPI data
# the reference's visuals use (zero-egress build; see module docstring)
ANNOT = "synthetic stand-in series — not FRED PCECTPI"



def load_pce():
    from sequential_monte_carlo_tpu.utils.dataio import read_csv_column

    path = os.path.join(HERE, "data", "pce_inflation.csv")
    values = read_csv_column(path, 1)
    with open(path) as f:
        dates = np.array(
            [row["date"] for row in csv.DictReader(f)], dtype="datetime64[D]"
        )
    return dates, jnp.asarray(values, dtype=jnp.float32)


def uc_prior():
    # ≡ inflation_example.jl:33-37: [Normal(3,2), Uniform(0,4), Uniform(0,4)]
    return smc.product_distribution(
        [
            smc.Normal(jnp.asarray(3.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(4.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(4.0)),
        ]
    )


def ucsv_prior():
    # ≡ inflation_example.jl:235-240
    return smc.product_distribution(
        [
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.Normal(jnp.asarray(3.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
        ]
    )


def run_online(name, model_fn, prior, y, n, m, chain, outdir, dates=None):
    """Online SMC² collecting per-t trend/cycle quantiles + variances
    ≡ the example's main loops (inflation_example.jl:64-74, 262-267)."""
    cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=chain, ess_threshold=0.5)
    sampler = smc.SMC2(model_fn, prior, cfg)

    def collect(state):
        t = state.t - 1
        yt = jax.lax.dynamic_index_in_dim(y, t, keepdims=False)
        xq = state_quantiles(state, PS)
        # cycle quantiles without a second sort: q_p(y−x) = y − q_{1−p}(x)
        return {
            "xq": xq,
            "cq": yt - xq[::-1],
            "var": state_variance(state),
        }

    t0 = time.time()
    # segmented dispatch (bitwise ≡ run()): the real series is rejuvenation-
    # heavy (79 triggers at reference size vs ~12 on tame synthetic data),
    # and one whole-sequence execution at N=8192 exceeds the remote-device
    # execute deadline — 16-step segments keep every dispatch bounded while
    # the carry stays on device.
    state, (infos, series) = sampler.run_segmented(
        jax.random.key(1998), y, segment_size=16, collect_fn=collect
    )
    jax.block_until_ready(state)
    dt = time.time() - t0
    theta_hat = np.asarray(smc.expected_parameters(state))
    n_rejuv = int(np.asarray(infos.rejuvenated).sum())
    print(f"[{name}] SMC² {m}x{n} T={len(y)} in {dt:.1f}s; "
          f"rejuvenations={n_rejuv}; "
          f"final ess={float(state.ess):.1f}; θ̂={theta_hat.round(4)}")

    d1 = None if dates is None else dates[1:]
    xq = np.asarray(series["xq"])  # (T-1, 3)
    plot_filtered_band(
        np.asarray(y)[1:], xq[:, 0], xq[:, 1], xq[:, 2],
        label=f"filtered trend ({name})",
        title="quarterly PCE inflation rate",
        path=os.path.join(outdir, f"pce_inflation_trend_{name}.png"),
        dates=d1, annotation=ANNOT,
    )
    cq = np.asarray(series["cq"])
    plot_filtered_band(
        np.asarray(y)[1:] - xq[:, 1], cq[:, 0], cq[:, 1], cq[:, 2],
        label=f"filtered cycle ({name})",
        title="quarterly PCE inflation rate",
        path=os.path.join(outdir, f"pce_inflation_cycle_{name}.png"),
        dates=d1, annotation=ANNOT,
    )
    hists = posterior_histograms(jax.random.key(7), state)
    plot_histograms(
        hists, var_names=[f"θ{i}" for i in range(len(hists))],
        path=os.path.join(outdir, f"theta_posterior_{name}.png"),
        annotation=ANNOT,
    )
    return state, theta_hat, np.asarray(series["var"])


def run_pf_at_theta_hat(name, model, y, n, outdir, dates=None):
    """Plain bootstrap PF at θ̂ with per-t quantiles ≡ get_latent_states_*
    (inflation_example.jl:153-178, 326-355)."""
    def summarize(state):
        w = jnp.exp(state.log_weights)
        x = state.particles[:, 0]
        return {
            "xq": weighted_quantile(x, w, PS),
            "var": jnp.sum(w * (x - jnp.sum(w * x)) ** 2),
        }

    _, logz, series = smc.filter_sequence(
        jax.random.key(0), model, n, y, summarize=summarize
    )
    xq = np.asarray(series["summary"]["xq"])
    plot_filtered_band(
        np.asarray(y), xq[:, 0], xq[:, 1], xq[:, 2],
        label=f"filtered trend ({name})",
        title="quarterly PCE inflation rate (given θ)",
        path=os.path.join(outdir, f"pce_inflation_trend_{name}_post.png"),
        dates=dates, annotation=ANNOT,
    )
    print(f"[{name}] PF at θ̂: logZ={float(logz):.2f}")

    # smoothed trend at θ̂ — beyond the reference (which only filters):
    # FFBS marginal smoother at the FULL filter N (round 4: the blocked
    # streaming-log-sum-exp backward pass lifts the former min(n, 2048)
    # cap — O(block·N) memory, same math)
    sm = smc.smoothed_marginals(jax.random.key(1), model, n, y)
    trend = np.asarray(smc.smoothed_mean(sm))[:, 0]
    w_s = np.asarray(jnp.exp(sm.log_weights))
    xs0 = np.asarray(sm.particles)[..., 0]
    var_s = (w_s * (xs0 - trend[:, None]) ** 2).sum(-1)
    sd = np.sqrt(var_s)
    plot_filtered_band(
        np.asarray(y), trend - sd, trend, trend + sd,
        label=f"smoothed trend ({name}, FFBS)",
        title="quarterly PCE inflation rate (given θ, smoothed)",
        path=os.path.join(outdir, f"pce_inflation_trend_{name}_smoothed.png"),
        dates=dates, annotation=ANNOT,
    )
    return np.asarray(series["summary"]["var"])


def run_posterior_smoothing(name, model_fn, state, y, n, outdir, dates=None,
                            n_theta=8, n_paths=64):
    """θ-posterior-mixture smoothed trend (round 4, beyond-reference):
    pooled backward-sampling FFBS draws across θ's drawn from the SMC²
    posterior ω — p(x_t | y_{1:T}) with θ-uncertainty integrated out,
    rather than plugged in at θ̂."""
    paths = smc.posterior_smoothed_paths(
        jax.random.key(11), model_fn, state.theta, state.log_omega, y,
        n=n, n_theta=n_theta, n_paths=n_paths,
    )
    trend = np.asarray(paths)[:, :, 0]  # (T, K·m)
    lo, med, hi = np.percentile(trend, [10, 50, 90], axis=1)
    plot_filtered_band(
        np.asarray(y), lo, med, hi,
        label=f"posterior-mixture smoothed trend ({name}, FFBS)",
        title="quarterly PCE inflation rate (θ integrated out, smoothed)",
        path=os.path.join(outdir, f"pce_inflation_trend_{name}_postmix.png"),
        dates=dates, annotation=ANNOT,
    )
    print(f"[{name}] posterior-mixture smoothing: {trend.shape[1]} paths "
          f"({n_theta} θ-draws × {n_paths})")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true",
                   help="reference sizes (UC 512x1024 chain 3; UCSV 512x8192 chain 5)")
    p.add_argument("--outdir", default=os.path.join(HERE, "out"))
    p.add_argument("--model", choices=["uc", "ucsv", "both"], default="both")
    args = p.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    dates, y = load_pce()
    if args.full:
        uc_sizes, ucsv_sizes = (1024, 512, 3), (8192, 512, 5)
    else:
        uc_sizes, ucsv_sizes = (256, 128, 3), (512, 128, 3)

    ratios, labels = [], []
    eps = 1e-12

    if args.model in ("uc", "both"):
        # -- UC model (inflation_example.jl:28-74) --
        uc_state, uc_theta, uc_vars = run_online(
            "uc", smc.uc_model, uc_prior(), y, *uc_sizes, outdir=args.outdir,
            dates=dates,
        )
        uc_pred_vars = run_pf_at_theta_hat(
            "uc", smc.uc_model(jnp.asarray(uc_theta)), y, uc_sizes[0],
            args.outdir, dates=dates,
        )
        ratios.append(np.log(uc_vars + eps) - np.log(uc_pred_vars[1:] + eps))
        labels.append("log variance ratio (UC)")
        run_posterior_smoothing(
            "uc", smc.uc_model, uc_state, y, uc_sizes[0], args.outdir,
            dates=dates,
        )

    if args.model in ("ucsv", "both"):
        # -- UC-SV model (inflation_example.jl:229-267) --
        ucsv_state, ucsv_theta, ucsv_vars = run_online(
            "ucsv", smc.ucsv_model, ucsv_prior(), y, *ucsv_sizes,
            outdir=args.outdir, dates=dates,
        )
        ucsv_pred_vars = run_pf_at_theta_hat(
            "ucsv", smc.ucsv_model(jnp.asarray(ucsv_theta)), y, ucsv_sizes[0],
            args.outdir, dates=dates,
        )
        ratios.append(np.log(ucsv_vars + eps) - np.log(ucsv_pred_vars[1:] + eps))
        labels.append("log variance ratio (UCSV)")
        run_posterior_smoothing(
            "ucsv", smc.ucsv_model, ucsv_state, y, ucsv_sizes[0],
            args.outdir, dates=dates,
        )

    # -- log variance ratio (inflation_example.jl:404-423) --
    plot_variance_ratio(
        ratios, labels=labels,
        path=os.path.join(args.outdir, "log_variance_ratio_inflation.png"),
        dates=dates[1:], annotation=ANNOT,
    )
    print(f"wrote figures to {args.outdir}")


if __name__ == "__main__":
    main()
