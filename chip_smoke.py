"""Smoke run of the library's main path on an NVIDIA GPU.

Drives the public sampler API once at the widths of the UC-SV SMC²
benchmark configuration (bench.py: M=512 θ-particles × N=8192 state
particles, T=241, chain=5, θ-ESS threshold 0.5, systematic inner
resampling, the seeded synthetic inflation-like series) and checks each
stage against a plain reference:

  a. compile ``SMC2.run`` at 512×8192; report compile time and memory;
  b. ``SMC2.run`` end to end at 512×1024 and 512×8192: finite ESS and
     logZ, a posterior mean inside the prior's support, the wall-clock
     after warm-up, the rejuvenation count, and ``run_segmented`` ≡ ``run``;
  c. plain references: f32 Kalman logZ vs an f64 NumPy recursion, batched
     PF logZ vs per-θ Kalman, resample+gather vs NumPy searchsorted+take,
     IBIS vs SMC² posterior means;
  d. density-tempered SMC, particle Gibbs and the marginal smoother, briefly;
  e. with ``--four-cards`` only (and nothing else): ``ShardedSMC2`` on a
     4×1 (θ) and a 2×2 (θ, particle) mesh, and the elastic N-doubling step,
     each against the same run on one card.

Timings are informational. The script exits non-zero, and prints no
result line, when JAX finds no GPU or when any phase fails. Its last line
is ``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
The compile cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is
set, else in ``<repo>/.jax_cache``.

Usage: python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

import sequential_monte_carlo_tpu as smc
from sequential_monte_carlo_tpu.ops.batched_filter import gather_ancestors
from sequential_monte_carlo_tpu.ops.resampling import search_ancestors
from sequential_monte_carlo_tpu.parallel import ShardedSMC2, make_mesh

REPO = os.path.dirname(os.path.abspath(__file__))
# |Δ posterior mean| allowed between two valid SMC runs whose random
# trajectories differ (tests/test_samplers.py, IBIS vs SMC²)
MC_MEAN_TOL = 0.35
# Limits of the four-card phase: a sharded run against the same run on one
# card (the readings behind each are in PERF.md and DEVIATIONS.md §9).
SHARD_RTOL = 1e-5  # a θ row "agrees": every |Δθ| ≤ SHARD_RTOL·(1 + |θ|)
SLOTS_DIFFER_STEP1 = 0.01  # cloud slots an ancestor flip may move by step 1
LOGZ_ATOL_STEP1 = 5e-3  # |Δ per-θ logZ| at init and after step 1
THETA_ROWS_AGREE = 0.99  # θ rows that agree after the first rejuvenation
THETA_MESH_MEAN_TOL = 1e-5  # |Δ posterior mean|, whole run, θ-only mesh
MC_SD_TOL = 1.0  # |Δ posterior mean| in posterior sds, runs that diverged


class SmokeError(RuntimeError):
    """A check of a phase failed."""


def _require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def compile_cache_dir(environ=os.environ) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<repo>/.jax_cache``."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO, ".jax_cache"
    )


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not available ({e.__class__.__name__})"
    return out.stdout.strip() or out.stderr.strip()


# -- configurations -----------------------------------------------------------

def ucsv_prior():
    # ≡ examples/inflation_example.jl:235-240
    return smc.product_distribution(
        [
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.Normal(jnp.asarray(3.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
        ]
    )


def lg_prior():
    # ≡ README.md:81-85 of the reference
    return smc.product_distribution(
        [
            smc.TruncatedNormal(jnp.asarray(0.0), jnp.asarray(1.0),
                                jnp.asarray(-1.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
        ]
    )


def synthetic_series(t: int, seed: int = 1998):
    """bench.py's seeded inflation-like series."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        3.0 + np.cumsum(rng.normal(0, 0.3, t)) + rng.normal(0, 0.5, t),
        dtype=jnp.float32,
    )


def lg_series(t: int, seed: int = 1998):
    model = smc.lg_model(jnp.asarray([0.5, 0.9, 0.8]))
    return smc.simulate(jax.random.key(seed), model, t)[1]


def ucsv_sampler(m: int, n: int, chain: int = 5, **cfg):
    config = smc.SMCConfig(
        n_particles=n, n_theta=m, chain=chain,
        ess_threshold=cfg.pop("ess_threshold", 0.5),
        inner=smc.PFConfig("systematic", 1.0), **cfg,
    )
    return smc.SMC2(smc.ucsv_model, ucsv_prior(), config)


def _max_abs_diff(a, b) -> float:
    """Largest |a − b| over matching pytrees (0.0 where both are equal,
    including matching infinities)."""
    worst = 0.0
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        same = (x == y) | (np.isnan(x) & np.isnan(y))
        if not same.all():
            worst = max(worst, float(np.max(np.abs(x - y)[~same])))
    return worst


def _bitwise(a, b) -> bool:
    return all(
        np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


def _state_summary(state):
    return (state.theta, state.log_omega, state.log_z, state.particles,
            state.log_w, state.ess)


# -- phases -------------------------------------------------------------------

def phase_compile(sampler, y):
    """a. Lower and compile the whole-sequence ``SMC2.run`` program."""
    t0 = time.perf_counter()
    compiled = sampler._run_jit.lower(jax.random.key(0), y).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {
        "compile_s": compile_s,
        "memory_analysis": {f: getattr(mem, f, None) for f in fields},
    }


def phase_end_to_end(sampler, y, segment_size: int = 16):
    """b. ``SMC2.run`` after a warm-up, checked, and ``run_segmented``
    against it with the same key."""
    t0 = time.perf_counter()
    jax.block_until_ready(sampler.run(jax.random.key(99), y))
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, infos = sampler.run(jax.random.key(0), y)
    jax.block_until_ready(state)
    run_s = time.perf_counter() - t0

    mean = smc.expected_parameters(state)
    _require(bool(jnp.isfinite(state.ess)), "non-finite θ-ESS")
    _require(bool(jnp.all(jnp.isfinite(state.log_z))), "non-finite logZ")
    _require(bool(jnp.all(jnp.isfinite(infos.ess))), "non-finite ESS trace")
    _require(bool(sampler.prior.in_support(mean)),
             f"posterior mean {mean} outside the prior's support")

    t0 = time.perf_counter()
    s_seg, i_seg = sampler.run_segmented(jax.random.key(0), y,
                                         segment_size=segment_size)
    jax.block_until_ready(s_seg)
    segmented_s = time.perf_counter() - t0
    full, seg = (_state_summary(state), infos), (_state_summary(s_seg), i_seg)
    bitwise = _bitwise(full, seg)
    mean_diff = float(jnp.max(jnp.abs(smc.expected_parameters(s_seg) - mean)))
    _require(bitwise, "run_segmented differs from run: max |Δ| "
             f"{_max_abs_diff(full, seg)}, posterior mean |Δ| {mean_diff}")
    return {
        "m": sampler.config.n_theta, "n": sampler.config.n_particles,
        "t": int(y.shape[0]), "warmup_s": warmup_s, "run_s": run_s,
        "segmented_s": segmented_s,
        "rejuvenations": int(np.sum(np.asarray(infos.rejuvenated))),
        "final_ess": float(state.ess),
        "posterior_mean": np.asarray(mean).tolist(),
        "segmented_bitwise": bitwise,
    }


def kalman_f64(A, B, Q, R, x0, s0, y64, predict_first: bool = True):
    """Univariate Kalman logZ in float64 NumPy (the plain reference).

    ``predict_first``: (x0, s0) is the state one step before y[0], as in
    ``ops/kalman.py``; False makes it the state AT y[0], as the particle
    filters draw it (``initial_distribution``)."""
    xt, st_ = x0, s0
    logz = 0.0
    for i, yt in enumerate(y64):
        if predict_first or i > 0:
            xt = A * xt
            st_ = A * A * st_ + Q
        s = B * B * st_ + R
        dy = yt - B * xt
        xt = xt + (st_ * B) / s * dy
        st_ = st_ - (st_ * B) ** 2 / s
        logz += -0.5 * (np.log(2 * np.pi) + np.log(s) + dy * dy / s)
    return logz


def phase_kalman_vs_f64(t: int = 500, rel_tol: float = 1e-4):
    """c1. f32 Kalman logZ on the device vs the f64 NumPy recursion."""
    model = smc.lg_model(jnp.asarray([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(0), model, t)
    z32 = float(jax.jit(lambda m, yy: smc.kalman_log_likelihood(m, yy)[1])(
        model, y))
    z64 = kalman_f64(0.5, 1.0, 0.9, 0.8, 0.0, 1.0, np.asarray(y, np.float64))
    rel = abs(z32 - z64) / abs(z64)
    _require(rel < rel_tol, f"Kalman f32 vs f64: relative {rel} ≥ {rel_tol}")
    return {"t": t, "logz_f32": z32, "logz_f64": z64, "relative": rel}


def phase_batched_pf_vs_kalman(n_theta: int = 64, n: int = 8192,
                               t: int = 100, reps: int = 8):
    """c2. Batched PF logZ vs per-θ f64 Kalman within 3 Monte Carlo
    standard errors: the pooled mean of logẐ − logZ, corrected by +σ²/2
    (log Ẑ is asymptotically normal with bias −σ²/2 when Ẑ is unbiased).
    The Kalman recursion starts at y[0] from N(x0, Σ0), as the particle
    filter does."""
    y = lg_series(t)
    scale = 1.0 + 0.01 * jnp.arange(n_theta, dtype=jnp.float32)
    thetas = jnp.asarray([0.5, 0.9, 0.8]) * scale[:, None]
    models = jax.vmap(smc.lg_model)(thetas)
    f = jax.jit(
        lambda k: smc.batched_log_likelihood(k, models, n, n_theta, y)[2]
    )
    z = np.stack([np.asarray(f(k), np.float64)
                  for k in jax.random.split(jax.random.key(5), reps)])
    y64 = np.asarray(y, np.float64)
    kz = np.array([kalman_f64(a, 1.0, q, r, 0.0, 1.0, y64, predict_first=False)
                   for a, q, r in np.asarray(thetas, np.float64)])
    d = z - kz[None, :]
    var = d.var(axis=0, ddof=1)
    se = math.sqrt(var.mean() / d.size)
    score = (d.mean() + var.mean() / 2) / se
    _require(np.isfinite(z).all(), "non-finite batched logZ")
    _require(abs(score) < 3.0, f"batched PF vs Kalman: {score:.2f} SE")
    return {"n_theta": n_theta, "n": n, "t": t, "reps": reps,
            "mean_diff": float(d.mean()), "logz_var": float(var.mean()),
            "score_se": float(score)}


def phase_resample_gather(m: int = 512, n: int = 8192, dx: int = 3,
                          seed: int = 7):
    """c3. The XLA inverse-CDF search + row gather vs NumPy searchsorted +
    take, bitwise, on a CDF and uniforms fixed on the host."""
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.standard_normal((m, n))
    w = np.exp(logits - logits.max(-1, keepdims=True))
    cdf = np.cumsum(w, axis=-1)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    u = ((np.arange(n, dtype=np.float32)[None, :]
          + rng.uniform(size=(m, 1)).astype(np.float32)) / np.float32(n))
    xs = rng.standard_normal((m, n, dx)).astype(np.float32)

    @jax.jit
    def stage(c, uu, x):
        anc = jax.vmap(search_ancestors)(c, uu)
        return anc, gather_ancestors(x, anc)

    args = tuple(jax.device_put(a) for a in (cdf, u, xs))
    anc, got = jax.block_until_ready(stage(*args))
    t0 = time.perf_counter()
    for _ in range(10):
        jax.block_until_ready(stage(*args))
    call_ms = (time.perf_counter() - t0) / 10 * 1e3
    ref_anc = np.stack([
        np.minimum(np.searchsorted(cdf[i], u[i], side="left"), n - 1)
        for i in range(m)
    ])
    ref = np.take_along_axis(xs, ref_anc[..., None], axis=1)
    _require(np.array_equal(np.asarray(anc), ref_anc),
             "ancestors differ from NumPy searchsorted")
    _require(np.array_equal(np.asarray(got), ref),
             "gathered values differ from NumPy take")
    return {"m": m, "n": n, "dx": dx, "host_clock_ms_per_call": call_ms}


def phase_ibis_vs_smc2(m: int = 512, n: int = 1024, t: int = 100,
                       chain: int = 3):
    """c4. IBIS (exact Kalman likelihoods) vs SMC² posterior means on LG."""
    prior, y = lg_prior(), lg_series(t)
    cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=chain,
                        ess_threshold=0.5)
    s_pf, _ = smc.SMC2(smc.lg_model, prior, cfg).run(jax.random.key(8), y)
    with jax.default_matmul_precision("highest"):  # the reference side
        s_kf, _ = smc.IBIS(smc.lg_model, prior,
                           smc.SMCConfig(n_theta=m, chain=chain)).run(
            jax.random.key(8), y)
    a = np.asarray(smc.expected_parameters(s_pf))
    b = np.asarray(smc.expected_parameters(s_kf))
    _require(np.all(np.abs(a - b) < MC_MEAN_TOL),
             f"IBIS {b} vs SMC² {a} beyond {MC_MEAN_TOL}")
    return {"smc2_mean": a.tolist(), "ibis_mean": b.tolist()}


def phase_other_samplers(m: int = 512, n_dt: int = 1024, n_pg: int = 8192,
                         sweeps: int = 3, n_smooth: int = 1024,
                         t_lg: int = 100, t_ucsv: int = 241):
    """d. density-tempered SMC (LG), particle Gibbs (UC-SV) and the
    marginal smoother (UC-SV): finite output of the expected shape."""
    out = {}
    y_lg, y_uc = lg_series(t_lg), synthetic_series(t_ucsv)

    t0 = time.perf_counter()
    sampler = smc.SMC2(smc.lg_model, lg_prior(), smc.SMCConfig(
        n_particles=n_dt, n_theta=m, chain=3, ess_threshold=0.5))
    state, trace = smc.density_tempered(sampler, jax.random.key(4), y_lg)
    mean = np.asarray(smc.expected_parameters(state))
    _require(np.isfinite(mean).all() and trace[-1].xi == 1.0,
             f"density-tempered: mean {mean}, last ξ {trace[-1].xi}")
    out["density_tempered"] = {"s": time.perf_counter() - t0,
                               "stages": len(trace), "mean": mean.tolist()}

    t0 = time.perf_counter()
    res = smc.particle_gibbs(jax.random.key(3), smc.ucsv_model, ucsv_prior(),
                             y_uc, smc.PGConfig(n_particles=n_pg, sweeps=sweeps))
    theta = np.asarray(res.theta)
    _require(theta.shape == (sweeps, 4) and np.isfinite(theta).all()
             and np.isfinite(np.asarray(res.final_path)).all(),
             "particle Gibbs: non-finite draws")
    out["particle_gibbs"] = {"s": time.perf_counter() - t0,
                             "last_theta": theta[-1].tolist()}

    t0 = time.perf_counter()
    model = smc.ucsv_model(jnp.asarray([0.2, 3.0, 0.5, 0.5]))
    cloud = smc.smoothed_marginals(jax.random.key(2), model, n_smooth, y_uc)
    sm = np.asarray(smc.smoothed_mean(cloud))
    wsum = np.asarray(jnp.exp(cloud.log_weights).sum(-1))
    _require(sm.shape == (t_ucsv, 3) and np.isfinite(sm).all()
             and np.allclose(wsum, 1.0, atol=1e-3),
             "smoother: non-finite means or unnormalized weights")
    out["smoothed_marginals"] = {"s": time.perf_counter() - t0}
    return out


def _posterior_sd(state):
    """θ-weighted posterior standard deviation of each parameter."""
    w = np.asarray(jax.nn.softmax(state.log_omega), np.float64)
    th = np.asarray(state.theta, np.float64)
    return np.sqrt(w @ (th - w @ th) ** 2)


def _agreement(ref, got):
    """How far a sharded state sits from the one-card state: the share of θ
    rows equal to SHARD_RTOL, the share of cloud slots (θ row, particle)
    whose state differs at all, max |Δ| of the per-θ logZ, max |Δ| of the
    posterior mean and that |Δ| in posterior standard deviations."""
    th_r, th_g = np.asarray(ref.theta), np.asarray(got.theta)
    rows = np.abs(th_r - th_g) <= SHARD_RTOL * (1.0 + np.abs(th_r))
    d_mean = np.abs(np.asarray(smc.expected_parameters(got))
                    - np.asarray(smc.expected_parameters(ref)))
    return {
        "theta_rows_agree": float(np.mean(np.all(rows, axis=1))),
        "slots_differ": float(np.mean(np.any(
            np.asarray(ref.particles) != np.asarray(got.particles), axis=-1))),
        "log_z_max_abs": float(np.max(np.abs(
            np.asarray(ref.log_z, np.float64)
            - np.asarray(got.log_z, np.float64)))),
        "posterior_mean_diff": float(d_mean.max()),
        "posterior_mean_diff_sd": float(np.max(d_mean / _posterior_sd(ref))),
        "finite": bool(jnp.isfinite(got.ess)),
    }


def _require_exact_until_rejuvenation(name, base, sharded, y, max_steps=20):
    """Step the one-card and the sharded sampler side by side from one key.
    At init and after the first online step, unless it rejuvenates, the
    two differ only by reordered sums: θ equal, at most SLOTS_DIFFER_STEP1
    of the cloud slots moved by an ancestor flip at a CDF boundary, logZ
    within LOGZ_ATOL_STEP1. Once a flip has spread, the clouds (and so the
    PMMH accept draws) part; while they have not, at least
    THETA_ROWS_AGREE of the θ rows still agree after the first
    rejuvenation."""
    ref, got = base.init(jax.random.key(0), y), sharded.init(jax.random.key(0), y)
    out = {"init": _agreement(ref, got)}
    exact = [out["init"]]
    before = out["init"]
    for k in range(1, max_steps + 1):
        ref, info = base.step(ref, y)
        got, _ = sharded.step(got, y)
        rec = _agreement(ref, got)
        if bool(info.rejuvenated):
            held = before["slots_differ"] <= SLOTS_DIFFER_STEP1
            out["first_rejuvenation"] = dict(rec, step=k, held=held)
            _require(not held or rec["theta_rows_agree"] >= THETA_ROWS_AGREE,
                     f"{name}: θ rows after the first rejuvenation: {rec}")
            break
        if k == 1:
            out["step_1"] = rec
            exact.append(rec)
        before = rec
    for rec in exact:
        _require(rec["theta_rows_agree"] == 1.0
                 and rec["slots_differ"] <= SLOTS_DIFFER_STEP1
                 and rec["log_z_max_abs"] <= LOGZ_ATOL_STEP1,
                 f"{name}: before any rejuvenation: {rec}")
    return out


def phase_four_cards(m: int = 512, n: int = 8192, t: int = 241,
                     chain: int = 5, n_elastic: int = 2048, devices=None):
    """e. ``ShardedSMC2`` on a 4×1 (θ) and a 2×2 (θ, particle) mesh, and
    the elastic N-doubling step on 2×2, each against the same run on one
    card. Both meshes reorder cross-device sums (the θ-axis log-sum-exp,
    the θ-resampling CDF, the RW-kernel moments; on 2×2 also the particle
    CDF), so each is first held tight step by step up to its first
    rejuvenation, then over the whole run: the θ-only mesh to
    THETA_MESH_MEAN_TOL on the posterior mean, the runs that diverge after
    an ancestor flip to MC_SD_TOL posterior standard deviations."""
    devices = list(devices if devices is not None else jax.devices())
    _require(len(devices) >= 4, f"needs 4 devices, found {len(devices)}")
    devices = devices[:4]
    y = synthetic_series(t)
    out = {}

    one_card = ucsv_sampler(m, n, chain)
    t0 = time.perf_counter()
    ref, _ = one_card.run(jax.random.key(0), y)
    jax.block_until_ready(ref)
    out["one_card_first_call_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(one_card.run(jax.random.key(0), y))
    out["one_card_run_s"] = time.perf_counter() - t0
    for shape in ((4, 1), (2, 2)):
        name = f"mesh_{shape[0]}x{shape[1]}"
        sharded = ShardedSMC2(ucsv_sampler(m, n, chain),
                              make_mesh(*shape, devices=devices))
        rec = {"steps": _require_exact_until_rejuvenation(
            name, one_card, sharded, y)}
        t0 = time.perf_counter()
        st, _ = sharded.run(jax.random.key(0), y)
        jax.block_until_ready(st)
        rec["first_call_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(sharded.run(jax.random.key(0), y))
        rec["run_s"] = time.perf_counter() - t0
        rec["run"] = _agreement(ref, st)
        out[name] = rec
        print(f"[info] {name}: {json.dumps(rec)}", flush=True)
        run = rec["run"]
        _require(run["finite"], f"{name}: non-finite ESS")
        if shape[1] == 1:
            _require(run["posterior_mean_diff"] <= THETA_MESH_MEAN_TOL
                     and run["theta_rows_agree"] >= THETA_ROWS_AGREE,
                     f"{name}: whole run beyond {THETA_MESH_MEAN_TOL}: {run}")
        else:
            _require(run["posterior_mean_diff_sd"] <= MC_SD_TOL,
                     f"{name}: whole run beyond {MC_SD_TOL} sd: {run}")

    # elastic N-doubling (in-graph, elastic_pad="full"): every step
    # rejuvenates (θ-ESS threshold 1) and every rejuvenation doubles
    def elastic():
        return ucsv_sampler(m, n_elastic, chain=3, ess_threshold=1.0,
                            acc_threshold=1.1, exchange_max_n=2 * n_elastic,
                            elastic_pad="full")

    y16 = synthetic_series(16)
    base = elastic()
    sharded = ShardedSMC2(elastic(), make_mesh(2, 2, devices=devices))
    rec = {"steps": _require_exact_until_rejuvenation(
        "elastic_2x2", base, sharded, y16, max_steps=1)}
    ref_e = base.init(jax.random.key(0), y16)
    st_e = sharded.init(jax.random.key(0), y16)
    for _ in range(3):
        ref_e, _ = base.step(ref_e, y16)
        st_e, _ = sharded.step(st_e, y16)
    jax.block_until_ready((ref_e, st_e))
    rec.update(_agreement(ref_e, st_e), active_n=int(st_e.active_n),
               active_n_one_card=int(ref_e.active_n))
    out["elastic_2x2"] = rec
    print(f"[info] elastic_2x2: {json.dumps(rec)}", flush=True)
    _require(rec["finite"] and rec["active_n"] > n_elastic
             and rec["active_n"] == rec["active_n_one_card"],
             f"elastic doubling: {rec}")
    _require(rec["posterior_mean_diff_sd"] <= MC_SD_TOL,
             f"elastic run beyond {MC_SD_TOL} sd of one card: {rec}")
    return out


# -- entry point --------------------------------------------------------------

def _run_phase(name, fn, failures):
    print(f"[phase {name}] start", flush=True)
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception:  # report every phase, then fail the run
        traceback.print_exc()
        failures.append(name)
        print(f"[phase {name}] FAILED after {time.perf_counter() - t0:.1f} s",
              flush=True)
        return
    res["phase_s"] = time.perf_counter() - t0
    print(f"[phase {name}] ok (timings informational): "
          f"{json.dumps(res, default=str)}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card ShardedSMC2 phase")
    args = p.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    cache = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)

    print("card (nvidia-smi name, power.limit):")
    print(gpu_name_and_power_limit())
    import jaxlib

    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
          f"compile cache {cache}; devices {jax.devices()}", flush=True)

    failures = []
    if args.four_cards:
        _run_phase("e four_cards", phase_four_cards, failures)
    else:
        y = synthetic_series(241)
        flagship = ucsv_sampler(512, 8192)
        _run_phase("a compile", lambda: phase_compile(flagship, y), failures)
        _run_phase("b end_to_end 512x1024",
                   lambda: phase_end_to_end(ucsv_sampler(512, 1024), y),
                   failures)
        _run_phase("b end_to_end 512x8192",
                   lambda: phase_end_to_end(flagship, y), failures)
        _run_phase("c1 kalman_vs_f64", phase_kalman_vs_f64, failures)
        _run_phase("c2 batched_pf_vs_kalman", phase_batched_pf_vs_kalman,
                   failures)
        _run_phase("c3 resample_gather", phase_resample_gather, failures)
        _run_phase("c4 ibis_vs_smc2", phase_ibis_vs_smc2, failures)
        _run_phase("d other_samplers", phase_other_samplers, failures)

    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
