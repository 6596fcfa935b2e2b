"""f32-vs-f64 numerics validation (SURVEY.md §7 hard part (d)).

The library computes in f32; the reference in Julia f64. These tests bound the
accumulation error of the f32 log-evidence path against f64 references on
CPU — the drift must stay far inside Monte-Carlo error.
"""
import jax
import jax.numpy as jnp
import numpy as np

import sequential_monte_carlo_tpu as smc


def _kalman_f64(A, B, Q, R, x0, s0, y64):
    xt, St = x0, s0
    logZ = 0.0
    for yt in y64:
        xt = A * xt
        St = A * A * St + Q
        st = B * B * St + R
        dy = yt - B * xt
        xt = xt + (St * B) / st * dy
        St = St - (St * B) ** 2 / st
        logZ += -0.5 * (np.log(2 * np.pi) + np.log(st) + dy * dy / st)
    return logZ


def test_kalman_f32_drift_vs_f64():
    """f32 Kalman logZ accumulated over T=500 stays within ~1e-4 relative
    of the f64 reference — far below any PF Monte-Carlo error."""
    m = smc.lg_model(jnp.asarray([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(0), m, 500)
    (_, _), z32 = smc.kalman_log_likelihood(m, y)
    z64 = _kalman_f64(0.5, 1.0, 0.9, 0.8, 0.0, 1.0, np.asarray(y, np.float64))
    assert abs(float(z32) - z64) / abs(z64) < 1e-4


def test_logsumexp_weight_path_f32_stability():
    """Max-shifted log-sum-exp keeps extreme log-weights finite in f32
    (weights spanning e^[-80, 40])."""
    logw = jnp.asarray(np.random.default_rng(0).uniform(-80, 40, 4096),
                       dtype=jnp.float32)
    log_mean, w, ess = smc.normalize(logw)
    assert np.isfinite(float(log_mean))
    assert np.isfinite(np.asarray(w)).all()
    assert float(jnp.sum(w)) == np.float32(1.0) or abs(float(jnp.sum(w)) - 1) < 1e-5
    # f64 reference
    l64 = np.asarray(logw, np.float64)
    ref = l64.max() + np.log(np.exp(l64 - l64.max()).sum()) - np.log(len(l64))
    assert abs(float(log_mean) - ref) < 1e-3


def test_pf_logz_f32_unbiased_long_series():
    """Accumulating 300 per-step f32 evidence increments doesn't drift:
    PF logZ still centered on the exact Kalman value."""
    m = smc.lg_model(jnp.asarray([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(1), m, 300)
    (_, _), kz = smc.kalman_log_likelihood(m, y)
    reps = 8
    zs = np.asarray(
        jax.vmap(lambda k: smc.log_likelihood(k, m, 1024, y)[1])(
            jax.random.split(jax.random.key(2), reps)
        )
    )
    se = zs.std(ddof=1) / np.sqrt(reps)
    assert abs(zs.mean() - float(kz)) < max(5 * se, 1.0)
