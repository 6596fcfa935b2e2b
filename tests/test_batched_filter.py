"""L2.5 batched filter: the XLA resample+gather and propagate stages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sequential_monte_carlo_tpu as smc
from sequential_monte_carlo_tpu.ops.batched_filter import (
    _elastic_sorted_u,
    _resample_gather,
    batched_log_likelihood,
    batched_log_likelihood_masked,
    batched_pf_init,
    batched_pf_step,
    gather_ancestors,
)
from sequential_monte_carlo_tpu.ops.resampling import (
    get_resampler,
    search_ancestors,
    stratified_uniforms,
    systematic_uniforms,
)


@pytest.fixture(scope="module")
def setup():
    m_true = smc.lg_model(jnp.array([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(7), m_true, 60)
    M = 16
    thetas = jnp.stack(
        [jnp.asarray([0.5, 0.9, 0.8]) * (1 + 0.02 * i) for i in range(M)]
    )
    models = jax.vmap(smc.lg_model)(thetas)
    return models, y, M


def test_batched_init_shapes(setup):
    models, y, M = setup
    out = batched_pf_init(jax.random.key(0), models, 128, M, y[0])
    assert out.particles.shape == (M, 128, 1)
    assert out.log_weights.shape == (M, 128)
    assert out.log_mean.shape == (M,)
    np.testing.assert_allclose(
        np.asarray(jnp.exp(out.log_weights).sum(-1)), np.ones(M), rtol=1e-4
    )


def test_batched_step_and_ll_match_kalman(setup):
    models, y, M = setup
    particles, log_w, logz = batched_log_likelihood(
        jax.random.key(1), models, 512, M, y
    )
    kz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    assert np.abs(np.asarray(logz - kz)).max() < 2.5


def test_batched_masked_equals_prefix_target(setup):
    models, y, M = setup
    t = 30
    mask = (jnp.arange(60) < t).astype(y.dtype)
    _, _, logz = batched_log_likelihood_masked(
        jax.random.key(2), models, 512, M, y, mask
    )
    kz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y[:t])[1])(models)
    assert np.abs(np.asarray(logz - kz)).max() < 2.5


def test_batched_adaptive_resampling(setup):
    models, y, M = setup
    cfg = smc.PFConfig("systematic", 0.5)
    _, _, logz = batched_log_likelihood(jax.random.key(3), models, 256, M, y, cfg)
    kz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    assert np.abs(np.asarray(logz - kz)).max() < 3.0


# ---- round-5 additions: conditional resample skip, guided batch, carry ----

def _select_formulation_step(key, models, particles, log_w, y, cfg):
    """The round-4 SELECT formulation of the adaptive batched step (XLA
    route), reimplemented inline as the bitwise oracle for the lax.cond
    rewrite (VERDICT r4 #2): always resample+gather, then per-row select."""
    from sequential_monte_carlo_tpu.ops.batched_filter import _row_normalize
    from sequential_monte_carlo_tpu.ops.resampling import get_resampler

    m, n, dx = particles.shape
    k_res, k_prop = jax.random.split(key)
    w = jnp.exp(log_w)
    keys = jax.random.split(k_res, m)
    anc = jax.vmap(lambda k, ww: get_resampler(cfg.resampling)(k, ww))(keys, w)
    gathered = jax.vmap(lambda x, a: jnp.take(x, a, axis=0))(particles, anc)
    log_n = jnp.log(jnp.asarray(float(n), dtype=log_w.dtype))
    reset_lw = jnp.full_like(log_w, -log_n)
    ess_prev = 1.0 / jnp.sum(w * w, axis=-1)
    do = (ess_prev < cfg.ess_threshold * n)[:, None]
    xp = jnp.where(do[..., None], gathered, particles)
    lw = jnp.where(do, reset_lw, log_w)
    keys_p = jax.random.split(k_prop, m)
    x_new = jax.vmap(
        lambda k, mod, x: mod.transition_distribution(x).sample(k)
    )(keys_p, models, xp)
    incr = jax.vmap(
        lambda mod, x: mod.observation_distribution(x).log_prob(y)
    )(models, x_new)
    return x_new, *_row_normalize(lw + incr)


def test_batched_adaptive_cond_bitwise_matches_select(setup):
    """The lax.cond adaptive-resample rewrite is bitwise-identical to the
    select formulation — BOTH when some rows fire and when none do (the
    cond's skip branch)."""
    models, y, M = setup
    n = 64
    cfg = smc.PFConfig("systematic", 0.5)
    init = batched_pf_init(jax.random.key(0), models, n, M, y[0])
    # (a) uniform weights: ESS = n for every row, NO row fires
    lw_hi = jnp.full((M, n), -jnp.log(float(n)))
    # (b) concentrated weights: every/some rows fire
    lw_lo = jax.nn.log_softmax(
        8.0 * jax.random.normal(jax.random.key(3), (M, n)), axis=-1
    )
    for lw0 in (lw_hi, lw_lo):
        out = batched_pf_step(
            jax.random.key(5), models, init.particles, lw0, y[1], cfg
        )
        x_ref, lwr, lmr, essr = _select_formulation_step(
            jax.random.key(5), models, init.particles, lw0, y[1], cfg
        )
        np.testing.assert_array_equal(np.asarray(out.particles), np.asarray(x_ref))
        np.testing.assert_array_equal(np.asarray(out.log_weights), np.asarray(lwr))
        np.testing.assert_array_equal(np.asarray(out.log_mean), np.asarray(lmr))


def test_batched_guided_proposal_matches_kalman(setup):
    """Guided inner filters through the BATCHED layer (VERDICT r4 #6): a
    transition proposal with the importance correction threaded via
    PFConfig.proposal — the correction cancels analytically, so the
    batched guided path must reproduce the bootstrap logZ statistics and
    match the exact Kalman logZ within MC error."""
    from sequential_monte_carlo_tpu.ops import Proposal

    models, y, M = setup
    prop = Proposal(
        initial=lambda mm: mm.initial_distribution(),
        step=lambda mm, xp: mm.transition_distribution(xp),
    )
    cfg = smc.PFConfig("systematic", 1.0, proposal=prop)
    _, _, logz = batched_log_likelihood(
        jax.random.key(11), models, 512, M, y, cfg
    )
    kz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    assert np.abs(np.asarray(logz - kz)).max() < 2.5

    # a genuinely different proposal (widened transition — the correction
    # does NOT cancel) stays a consistent estimator of the same logZ
    from sequential_monte_carlo_tpu.distributions import Normal, Product

    def widened(mm, xp):
        loc = mm.A[..., 0, :] * xp
        return Product(Normal(loc, 1.5 * jnp.sqrt(mm.Q[..., 0, :])))

    prop_w = Proposal(
        initial=lambda mm: mm.initial_distribution(), step=widened
    )
    cfg_w = smc.PFConfig("systematic", 1.0, proposal=prop_w)
    _, _, logz_w = batched_log_likelihood(
        jax.random.key(12), models, 512, M, y, cfg_w
    )
    assert np.abs(np.asarray(logz_w - kz)).max() < 3.0


def test_batched_apf_matches_kalman(setup):
    """Batched auxiliary-PF route (PFConfig(algorithm='apf'), VERDICT r4
    #6 lookahead): logZ matches the exact Kalman oracle within MC error,
    and one step keeps normalized weights and a finite evidence."""
    models, y, M = setup
    kz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    cfg = smc.PFConfig("systematic", 1.0, algorithm="apf")
    _, _, logz = batched_log_likelihood(
        jax.random.key(13), models, 512, M, y, cfg
    )
    assert np.abs(np.asarray(logz - kz)).max() < 2.5

    init = batched_pf_init(jax.random.key(0), models, 128, M, y[0])
    out = batched_pf_step(
        jax.random.key(1), models, init.particles, init.log_weights,
        y[1], cfg,
    )
    lw = np.asarray(out.log_weights)
    np.testing.assert_allclose(np.exp(lw).sum(-1), np.ones(M), rtol=1e-4)
    assert np.isfinite(np.asarray(out.log_mean)).all()


def test_batched_apf_rejects_elastic():
    import pytest as _pytest

    thetas = jnp.stack([jnp.asarray([0.5, 0.9, 0.8])] * 4)
    models = jax.vmap(smc.lg_model)(thetas)
    cfg = smc.PFConfig("systematic", 1.0, algorithm="apf")
    init = batched_pf_init(jax.random.key(0), models, 64, 4, jnp.asarray(0.1))
    with _pytest.raises(ValueError, match="apf"):
        batched_pf_step(
            jax.random.key(1), models, init.particles, init.log_weights,
            jnp.asarray(0.2), cfg, active_n=jnp.asarray(32),
        )


def test_batched_config_validation():
    """Unknown algorithm strings and apf+proposal raise instead of
    silently running bootstrap (r5 review findings)."""
    from sequential_monte_carlo_tpu.ops import Proposal

    thetas = jnp.stack([jnp.asarray([0.5, 0.9, 0.8])] * 4)
    models = jax.vmap(smc.lg_model)(thetas)
    init = batched_pf_init(jax.random.key(0), models, 64, 4, jnp.asarray(0.1))

    with pytest.raises(ValueError, match="unknown algorithm"):
        batched_pf_step(
            jax.random.key(1), models, init.particles, init.log_weights,
            jnp.asarray(0.2), smc.PFConfig(algorithm="afp"),
        )
    prop = Proposal(
        initial=lambda m: m.initial_distribution(),
        step=lambda m, xp: m.transition_distribution(xp),
    )
    with pytest.raises(ValueError, match="bootstrap algorithm only"):
        batched_pf_step(
            jax.random.key(1), models, init.particles, init.log_weights,
            jnp.asarray(0.2),
            smc.PFConfig(algorithm="apf", proposal=prop),
        )


def test_batched_apf_rejects_adaptive():
    """apf + ess_threshold < 1 raises (APF resamples by construction;
    silently ignoring the trigger was the r5 second-pass finding)."""
    thetas = jnp.stack([jnp.asarray([0.5, 0.9, 0.8])] * 4)
    models = jax.vmap(smc.lg_model)(thetas)
    init = batched_pf_init(jax.random.key(0), models, 64, 4, jnp.asarray(0.1))
    with pytest.raises(ValueError, match="bootstrap"):
        batched_pf_step(
            jax.random.key(1), models, init.particles, init.log_weights,
            jnp.asarray(0.2),
            smc.PFConfig("systematic", 0.5, algorithm="apf"),
        )


# ---- XLA resample+gather stage ---------------------------------------------

SCHEMES = ["systematic", "stratified", "multinomial", "residual",
           "residual_systematic"]


def _index_cloud(m, n, dx=2):
    """Particles whose every component holds the particle's own index, so a
    gathered cloud reads back as its ancestor vector."""
    idx = jnp.arange(n, dtype=jnp.float32)[None, :, None]
    return jnp.broadcast_to(idx, (m, n, dx))


@pytest.mark.parametrize("concentration", [0.0, 2.0, 8.0])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_resample_gather_matches_per_row_oracle(scheme, concentration):
    """The batched stage ≡ the per-row resampler + take, row by row, with
    the same split keys — bitwise, at any weight concentration."""
    m, n, dx = 6, 256, 3
    w = jax.nn.softmax(
        concentration * jax.random.normal(jax.random.key(0), (m, n)), axis=-1
    )
    xs = jax.random.normal(jax.random.key(1), (m, n, dx))
    k_res = jax.random.key(2)
    out = _resample_gather(k_res, smc.PFConfig(scheme), xs, w, None)
    keys = jax.random.split(k_res, m)
    resampler = jax.jit(get_resampler(scheme))
    for i in range(m):
        anc = resampler(keys[i], w[i])
        np.testing.assert_array_equal(
            np.asarray(out[i]), np.asarray(jnp.take(xs[i], anc, axis=0))
        )


@pytest.mark.parametrize("scheme", ["systematic", "stratified", "multinomial"])
def test_resample_gather_degenerate_weight(scheme):
    """Point-mass weights: every output particle is the heavy one."""
    m, n = 3, 256
    w = jnp.zeros((m, n)).at[:, 17].set(1.0)
    xs = jax.random.normal(jax.random.key(1), (m, n, 2))
    out = _resample_gather(jax.random.key(2), smc.PFConfig(scheme), xs, w, None)
    expect = jnp.broadcast_to(xs[:, 17:18, :], (m, n, 2))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(expect))


@pytest.mark.parametrize("scheme", ["systematic", "stratified"])
def test_resample_gather_uniform_weights_identity(scheme):
    """Uniform weights + one uniform per stratum ⇒ every particle is drawn
    exactly once, in order."""
    m, n = 2, 128
    w = jnp.full((m, n), 1.0 / n)
    out = _resample_gather(
        jax.random.key(0), smc.PFConfig(scheme), _index_cloud(m, n), w, None
    )
    for i in range(m):
        np.testing.assert_array_equal(
            np.asarray(out[i, :, 0]), np.arange(n, dtype=np.float32)
        )


@pytest.mark.parametrize("scheme", ["systematic", "stratified", "multinomial"])
def test_resample_gather_elastic_prefix(scheme):
    """Elastic (padded-N) mode: only the live prefix is ever drawn, and a
    systematic draw gives each live particle ⌊n·w⌋ or ⌈n·w⌉ offspring."""
    m, n, active = 4, 256, 96
    logits = 2.0 * jax.random.normal(jax.random.key(3), (m, n))
    live = jnp.arange(n) < active
    w = jax.nn.softmax(jnp.where(live[None, :], logits, -jnp.inf), axis=-1)
    out = _resample_gather(
        jax.random.key(4), smc.PFConfig(scheme), _index_cloud(m, n), w,
        jnp.asarray(active, jnp.int32),
    )
    anc = np.asarray(out[..., 0]).astype(np.int64)
    assert (anc < active).all()
    if scheme == "systematic":
        counts = np.stack([np.bincount(a[:active], minlength=n) for a in anc])
        nw = active * np.asarray(w, np.float64)
        assert (counts[:, :active] >= np.floor(nw[:, :active]) - 1).all()
        assert (counts[:, :active] <= np.ceil(nw[:, :active]) + 1).all()
        assert counts.sum(-1).tolist() == [active] * m


def test_elastic_sorted_u_covers_live_prefix():
    """The elastic uniform grid is sorted, stays below 1, and its first
    active_n entries hold one point per live stratum."""
    m, n, active = 3, 64, 40
    u = _elastic_sorted_u(
        jax.random.key(5), smc.PFConfig("systematic"), m, n,
        jnp.asarray(active, jnp.int32), jnp.float32,
    )
    u = np.asarray(u)
    assert (np.diff(u, axis=-1) >= 0).all() and (u < 1.0).all()
    strata = np.floor(u[:, :active] * active)
    np.testing.assert_array_equal(strata, np.tile(np.arange(active), (m, 1)))


@pytest.mark.parametrize("concentration", [0.0, 2.0, 8.0])
def test_search_ancestors_and_gather_match_numpy(concentration):
    """The inverse-CDF search and the row gather ≡ NumPy searchsorted-left
    + take, bitwise, on a CDF and uniforms fixed on the host."""
    rng = np.random.default_rng(7)
    m, n, dx = 8, 512, 3
    logits = concentration * rng.standard_normal((m, n))
    w = np.exp(logits - logits.max(-1, keepdims=True)).astype(np.float32)
    cdf = np.cumsum(w, axis=-1, dtype=np.float32)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    u = ((np.arange(n, dtype=np.float32)[None, :]
          + rng.uniform(size=(m, 1)).astype(np.float32)) / np.float32(n))
    xs = rng.standard_normal((m, n, dx)).astype(np.float32)
    anc = np.asarray(jax.vmap(search_ancestors)(cdf, u))
    ref = np.stack([
        np.minimum(np.searchsorted(cdf[i], u[i], side="left"), n - 1)
        for i in range(m)
    ])
    np.testing.assert_array_equal(anc, ref)
    got = np.asarray(gather_ancestors(jnp.asarray(xs), jnp.asarray(anc)))
    np.testing.assert_array_equal(got, np.take_along_axis(xs, ref[..., None], 1))


@pytest.mark.parametrize("make_u", [systematic_uniforms, stratified_uniforms])
def test_uniform_grids_one_point_per_stratum(make_u):
    m, n = 4, 128
    u = np.asarray(make_u(jax.random.key(6), m, n))
    assert u.shape == (m, n)
    assert ((u >= 0) & (u < 1)).all()
    np.testing.assert_array_equal(
        np.floor(u * n), np.tile(np.arange(n), (m, 1))
    )


# ---- propagate + reweight stage --------------------------------------------
# Uniform weights with ess_threshold < 1 never fire the resample trigger, so
# one batched step propagates the given cloud as-is.

def _propagate(models, x, y, seed=0):
    m, n = x.shape[:2]
    lw = jnp.full((m, n), -jnp.log(float(n)))
    return batched_pf_step(
        jax.random.key(seed), models, x, lw, jnp.asarray(y),
        smc.PFConfig("systematic", 0.5),
    )


def _expect_log_norm(logw):
    logw = np.asarray(logw, np.float64)
    mx = logw.max(-1, keepdims=True)
    return logw - mx - np.log(np.exp(logw - mx).sum(-1, keepdims=True))


def test_propagate_sv_deterministic_at_sigma_zero():
    """σ=0 collapses the SV transition to the AR(1) mean; the weights are
    the N(0, exp(x'))-density of y, normalized per row."""
    import math

    m, n = 4, 256
    models = jax.vmap(smc.sv_model)(jnp.tile(jnp.asarray([-1.0, 0.9, 0.0]), (m, 1)))
    x = jax.random.normal(jax.random.key(0), (m, n, 1))
    out = _propagate(models, x, 0.7)
    expect = -1.0 + 0.9 * (np.asarray(x[..., 0]) + 1.0)
    np.testing.assert_allclose(
        np.asarray(out.particles[..., 0]), expect, rtol=1e-5, atol=1e-6
    )
    logw = -0.5 * 0.49 * np.exp(-expect) - 0.5 * expect - 0.5 * math.log(2 * math.pi)
    np.testing.assert_allclose(
        np.asarray(out.log_weights), _expect_log_norm(logw), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("family", ["univariate", "hodrick_prescott"])
def test_propagate_lg_deterministic_at_q_zero(family):
    """Q=0 makes the LG transition exactly A@x: univariate, and the 2-dim
    Hodrick–Prescott companion form whose second state copies the first."""
    m, n = 4, 256
    if family == "univariate":
        models = jax.vmap(smc.lg_model)(jnp.tile(jnp.asarray([0.5, 0.0, 0.8]), (m, 1)))
        x = jax.random.normal(jax.random.key(1), (m, n, 1))
        out = _propagate(models, x, 0.3)
        np.testing.assert_allclose(
            np.asarray(out.particles[..., 0]), 0.5 * np.asarray(x[..., 0]),
            rtol=1e-6, atol=1e-6,
        )
        delta = 0.3 - 0.5 * np.asarray(x[..., 0], np.float64)
        np.testing.assert_allclose(
            np.asarray(out.log_weights),
            _expect_log_norm(-0.5 * delta * delta / 0.8), rtol=1e-4, atol=1e-4,
        )
    else:
        hp = smc.hodrick_prescott(1600.0, np.array([1.0, 1.1, 1.2]))
        models = jax.tree.map(lambda a: jnp.broadcast_to(a, (m,) + a.shape), hp)
        x = jax.random.normal(jax.random.key(2), (m, n, 2))
        out = _propagate(models, x, 1.05)
        np.testing.assert_allclose(
            np.asarray(out.particles[..., 1]), np.asarray(x[..., 0]),
            rtol=1e-5, atol=1e-6,
        )
        assert np.isfinite(np.asarray(out.log_weights)).all()


def test_propagate_ucsv_gamma_zero_freezes_vols():
    """γ=0 makes both log-vol random walks degenerate: the vol planes come
    back bitwise unchanged, whatever the draws."""
    m, n = 4, 512
    models = jax.vmap(smc.ucsv_model)(jnp.tile(jnp.asarray([0.0, 3.0, 0.2, 0.2]), (m, 1)))
    x = jax.random.normal(jax.random.key(3), (m, n, 3))
    out = _propagate(models, x, 1.3)
    np.testing.assert_array_equal(np.asarray(out.particles[..., 1:]),
                                  np.asarray(x[..., 1:]))


def test_propagate_ucsv_trend_increment_statistics():
    """(x' − x)·exp(−½ logσε) ≈ N(0, 1): the trend draws are standard
    normals (threefry draws, real on every backend)."""
    m, n = 2, 4096
    models = jax.vmap(smc.ucsv_model)(jnp.tile(jnp.asarray([0.0, 3.0, 0.2, 0.2]), (m, 1)))
    x = jax.random.normal(jax.random.key(4), (m, n, 3))
    out = _propagate(models, x, 1.3)
    z = np.asarray((out.particles[..., 0] - x[..., 0]) * jnp.exp(-0.5 * x[..., 1]))
    assert abs(z.mean()) < 0.05
    assert abs(z.std() - 1.0) < 0.05


@pytest.mark.parametrize("scheme", ["systematic", "stratified", "multinomial"])
def test_batched_lg_logz_matches_kalman(setup, scheme):
    """LG batched logZ through every exact scheme stays within MC error of
    the per-θ Kalman logZ."""
    models, y, M = setup
    _, _, z = batched_log_likelihood(
        jax.random.key(5), models, 512, M, y, smc.PFConfig(scheme)
    )
    kz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    assert np.abs(np.asarray(z - kz)).max() < 3.0
