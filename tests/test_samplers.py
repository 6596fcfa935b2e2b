"""L3 samplers: SMC², density-tempered SMC, IBIS — validated against an
exact-posterior oracle (Kalman-likelihood importance sampling from the
prior), the rebuild's formalization of the reference's golden run
(smc_samplers.jl:197-220; SURVEY.md §4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sequential_monte_carlo_tpu as smc


def _prior():
    # ≡ README.md:81-85 prior
    return smc.product_distribution(
        [
            smc.TruncatedNormal(
                jnp.asarray(0.0), jnp.asarray(1.0), jnp.asarray(-1.0), jnp.asarray(1.0)
            ),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
        ]
    )


@pytest.fixture(scope="module")
def lg_setup():
    prior = _prior()
    m_true = smc.lg_model(jnp.array([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(1998), m_true, 100)
    return prior, y


@pytest.fixture(scope="module")
def oracle_mean(lg_setup):
    """Exact posterior mean via prior-IS with exact Kalman likelihoods."""
    prior, y = lg_setup
    theta = prior.sample(jax.random.key(77), (100_000,))
    models = jax.vmap(smc.lg_model)(theta)
    logz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    w = jax.nn.softmax(logz)
    return np.asarray(w @ theta)


CFG = smc.SMCConfig(n_particles=256, n_theta=192, chain=3, ess_threshold=0.5)


def test_smc2_init(lg_setup):
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    state = sampler.init(jax.random.key(0), y)
    assert state.theta.shape == (192, 3)
    assert state.particles.shape == (192, 256, 1)
    assert state.log_w.shape == (192, 256)
    assert np.isfinite(float(state.ess))
    assert int(state.t) == 1
    # per-θ particle weights normalized
    np.testing.assert_allclose(
        np.asarray(jnp.exp(state.log_w).sum(-1)), np.ones(192), rtol=1e-3
    )


def test_smc2_posterior_matches_oracle(lg_setup, oracle_mean):
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    state, infos = sampler.run(jax.random.key(3), y)
    got = np.asarray(smc.expected_parameters(state))
    assert np.all(np.abs(got - oracle_mean) < 0.3), (got, oracle_mean)
    # θ-ESS telemetry well-formed
    assert infos.ess.shape == (99,)
    assert np.isfinite(np.asarray(infos.ess)).all()
    assert bool(np.asarray(infos.rejuvenated).any())  # degeneracy fired


def test_smc2_stepwise_equals_fused_run(lg_setup):
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    s1 = sampler.init(jax.random.key(5), y)
    for _ in range(1, y.shape[0]):
        s1, _ = sampler.step(s1, y)
    s2, _ = sampler.run(jax.random.key(5), y)
    np.testing.assert_allclose(
        np.asarray(s1.theta), np.asarray(s2.theta), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(s1.log_omega), np.asarray(s2.log_omega), rtol=1e-4, atol=1e-4
    )


def test_smc2_reproducible(lg_setup):
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    a, _ = sampler.run(jax.random.key(9), y)
    b, _ = sampler.run(jax.random.key(9), y)
    assert np.array_equal(np.asarray(a.theta), np.asarray(b.theta))


def test_dtheta1_kernel_semantics_and_smc2(lg_setup):
    """dθ=1 path (DEVIATIONS.md §1): the univariate RW kernel uses the
    COVARIANCE semantics (Σ = 2.83²·var(θ) + jitter, proposal std = √Σ) —
    the multivariate branch of smc_samplers.jl:95-101 specialized to d=1,
    NOT the reference's univariate Normal(x, 2.83²·var) std-of-a-variance
    form (smc_samplers.jl:87-92). Also runs SMC² end-to-end on a
    one-free-parameter model, which no shipped model otherwise exercises."""
    from sequential_monte_carlo_tpu.samplers.kernels import rw_kernel_cov

    th = jax.random.normal(jax.random.key(0), (512, 1)) * 0.37 + 1.0
    sigma = rw_kernel_cov(th, CFG)
    var = float(jnp.var(th, ddof=1))
    np.testing.assert_allclose(
        float(sigma[0, 0]), CFG.rw_scale * var + CFG.cov_jitter, rtol=1e-5
    )

    _, y = lg_setup
    prior1 = smc.product_distribution(
        [smc.LogNormal(jnp.asarray(0.0), jnp.asarray(0.5))]
    )
    fixed = jnp.asarray([0.5, 0.9])
    model1 = lambda th_: smc.lg_model(jnp.concatenate([fixed, th_]))  # noqa: E731
    cfg = smc.SMCConfig(
        n_particles=128, n_theta=128, chain=2, ess_threshold=0.5
    )
    sampler = smc.SMC2(model1, prior1, cfg)
    state, infos = sampler.run(jax.random.key(4), y[:40])
    est = float(smc.expected_parameters(state)[0])
    # truth: R = 0.8 (the free parameter is the observation VARIANCE;
    # lg_model passes √R to Normal); loose band — 40 obs, 128 θ
    assert np.isfinite(est) and 0.3 < est < 2.0, est


def test_density_tempered_posterior_and_schedule(lg_setup, oracle_mean):
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    state, trace = smc.density_tempered(sampler, jax.random.key(4), y)
    got = np.asarray(smc.expected_parameters(state))
    assert np.all(np.abs(got - oracle_mean) < 0.3), (got, oracle_mean)
    # ξ strictly increases to exactly 1 (smc_samplers.jl:235-266)
    xis = [s.xi for s in trace]
    assert all(b > a for a, b in zip(xis, xis[1:] )) or len(xis) == 1
    assert xis[-1] == 1.0
    # intermediate stages pin ESS at ess_min (bisection target, :250-256)
    for s in trace[:-1]:
        assert abs(s.ess - CFG.ess_min) < 1.5


def test_ibis_posterior_matches_oracle(lg_setup, oracle_mean):
    prior, y = lg_setup
    ibis = smc.IBIS(smc.lg_model, prior, smc.SMCConfig(n_theta=256, chain=3))
    state, infos = ibis.run(jax.random.key(6), y)
    got = np.asarray(smc.expected_parameters(state))
    assert np.all(np.abs(got - oracle_mean) < 0.3), (got, oracle_mean)


def test_ibis_smc2_agree(lg_setup):
    """SMC²-vs-IBIS θ-posterior agreement on LG (SURVEY.md §4 plan)."""
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    ibis = smc.IBIS(smc.lg_model, prior, smc.SMCConfig(n_theta=192, chain=3))
    s_pf, _ = sampler.run(jax.random.key(8), y)
    s_kf, _ = ibis.run(jax.random.key(8), y)
    a = np.asarray(smc.expected_parameters(s_pf))
    b = np.asarray(smc.expected_parameters(s_kf))
    assert np.all(np.abs(a - b) < 0.35), (a, b)


def test_rejuvenation_resets_weights_and_reports_acceptance(lg_setup):
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    state = sampler.init(jax.random.key(10), y)
    rejuvenated = False
    for _ in range(1, 40):
        state, info = sampler.step(state, y)
        if bool(info.rejuvenated):
            rejuvenated = True
            assert 0.0 <= float(info.acc_ratio) <= 1.0
    assert rejuvenated


def test_exchange_doubles_n(lg_setup):
    """exchange! ≡ smc_samplers.jl:163-189, IN-GRAPH (elastic_pad="full"):
    acc below threshold → the live particle count doubles inside the
    compiled step. Arrays are padded once to the doubling cap;
    ``state.active_n`` carries the live count and the dead tail stays at
    log-weight −inf."""
    prior, y = lg_setup
    cfg = smc.SMCConfig(
        n_particles=64, n_theta=64, chain=2, ess_threshold=0.5,
        acc_threshold=1.1,  # always trigger after a rejuvenation
        exchange_max_n=128, elastic_pad="full",
    )
    sampler = smc.SMC2(smc.lg_model, prior, cfg)
    state = sampler.init(jax.random.key(11), y)
    assert state.particles.shape[1] == 256  # padded to the doubling cap
    assert int(state.active_n) == 64
    sizes = {64}
    for _ in range(1, 30):
        state, info = sampler.step(state, y)
        sizes.add(int(state.active_n))
    assert 128 in sizes  # doubled at least once
    assert max(sizes) <= 256  # respects the cap (≤128 before doubling)
    # the inactive tail is exactly dead weight
    lw = np.asarray(state.log_w)
    assert (lw[:, int(state.active_n):] == -np.inf).all()
    assert np.isfinite(lw[:, : int(state.active_n)]).all()


def test_exchange_inside_fused_run(lg_setup):
    """Acceptance collapse doubles active_n inside ONE compiled lax.scan —
    run() honors acc_threshold with zero host sync (VERDICT r1 #5)."""
    prior, y = lg_setup
    cfg = smc.SMCConfig(
        n_particles=64, n_theta=64, chain=2, ess_threshold=0.5,
        acc_threshold=1.1, exchange_max_n=128, elastic_pad="full",
    )
    sampler = smc.SMC2(smc.lg_model, prior, cfg)
    state, infos = sampler.run(jax.random.key(11), y)
    assert int(state.active_n) > 64  # doubled within the scan
    assert int(state.active_n) <= 256
    assert np.isfinite(float(state.ess))
    assert np.isfinite(np.asarray(infos.log_evidence_incr)).all()


def test_exchange_grow_mode_step_driven(lg_setup):
    """Pay-as-you-grow elastic mode (default, VERDICT r2 #2): arrays start
    UNPADDED; a triggered exchange raises exchange_pending and
    maybe_exchange services it by re-padding + refiltering at the doubled
    static shape — reference timing, zero steady-state padding tax."""
    prior, y = lg_setup
    cfg = smc.SMCConfig(
        n_particles=64, n_theta=64, chain=2, ess_threshold=0.5,
        acc_threshold=1.1, exchange_max_n=128,  # elastic_pad="grow" default
    )
    sampler = smc.SMC2(smc.lg_model, prior, cfg)
    state = sampler.init(jax.random.key(11), y)
    assert state.particles.shape[1] == 64  # NO padding at init
    assert int(state.active_n) == 64
    sizes = {64}
    for _ in range(1, 30):
        state, info = sampler.step(state, y)
        state = sampler.maybe_exchange(state, y, info)
        assert int(state.active_n) == state.particles.shape[1]  # invariant
        sizes.add(int(state.active_n))
    assert 128 in sizes  # doubled at least once
    assert max(sizes) <= 256  # respects the cap (≤128 before doubling)
    assert np.isfinite(np.asarray(state.log_w)).all()  # no dead tail


def test_exchange_grow_mode_segmented(lg_setup):
    """run_segmented services pending doublings at segment boundaries."""
    prior, y = lg_setup
    cfg = smc.SMCConfig(
        n_particles=64, n_theta=64, chain=2, ess_threshold=0.5,
        acc_threshold=1.1, exchange_max_n=128,
    )
    sampler = smc.SMC2(smc.lg_model, prior, cfg)
    state, infos = sampler.run_segmented(jax.random.key(11), y, segment_size=8)
    assert int(state.active_n) > 64
    assert int(state.active_n) == state.particles.shape[1]
    assert np.isfinite(float(state.ess))
    assert infos.ess.shape == (y.shape[0] - 1,)
    # run() in grow mode delegates to the segmented path and matches it
    s2, _ = sampler.run(jax.random.key(11), y)
    assert int(s2.active_n) > 64


def test_exchange_grow_mode_no_fire_is_free(lg_setup):
    """With acc_threshold > 0 but no exchange fired, grow mode is
    BITWISE-identical to the acc_threshold=-1 run (zero padding tax —
    VERDICT r2 #2 done-criterion, exact rather than within-10%)."""
    prior, y = lg_setup
    base = smc.SMCConfig(n_particles=64, n_theta=64, chain=2,
                         ess_threshold=0.5)
    elastic = base._replace(acc_threshold=1e-6)  # never triggers
    s_base, _ = smc.SMC2(smc.lg_model, prior, base).run_segmented(
        jax.random.key(3), y, segment_size=16
    )
    s_el, _ = smc.SMC2(smc.lg_model, prior, elastic).run_segmented(
        jax.random.key(3), y, segment_size=16
    )
    assert not bool(s_el.exchange_pending)
    assert s_el.particles.shape == s_base.particles.shape
    np.testing.assert_array_equal(np.asarray(s_el.theta), np.asarray(s_base.theta))
    np.testing.assert_array_equal(
        np.asarray(s_el.particles), np.asarray(s_base.particles)
    )
    np.testing.assert_array_equal(
        np.asarray(s_el.log_omega), np.asarray(s_base.log_omega)
    )


def test_sampler_repr(lg_setup):
    """__repr__ ≡ Base.show(io, smc) (smc_samplers.jl:67-72): ess + mean θ."""
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    state = sampler.init(jax.random.key(0), y)
    r = repr(state)
    assert "ess" in r and "mean(θ)" in r
    ibis = smc.IBIS(smc.lg_model, prior, smc.SMCConfig(n_theta=64, chain=2))
    ri = repr(ibis.init(jax.random.key(0), y))
    assert "ess" in ri and "mean(θ)" in ri


def test_evidence_accumulation(lg_setup):
    """Σ log-evidence increments ≈ log marginal likelihood ∫ p(y|θ)p(θ)dθ."""
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    state, infos = sampler.run(jax.random.key(12), y)
    # oracle: log mean of exp(kalman logZ) over prior draws
    theta = prior.sample(jax.random.key(13), (50_000,))
    models = jax.vmap(smc.lg_model)(theta)
    logz = jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    log_ml = float(
        jax.scipy.special.logsumexp(logz) - jnp.log(logz.shape[0])
    )
    init_evidence = float(
        jax.scipy.special.logsumexp(sampler.init(jax.random.key(12), y).log_omega)
        - jnp.log(CFG.n_theta)
    )
    total = init_evidence + float(np.asarray(infos.log_evidence_incr).sum())
    assert abs(total - log_ml) < 2.0, (total, log_ml)


def test_smc2_segmented_equals_fused_run(lg_setup):
    """run_segmented dispatches the same scan in chunks — same keys, same
    math ⇒ bitwise-identical final state and infos to run()."""
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    s_full, i_full = sampler.run(jax.random.key(11), y)
    s_seg, i_seg = sampler.run_segmented(jax.random.key(11), y, segment_size=17)
    assert bool(jnp.all(s_full.theta == s_seg.theta))
    assert bool(jnp.all(s_full.log_omega == s_seg.log_omega))
    assert bool(jnp.all(s_full.particles == s_seg.particles))
    assert float(s_full.ess) == float(s_seg.ess)
    np.testing.assert_array_equal(np.asarray(i_full.ess), np.asarray(i_seg.ess))
    np.testing.assert_array_equal(
        np.asarray(i_full.rejuvenated), np.asarray(i_seg.rejuvenated)
    )


def test_smc2_segmented_with_collect(lg_setup):
    prior, y = lg_setup
    sampler = smc.SMC2(smc.lg_model, prior, CFG)
    collect = lambda s: {"mean": smc.expected_parameters(s)}
    s_full, (i_full, c_full) = sampler.run(jax.random.key(12), y, collect_fn=collect)
    s_seg, (i_seg, c_seg) = sampler.run_segmented(
        jax.random.key(12), y, segment_size=10, collect_fn=collect
    )
    np.testing.assert_array_equal(
        np.asarray(c_full["mean"]), np.asarray(c_seg["mean"])
    )
    assert c_seg["mean"].shape == (y.shape[0] - 1, 3)


def test_smc2_guided_inner_filter(lg_setup, oracle_mean):
    """SMC² with a GUIDED inner filter (VERDICT r4 #6): a widened-
    transition proposal threaded via SMCConfig.inner.proposal — the whole
    L3 stack (online steps + PMMH rejuvenation) runs non-bootstrap inner
    filters and still recovers the oracle posterior, and the per-θ logZ
    estimates match the exact Kalman likelihoods within MC error."""
    from sequential_monte_carlo_tpu.distributions import Normal, Product
    from sequential_monte_carlo_tpu.ops import Proposal

    prior, y = lg_setup

    def widened(mm, xp):
        loc = mm.A[..., 0, :] * xp
        return Product(Normal(loc, 1.25 * jnp.sqrt(mm.Q[..., 0, :])))

    prop = Proposal(
        initial=lambda mm: mm.initial_distribution(), step=widened
    )
    cfg = CFG._replace(inner=smc.PFConfig("systematic", 1.0, proposal=prop))
    sampler = smc.SMC2(smc.lg_model, prior, cfg)
    state, infos = sampler.run(jax.random.key(21), y)
    got = np.asarray(smc.expected_parameters(state))
    assert np.all(np.abs(got - oracle_mean) < 0.3), (got, oracle_mean)
    # Kalman-oracle logZ check on the guided inner filters' estimates
    models = jax.vmap(smc.lg_model)(state.theta)
    kz = np.asarray(
        jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    )
    dz = np.asarray(state.log_z) - kz
    assert np.isfinite(dz).all()
    assert np.abs(np.median(dz)) < 2.0


def test_smc2_apf_inner_filter(lg_setup, oracle_mean):
    """SMC² with an AUXILIARY-PF inner filter (PFConfig(algorithm='apf'),
    VERDICT r4 #6 lookahead) recovers the oracle posterior — the whole L3
    stack (online steps + PMMH rejuvenation) runs APF inner filters."""
    prior, y = lg_setup
    cfg = CFG._replace(
        inner=smc.PFConfig("systematic", 1.0, algorithm="apf")
    )
    sampler = smc.SMC2(smc.lg_model, prior, cfg)
    state, infos = sampler.run(jax.random.key(23), y)
    got = np.asarray(smc.expected_parameters(state))
    assert np.all(np.abs(got - oracle_mean) < 0.3), (got, oracle_mean)
    models = jax.vmap(smc.lg_model)(state.theta)
    kz = np.asarray(
        jax.vmap(lambda m: smc.kalman_log_likelihood(m, y)[1])(models)
    )
    dz = np.asarray(state.log_z) - kz
    assert np.isfinite(dz).all()
    assert np.abs(np.median(dz)) < 2.0
