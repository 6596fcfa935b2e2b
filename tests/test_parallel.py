"""L4 distributed: mesh-sharded SMC² on the 8-device virtual CPU mesh
(SURVEY.md §4: 'multi-device tests on CPU via xla_force_host_platform_device_count')."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sequential_monte_carlo_tpu as smc
from sequential_monte_carlo_tpu.parallel import (
    PARTICLE_AXIS,
    THETA_AXIS,
    ShardedSMC2,
    make_mesh,
    shard_state,
    smc2_state_shardings,
)


@pytest.fixture(scope="module")
def setup():
    prior = smc.product_distribution(
        [
            smc.TruncatedNormal(jnp.asarray(0.0), jnp.asarray(1.0),
                                jnp.asarray(-1.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
        ]
    )
    m_true = smc.lg_model(jnp.array([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(1998), m_true, 40)
    cfg = smc.SMCConfig(n_particles=128, n_theta=64, chain=2, ess_threshold=0.5)
    return prior, y, cfg


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    mesh = make_mesh(n_theta_shards=4, n_particle_shards=2)
    assert mesh.shape[THETA_AXIS] == 4
    assert mesh.shape[PARTICLE_AXIS] == 2
    with pytest.raises(ValueError):
        make_mesh(n_theta_shards=3, n_particle_shards=2)


def test_sharded_state_placement(setup):
    prior, y, cfg = setup
    mesh = make_mesh(4, 2)
    sh = ShardedSMC2(smc.SMC2(smc.lg_model, prior, cfg), mesh)
    state = sh.init(jax.random.key(0), y)
    # θ sharded over the theta axis, particles over (theta, particle)
    assert state.theta.sharding.spec == jax.sharding.PartitionSpec(THETA_AXIS, None)
    assert state.particles.sharding.spec == jax.sharding.PartitionSpec(
        THETA_AXIS, PARTICLE_AXIS, None
    )


def test_sharded_matches_single_device(setup):
    """Sharding must not change the numerics (same keys ⇒ same posterior)."""
    prior, y, cfg = setup
    mesh = make_mesh(4, 2)
    sh = ShardedSMC2(smc.SMC2(smc.lg_model, prior, cfg), mesh)
    state = sh.init(jax.random.key(0), y)
    for _ in range(1, y.shape[0]):
        state, _ = sh.step(state, y)

    base = smc.SMC2(smc.lg_model, prior, cfg)
    ref = base.init(jax.random.key(0), y)
    for _ in range(1, y.shape[0]):
        ref, _ = base.step(ref, y)

    np.testing.assert_allclose(
        np.asarray(state.theta), np.asarray(ref.theta), rtol=1e-3, atol=1e-4
    )
    assert abs(float(state.ess) - float(ref.ess)) < 1.0


def test_sharded_fused_run(setup):
    prior, y, cfg = setup
    mesh = make_mesh(8, 1)
    sh = ShardedSMC2(smc.SMC2(smc.lg_model, prior, cfg), mesh)
    state, infos = sh.run(jax.random.key(1), y)
    assert np.isfinite(float(state.ess))
    assert infos.ess.shape == (39,)


def test_reshard_roundtrip(setup):
    prior, y, cfg = setup
    base = smc.SMC2(smc.lg_model, prior, cfg)
    state = base.init(jax.random.key(2), y)
    mesh = make_mesh(2, 4)
    sh = ShardedSMC2(base, mesh)
    placed = sh.reshard(state)
    np.testing.assert_array_equal(np.asarray(placed.theta), np.asarray(state.theta))
    t_before = int(state.t)  # read before step: donation may alias buffers
    stepped, _ = sh.step(placed, y)
    assert int(stepped.t) == t_before + 1


def test_theta_only_mesh_ibis(setup):
    """IBIS θ-sharding over all 8 devices."""
    prior, y, cfg = setup
    from sequential_monte_carlo_tpu.parallel import ibis_state_shardings

    mesh = make_mesh(8, 1)
    ibis = smc.IBIS(smc.lg_model, prior, smc.SMCConfig(n_theta=64, chain=2))
    state = ibis.init(jax.random.key(3), y)
    placed = shard_state(state, ibis_state_shardings(mesh))
    stepped, _ = ibis.step(placed, y)
    assert np.isfinite(float(stepped.ess))


# -- UC-SV under θ- and particle-sharding ------------------------------------


@pytest.fixture(scope="module")
def ucsv_setup():
    prior = smc.product_distribution(
        [
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.Normal(jnp.asarray(3.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
            smc.Uniform(jnp.asarray(0.0), jnp.asarray(2.0)),
        ]
    )
    m_true = smc.ucsv_model(jnp.array([0.2, 3.0, 0.5, 0.5]))
    _, y = smc.simulate(jax.random.key(1998), m_true, 12)
    return prior, y


def _ucsv_cfg(n=256, m=32):
    inner = smc.PFConfig("systematic", 1.0)
    return smc.SMCConfig(
        n_particles=n, n_theta=m, chain=2, ess_threshold=0.5, inner=inner
    )


# -- elastic exchange (N-doubling) under sharding (VERDICT r2 #4) -----------


def _elastic_cfg(elastic_pad):
    return smc.SMCConfig(
        n_particles=64, n_theta=64, chain=2, ess_threshold=0.5,
        acc_threshold=1.1,  # always trigger after a rejuvenation
        exchange_max_n=128, elastic_pad=elastic_pad,
    )


def _run_elastic_sharded(prior, y, mesh, elastic_pad, n_steps=20):
    sh = ShardedSMC2(smc.SMC2(smc.lg_model, prior, _elastic_cfg(elastic_pad)), mesh)
    state = sh.init(jax.random.key(11), y)
    sizes = {int(state.active_n)}
    for _ in range(n_steps):
        state, info = sh.step(state, y)
        if elastic_pad == "grow":
            state = sh.sampler.maybe_exchange(state, y, info)
            state = sh.reshard(state)  # re-place the re-padded arrays
        sizes.add(int(state.active_n))
    return state, sizes


def _run_elastic_unsharded(prior, y, elastic_pad, n_steps=20):
    base = smc.SMC2(smc.lg_model, prior, _elastic_cfg(elastic_pad))
    state = base.init(jax.random.key(11), y)
    for _ in range(n_steps):
        state, info = base.step(state, y)
        if elastic_pad == "grow":
            state = base.maybe_exchange(state, y, info)
    return state


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sharded_elastic_full_matches_unsharded(setup, mesh_shape):
    """In-graph elastic exchange (elastic_pad="full", active_n carried in
    the compiled scan) composed with ShardedSMC2 on the 8-device mesh —
    θ-sharded and θ×particle — doubles identically to the unsharded run
    (≡ exchange!, smc_samplers.jl:163-189, under the SURVEY §5.8 mesh)."""
    prior, y, _ = setup
    mesh = make_mesh(*mesh_shape)
    state, sizes = _run_elastic_sharded(prior, y, mesh, "full")
    assert state.particles.shape[1] == 256  # padded to the doubling cap
    assert 128 in sizes  # doubled at least once
    assert max(sizes) <= 256
    lw = np.asarray(state.log_w)
    assert (lw[:, int(state.active_n):] == -np.inf).all()

    ref = _run_elastic_unsharded(prior, y, "full")
    assert int(state.active_n) == int(ref.active_n)
    np.testing.assert_allclose(
        np.asarray(state.theta), np.asarray(ref.theta), rtol=1e-3, atol=1e-4
    )


def test_sharded_elastic_grow_matches_unsharded(setup):
    """Pay-as-you-grow elastic mode under θ-sharding: the pending-exchange
    flag raised inside the sharded step is serviced host-side (re-pad +
    refilter + reshard); active_n tracks the array size and the doubled run
    matches the unsharded sampler."""
    prior, y, _ = setup
    mesh = make_mesh(8, 1)
    state, sizes = _run_elastic_sharded(prior, y, mesh, "grow")
    assert int(state.active_n) == state.particles.shape[1]  # invariant
    assert 128 in sizes
    assert max(sizes) <= 256
    assert np.isfinite(np.asarray(state.log_w)).all()  # no dead tail

    ref = _run_elastic_unsharded(prior, y, "grow")
    assert int(state.active_n) == int(ref.active_n)
    np.testing.assert_allclose(
        np.asarray(state.theta), np.asarray(ref.theta), rtol=1e-3, atol=1e-4
    )


def test_particle_sharded_mesh_disables_fused_and_runs(ucsv_setup):
    """With the particle axis sharded, the batched filter runs correctly
    under GSPMD."""
    prior, y = ucsv_setup
    mesh = make_mesh(4, 2)
    cfg = _ucsv_cfg()

    sh = ShardedSMC2(smc.SMC2(smc.ucsv_model, prior, cfg), mesh)
    state = sh.init(jax.random.key(0), y)
    state, info = sh.step(state, y)
    assert np.isfinite(float(state.ess))
    assert int(state.t) == 2


def test_sharded_adaptive_cond_matches_unsharded(ucsv_setup):
    """The ADAPTIVE inner-resampling route (round 5: the whole resample
    stage under one lax.cond) composed with θ-sharding must reproduce the
    unsharded adaptive route."""
    prior, y = ucsv_setup

    def cfg():
        inner = smc.PFConfig("systematic", 0.5)
        return smc.SMCConfig(
            n_particles=256, n_theta=32, chain=2, ess_threshold=0.5,
            inner=inner,
        )

    base = smc.SMC2(smc.ucsv_model, prior, cfg())
    ref = base.init(jax.random.key(0), y)
    for _ in range(3):
        ref, _ = base.step(ref, y)

    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    sh = ShardedSMC2(smc.SMC2(smc.ucsv_model, prior, cfg()), mesh)
    state = sh.init(jax.random.key(0), y)
    for _ in range(3):
        state, _ = sh.step(state, y)

    np.testing.assert_allclose(
        np.asarray(state.particles), np.asarray(ref.particles),
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(state.log_w), np.asarray(ref.log_w), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(state.log_omega), np.asarray(ref.log_omega),
        rtol=1e-4, atol=1e-4,
    )
