"""Mesh-sharded SMC² (L4 distributed layer).

Replaces the reference's single-process ``Threads.@threads`` θ-loop
(SURVEY.md §5.8) with a GSPMD-partitioned sampler: the SMC2State lives
sharded over a (theta, particle) mesh and the jitted step is compiled with
sharding-annotated inputs/outputs, so XLA inserts the collectives the
algorithm needs —

  * ``pmax``/``psum`` for the log-sum-exp normalize and global θ-ESS,
  * all-gathers for θ-resampling ancestry (O(M) scalars per step — tiny
    over DCN) and for cross-shard particle gathers after resampling,
  * everything else (propagate/reweight/PMMH accept) stays local to the
    shard: zero communication in the steady-state hot path.

``ShardedSMC2`` wraps a :class:`..samplers.SMC2` — identical numerics,
identical API — and only changes data placement.
"""
from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..samplers.smc2 import SMC2
from .mesh import make_mesh, shard_state, smc2_state_shardings


class ShardedSMC2:
    """SMC² over a (theta, particle) device mesh.

    Usage::

        mesh = make_mesh(n_theta_shards=4, n_particle_shards=2)
        sharded = ShardedSMC2(SMC2(model_fn, prior, cfg), mesh)
        state = sharded.init(key, y)      # state placed across the mesh
        state, info = sharded.step(state, y)
    """

    def __init__(self, sampler: SMC2, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.sampler = sampler
        self.shardings = smc2_state_shardings(self.mesh)
        repl = NamedSharding(self.mesh, P())
        self._init_jit = jax.jit(
            sampler._init_impl, out_shardings=self.shardings
        )
        self._step_jit = jax.jit(
            sampler._step_impl,
            in_shardings=(self.shardings, repl),
            out_shardings=(self.shardings, None),
            donate_argnums=(0,),
        )
        self._run_jit = jax.jit(
            sampler._run_impl, out_shardings=(self.shardings, None)
        )

    @property
    def config(self):
        return self.sampler.config

    def init(self, key, y):
        state = self._init_jit(key, jax.numpy.asarray(y))
        return state

    def step(self, state, y):
        return self._step_jit(state, jax.numpy.asarray(y))

    def run(self, key, y):
        """Whole-sequence fused scan, state sharded across the mesh."""
        return self._run_jit(key, jax.numpy.asarray(y))

    def reshard(self, state):
        """Place an existing (e.g. checkpointed) state onto this mesh."""
        return shard_state(state, self.shardings)


class ShardedIBIS:
    """IBIS with the θ-axis sharded over the mesh's ``theta`` axis.

    The Kalman bank is embarrassingly parallel over θ; only the θ-resample
    ancestry and global ESS cross shards (O(M) scalars per step)."""

    def __init__(self, ibis, mesh=None):
        from .mesh import ibis_state_shardings

        self.ibis = ibis
        self.mesh = mesh if mesh is not None else make_mesh()
        self.shardings = ibis_state_shardings(self.mesh)
        repl = NamedSharding(self.mesh, P())
        self._init_jit = jax.jit(ibis._init_impl, out_shardings=self.shardings)
        self._step_jit = jax.jit(
            ibis._step_impl,
            in_shardings=(self.shardings, repl),
            out_shardings=(self.shardings, None),
            donate_argnums=(0,),
        )
        self._run_jit = jax.jit(
            ibis._run_impl, out_shardings=(self.shardings, None)
        )

    @property
    def config(self):
        return self.ibis.config

    def init(self, key, y):
        return self._init_jit(key, jax.numpy.asarray(y))

    def step(self, state, y):
        return self._step_jit(state, jax.numpy.asarray(y))

    def run(self, key, y):
        return self._run_jit(key, jax.numpy.asarray(y))

    def reshard(self, state):
        return shard_state(state, self.shardings)
