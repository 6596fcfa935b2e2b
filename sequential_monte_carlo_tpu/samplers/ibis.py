"""IBIS — SMC² with the exact Kalman inner filter (L3).

≡ /root/reference/src/ibis.jl: the resample-move-reweight skeleton of SMC²
with the inner particle filter replaced by the exact Kalman filter — per-θ
state is a (mean, cov) pair instead of a particle cloud; rejuvenation
re-runs the exact ``log_likelihood(y, model)`` (ibis.jl:100); there is no
exchange step (no N to double). Only valid for linear-Gaussian models.

Array shape: the M Kalman filters are one ``vmap`` bank — per step a handful
of (dx,dx) matmuls batched over M; rejuvenation is a ``lax.scan`` over
``chain`` of one batched masked Kalman sweep over (M, T).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..ops.kalman import (
    KalmanState,
    kalman_init,
    kalman_log_likelihood_masked,
    kalman_step,
)
from ..ops.resampling import get_resampler
from ..ops.weights import ess_from_log_weights
from ..utils.struct import replace
from .base import IBISState, SMCConfig, StepInfo
from .kernels import anneal_scales, kernel_chol, propose, rw_kernel_cov
from .smc2 import expected_parameters  # re-exported for IBIS states too

__all__ = ["IBIS", "expected_parameters"]


class IBIS:
    """Iterated Batch Importance Sampling over θ with exact marginals.

    Usage ≡ the reference (ibis.jl:26-33, :134-147)::

        ibis = IBIS(lg_model, prior, SMCConfig(n_theta=512, chain=3))
        state = ibis.init(key, y)             # ≡ smc²(ibis, y)
        for t in range(1, len(y)):
            state, info = ibis.step(state, y)  # ≡ smc²!(ibis, y, t)
    """

    def __init__(self, model_fn: Callable, prior, config: SMCConfig = SMCConfig()):
        self.model_fn = model_fn
        self.prior = prior
        self.config = config
        self._init_jit = jax.jit(self._init_impl)
        self._step_jit = jax.jit(self._step_impl)
        self._run_jit = jax.jit(self._run_impl)

    # -- init ---------------------------------------------------------------

    def _init_impl(self, key, y):
        cfg = self.config
        k_theta, k_state = jax.random.split(key)
        theta = self.prior.sample(k_theta, (cfg.n_theta,))
        models = jax.vmap(self.model_fn)(theta)

        # per-θ prior Kalman state = (x0, Σ0) (ibis.jl:38-40), then one
        # update with y[0] (ibis.jl:160-170)
        def first(m):
            out = kalman_step(m, kalman_init(m), y[0])
            return out.state.mean, out.state.cov, out.log_lik

        mean, cov, ll = jax.vmap(first)(models)
        return IBISState(
            theta=theta,
            log_omega=ll,
            mean=mean,
            cov=cov,
            log_z=ll,
            ess=ess_from_log_weights(ll),
            acc_ratio=jnp.asarray(0.0),
            key=k_state,
            t=jnp.asarray(1, dtype=jnp.int32),
        )

    def init(self, key, y) -> IBISState:
        return self._init_jit(key, jnp.asarray(y))

    # -- resample-move ------------------------------------------------------

    def _resample_theta(self, state: IBISState, key) -> IBISState:
        """≡ resample! (ibis.jl:73-84): co-reindex θ, Kalman states, logZ."""
        cfg = self.config
        w = jax.nn.softmax(state.log_omega)
        a = get_resampler(cfg.theta_resampling)(key, w)
        return replace(
            state,
            theta=state.theta[a],
            mean=state.mean[a],
            cov=state.cov[a],
            log_z=state.log_z[a],
            log_omega=jnp.zeros_like(state.log_omega),
        )

    def _rejuvenate(self, state: IBISState, key, y, mask, xi) -> IBISState:
        """≡ rejuvenate! (ibis.jl:87-125) with the exact masked Kalman
        likelihood in place of the PF estimate."""
        cfg = self.config
        sigma = rw_kernel_cov(state.theta, cfg)
        chol = kernel_chol(sigma)
        scales = anneal_scales(cfg)

        def masked_ll(m):
            (mean, cov), logz = kalman_log_likelihood_masked(m, y, mask)
            return mean, cov, logz

        def chain_step(carry, inp):
            theta, mean, cov, log_z, accepted = carry
            k, scale = inp
            k_prop, k_acc = jax.random.split(k)

            theta_prop = propose(k_prop, theta, chol, scale)
            ok = self.prior.in_support(theta_prop)
            theta_safe = jnp.where(ok[:, None], theta_prop, theta)
            models = jax.vmap(self.model_fn)(theta_safe)
            mean_prop, cov_prop, logz_prop = jax.vmap(masked_ll)(models)

            lp_prop = self.prior.log_prob(theta_prop)
            lp_curr = self.prior.log_prob(theta)
            log_ratio = xi * (logz_prop - log_z) + (lp_prop - lp_curr)
            guard = (logz_prop + lp_prop) > -jnp.inf
            log_u = jnp.log(jax.random.uniform(k_acc, (cfg.n_theta,)))
            accept = ok & guard & (log_u < log_ratio)

            theta = jnp.where(accept[:, None], theta_prop, theta)
            mean = jnp.where(accept[:, None], mean_prop, mean)
            cov = jnp.where(accept[:, None, None], cov_prop, cov)
            log_z = jnp.where(accept, logz_prop, log_z)
            accepted = accepted | accept
            return (theta, mean, cov, log_z, accepted), None

        keys = jax.random.split(key, cfg.chain)
        init = (
            state.theta,
            state.mean,
            state.cov,
            state.log_z,
            jnp.zeros(cfg.n_theta, dtype=bool),
        )
        (theta, mean, cov, log_z, accepted), _ = jax.lax.scan(
            chain_step, init, (keys, scales)
        )
        return replace(
            state,
            theta=theta,
            mean=mean,
            cov=cov,
            log_z=log_z,
            log_omega=jnp.zeros_like(state.log_omega),
            ess=jnp.asarray(float(cfg.n_theta)),
            acc_ratio=jnp.mean(accepted.astype(state.theta.dtype)),
        )

    # -- online step --------------------------------------------------------

    def _step_impl(self, state: IBISState, y):
        cfg = self.config
        T = y.shape[0]
        key, k_resample, k_rejuv = jax.random.split(state.key, 3)
        state = replace(state, key=key)

        degenerate = state.ess < cfg.ess_min

        def do_rejuv(st):
            st = self._resample_theta(st, k_resample)
            mask = (jnp.arange(T) < state.t).astype(y.dtype)
            return self._rejuvenate(st, k_rejuv, y, mask, jnp.asarray(1.0))

        state = jax.lax.cond(degenerate, do_rejuv, lambda s: s, state)

        # exact propagate ≡ ibis.jl:172-184
        yt = jax.lax.dynamic_index_in_dim(y, state.t, keepdims=False)
        models = jax.vmap(self.model_fn)(state.theta)

        def prop(m, mean, cov):
            out = kalman_step(m, KalmanState(mean, cov), yt)
            return out.state.mean, out.state.cov, out.log_lik

        mean, cov, ll = jax.vmap(prop)(models, state.mean, state.cov)
        prev_lse = jax.scipy.special.logsumexp(state.log_omega)
        log_omega = state.log_omega + ll
        log_z = state.log_z + ll
        ess = ess_from_log_weights(log_omega)
        evidence_incr = jax.scipy.special.logsumexp(log_omega) - prev_lse

        state = replace(
            state,
            mean=mean,
            cov=cov,
            log_omega=log_omega,
            log_z=log_z,
            ess=ess,
            t=state.t + 1,
        )
        info = StepInfo(
            ess=ess,
            rejuvenated=degenerate,
            acc_ratio=state.acc_ratio,
            log_evidence_incr=evidence_incr,
        )
        return state, info

    def step(self, state: IBISState, y):
        return self._step_jit(state, jnp.asarray(y))

    # -- fused run ----------------------------------------------------------

    def _run_impl(self, key, y):
        state = self._init_impl(key, y)

        def scan_step(st, _):
            st, info = self._step_impl(st, y)
            return st, info

        return jax.lax.scan(scan_step, state, None, length=y.shape[0] - 1)

    def run(self, key, y):
        """Whole-sequence online IBIS as one compiled scan."""
        return self._run_jit(key, jnp.asarray(y))
