"""Stock–Watson unobserved-components stochastic-volatility model (L1).

≡ /root/reference/src/state_space_models.jl:215-263. Nonlinear,
heteroskedastic, 3-dim state s = (x, log σε, log ση):

  x_t      ~ N(x_{t-1},      exp(½ log σε,t-1))     trend random walk
  logσε,t  ~ N(log σε,t-1,   γε)                    trend-vol random walk
  logση,t  ~ N(log ση,t-1,   γη)                    obs-vol random walk
  y_t      ~ N(x_t,          exp(½ log ση,t))       observation

(γε, γη are standard deviations, exactly as the reference passes them to
``Normal`` at state_space_models.jl:236-241.) The heterogeneous 3-component
transition uses :class:`TupleProduct` — SURVEY.md §0.2's missing helper,
realized natively. Everything is elementwise over the particle cloud: the
whole propagate+reweight step is elementwise work that XLA fuses.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..distributions import Normal, TupleProduct
from ..utils.struct import pytree_dataclass


@pytree_dataclass
class UCSVModel:
    gamma_eps: jnp.ndarray  # vol-of-vol of the trend-noise log-variance (std)
    gamma_eta: jnp.ndarray  # vol-of-vol of the obs-noise log-variance (std)
    x0: jnp.ndarray  # initial trend level
    log_sigma_eps0: jnp.ndarray  # initial log σε
    log_sigma_eta0: jnp.ndarray  # initial log ση

    @property
    def state_dim(self) -> int:
        return 3

    def initial_distribution(self):
        # ≡ state_space_models.jl:249-260
        return TupleProduct(
            (
                Normal(self.x0, jnp.exp(0.5 * self.log_sigma_eps0)),
                Normal(self.log_sigma_eps0, self.gamma_eps),
                Normal(self.log_sigma_eta0, self.gamma_eta),
            )
        )

    def transition_distribution(self, s):
        # ≡ state_space_models.jl:233-242
        x, log_se, log_sn = s[..., 0], s[..., 1], s[..., 2]
        return TupleProduct(
            (
                Normal(x, jnp.exp(0.5 * log_se)),
                Normal(log_se, self.gamma_eps),
                Normal(log_sn, self.gamma_eta),
            )
        )

    def observation_distribution(self, s):
        # ≡ state_space_models.jl:244-247
        return Normal(s[..., 0], jnp.exp(0.5 * s[..., 2]))


def unobserved_components_stochastic_volatility(
    x0, gamma_eps, gamma_eta, log_sigma_eps, log_sigma_eta
):
    """≡ the reference's keyword wrapper (state_space_models.jl:225-227)."""
    f = lambda v: jnp.asarray(v, dtype=jnp.result_type(float))
    return UCSVModel(
        gamma_eps=f(gamma_eps),
        gamma_eta=f(gamma_eta),
        x0=f(x0),
        log_sigma_eps0=f(log_sigma_eps),
        log_sigma_eta0=f(log_sigma_eta),
    )


def ucsv_model(theta):
    """θ ↦ UCSV with θ = (γ, x0, log σε0, log ση0), shared vol-of-vol γ — the
    4-parameter constructor used by the inflation example
    (``UCSV(θ[1],θ[2],(θ[3],θ[4]))``, examples/inflation_example.jl:229-232,
    prior at :235-240)."""
    return UCSVModel(
        gamma_eps=theta[0],
        gamma_eta=theta[0],
        x0=theta[1],
        log_sigma_eps0=theta[2],
        log_sigma_eta0=theta[3],
    )
