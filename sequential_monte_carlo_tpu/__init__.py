"""sequential_monte_carlo_tpu — a Sequential Monte Carlo engine in JAX.

A from-scratch JAX/XLA framework with the capabilities of
charlesknipp/sequential_monte_carlo (SequentialMonteCarlo.jl): state-space
models, particle/Kalman filters, and joint state+parameter inference via
density-tempered SMC, online SMC², and IBIS — redesigned around `vmap`/
`lax.scan`/`shard_map` instead of per-particle loops and threads.

Layer map (SURVEY.md §1):
  distributions/  L0  pure-JAX distribution kit
  models/         L1  SSM protocol + model zoo + declarative DSL
  ops/            L2  weight math, resamplers, particle & Kalman filters
  samplers/       L3  SMC², density-tempered SMC, IBIS, PMMH rejuvenation
  parallel/       L4  device meshes, sharded sampler steps, collectives
  analysis/       L6  posterior summaries and plotting
"""

from . import analysis, distributions, models, ops, parallel, samplers, utils
from .distributions import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .samplers import *  # noqa: F401,F403

__version__ = "0.6.0"
