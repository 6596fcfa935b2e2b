"""Driver contract: entry() compiles single-device; dryrun_multichip runs
on the virtual 8-device mesh."""
import sys
from pathlib import Path

import jax
import numpy as np


sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    state, info = out
    assert np.isfinite(float(state.ess))
    assert int(state.t) == 2


def test_dryrun_multichip_8():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_dryrun_multichip_4():
    import __graft_entry__ as ge

    ge.dryrun_multichip(4)
