"""Opt-in slow statistical cross-check (VERDICT r3 #8 as a test).

Runs benchmarks/crosscheck_flagship.py --quick: density-tempered SMC vs
online SMC² must agree on the UC-SV θ-posterior within MC error on the
vendored PCE series. ~5-10 min on CPU, so gated behind SMC_SLOW_TESTS=1.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HARNESS = Path(__file__).parent.parent / "benchmarks" / "crosscheck_flagship.py"


@pytest.mark.skipif(
    os.environ.get("SMC_SLOW_TESTS") != "1",
    reason="slow opt-in check (set SMC_SLOW_TESTS=1); flagship-size result "
    "recorded in BASELINE.md",
)
def test_samplers_crosscheck_quick():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(HARNESS), "--quick"],
        env=env, capture_output=True, text=True, timeout=1800,
    )
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    assert rec["agree"] is True, rec
