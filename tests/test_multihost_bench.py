"""The multi-host scaling-efficiency harness runs green on the CPU rig
(VERDICT r3 #5). The efficiency NUMBER on CPU virtual devices is not
meaningful (all virtual devices share the same cores and collectives ride
localhost gRPC); the test asserts the harness mechanics — both rigs
launch, time, and report."""
import json
import os
import subprocess
import sys
from pathlib import Path

HARNESS = Path(__file__).parent.parent / "benchmarks" / "bench_multihost.py"


def test_multihost_bench_harness_runs():
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, str(HARNESS), "--m", "32", "--n", "64", "--t", "12",
         "--steps", "3"],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    assert rec["metric"] == "smc2_theta_sharded_scaling_2proc"
    assert rec["t_1proc_s"] > 0 and rec["t_2proc_s"] > 0
    assert 0 < rec["efficiency"]
