"""Multi-host launcher integration test (SURVEY.md §5.8, §7.6).

Launches TWO OS processes against a localhost ``jax.distributed``
coordinator, each owning 4 virtual CPU devices; the global (theta=8)
mesh spans both — the CPU-backend twin of a 2-host deployment. This is the
host-level replacement for the reference's ``Threads.@threads`` θ-loop
(/root/reference/src/smc_samplers.jl:112).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_smc2():
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).parent.parent)
    env.pop("JAX_PLATFORMS", None)  # worker sets its own
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), addr, str(i), "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        outs.append(json.loads(line))

    assert {o["process"] for o in outs} == {0, 1}
    # both processes ran the same global program: identical posterior stats
    assert outs[0]["t"] == outs[1]["t"] == 24
    assert outs[0]["ess"] == outs[1]["ess"]
    assert outs[0]["theta_hat"] == outs[1]["theta_hat"]
