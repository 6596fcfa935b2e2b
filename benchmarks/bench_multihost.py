"""Multi-host scaling-efficiency harness (VERDICT r3 #5; SURVEY.md §5.8).

Times the θ-sharded SMC² online step at a FIXED global (M, N) on a
1-process mesh vs an n-process `jax.distributed` mesh and prints the
strong-scaling efficiency

    efficiency = t_1proc / (n_proc · t_nproc)

Each process owns ``--devices-per-proc`` virtual CPU devices, so the
n-process run has n× the devices of the baseline — ideal scaling halves
the wall-clock at n=2. The numbers characterize the HARNESS (host-sync
behavior, number of collectives) on the CPU backend; every process is
pinned to the CPU, and the one-process four-card GPU path is
``python chip_smoke.py --four-cards``.

This is the scaling analog of the reference's only parallelism —
``Threads.@threads`` over θ (/root/reference/src/smc_samplers.jl:112,174,223)
— moved to a host-spanning device mesh.

Two driver configurations (VERDICT r4 #7 — report BOTH in BASELINE.md):

  * default (M=128, N=256, 16 steps): per-step device work is tens of ms,
    comparable to localhost-gRPC sync — the measured efficiency mixes
    core contention with collective latency (a lower bound).
  * ``--compute-bound`` (M=64, N=16384, 4 steps): per-step device work is
    hundreds of ms, ≫ sync cost — the efficiency then isolates the
    collective COUNT/structure of the sharded step (how much work the
    program duplicates or serializes across hosts), which is the part
    this rig CAN characterize. Core contention still applies where
    virtual devices outnumber physical cores.

Usage (driver, CPU): python benchmarks/bench_multihost.py
  [--procs 2] [--m 128] [--n 256] [--t 32] [--devices-per-proc 4]
  [--compute-bound]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# worker: one process of the distributed rig
# ---------------------------------------------------------------------------

def worker(addr: str, pid: int, nproc: int, m: int, n: int, t: int,
           steps: int, devices: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={devices}"
        ).strip()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import sequential_monte_carlo_tpu as smc
    from sequential_monte_carlo_tpu.parallel import (
        ShardedSMC2,
        initialize_distributed,
        make_global_mesh,
    )

    if nproc > 1:
        initialize_distributed(
            coordinator_address=addr, num_processes=nproc, process_id=pid
        )
        mesh = make_global_mesh()
    else:
        from sequential_monte_carlo_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()

    prior = smc.product_distribution(
        [
            smc.TruncatedNormal(jnp.asarray(0.0), jnp.asarray(1.0),
                                jnp.asarray(-1.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
            smc.LogNormal(jnp.asarray(0.0), jnp.asarray(1.0)),
        ]
    )
    m_true = smc.lg_model(jnp.array([0.5, 0.9, 0.8]))
    _, y = smc.simulate(jax.random.key(1998), m_true, t)
    y = np.asarray(y)  # replicated input on every process

    cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=2, ess_threshold=0.5)
    sharded = ShardedSMC2(smc.SMC2(smc.lg_model, prior, cfg), mesh)

    # warm-up: compile init + step
    state = sharded.init(jax.random.key(0), y)
    state, _ = sharded.step(state, y)
    jax.block_until_ready(state.log_omega)

    state = sharded.init(jax.random.key(1), y)
    jax.block_until_ready(state.log_omega)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = sharded.step(state, y)
    jax.block_until_ready(state.log_omega)
    elapsed = time.perf_counter() - t0

    print(json.dumps({
        "process": pid,
        "n_proc": nproc,
        "devices": len(jax.devices()),
        "elapsed_s": round(elapsed, 4),
        "per_step_ms": round(1e3 * elapsed / steps, 3),
        "ess": float(state.ess),
    }), flush=True)


# ---------------------------------------------------------------------------
# driver: launch 1-process baseline, then the n-process rig
# ---------------------------------------------------------------------------

def _launch(nproc: int, args) -> list[dict]:
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.devices_per_proc}"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", addr, str(i), str(nproc),
             "--m", str(args.m), "--n", str(args.n), "--t", str(args.t),
             "--steps", str(args.steps),
             "--devices-per-proc", str(args.devices_per_proc)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{out}\n{err}")
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(line))
    return outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=3, metavar=("ADDR", "PID", "NPROC"))
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--compute-bound", action="store_true",
                    help="preset: M=64, N=16384, 4 steps, T=8 — per-shard "
                         "compute dominates gRPC sync (VERDICT r4 #7)")
    args = ap.parse_args()
    if args.compute_bound and not args.worker:
        args.m, args.n, args.t, args.steps = 64, 16384, 8, 4

    if args.worker:
        addr, pid, nproc = args.worker
        worker(addr, int(pid), int(nproc), args.m, args.n, args.t,
               args.steps, args.devices_per_proc)
        return

    base = _launch(1, args)[0]
    multi = _launch(args.procs, args)
    # all processes run the same global program; take the max elapsed
    t_multi = max(o["elapsed_s"] for o in multi)
    eff = base["elapsed_s"] / (args.procs * t_multi)
    # On a rig whose processes share physical cores, adding processes adds
    # NO compute: the best possible "efficiency" is cores-limited. Report
    # the ceiling so the measured number is read against it — efficiency
    # ≈ ceiling means the sharded step's collective structure adds ~no
    # overhead beyond core contention (all this rig can certify).
    cores = os.cpu_count() or 1
    # baseline saturates min(cores, devices_per_proc) cores; the n-proc run
    # gets at most `cores` for n× that demand
    ceiling = min(
        1.0, cores / (args.procs * min(cores, args.devices_per_proc))
    )
    print(json.dumps({
        "metric": f"smc2_theta_sharded_scaling_{args.procs}proc",
        "global_m": args.m,
        "global_n": args.n,
        "steps": args.steps,
        "t_1proc_s": base["elapsed_s"],
        f"t_{args.procs}proc_s": t_multi,
        "efficiency": round(eff, 3),
        "physical_cores": cores,
        "core_ceiling": round(ceiling, 3),
        "compute_bound": bool(args.compute_bound),
        "note": (
            "CPU virtual-device rig: characterizes harness sync behavior"
        ),
    }))


if __name__ == "__main__":
    main()
