"""Device-time profile of the scanned SMC² inner filter step on a GPU.

Traces a jitted ``lax.scan`` of ``batched_pf_step`` on the UC-SV model at
(M, N) with ``jax.profiler`` and reduces the GPU device plane of the trace
to device time per named scope, per step: ``pf_resample``,
``pf_propagate`` (the draws), ``pf_reweight`` (the observation density,
nested in ``pf_propagate``) and ``pf_normalize``. Each kernel is
attributed through the ``op_name`` metadata of its HLO instruction in the
compiled program (``hlo_scopes``); device copies count as ``memcpy``, and
kernels outside every scope as ``other``. ``top_kernels`` also lists every
scope a fused kernel touches. ``busy`` is the union of the kernel intervals
over the window, per step.

Usage: python benchmarks/profile_step.py [--m 512] [--n 8192] [--iters 20]
           [--out profile_512x8192.json]
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"),
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import gpu_name_and_power_limit  # noqa: E402

SCOPES = ("pf_resample", "pf_propagate", "pf_reweight", "pf_normalize")
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = ")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name → (label, every scope it touches). The label is
    the innermost SCOPES entry in the instruction's own ``op_name`` (for a
    fusion, that of its root); without one, the scopes of the fused
    computation's instructions joined with "+"; with none, "other"."""
    own, calls, members = {}, {}, collections.defaultdict(list)
    comp = None
    for line in hlo_text.splitlines():
        mc = _COMP.match(line)
        if mc and " = " not in line:
            comp = mc.group(1)
            continue
        mi = _INSTR.match(line)
        if not mi:
            continue
        name = mi.group(1)
        members[comp].append(name)
        mo = _OP_NAME.search(line)
        hits = [p for p in mo.group(1).split("/") if p in SCOPES] if mo else []
        own[name] = hits[-1] if hits else None
        mcall = _CALLS.search(line)
        if mcall:
            calls[name] = mcall.group(1)

    def touched(name, depth=0):
        out = {own[name]} if own.get(name) else set()
        if name in calls and depth < 4:
            for m in members.get(calls[name], ()):
                out |= touched(m, depth + 1)
        return out

    out = {}
    for name in own:
        every = "+".join(sc for sc in SCOPES if sc in touched(name)) or "other"
        out[name] = (own[name] or every, every)
        # GPU kernels carry the instruction name with "." and "-" as "_"
        out.setdefault(re.sub(r"[.\-]", "_", name), out[name])
    return out


def _intervals_union(iv):
    total, end = 0.0, float("-inf")
    for s, e in sorted(iv):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def reduce_trace(profile, scope_of: dict, plane_prefix: str = "/device:GPU"):
    """Sum device durations per scope over the planes named
    ``plane_prefix*`` (kernel lines only: "Stream" lines where the plane
    has them). Returns ({label: ns}, busy_ns, line names seen,
    {(kernel, hlo_op, label, every scope): ns})."""
    per_scope, per_kernel = collections.Counter(), collections.Counter()
    iv, seen = [], set()
    for plane in profile.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            seen.add(line.name)
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                op = stats.get("hlo_op", ev.name)
                if op not in scope_of:
                    # inside a CUDA graph hlo_op is "command_buffer" and the
                    # kernel's own name identifies the instruction
                    op = ev.name if ev.name in scope_of else op
                if "hlo_op" not in stats and op not in scope_of:
                    continue  # not an XLA kernel (thread-pool markers etc.)
                if ev.name.lower().startswith("memcpy"):
                    label, every = "memcpy", "memcpy"
                else:
                    label, every = scope_of.get(op, ("other", "other"))
                per_scope[label] += ev.duration_ns
                per_kernel[(ev.name, op, label, every)] += ev.duration_ns
                iv.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    return dict(per_scope), _intervals_union(iv), sorted(seen), per_kernel


def profile(m: int, n: int, iters: int, ess_threshold: float = 1.0,
            uniform_weights: bool = False, plane_prefix: str = "/device:GPU",
            top: int = 16):
    """Trace ``iters`` scanned steps at (m, n); per-step device time per
    scope in microseconds, plus busy time, the ``top`` kernels and the
    trace's line names."""
    from sequential_monte_carlo_tpu.models.ucsv import ucsv_model
    from sequential_monte_carlo_tpu.ops.batched_filter import batched_pf_step
    from sequential_monte_carlo_tpu.ops.particle_filter import PFConfig

    theta = jnp.tile(jnp.asarray([[0.5, 3.0, 0.2, 0.2]]), (m, 1))
    models = jax.vmap(ucsv_model)(theta)
    cfg = PFConfig("systematic", ess_threshold)
    xp = jax.random.normal(jax.random.key(6), (m, n, 3), jnp.float32)
    lw = jnp.full((m, n), -jnp.log(float(n)))

    @jax.jit
    def chain(key, xp, lw):
        def body(carry, k):
            xp, lw = carry
            if uniform_weights:
                lw = jnp.full_like(lw, -jnp.log(float(n)))
            out = batched_pf_step(k, models, xp, lw, jnp.float32(2.5), cfg)
            return (out.particles, out.log_weights), None

        keys = jax.random.split(key, iters)
        (xp, lw), _ = jax.lax.scan(body, (xp, lw), keys)
        return xp, lw

    compiled = chain.lower(jax.random.key(0), xp, lw).compile()
    scope_of = hlo_scopes(compiled.as_text())
    jax.block_until_ready(compiled(jax.random.key(0), xp, lw))

    with tempfile.TemporaryDirectory(prefix="smc_profile_") as tracedir:
        with jax.profiler.trace(tracedir):
            jax.block_until_ready(compiled(jax.random.key(1), xp, lw))
        path = sorted(glob.glob(f"{tracedir}/**/*.xplane.pb", recursive=True))[-1]
        data = jax.profiler.ProfileData.from_file(path)
        per_scope, busy, lines, per_kernel = reduce_trace(
            data, scope_of, plane_prefix)
    us = lambda ns: ns / 1e3 / iters  # noqa: E731
    return {
        "m": m, "n": n, "iters": iters, "ess_threshold": ess_threshold,
        "us_per_step": {k: us(v) for k, v in sorted(per_scope.items())},
        "busy_us_per_step": us(busy),
        "top_kernels": [[*key, us(ns)]
                        for key, ns in per_kernel.most_common(top)],
        "trace_lines": lines,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--top", type=int, default=16,
                   help="report this many kernels by device time")
    p.add_argument("--ess-threshold", type=float, default=1.0,
                   help="<1 profiles the ADAPTIVE route (VERDICT r4 #2): "
                        "steps where no row's ESS trigger fires take the "
                        "lax.cond skip branch")
    p.add_argument("--uniform-weights", action="store_true",
                   help="reset log-weights to -log N before every step: "
                        "with --ess-threshold < 1 the trigger never fires, "
                        "profiling the pure SKIP branch")
    p.add_argument("--out", help="also write the result JSON to this path")
    args = p.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"profile_step: needs a GPU, found {dev.platform}")
    res = profile(args.m, args.n, args.iters, args.ess_threshold,
                  args.uniform_weights, top=args.top)
    res.update(device_kind=dev.device_kind,
               gpu=gpu_name_and_power_limit())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
