"""Tier comparison on one GPU: batched quadrotor-hovering solves/s.

Workload: the reference's hovering problem (nx=12, nu=4, N=10 — reference:
src/tinympc/glob_opts.hpp:5-8) at a fixed 100 ADMM iterations per solve (the
reference's max_iter ceiling, examples/quadrotor_hovering.cpp:75;
fixed-iteration for determinism), over seeded perturbed initial states.

Each (tier, batch) pair is compiled ahead of time (compile time reported
apart), run once for its controls, then timed as the best of ``--reps``
wall-clock runs that end in ``block_until_ready``. Every non-scan tier's
controls are compared with the scan tier's at the same batch (max |Δu|).
``--sweep`` also times the fused kernel over batch tiles and warp counts.

Fails (exit != 0) when JAX finds no GPU. Prints one JSON line per
measurement and, last, one summary JSON line with the device.

    python bench.py --batches 65536 1048576
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[65536, 1048576])
    ap.add_argument("--tiers", nargs="+", default=["scan", "condensed", "fused"])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-tile", type=int, default=None)
    ap.add_argument("--num-warps", type=int, default=None)
    ap.add_argument("--sweep", nargs="*", default=None, metavar="TILExWARPS",
                    help="also time the fused kernel at these batch-tile x "
                         "warp-count pairs (e.g. 32x8 64x16) at the first "
                         "batch; no pairs = {16,32,64} x {2,4,8}")
    opts = ap.parse_args()

    from accelerated_tinympc_tpu.utils import enable_compile_cache
    from accelerated_tinympc_tpu.utils.profiling import (
        gpu_name_and_power_limit, memory_summary, require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    smi = gpu_name_and_power_limit()
    print(f"nvidia-smi: {smi}", flush=True)

    import jax
    import jax.numpy as jnp

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.ops import fused_admm
    from accelerated_tinympc_tpu.precompute import condensed_operators
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched, solve_batched,
    )
    from accelerated_tinympc_tpu.solver.condensed import (
        flatten_problem, init_flat_state, solve_condensed,
    )

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    nx, nu, N = problem.nx, problem.nu, problem.horizon
    settings = atm.Settings(max_iter=opts.iters, check_termination=0)
    ops = condensed_operators(cache, np.asarray(problem.A),
                              np.asarray(problem.B), N)
    pp = fused_admm.pad_problem(problem, cache, ops)
    fp = flatten_problem(problem, cache)

    def controls(tier, x0s, bt=None, nw=None):
        """Jitted ``x0s -> (B, (N-1)*nu)`` controls for one tier."""
        B = x0s.shape[0]
        if tier == "scan":
            def f(x):
                st = init_state_batched(B, nx, nu, N)
                st = st.replace(x=st.x.at[:, 0, :].set(x))
                return solve_batched(st, problem, cache,
                                     settings).u.reshape(B, -1)
        elif tier == "condensed":
            def f(x):
                st = init_flat_state(B, nx, nu, N).replace(x0=x)
                return solve_condensed(st, fp, ops, settings, nx).U
        else:
            kw = {}
            if bt:
                kw["batch_tile"] = bt
            if nw:
                kw["num_warps"] = nw

            def f(x):
                res = fused_admm.fused_solve(
                    x, fused_admm.FusedCarry.zeros(B, pp), pp,
                    max_iter=opts.iters, **kw)
                return res.U[:, :(N - 1) * nu]
        return jax.jit(f)

    def measure(tier, x0s, ref_u, **kw):
        B = x0s.shape[0]
        t0 = time.perf_counter()
        compiled = controls(tier, x0s, **kw).lower(x0s).compile()
        compile_s = time.perf_counter() - t0
        u = jax.block_until_ready(compiled(x0s))
        times = []
        for _ in range(opts.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(x0s))
            times.append(time.perf_counter() - t0)
        best = min(times)
        row = {
            "tier": tier, "batch": B, **{k: v for k, v in kw.items() if v},
            "solve_s": best, "solves_per_s": B / best,
            "times_s": times, "compile_s": compile_s,
            "finite": bool(jnp.all(jnp.isfinite(u))),
            "memory": memory_summary(compiled),
        }
        if ref_u is not None:
            row["max_abs_du_vs_scan"] = float(jnp.max(jnp.abs(u - ref_u)))
        print(json.dumps(row), flush=True)
        return u, row

    rng = np.random.default_rng(opts.seed)
    rows = []
    for B in opts.batches:
        x0s = jnp.asarray(
            np.asarray(x0)[None] + 0.05 * rng.standard_normal((B, nx)),
            jnp.float32,
        )
        ref_u = None
        for tier in sorted(opts.tiers, key=lambda t: t != "scan"):
            kw = ({"bt": opts.batch_tile, "nw": opts.num_warps}
                  if tier == "fused" else {})
            u, row = measure(tier, x0s, ref_u, **kw)
            rows.append(row)
            if tier == "scan":
                ref_u = u
            del u
        if opts.sweep is not None and B == opts.batches[0]:
            pairs = [tuple(map(int, p.split("x"))) for p in opts.sweep] or [
                (bt, nw) for bt in (16, 32, 64) for nw in (2, 4, 8)]
            for bt, nw in pairs:
                rows.append(measure("fused", x0s, ref_u, bt=bt, nw=nw)[1])
        del ref_u, x0s

    peak = jax.devices()[0].memory_stats() or {}
    ok = all(r["finite"] for r in rows) and all(
        r.get("max_abs_du_vs_scan", 0.0) <= 1e-4 for r in rows)
    print(json.dumps({
        "ok": ok, "nvidia_smi": smi,
        "peak_bytes_in_use": peak.get("peak_bytes_in_use"),
        "device": device,
    }))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
