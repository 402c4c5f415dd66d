"""Extended measurements on one NVIDIA GPU, one JSON line per metric.

``bench.py`` compares the tiers on the hovering throughput workload; this
tool times the other workloads the benchmark's cells are to be built from
(ROADMAP S1):

* ``latency``  — per-solve latency at B=1/8/128 against the 10 ms budget of
  the reference's 100 Hz configuration (fused and scan tiers);
* ``mission``  — a 70-tick warm hovering mission at B=4,096, adaptive ticks
  (tol 1e-3, checked every iteration) on the fused and scan tiers;
* ``fleet``    — random-LTI plants (nx=12, nu=4, N=10) at B=16,384 on the
  scan and instance-ops fleet tiers, 100 fixed iterations;
* ``horizon``  — N=256, B=2,048 on the scan and block tiers;
* ``rho``      — per-instance adaptive rho (scan engine) at B=16,384 with
  a quarter of the instances at a rho mis-scaled by 100x;
* ``riccati``  — batched Riccati cache builds at B=4,096 (vmapped fixed
  point cold, Newton-Kleinman warm);
* ``roofline`` — the fused kernel's achieved f32 FLOP/s at B=1,048,576
  against the published peak of the card (``utils.profiling.PEAKS``).

Every time is the best of ``--reps`` wall-clock runs ending in
``block_until_ready`` after one warm-up run; compile time is reported
apart. Every line names the device. Fails when JAX finds no GPU.

    python tools/bench_suite.py [--only latency mission ...]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

GROUPS = ("latency", "mission", "fleet", "horizon", "rho", "riccati",
          "roofline")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS)
    ap.add_argument("--reps", type=int, default=5)
    opts = ap.parse_args()

    from accelerated_tinympc_tpu.utils import enable_compile_cache
    from accelerated_tinympc_tpu.utils.profiling import (
        gpu_name_and_power_limit, peaks, require_gpu, solver_cost,
    )

    enable_compile_cache()
    device = require_gpu()
    smi = gpu_name_and_power_limit()

    import jax
    import jax.numpy as jnp

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.api import fused_mpc_rollout, mpc_rollout
    from accelerated_tinympc_tpu.models import random_lti_plants
    from accelerated_tinympc_tpu.ops import FusedCarry, fused_solve, pad_problem
    from accelerated_tinympc_tpu.precompute import (
        condensed_operators, riccati_caches_batched,
    )
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched, solve_batched,
    )

    def emit(metric, value, unit, **extra):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          **extra, "nvidia_smi": smi, "device": device}),
              flush=True)

    def timed(fn, *args):
        """(compile_s, best_s) of ``jax.jit(fn)`` on ``args``."""
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(compiled(*args))
        best = float("inf")
        for _ in range(opts.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(*args))
            best = min(best, time.perf_counter() - t0)
        return compile_s, best

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    pp = pad_problem(problem, cache, condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon))
    rng = np.random.default_rng(0)

    def perturbed(batch, scale=0.05):
        return jnp.asarray(
            np.asarray(x0)[None] + scale * rng.standard_normal((batch, 12)),
            jnp.float32)

    def scan_state(x0s, n=12, m=4, N=10):
        st = init_state_batched(x0s.shape[0], n, m, N)
        return st.replace(x=st.x.at[:, 0, :].set(x0s))

    fixed100 = atm.Settings(max_iter=100, check_termination=0)

    if "latency" in opts.only:
        for B in (1, 8, 128):
            x0s = perturbed(B)
            c, t = timed(lambda x: fused_solve(
                x, FusedCarry.zeros(B, pp), pp, max_iter=100).U, x0s)
            emit("fused_fixed100_latency", t * 1e3, "ms", batch=B,
                 compile_s=c, budget_ms=10.0)
            c, t = timed(lambda s: solve_batched(
                s, problem, cache, fixed100).u, scan_state(x0s))
            emit("scan_fixed100_latency", t * 1e3, "ms", batch=B,
                 compile_s=c, budget_ms=10.0)

    if "mission" in opts.only:
        B, T = 4096, 70
        adaptive = atm.Settings(max_iter=100, check_termination=1)
        x0s = perturbed(B, 0.01)
        c, t = timed(lambda x: fused_mpc_rollout(
            pp, x, T, problem=problem, max_iter=100,
            check_termination=1)[1], x0s)
        emit("fused_mission_tick", t / T * 1e3, "ms", batch=B, ticks=T,
             compile_s=c, solves_per_s=B * T / t)
        c, t = timed(lambda x: mpc_rollout(
            problem, cache, adaptive, x, T, batched=True)[2].u, x0s)
        emit("scan_mission_tick", t / T * 1e3, "ms", batch=B, ticks=T,
             compile_s=c, solves_per_s=B * T / t)

    if "fleet" in opts.only:
        B = 16_384
        A, Bm, Q, R = random_lti_plants(B, 12, 4, seed=1)
        x0s = (0.4 * rng.standard_normal((B, 12))).astype(np.float32)
        for tier in ("scan", "instance_ops"):
            t0 = time.perf_counter()
            f = atm.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=10,
                                       u_min=-3.0, u_max=3.0,
                                       settings=fixed100, tier=tier)
            jax.block_until_ready(f.cache.Kinf)
            setup_s = time.perf_counter() - t0
            f.set_x0(x0s)
            f.solve()
            t0 = time.perf_counter()
            f.solve()
            jax.block_until_ready(f.get_u())
            t = time.perf_counter() - t0
            emit(f"fleet_{tier}_fixed100_solves_per_s", B / t, "solves/s",
                 batch=B, setup_s=setup_s, solve_s=t,
                 note="one warm call through TinyMPCFleet.solve "
                      "(includes its per-call retrace)")

    if "horizon" in opts.only:
        from accelerated_tinympc_tpu.models import random_lti_problem
        from accelerated_tinympc_tpu.precompute import riccati_cache
        from accelerated_tinympc_tpu.solver.block_condensed import (
            block_sweeps,
        )

        B, N = 2048, 256
        lp, rho = random_lti_problem(seed=0, nx=12, nu=4, horizon=N)
        lc = riccati_cache(np.asarray(lp.A), np.asarray(lp.B),
                           np.asarray(lp.Q), np.asarray(lp.R), rho)
        st = scan_state(jnp.asarray(0.3 * rng.standard_normal((B, 12)),
                                    jnp.float32), N=N)
        c, t = timed(lambda s: solve_batched(s, lp, lc, fixed100).u, st)
        emit("horizon256_scan_solves_per_s", B / t, "solves/s", batch=B,
             compile_s=c)
        fwd, bwd = block_sweeps(lc, lp.A, lp.B, N, 32)
        c, t = timed(lambda s: solve_batched(
            s, lp, lc, fixed100, forward=fwd, backward=bwd).u, st)
        emit("horizon256_block32_solves_per_s", B / t, "solves/s", batch=B,
             compile_s=c)

    if "rho" in opts.only:
        B = 16_384
        A, Bm, Q, R = random_lti_plants(B, 12, 4, seed=2)
        rho0 = np.where(np.arange(B) % 4 == 0, 1e-2, 1.0).astype(np.float32)
        f = atm.TinyMPCFleet.setup(
            A, Bm, Q, R, rho=rho0, horizon=10, u_min=-3.0, u_max=3.0,
            settings=atm.Settings(max_iter=100, check_termination=1))
        f.set_x0((0.4 * rng.standard_normal((B, 12))).astype(np.float32))
        t0 = time.perf_counter()
        info = f.solve_adaptive_rho(engine="scan", chunk=25, max_rounds=20)
        t = time.perf_counter() - t0
        emit("adaptive_rho_scan_solves_per_s", B / t, "solves/s", batch=B,
             rounds=info["rounds"],
             solved_fraction=float(np.mean(info["solved"])),
             note="first call, compile included")

    if "riccati" in opts.only:
        B = 4096
        A, Bm, Q, R = (jnp.asarray(a) for a in random_lti_plants(B, 12, 4))
        rho = jnp.ones((B,), jnp.float32)
        c, t = timed(riccati_caches_batched, A, Bm, Q, R, rho)
        emit("riccati_fixed_point_caches_per_s", B / t, "caches/s", batch=B,
             compile_s=c)
        warm = riccati_caches_batched(A, Bm, Q, R, rho)
        c, t = timed(lambda r, w: riccati_caches_batched(
            A, Bm, Q, R, r, warm=w, newton=True), rho * 2.0, warm)
        emit("riccati_newton_warm_caches_per_s", B / t, "caches/s", batch=B,
             compile_s=c)

    if "roofline" in opts.only:
        B = 1_048_576
        x0s = perturbed(B)
        c, t = timed(lambda x: fused_solve(
            x, FusedCarry.zeros(B, pp), pp, max_iter=100).U, x0s)
        cost = solver_cost(12, 4, 10, 100)
        flops = cost["flops_padded"] * B / t
        emit("fused_f32_flops", flops, "FLOP/s", batch=B, compile_s=c,
             share_of_f32_peak=flops / peaks(device["kind"])["f32_flops"],
             useful_flops=cost["flops"] * B / t)


if __name__ == "__main__":
    main()
