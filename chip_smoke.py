"""Smoke test of the batched TinyMPC engine on an NVIDIA GPU.

Drives the main path through the user entry points (``TinyMPC``,
``mpc_rollout`` / ``fused_mpc_rollout``, ``TinyMPCFleet``) at the sizes the
benchmark uses, runs the fused kernel as compiled for the card (never in
interpret mode), and compares every tier with the scan tier, which holds the
reference semantics. Phases:

1. golden parity on the scan tier (hovering, tracking, cartpole) against
   trajectories dumped from the compiled reference (``tests/golden/``);
2. hovering, 100 fixed iterations, B=1,048,576: every ``TinyMPC`` tier vs
   the scan tier;
3. adaptive (check every iteration, tol 1e-3), B=65,536: the fused kernel's
   per-instance iteration counts vs the scan tier's (equal, or one check
   apart where a residual sits on the tolerance — the rule of
   ``accelerated_tinympc_tpu.utils.parity.compare_schedules``);
4. a 70-tick warm hovering mission, B=4,096: ``mpc_rollout`` vs
   ``fused_mpc_rollout``;
5. ``TinyMPCFleet`` with random-LTI plants (nx=12, nu=4, N=10, B=16,384):
   adaptive solve on the default tier vs ``instance_ops``, plus two rounds
   of ``solve_adaptive_rho(engine="scan")`` at B=4,096;
6. the ``gpu``-marked tests, in this process.

With ``--chips 4`` only the multi-device path runs: ``sharded_solve`` and
``sharded_fused_solve`` over a 4-device mesh at 4 x 262,144 instances, each
shard compared with a one-device solve of the same instances.

The first line is the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them. Every
phase prints one JSON line (tolerance, error against the scan tier,
compile time of its main program — null for the test phase —,
``memory_analysis()``, ``peak_bytes_in_use``). The last line
is ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when JAX finds no GPU or any phase fails.

    python chip_smoke.py            # one card
    python chip_smoke.py --chips 4  # the sharded path on four cards
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
U_TOL = 1e-4  # control-parity bar against the scan tier / the reference


def _aot(fn, *args):
    """Compile ``jax.jit(fn)`` for ``args``; returns (compiled, seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _report(name, tol, err, ok, compile_s, compiled=None, **extra):
    from accelerated_tinympc_tpu.utils.profiling import (
        memory_summary, peak_bytes_in_use,
    )

    rec = {
        "phase": name, "ok": bool(ok), "tol": tol, "err": float(err),
        "compile_s": None if compile_s is None else round(compile_s, 3),
        "memory": memory_summary(compiled) if compiled is not None else {},
        "peak_bytes_in_use": peak_bytes_in_use(), **extra,
    }
    print(json.dumps(rec), flush=True)
    if not ok:
        raise SystemExit(f"phase {name} failed: {rec}")


def _perturbed(x0, batch, scale, seed):
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    x = np.asarray(x0)[None] + scale * rng.standard_normal((batch, x0.size))
    return jnp.asarray(x, jnp.float32)


def phase_golden():
    """Scan tier vs the compiled reference's trajectories."""
    import numpy as np

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.models import cartpole as cp
    from golden_utils import load_traj_csv, run_mpc_loop

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    tp, tc, tx0, Xref_total = atm.models.quadrotor_tracking_setup()
    cpp = atm.models.cartpole_problem()
    cpp = cpp.replace(Q=cpp.Q + np.float32(cp.RHO), R=cpp.R + np.float32(cp.RHO))
    ccache = atm.riccati_cache(cp.A, cp.B, cp.Q_DIAG, cp.R_DIAG, cp.RHO)
    cases = [
        ("hovering_fixed50", problem, cache, x0, 50, 0, 70, None, 12, 4),
        ("hovering_adaptive", problem, cache, x0, 100, 1, 70, None, 12, 4),
        ("tracking_fixed25", tp, tc, tx0, 25, 0, 290, Xref_total, 12, 4),
        ("tracking_adaptive", tp, tc, tx0, 100, 1, 290, Xref_total, 12, 4),
        ("cartpole_fixed40", cpp, ccache, np.array([0.0, 0.0, 0.1, 0.0]),
         40, 0, 300, None, 4, 1),
        ("cartpole_adaptive", cpp, ccache, np.array([0.0, 0.0, 0.1, 0.0]),
         150, 1, 300, None, 4, 1),
    ]
    errs = {}
    t0 = time.perf_counter()
    for name, prob, ca, xi, it, chk, steps, xr, nx, nu in cases:
        settings = atm.Settings(max_iter=it, check_termination=chk)
        _, u0, _ = run_mpc_loop(prob, ca, settings, xi, steps=steps,
                                Xref_total=xr)
        errs[name] = float(np.max(np.abs(u0 - load_traj_csv(name, nx, nu)["u0"])))
    wall = time.perf_counter() - t0
    compiled, cs = _aot(atm.solve, atm.init_state(12, 4, 10), problem, cache,
                        atm.Settings(max_iter=100))
    err = max(errs.values())
    _report("golden_scan", U_TOL, err, err < U_TOL, cs, compiled,
            per_case=errs, wall_s=round(wall, 3))


def phase_tiers(batch=1_048_576):
    """Every TinyMPC tier vs the scan tier, hovering, 100 fixed iters."""
    import numpy as np

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.api.solver import TIERS
    from accelerated_tinympc_tpu.ops import FusedCarry, fused_solve

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    settings = atm.Settings(max_iter=100, check_termination=0)
    x0s = _perturbed(x0, batch, 0.05, seed=1)
    us, times = {}, {}
    for tier in sorted(TIERS, key=lambda t: t != "scan"):
        m = atm.TinyMPC.from_parts(problem, cache, settings=settings,
                                   batch=batch, tier=tier)
        m.set_x0(x0s)
        t0 = time.perf_counter()
        m.solve()
        u = m.get_u()
        t1 = time.perf_counter()
        m.solve()
        m.get_u()
        t2 = time.perf_counter()
        us[tier] = np.asarray(u).reshape(batch, -1)
        times[tier] = {"first_call_s": round(t1 - t0, 3),
                       "steady_call_s": round(t2 - t1, 3)}
        del m, u
    ref = us.pop("scan")
    errs = {t: float(np.max(np.abs(u - ref))) for t, u in us.items()}
    finite = all(bool(np.all(np.isfinite(u))) for u in us.values())
    if "fused" in us:
        m = atm.TinyMPC.from_parts(problem, cache, settings=settings,
                                   tier="fused")
        pp = m._pp
        compiled, cs = _aot(
            lambda x, c: fused_solve(x, c, pp, max_iter=100),
            x0s, FusedCarry.zeros(batch, pp))
    else:
        compiled, cs = None, 0.0
    err = max(errs.values())
    _report("tiers_fixed100_B1M", U_TOL, err, finite and err <= U_TOL, cs,
            compiled, per_tier=errs, times=times, batch=batch)


def phase_adaptive(batch=65_536, warm_ticks=10):
    """The fused kernel's per-instance iteration counts vs the scan tier's
    at the reference's settings (tol 1e-3, checked every iteration, at most
    100). ``warm_ticks`` fixed-iteration ticks of the mission warm both
    tiers identically (adaptive warm ticks would let knife-edge exits in
    early ticks change later ticks' warm starts), then both tiers solve one
    adaptive tick from the same measurement."""
    import numpy as np

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.ops import FusedCarry, fused_solve
    from accelerated_tinympc_tpu.utils.parity import compare_schedules

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    warm = atm.Settings(max_iter=100, check_termination=0)
    settings = atm.Settings(max_iter=100, check_termination=1,
                            abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    x0s = _perturbed(x0, batch, 0.05, seed=2)
    out, x_meas = {}, None
    for tier in ("scan", "fused"):
        m = atm.TinyMPC.from_parts(problem, cache, settings=warm,
                                   batch=batch, tier=tier)
        m.set_x0(x0s)
        xf, _us = m.rollout(warm_ticks)
        x_meas = xf if x_meas is None else x_meas
        m.settings = settings
        m.reset_duals()
        m.set_x0(x_meas)
        info = m.solve()
        out[tier] = (np.asarray(info["iterations"]), info["residuals"],
                     np.asarray(m.get_u()).reshape(batch, -1))
    pp = m._pp
    compiled, cs = _aot(
        lambda x, c: fused_solve(x, c, pp, max_iter=100, check_termination=1),
        x_meas, FusedCarry.zeros(batch, pp))
    ok, err, detail = compare_schedules(out["scan"], out["fused"], settings)
    _report("adaptive_iters_B65k", U_TOL, err, ok, cs, compiled, **detail)


def phase_mission(batch=4096, ticks=70):
    """70-tick warm hovering mission: scan-tier vs fused-kernel ticks."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.api import fused_mpc_rollout, mpc_rollout
    from accelerated_tinympc_tpu.ops import pad_problem
    from accelerated_tinympc_tpu.precompute import condensed_operators

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    settings = atm.Settings(max_iter=100, check_termination=0)
    x0s = _perturbed(x0, batch, 0.01, seed=3)
    scan, cs1 = _aot(lambda x: mpc_rollout(problem, cache, settings, x, ticks,
                                           batched=True), x0s)
    _st, xf_s, trace = scan(x0s)
    pp = pad_problem(problem, cache, condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon))
    fused, cs2 = _aot(lambda x: fused_mpc_rollout(
        pp, x, ticks, problem=problem, max_iter=100), x0s)
    xf_f, us_f, _carry = fused(x0s)
    err = float(jnp.max(jnp.abs(us_f - trace.u)))
    track = float(jnp.max(jnp.linalg.norm(xf_f - problem.Xref[1], axis=-1)))
    jax.block_until_ready(xf_s)
    _report("mission_70ticks_B4096", U_TOL, err,
            err <= U_TOL and track < 0.01, cs1 + cs2, fused,
            final_tracking_error_max=track, tracking_tol=0.01)


def phase_fleet(batch=16_384, rho_batch=4096):
    """TinyMPCFleet: default tier vs instance_ops, then adaptive rho."""
    import jax.numpy as jnp
    import numpy as np

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.models import random_lti_plants
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched, solve_batched,
    )
    from accelerated_tinympc_tpu.utils.parity import compare_schedules

    A, B, Q, R = random_lti_plants(batch, 12, 4, seed=4)
    rng = np.random.default_rng(5)
    x0s = (0.4 * rng.standard_normal((batch, 12))).astype(np.float32)
    settings = atm.Settings(max_iter=200, check_termination=1,
                            abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    out = {}
    t0 = time.perf_counter()
    for tier in ("scan", "instance_ops"):
        f = atm.TinyMPCFleet.setup(A, B, Q, R, rho=1.0, horizon=10,
                                   u_min=-3.0, u_max=3.0, settings=settings,
                                   tier=tier)
        f.set_x0(x0s)
        info = f.solve()
        out[tier] = (info["iterations"], info["residuals"],
                     np.asarray(f.get_u()).reshape(batch, -1))
        fleet = f
    setup_and_solve_s = time.perf_counter() - t0
    ok, err, detail = compare_schedules(out["scan"], out["instance_ops"],
                                        settings)
    st = init_state_batched(batch, 12, 4, 10)
    st = st.replace(x=st.x.at[:, 0, :].set(jnp.asarray(x0s)))
    compiled, cs = _aot(lambda s: solve_batched(
        s, fleet.problem, fleet.cache, fleet.settings,
        problem_axes=0, cache_axes=0), st)

    sub = slice(0, rho_batch)
    f = atm.TinyMPCFleet.setup(A[sub], B[sub], Q[sub], R[sub],
                               rho=np.where(np.arange(rho_batch) % 2, 1.0,
                                            1e-2).astype(np.float32),
                               horizon=10, u_min=-3.0, u_max=3.0,
                               settings=settings)
    f.set_x0(x0s[sub])
    rinfo = f.solve_adaptive_rho(engine="scan", chunk=25, max_rounds=2)
    rho_ok = (rinfo["rounds"] <= 2 and rinfo["rho"].shape == (rho_batch,)
              and bool(np.all(np.isfinite(rinfo["rho"])))
              and bool(np.all(np.isfinite(np.asarray(f.get_u())))))
    _report("fleet_B16k", U_TOL, err, ok and rho_ok, cs, compiled, **detail,
            converged_fraction=float(np.mean(
                out["scan"][0] < settings.max_iter)),
            setup_and_solve_s=round(setup_and_solve_s, 3),
            adaptive_rho={"rounds": rinfo["rounds"],
                          "solved_fraction": float(np.mean(rinfo["solved"])),
                          "rho_changed": int(np.sum(rinfo["rho"] != np.where(
                              np.arange(rho_batch) % 2, 1.0, 1e-2)))})


def phase_gpu_tests():
    """The gpu-marked tests, in this process (they need the card)."""
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "--tb=no", "-rfE",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      str(ROOT / "tests")])
    _report("gpu_marked_tests", 0, int(rc), int(rc) == 0, None,
            wall_s=round(time.perf_counter() - t0, 3))


def phase_sharded(n_dev=4, per_device=262_144):
    """sharded_solve + sharded_fused_solve over a 4-device mesh, each shard
    vs a one-device solve of the same instances."""
    import jax
    import numpy as np

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.ops import FusedCarry, fused_solve, pad_problem
    from accelerated_tinympc_tpu.parallel import (
        make_batch_mesh, replicate, shard_batch, sharded_fused_solve,
        sharded_solve,
    )
    from accelerated_tinympc_tpu.precompute import condensed_operators
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched, solve_batched,
    )

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    settings = atm.Settings(max_iter=100, check_termination=0)
    total = n_dev * per_device
    mesh = make_batch_mesh(n_dev)
    x0s = np.asarray(_perturbed(x0, total, 0.05, seed=6))
    dev0 = jax.devices()[0]

    def state_for(x):
        st = init_state_batched(x.shape[0], 12, 4, 10)
        return st.replace(x=st.x.at[:, 0, :].set(x))

    def run(fn, *args):
        """AOT-compile ``fn`` (already jitted) for ``args``, run it once:
        (compiled, outputs, compile seconds, run seconds)."""
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        t1 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        return compiled, out, t1 - t0, time.perf_counter() - t1

    compiled, (out, stats), cs, rs = run(
        sharded_solve(mesh, settings), shard_batch(state_for(x0s), mesh),
        replicate(problem, mesh), replicate(cache, mesh))
    local = jax.jit(lambda s: solve_batched(s, problem, cache, settings))
    err = 0.0
    for shard in out.u.addressable_shards:
        sl = shard.index[0]
        want = local(jax.device_put(state_for(x0s[sl]), dev0)).u
        err = max(err, float(np.max(np.abs(np.asarray(shard.data)
                                           - np.asarray(want)))))
    n_ok = float(stats["n_total"]) == total
    _report("sharded_solve_4x262k", U_TOL, err, n_ok and err <= U_TOL, cs,
            compiled, n_total=float(stats["n_total"]), run_s=round(rs, 3))

    pp = pad_problem(problem, cache, condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon))
    compiled, (res, fstats), cs, rs = run(
        sharded_fused_solve(mesh, pp, max_iter=100),
        shard_batch(x0s, mesh), shard_batch(FusedCarry.zeros(total, pp), mesh))
    flocal = jax.jit(lambda x: fused_solve(
        x, FusedCarry.zeros(per_device, pp), pp, max_iter=100).U)
    ferr = 0.0
    for shard in res.U.addressable_shards:
        sl = shard.index[0]
        want = flocal(jax.device_put(x0s[sl], dev0))
        ferr = max(ferr, float(np.max(np.abs(np.asarray(shard.data)
                                             - np.asarray(want)))))
    n_ok = float(fstats["n_total"]) == total
    _report("sharded_fused_solve_4x262k", U_TOL, ferr,
            n_ok and ferr <= U_TOL, cs, compiled,
            n_total=float(fstats["n_total"]), run_s=round(rs, 3))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    opts = ap.parse_args()

    # The card only: the test conftest keeps this platform when it is set.
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from accelerated_tinympc_tpu.utils import enable_compile_cache
    from accelerated_tinympc_tpu.utils.profiling import (
        gpu_name_and_power_limit, require_gpu,
    )

    enable_compile_cache()
    device = require_gpu()
    if device["count"] < opts.chips:
        raise SystemExit(f"--chips {opts.chips} needs {opts.chips} devices, "
                         f"JAX finds {device['count']}")
    print(gpu_name_and_power_limit(), flush=True)  # as nvidia-smi prints it
    if opts.chips == 4:
        phases = [phase_sharded]
    else:
        phases = [phase_golden, phase_tiers, phase_adaptive, phase_mission,
                  phase_fleet, phase_gpu_tests]
    for phase in phases:
        phase()
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))


if __name__ == "__main__":
    main()
