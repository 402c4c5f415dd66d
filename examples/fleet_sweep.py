"""Heterogeneous-fleet scenario MPC with the TinyMPCFleet API.

The reference binds one problem per process (reference:
src/tinympc/tiny_wrapper.hpp:6); this example solves a fleet of *distinct*
random LTI plants — a plant-uncertainty / design-space sweep — one batched
dispatch per tick: on-device Riccati precompute for every plant, adaptive
per-instance early termination, optional SOC thrust cones, warm-started
re-solves across a short receding-horizon loop. ``--tier`` picks the fleet
tier: ``scan`` (the default: vmapped scan sweeps) or ``instance_ops``
(per-instance condensed operators).

``--cones`` additionally constrains each plant's first three inputs to a
thrust cone with *per-instance* geometry: every lander draws its own tilt
limit mu, and half the fleet has its thrust axis on a different input
coordinate (per-instance ball/axis masks — heterogeneous constraint
structure, not just parameters). Per-instance geometry runs on the
``instance_ops`` tier, which ``--cones`` selects.

``--drift 0.003`` additionally drifts every plant a little each tick and
refreshes all caches online through ``TinyMPCFleet.set_plants``
(Newton-Kleinman warm from the current gains; destabilized instances fall
back to the warm fixed point) — the system-identification serving loop.

Run: python examples/fleet_sweep.py [--fleet 512] [--ticks 5]
     [--tier scan|instance_ops] [--cones] [--drift 0.003]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import random_lti_problem


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=512)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--tier", default="scan",
                    choices=("scan", "instance_ops"))
    ap.add_argument("--cones", action="store_true",
                    help="per-instance thrust-cone geometry (mu + axis)")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="per-tick random plant drift scale (online model "
                         "updates via set_plants + Newton cache refresh)")
    args = ap.parse_args()
    atm.utils.enable_compile_cache()
    print("device:", atm.utils.device_info())

    B, N = args.fleet, args.horizon
    nx, nu = 8, 3
    n_distinct = min(B, 64)
    plants = [random_lti_problem(seed=s, nx=nx, nu=nu, horizon=N)[0]
              for s in range(n_distinct)]
    reps = -(-B // n_distinct)
    stack = lambda f: np.tile(
        np.stack([np.asarray(f(p)) for p in plants]),
        (reps,) + (1,) * f(plants[0]).ndim,
    )[:B]
    A = stack(lambda p: p.A)
    Bm = stack(lambda p: p.B)
    Q = stack(lambda p: p.Q)
    R = stack(lambda p: p.R)

    cone_kw = {}
    if args.cones:
        from accelerated_tinympc_tpu.solver.cones import Cone, ConeSet

        rngc = np.random.default_rng(42)
        mu = (0.6 + 0.8 * rngc.random(B)).astype(np.float32)
        h = B // 2
        ball = np.zeros((B, nu), np.float32)
        ball[:h, [0, 1]] = 1.0     # thrust axis on u[2]...
        ball[h:, [1, 2]] = 1.0     # ...or on u[0] for the other half
        axis = np.full(B, 2, np.int64)
        axis[h:] = 0
        cone_kw = dict(
            cones=ConeSet(input_cones=(
                Cone(ball=(0, 1), axis=2, mu=1.0, shift=2.0),
            )),
            cone_mu=mu[None, :], cone_ball=[ball], cone_axis=[axis],
        )
    fleet = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N,
        u_min=-2.0, u_max=2.0,
        settings=atm.Settings(max_iter=300, check_termination=1,
                              abs_pri_tol=5e-3, abs_dua_tol=5e-3),
        tier="instance_ops" if args.cones else args.tier,
        **cone_kw,
    )
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, nx)).astype(np.float32) * 0.5
    norm0 = np.linalg.norm(x, axis=1).mean()

    drift_rng = np.random.default_rng(7)
    for t in range(args.ticks):
        if args.drift and t > 0:
            # Online model drift: every plant wanders a little each tick
            # (the system-identification serving loop). set_plants
            # refreshes all caches by Newton-Kleinman warm from the current
            # gains; instances whose drift destabilized an old gain fall
            # back to the warm fixed point automatically.
            A = (A + args.drift
                 * drift_rng.standard_normal(A.shape).astype(np.float32))
            Bm = (Bm + args.drift
                  * drift_rng.standard_normal(Bm.shape).astype(np.float32))
            td = time.perf_counter()
            fleet.set_plants(A=A, B=Bm, refresh="newton")
            print(f"   drift: caches refreshed in "
                  f"{(time.perf_counter() - td) * 1e3:.1f} ms")
        fleet.set_x0(x)
        t0 = time.perf_counter()
        info = fleet.solve()
        dt = time.perf_counter() - t0
        u0 = np.asarray(fleet.get_u())[:, 0, :]
        # per-instance nominal plant step
        x = np.einsum("bij,bj->bi", A, x) + np.einsum("bij,bj->bi", Bm, u0)
        print(f"tick {t}: solved {info['converged_fraction']:.1%}  "
              f"iters mean {info['iterations_mean']:.1f}  "
              f"|x| mean {np.linalg.norm(x, axis=1).mean():.3f}  "
              f"({dt * 1e3:.1f} ms, {B / dt:,.0f} solves/s)")
        fleet.reset_duals()  # reference re-solve protocol

    # Random near-marginally-stable plants under tight input boxes decay
    # a few percent per tick — check sustained regulation, not touchdown.
    # Under --drift the plants keep changing underfoot; the controller's
    # job is then containment (bounded states with refreshed gains).
    final = np.linalg.norm(x, axis=1).mean()
    ok = final < (1.5 * norm0 if args.drift else 0.8 * norm0)
    print(("FLEET CONTAINED" if args.drift else "FLEET REGULATED")
          if ok else "CHECK FAILED")


if __name__ == "__main__":
    main()
