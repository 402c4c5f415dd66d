"""Quadrotor hovering MPC (capability parity with reference:
examples/quadrotor_hovering.cpp): 12-state Crazyflie-style LTI at 20 Hz,
box-bounded inputs/states, hover setpoint z=2, 70 receding-horizon ticks.

Differences from the reference: the whole 70-tick loop runs as ONE device
program (lax.scan — no per-tick host dispatch), and the same script can run
thousands of perturbed instances batched (see batch_scenario_mpc.py).

Run: python examples/quadrotor_hovering.py [--ticks 70] [--adaptive]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.api import mpc_rollout


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=70)
    ap.add_argument("--hz", type=int, default=20, choices=(20, 50, 100))
    ap.add_argument("--adaptive", action="store_true",
                    help="reference default settings (tol 1e-3, check every "
                         "iter) instead of fixed 100 iterations")
    args = ap.parse_args()
    atm.utils.enable_compile_cache()

    problem, cache, x0 = atm.models.quadrotor_hovering_setup(args.hz)
    settings = (
        atm.Settings(max_iter=100, check_termination=1)
        if args.adaptive
        else atm.Settings(max_iter=100, check_termination=0)
    )

    rollout = jax.jit(
        lambda x: mpc_rollout(problem, cache, settings, x, args.ticks)
    )
    _, x_final, trace = rollout(jnp.asarray(x0, jnp.float32))

    # Per-tick tracking error, as the reference example prints
    # (quadrotor_hovering.cpp:92).
    err = np.linalg.norm(
        np.asarray(trace.x) - np.asarray(problem.Xref)[None, 0], axis=-1
    )
    for k in range(0, args.ticks, max(1, args.ticks // 20)):
        print(f"tick {k:3d}  tracking error: {err[k]:.6f}  "
              f"iters: {int(trace.iters[k])}")
    print(f"final error: {float(jnp.linalg.norm(x_final - problem.Xref[0])):.6f}")


if __name__ == "__main__":
    main()
