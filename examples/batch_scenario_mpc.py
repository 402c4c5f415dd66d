"""Batched scenario MPC — the headline workload (no reference counterpart;
the reference is one-problem-per-MCU, SURVEY.md §2): run thousands of
perturbed quadrotor instances through the full receding-horizon loop
simultaneously, one plant per instance, all on one device.

``--tier auto`` uses the fused kernel on a GPU and the scan tier elsewhere
(the kernel compiles only for the card; on the CPU it would run in the
Pallas interpreter).

Run: python examples/batch_scenario_mpc.py [--batch 4096] [--ticks 20]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.api import fused_mpc_rollout, mpc_rollout
from accelerated_tinympc_tpu.ops import pad_problem
from accelerated_tinympc_tpu.precompute import condensed_operators


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--tier", default="auto", choices=("auto", "fused", "jnp"))
    args = ap.parse_args()
    atm.utils.enable_compile_cache()
    print("device:", atm.utils.device_info())

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        np.asarray(x0)[None] + 0.05 * rng.standard_normal((args.batch, 12)),
        jnp.float32,
    )
    on_gpu = jax.devices()[0].platform == "gpu"
    tier = args.tier if args.tier != "auto" else ("fused" if on_gpu else "jnp")
    settings = atm.Settings(max_iter=args.iters, check_termination=0)

    if tier == "fused":
        ops = condensed_operators(
            cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon
        )
        pp = pad_problem(problem, cache, ops)

        @jax.jit
        def run(x0s):
            xf, us, _carry = fused_mpc_rollout(
                pp, x0s, args.ticks, problem=problem, max_iter=args.iters,
            )
            return xf, us
    else:
        @jax.jit
        def run(x0s):
            _, xf, trace = mpc_rollout(
                problem, cache, settings, x0s, args.ticks, batched=True
            )
            return xf, trace.u

    xf, us = jax.block_until_ready(run(x0s))
    t0 = time.time()
    xf, us = jax.block_until_ready(run(x0s))
    dt = time.time() - t0
    solves = args.batch * args.ticks
    err = np.linalg.norm(np.asarray(xf) - np.asarray(problem.Xref)[0], axis=-1)
    print(f"tier={tier} batch={args.batch} ticks={args.ticks} "
          f"iters={args.iters}")
    print(f"{solves:,} solves in {dt*1e3:.1f} ms -> {solves/dt:,.0f} solves/s")
    print(f"tracking error after {args.ticks} ticks: "
          f"mean {err.mean():.4f}, max {err.max():.4f}")


if __name__ == "__main__":
    main()
