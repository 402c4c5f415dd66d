"""Quadrotor trajectory tracking (capability parity with reference:
examples/quadrotor_tracking.cpp): slide a 10-knot horizon window along a
301-knot y-axis line trajectory at 20 Hz, one solve per tick.

The window slide (reference: quadrotor_tracking.cpp:101) happens on device via
dynamic_slice inside the scanned tick — the full trajectory lives in device
memory once.

Run: python examples/quadrotor_tracking.py
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.api import mpc_rollout, tracking_error


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trajectory", default="quadrotor_20hz_y_axis_line")
    ap.add_argument("--adaptive", action="store_true")
    args = ap.parse_args()
    atm.utils.enable_compile_cache()

    problem, cache, x0, Xref_total = atm.models.quadrotor_tracking_setup(
        trajectory=args.trajectory
    )
    # reference runs NTOTAL - NHORIZON - 1 ticks (quadrotor_tracking.cpp:93)
    ticks = Xref_total.shape[0] - problem.horizon - 1
    settings = (
        atm.Settings(max_iter=100, check_termination=1)
        if args.adaptive
        else atm.Settings(max_iter=25, check_termination=0)
    )

    Xref_dev = jnp.asarray(Xref_total, jnp.float32)
    if jax.devices()[0].platform == "gpu" and not args.adaptive:
        # fused kernel tier with the sliding window recomputed on device
        from accelerated_tinympc_tpu.api import fused_mpc_rollout
        from accelerated_tinympc_tpu.ops import pad_problem
        from accelerated_tinympc_tpu.precompute import condensed_operators

        ops = condensed_operators(
            cache, np.asarray(problem.A), np.asarray(problem.B),
            problem.horizon,
        )
        pp = pad_problem(problem, cache, ops)
        rollout = jax.jit(
            lambda x: fused_mpc_rollout(
                pp, x[None], ticks, problem=problem,
                max_iter=settings.max_iter,
                Xref_total=Xref_dev, Pinf=cache.Pinf,
            )
        )
        _xf, us, _ = rollout(jnp.asarray(x0, jnp.float32))
        # reconstruct the plant trace for error reporting
        xs = [np.asarray(x0, np.float64)]
        A = np.asarray(problem.A, np.float64)
        Bm = np.asarray(problem.B, np.float64)
        for k in range(ticks - 1):
            xs.append(A @ xs[-1] + Bm @ np.asarray(us[k, 0], np.float64))
        err = np.linalg.norm(
            np.stack(xs) - np.asarray(Xref_total[:ticks]), axis=-1
        )
    else:
        rollout = jax.jit(
            lambda x: mpc_rollout(
                problem, cache, settings, x, ticks, Xref_total=Xref_dev
            )
        )
        _, _, trace = rollout(jnp.asarray(x0, jnp.float32))
        err = np.asarray(tracking_error(trace, Xref_dev))
    for k in range(0, ticks, max(1, ticks // 20)):
        print(f"tick {k:3d}  tracking error: {err[k]:.6f}")
    print(f"mean tracking error: {err.mean():.6f}  max: {err.max():.6f}")


if __name__ == "__main__":
    main()
