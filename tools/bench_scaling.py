"""Weak-scaling measurement of the sharded scan-tier solve over a device mesh.

On a multi-card host this measures real scaling over NVLink; on a CPU-only
machine it rehearses the sharded path over virtual devices (the rates are
then the CPU's, not a device metric — every line names its device):

  python tools/bench_scaling.py            # real devices
  python tools/bench_scaling.py --virtual 8  # 8 virtual CPU devices

One JSON line per mesh size: solves/s and efficiency vs 1 device.
"""

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices")
    ap.add_argument("--batch-per-device", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    if args.virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags +
                f" --xla_force_host_platform_device_count={args.virtual}"
            ).strip()
    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.parallel import (
        make_batch_mesh, replicate, shard_batch, sharded_solve,
    )
    from accelerated_tinympc_tpu.solver.batched import init_state_batched

    n_total = jax.device_count()
    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    settings = atm.Settings(max_iter=args.iters, check_termination=0)
    rng = np.random.default_rng(0)

    base_rate = None
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total]
    for n in sizes:
        batch = args.batch_per_device * n
        x0s = jnp.asarray(
            np.asarray(x0)[None] + 0.05 * rng.standard_normal((batch, 12)),
            jnp.float32,
        )
        state = init_state_batched(batch, 12, 4, 10)
        state = state.replace(x=state.x.at[:, 0, :].set(x0s))
        mesh = make_batch_mesh(n)
        solve = sharded_solve(mesh, settings)
        sargs = (shard_batch(state, mesh), replicate(problem, mesh),
                 replicate(cache, mesh))
        jax.block_until_ready(solve(*sargs))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(solve(*sargs))
            ts.append(time.perf_counter() - t0)
        rate = batch / min(ts)
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "device": atm.utils.device_info(),
            "devices": n, "batch": batch,
            "solves_per_sec": round(rate),
            "weak_scaling_efficiency": round(rate / (base_rate * n), 3),
        }), flush=True)


if __name__ == "__main__":
    main()
