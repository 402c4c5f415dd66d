"""Multi-device sharded batch solve (no reference counterpart — the
reference has zero distribution, SURVEY.md §2): shard a large batch of MPC
instances over a device mesh; the solve is communication-free, convergence
stats are psum-reduced over the interconnect (NVLink between the cards of
one host).

On a CPU-only machine this demos against virtual devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/multichip_sharded.py
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.parallel import (
    make_batch_mesh,
    replicate,
    shard_batch,
    sharded_solve,
    summarize_stats,
)
from accelerated_tinympc_tpu.solver.batched import init_state_batched


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-per-device", type=int, default=64)
    args = ap.parse_args()
    atm.utils.enable_compile_cache()

    n_dev = jax.device_count()
    batch = args.batch_per_device * n_dev
    print(f"{n_dev} devices ({jax.devices()[0].platform}), batch {batch}")

    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(
        np.asarray(x0)[None] + 0.05 * rng.standard_normal((batch, 12)),
        jnp.float32,
    )
    state = init_state_batched(batch, 12, 4, 10)
    state = state.replace(x=state.x.at[:, 0, :].set(x0s))

    mesh = make_batch_mesh()
    settings = atm.Settings(
        abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=400, check_termination=1
    )
    solve = sharded_solve(mesh, settings)
    out, stats = solve(
        shard_batch(state, mesh), replicate(problem, mesh),
        replicate(cache, mesh),
    )
    print("output sharding:", out.u.sharding)
    for k, v in summarize_stats(stats).items():
        print(f"  {k}: {v:.4f}")


if __name__ == "__main__":
    main()
