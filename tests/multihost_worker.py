"""Worker process for the multi-host (DCN) smoke test.

Launched by tests/test_multihost.py as one of ``num_processes`` localhost
processes. Brings up the JAX distributed runtime via
``parallel.mesh.initialize_distributed`` (the entry the reference has no
analogue for — SURVEY.md §5 distributed row), runs a batch-sharded solve over
the *global* device mesh (2 virtual CPU devices per process), and prints the
psum'd global stats — proving the DCN path is live code, not a stub.

Usage: python multihost_worker.py <coordinator> <num_processes> <process_id>
"""

import os
import sys

# Per-process virtual devices BEFORE jax initializes its backend.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> int:
    coordinator, num_processes, process_id = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

    from accelerated_tinympc_tpu.parallel.mesh import (
        initialize_distributed, make_batch_mesh, sharded_solve,
    )
    from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
    from accelerated_tinympc_tpu.solver.batched import init_state_batched
    from accelerated_tinympc_tpu.types import Settings
    from jax.sharding import NamedSharding, PartitionSpec as P

    initialize_distributed(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    assert jax.process_count() == num_processes, jax.process_count()
    n_dev = len(jax.devices())  # global devices across processes
    assert n_dev == 2 * num_processes, n_dev

    mesh = make_batch_mesh()
    problem, cache, x0 = quadrotor_hovering_setup()
    settings = Settings(max_iter=60, check_termination=1,
                        abs_pri_tol=0.02, abs_dua_tol=0.02)

    B = 4 * n_dev
    rng = np.random.default_rng(11)  # same seed in every process
    x0s = rng.standard_normal((B, 12)).astype(np.float32) * 0.1 + np.asarray(
        x0, np.float32
    )
    state = init_state_batched(B, 12, 4, 10)
    state = state.replace(x=state.x.at[:, 0, :].set(jnp.asarray(x0s)))

    # Build the global batch-sharded array from per-process local shards.
    sharding = NamedSharding(mesh, P("batch"))

    def to_global(a):
        if a.ndim == 0 or a.shape[0] != B:
            return jax.device_put(a, NamedSharding(mesh, P()))
        return jax.make_array_from_callback(
            a.shape, sharding, lambda idx: np.asarray(a)[idx]
        )

    state = jax.tree.map(to_global, state)
    solve = sharded_solve(mesh, settings)
    out, stats = solve(state, problem, cache)
    print("STATS", process_id,
          float(stats["n_total"]), float(stats["n_converged"]),
          float(stats["iterations_sum"]), flush=True)

    # Pallas kernel across the process boundary: the fused whole-solve
    # kernel per shard (interpret mode on CPU devices),
    # global batch-sharded inputs spanning both processes, psum'd stats.
    # Each process checks its own addressable output shards against a
    # locally-computed unsharded fused solve of the full batch.
    from accelerated_tinympc_tpu.ops import FusedCarry, fused_solve, pad_problem
    from accelerated_tinympc_tpu.parallel.mesh import sharded_fused_solve
    from accelerated_tinympc_tpu.precompute import condensed_operators

    ops = condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon
    )
    pp = pad_problem(problem, cache, ops)
    carry = FusedCarry.zeros(B, pp)
    x0g = jax.make_array_from_callback(
        (B, 12), sharding, lambda idx: x0s[idx]
    )
    carry_g = jax.tree.map(
        lambda a: jax.make_array_from_callback(
            a.shape, sharding, lambda idx: np.asarray(a)[idx]
        ),
        carry,
    )
    fsolve = sharded_fused_solve(
        mesh, pp, max_iter=10, check_termination=0, interpret=True,
    )
    fres, fstats = fsolve(x0g, carry_g)
    want = fused_solve(
        jnp.asarray(x0s), carry, pp, max_iter=10, check_termination=0,
        interpret=True,
    )
    want_U = np.asarray(want.U)
    max_diff = 0.0
    rows = 0
    for shard in fres.U.addressable_shards:
        sl = shard.index[0]
        max_diff = max(
            max_diff,
            float(np.abs(np.asarray(shard.data) - want_U[sl]).max()),
        )
        rows += np.asarray(shard.data).shape[0]
    print("FUSED", process_id, float(fstats["n_total"]), rows, max_diff,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
