"""Multi-device scaling: shard the batch axis over a device mesh.

The reference has zero distribution (SURVEY.md §2 — grep-verified: no
NCCL/MPI/threads anywhere); its scaling unit is "one MCU, one problem". Here
the scaling story is the inverse: the per-instance ADMM solve (reference:
src/tinympc/admm.cpp:111-152) is embarrassingly parallel across instances, so
the batch axis shards over the devices with **zero** cross-device traffic in
the solve itself; collectives appear only for global convergence/residual
statistics (``psum``/``pmax``, which XLA hands to NCCL over NVLink on one
host).

Design: one 1-D ``batch`` mesh axis over all devices (every card reaches
every other at the same rate, so the mesh follows the algorithm alone).
``shard_map`` runs the local batch shard through the same solver tiers used
on one device (scan / condensed / block / fused — identical numerics), then a
``psum`` reduces the convergence stats. Multi-host entry is standard
``jax.distributed.initialize``.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.fused_admm import DEFAULT_BATCH_TILE, fused_solve
from ..solver.batched import solve_batched
from ..types import SOLVED, Cache, Problem, Settings, State

BATCH_AXIS = "batch"


def make_batch_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over all (or the first ``n_devices``) local-process devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.make_mesh((len(devs),), (BATCH_AXIS,), devices=devs)


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """Place a batch-leading pytree with the batch axis sharded over the mesh."""
    def put(x):
        spec = P(BATCH_AXIS, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Place shared (problem/cache) pytrees replicated on every device."""
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(put, tree)


def sharded_solve(
    mesh: Mesh,
    settings: Settings,
    *,
    solver: Callable[..., State] | None = None,
) -> Callable[[State, Problem, Cache], tuple[State, dict[str, jax.Array]]]:
    """Build a jitted sharded solve: batch-sharded state in, batch-sharded
    state + *globally reduced* stats out.

    The returned callable expects ``state`` sharded over ``BATCH_AXIS`` (see
    :func:`shard_batch`) and ``problem``/``cache`` replicated. Stats are
    reduced with ``psum``/``pmax`` over the mesh so every host sees global
    values — the cross-device traffic is only these scalars.
    """
    local_solve = solver or (
        lambda s, p, c: solve_batched(s, p, c, settings)
    )

    def shard_fn(state: State, problem: Problem, cache: Cache):
        out = local_solve(state, problem, cache)
        converged = (out.status == SOLVED).astype(jnp.float32)
        n_local = jnp.asarray(out.iter.shape[0], jnp.float32)
        stats = {
            "n_total": jax.lax.psum(n_local, BATCH_AXIS),
            "n_converged": jax.lax.psum(jnp.sum(converged), BATCH_AXIS),
            "iterations_sum": jax.lax.psum(
                jnp.sum(out.iter.astype(jnp.float32)), BATCH_AXIS
            ),
            "iterations_max": jax.lax.pmax(jnp.max(out.iter), BATCH_AXIS),
            "primal_residual_state_max": jax.lax.pmax(
                jnp.max(out.primal_residual_state), BATCH_AXIS
            ),
            "primal_residual_input_max": jax.lax.pmax(
                jnp.max(out.primal_residual_input), BATCH_AXIS
            ),
            "dual_residual_state_max": jax.lax.pmax(
                jnp.max(out.dual_residual_state), BATCH_AXIS
            ),
            "dual_residual_input_max": jax.lax.pmax(
                jnp.max(out.dual_residual_input), BATCH_AXIS
            ),
        }
        return out, stats

    batch_spec = P(BATCH_AXIS)
    # check_vma=False is needed: the adaptive solver resets status/iter to
    # fresh (device-invariant) constants, and with the check on, the
    # while_loop carry types then differ in their varying manual axes
    # (TypeError on 4 devices). Semantics are unaffected (batch-parallel).
    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(batch_spec, P(), P()),
        out_specs=(batch_spec, P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def summarize_stats(stats: dict[str, jax.Array]) -> dict[str, float]:
    """Host-side scalarization of the psum'd stats."""
    n = float(stats["n_total"])
    return {
        "n_total": n,
        "converged_fraction": float(stats["n_converged"]) / max(n, 1.0),
        "iterations_mean": float(stats["iterations_sum"]) / max(n, 1.0),
        "iterations_max": float(stats["iterations_max"]),
        "primal_residual_state_max": float(stats["primal_residual_state_max"]),
        "primal_residual_input_max": float(stats["primal_residual_input_max"]),
        "dual_residual_state_max": float(stats["dual_residual_state_max"]),
        "dual_residual_input_max": float(stats["dual_residual_input_max"]),
    }


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host entry (DCN): standard JAX distributed runtime bring-up.
    No-op when running single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def sharded_fused_solve(
    mesh: Mesh,
    pp,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int = DEFAULT_BATCH_TILE,
    interpret: bool = False,
):
    """The fused kernel per shard under ``shard_map`` — each device runs its
    local batch through one whole-solve kernel launch, with only the
    convergence stats psum'd over the mesh.

    Returns a jitted ``(x0s, carry) -> (FusedResult, stats)`` where ``x0s``
    and every carry leaf are batch-sharded (see :func:`shard_batch`) and the
    result stays batch-sharded. ``pp`` (operators/problem vectors) is
    replicated automatically as closure constants.
    """
    def shard_fn(x0s, carry):
        res = fused_solve(
            x0s, carry, pp, max_iter=max_iter,
            check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            batch_tile=batch_tile, interpret=interpret,
        )
        n_local = jnp.asarray(res.stats.shape[0], jnp.float32)
        stats = {
            "n_total": jax.lax.psum(n_local, BATCH_AXIS),
            "n_converged": jax.lax.psum(jnp.sum(res.stats[:, 1]), BATCH_AXIS),
            "iterations_sum": jax.lax.psum(
                jnp.sum(res.stats[:, 0]), BATCH_AXIS
            ),
            "iterations_max": jax.lax.pmax(
                jnp.max(res.stats[:, 0]), BATCH_AXIS
            ),
            # residual columns (2-5): pri_state, dua_state, pri_input,
            # dua_input — valid in both modes (the fixed mode fills them from
            # its final iteration). Only the solved flag (column 1) is
            # untracked in fixed-iteration mode, so n_converged is
            # meaningful only in adaptive mode.
            "primal_residual_state_max": jax.lax.pmax(
                jnp.max(res.stats[:, 2]), BATCH_AXIS
            ),
            "dual_residual_state_max": jax.lax.pmax(
                jnp.max(res.stats[:, 3]), BATCH_AXIS
            ),
            "primal_residual_input_max": jax.lax.pmax(
                jnp.max(res.stats[:, 4]), BATCH_AXIS
            ),
            "dual_residual_input_max": jax.lax.pmax(
                jnp.max(res.stats[:, 5]), BATCH_AXIS
            ),
        }
        return res, stats

    batch_spec = P(BATCH_AXIS)
    # check_vma=False is needed: pallas_call's out_shape carries no
    # varying-manual-axes annotation, which the check rejects.
    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(batch_spec, batch_spec),
        out_specs=(batch_spec, P()),
        check_vma=False,
    )
    return jax.jit(mapped)
