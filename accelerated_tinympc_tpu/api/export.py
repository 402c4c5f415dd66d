"""AOT export: freeze a compiled solve into a serialized, relocatable artifact.

This is the accelerator-side half of the reference's codegen capability (reference:
src/tinympc/codegen.cpp — freeze solver + data so the solve can run elsewhere
without the setup toolchain): ``jax.export`` serializes the lowered StableHLO
of a jitted solve (problem/cache baked in as constants), which any later
process can deserialize and call without this package's solver code — the
deployment story for serving fleets.
"""

from __future__ import annotations

import pathlib
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import export as jax_export

from ..ops.fused_admm import DEFAULT_BATCH_TILE, FusedCarry, fused_solve
from ..solver.batched import init_state_batched, solve_batched
from ..types import Cache, Problem, Settings


def export_batched_solve(
    problem: Problem,
    cache: Cache,
    settings: Settings,
    batch: int,
    *,
    platforms: tuple[str, ...] | None = None,
    cones=None,
) -> jax_export.Exported:
    """Export ``x0s (batch, nx) -> solved State`` with problem/cache baked in.

    ``platforms`` defaults to the current backend; pass e.g. ``("cuda", "cpu")``
    for a multi-platform artifact. ``cones`` (a static
    :class:`..solver.cones.ConeSet`) bakes SOC projections into the
    artifact.
    """
    nx, nu, N = problem.nx, problem.nu, problem.horizon
    project = None
    if cones is not None:
        from ..solver.cones import cone_slack_update

        project = cone_slack_update(cones)

    def solve_fn(x0s: jax.Array) -> dict[str, jax.Array]:
        state = init_state_batched(batch, nx, nu, N, x0s.dtype)
        state = state.replace(x=state.x.at[:, 0, :].set(x0s))
        out = solve_batched(state, problem, cache, settings, project=project)
        # Plain dict output: jax.export can serialize it without pytree
        # registration, and consumers get named arrays.
        return {
            "x": out.x, "u": out.u,
            "iterations": out.iter, "status": out.status,
            "primal_residual_state": out.primal_residual_state,
            "primal_residual_input": out.primal_residual_input,
            "dual_residual_state": out.dual_residual_state,
            "dual_residual_input": out.dual_residual_input,
        }

    args = (jax.ShapeDtypeStruct((batch, nx), jnp.float32),)
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = list(platforms)
    return jax_export.export(jax.jit(solve_fn), **kwargs)(*args)


def save_exported(path: str | pathlib.Path, exported: jax_export.Exported) -> None:
    pathlib.Path(path).write_bytes(exported.serialize())


def load_exported(path: str | pathlib.Path) -> Callable[..., Any]:
    """Load a serialized artifact; returns a callable running the baked solve."""
    exported = jax_export.deserialize(pathlib.Path(path).read_bytes())
    return jax.jit(exported.call)


def export_fused_solve(
    pp,
    batch: int,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int = DEFAULT_BATCH_TILE,
    platforms: tuple[str, ...] | None = None,
) -> jax_export.Exported:
    """Export the fused whole-solve kernel (operators baked in) as a
    serialized artifact — the deployment form of the fused tier.

    Signature of the exported callable:
    ``(x0 (B, nx), D, Y, G, Z, V) -> dict`` with the solved ``U``/``X``,
    updated carries, and the stats rows (plain arrays/dicts only — custom
    pytree types are not serializable by jax.export). The kernel lowers
    through Triton, so the artifact targets CUDA (the default platform
    list). JAX gives the Triton kernel call no compatibility guarantee
    across versions, so its safety check is waived here: load the artifact
    with the same jax/jaxlib version that exported it.
    """

    nx = pp.dims[0]

    def fn(x0, D, Y, G, Z, V):
        res = fused_solve(
            x0, FusedCarry(D=D, Y=Y, G=G, Z=Z, V=V), pp,
            max_iter=max_iter, check_termination=check_termination,
            abs_pri_tol=abs_pri_tol, abs_dua_tol=abs_dua_tol,
            batch_tile=batch_tile,
        )
        return {
            "U": res.U, "X": res.X, "stats": res.stats,
            "D": res.carry.D, "Y": res.carry.Y, "G": res.carry.G,
            "Z": res.carry.Z, "V": res.carry.V,
        }

    f32 = jnp.float32
    args = (
        jax.ShapeDtypeStruct((batch, nx), f32),
        jax.ShapeDtypeStruct((batch, pp.Dup), f32),
        jax.ShapeDtypeStruct((batch, pp.Dup), f32),
        jax.ShapeDtypeStruct((batch, pp.Dxp), f32),
        jax.ShapeDtypeStruct((batch, pp.Dup), f32),
        jax.ShapeDtypeStruct((batch, pp.Dxp), f32),
    )
    return jax_export.export(
        jax.jit(fn), platforms=list(platforms or ("cuda",)),
        disabled_checks=[
            jax_export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*args)
