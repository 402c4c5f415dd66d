"""Core data model: immutable pytrees for problem, cache, settings, solver state.

Semantic (not structural) counterpart of the reference's mutable global workspace
(reference: src/tinympc/types.hpp:26-107 — TinyCache/TinySettings/TinyWorkspace/
TinySolver). Differences, by design:

- Arrays are **time-major** ``(N, nx)`` / ``(N-1, nu)`` instead of the reference's
  column-major ``(nx, N)`` Eigen matrices: the leading axis is the horizon, and a
  batch axis is prepended by ``vmap``/sharding, so the batch is the leading
  axis of every batched array.
- State is immutable; every ADMM stage is a pure function ``state -> state``.
- Shape/flag fields that must be trace-time constants (dims, iteration limits,
  bound-enable flags) live in :class:`Settings` as non-pytree metadata, the JAX
  analogue of the reference's compile-time macros (reference:
  src/tinympc/glob_opts.hpp:3-9).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

Array = jax.Array


def static_field(**kw) -> Any:
    """A dataclass field kept out of the pytree: trace-time metadata (dims,
    iteration limits, flags) that stays a Python value under ``jit``."""
    return dataclasses.field(metadata={"static": True}, **kw)


def pytree_dataclass(cls: type) -> type:
    """Frozen dataclass registered as a JAX pytree, with a functional
    ``replace``. Fields made with :func:`static_field` are pytree metadata;
    every other field is a leaf."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls

# Solver status codes (reference: src/tinympc/admm.cpp:114,136 — 11 = TINY_UNSOLVED,
# 1 = TINY_SOLVED; a max-iter exit leaves status at 11 and returns exitflag 1).
UNSOLVED = 11
SOLVED = 1


@pytree_dataclass
class Cache:
    """Precomputed infinite-horizon Riccati cache.

    Counterpart of TinyCache (reference: src/tinympc/types.hpp:26-34). Shapes:
    ``Kinf (nu, nx)``, ``Pinf (nx, nx)``, ``Quu_inv (nu, nu)``, ``AmBKt (nx, nx)``,
    ``coeff_d2p (nx, nu)``; ``rho`` scalar.
    """

    rho: Array
    Kinf: Array
    Pinf: Array
    Quu_inv: Array
    AmBKt: Array
    coeff_d2p: Array

    @property
    def nx(self) -> int:
        return self.Pinf.shape[-1]

    @property
    def nu(self) -> int:
        return self.Quu_inv.shape[-1]


@pytree_dataclass
class Settings:
    """Solver settings. Counterpart of TinySettings (reference:
    src/tinympc/types.hpp:39-47).

    ``max_iter``/``check_termination``/bound flags are static (trace-time)
    metadata; tolerances are traced scalars so they can be changed without
    recompilation. ``check_termination == 0`` disables the termination check
    entirely (fixed-iteration mode, used for deterministic benchmarking and
    golden-parity runs).

    ``alpha`` is OSQP-style over-relaxation (beyond-reference, off by
    default: 1.0 reproduces the reference schedule bit-for-bit). With
    ``alpha != 1`` the slack/dual stages see the relaxed iterate
    ``alpha * u + (1 - alpha) * z_old`` (likewise for states). It helps
    *constraint-bound* workloads where plain ADMM stalls, but slows easy
    solves whose constraints are inactive (the slack settle becomes a
    ``|1-alpha|`` geometric filter) — use it where ADMM stalls, not as a
    blanket default. Honored by the scan/batched, condensed, block and
    fused tiers, the missions built on them, the scan-tier adaptive-rho
    loop and generated C++ projects (TINY_ALPHA); the instance-ops tier
    and its adaptive-rho loop raise on alpha != 1.
    Static metadata — changing it recompiles.
    """

    abs_pri_tol: Array = 1e-3
    abs_dua_tol: Array = 1e-3
    max_iter: int = static_field(default=100)
    check_termination: int = static_field(default=1)
    en_state_bound: bool = static_field(default=True)
    en_input_bound: bool = static_field(default=True)
    alpha: float = static_field(default=1.0)


@pytree_dataclass
class Problem:
    """Time-invariant problem data + references + bounds.

    Counterpart of the non-iterate half of TinyWorkspace (reference:
    src/tinympc/types.hpp:83-93). ``Q``/``R`` are the diagonal cost vectors
    exactly as the user supplies them into the workspace (the reference's
    examples load the *raw* diagonals — examples/quadrotor_hovering.cpp:42-43 —
    while its codegen path stores rho-augmented ones — src/tinympc/codegen.cpp:
    254-258; we reproduce whichever the caller provides, never "fix" it).

    Shapes (single instance): ``A (nx, nx)``, ``B (nx, nu)``, ``Q (nx,)``,
    ``R (nu,)``, ``x_min/x_max/Xref (N, nx)``, ``u_min/u_max/Uref (N-1, nu)``.
    """

    A: Array
    B: Array
    Q: Array
    R: Array
    u_min: Array
    u_max: Array
    x_min: Array
    x_max: Array
    Xref: Array
    Uref: Array

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]

    @property
    def horizon(self) -> int:
        return self.Xref.shape[-2]


@pytree_dataclass
class State:
    """ADMM iterates + diagnostics: the mutable half of TinyWorkspace
    (reference: src/tinympc/types.hpp:52-81), carried functionally.

    Shapes (single instance): ``x/q/p/v/vnew/g (N, nx)``;
    ``u/r/d/z/znew/y (N-1, nu)``. Warm starting across MPC ticks is expressed by
    reusing the returned State for the next solve (reference keeps these fields
    in the global workspace between tiny_solve calls —
    examples/quadrotor_hovering.cpp:99-104 resets only y and g).
    """

    x: Array
    u: Array
    q: Array
    r: Array
    p: Array
    d: Array
    v: Array
    vnew: Array
    z: Array
    znew: Array
    g: Array
    y: Array
    primal_residual_state: Array
    primal_residual_input: Array
    dual_residual_state: Array
    dual_residual_input: Array
    status: Array
    iter: Array


def init_state(nx: int, nu: int, horizon: int, dtype: Any = jnp.float32) -> State:
    """Cold-start state: everything zeroed (reference:
    examples/quadrotor_hovering.cpp:52-71)."""
    xs = jnp.zeros((horizon, nx), dtype)
    us = jnp.zeros((horizon - 1, nu), dtype)
    zero = jnp.zeros((), dtype)
    return State(
        x=xs, u=us, q=xs, r=us, p=xs, d=us,
        v=xs, vnew=xs, z=us, znew=us, g=xs, y=us,
        primal_residual_state=zero, primal_residual_input=zero,
        dual_residual_state=zero, dual_residual_input=zero,
        status=jnp.zeros((), jnp.int32), iter=jnp.zeros((), jnp.int32),
    )


def reset_duals(state: State) -> State:
    """Zero the dual variables y, g between MPC ticks (reference:
    examples/quadrotor_hovering.cpp:100-101; src/tinympc/tiny_wrapper.cpp:131-140)."""
    return state.replace(y=jnp.zeros_like(state.y), g=jnp.zeros_like(state.g))


def set_x0(state: State, x0: Array) -> State:
    """Install the measured state into the first knot (reference:
    examples/quadrotor_hovering.cpp:95; src/tinympc/tiny_wrapper.cpp:5-19)."""
    return state.replace(x=state.x.at[..., 0, :].set(x0))
