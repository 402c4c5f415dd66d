"""Condensed-operator ADMM: the dense-matmul execution tier.

Both horizon sweeps of the reference's ADMM iteration are affine recurrences
(forward rollout — reference: src/tinympc/admm.cpp:27-37; backward Riccati
gradient recursion — src/tinympc/admm.cpp:15-22), so each sweep collapses into a
dense matmul against precomputed operators (:func:`..precompute.condensed_operators`).
For a batch ``B`` the per-iteration hot path becomes a handful of
``(B, n) @ (n, m)`` matmuls over the batch — instead of ``2*(N-1)``
dependent 12x12-class matvecs, each a small launch-bound step.

State layout here is *flat and batch-leading*: ``X/V/G/Q (B, N*nx)``,
``U/Z/Y/R/D (B, (N-1)*nu)``, time-major within the flattened axis. The math is
bit-for-bit the same schedule as :mod:`.admm` (same stage order, warm start,
early-exit semantics, replicated reference quirks); only the sweep realization
differs. Tested for parity against the scan tier.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from ..precompute import CondensedOperators
from ..types import SOLVED, UNSOLVED, Cache, Problem, Settings, pytree_dataclass

_HI = jax.lax.Precision.HIGHEST


def _mm(a: jax.Array, bT: jax.Array) -> jax.Array:
    """(B, k) @ (k, n) at full f32 precision (IEEE f32, never TF32)."""
    return jnp.matmul(a, bT, precision=_HI)


@pytree_dataclass
class FlatState:
    """Flattened batched ADMM iterate set. Leaves ``(B, N*nx)`` / ``(B, m*nu)``
    except residuals/status/iter ``(B,)``. ``x0`` is the (fixed-per-solve)
    measured state, ``(B, nx)``."""

    x0: jax.Array
    X: jax.Array
    U: jax.Array
    Q: jax.Array
    R: jax.Array
    P: jax.Array
    D: jax.Array
    V: jax.Array
    Vnew: jax.Array
    Z: jax.Array
    Znew: jax.Array
    G: jax.Array
    Y: jax.Array
    primal_residual_state: jax.Array
    primal_residual_input: jax.Array
    dual_residual_state: jax.Array
    dual_residual_input: jax.Array
    status: jax.Array
    iter: jax.Array


@pytree_dataclass
class FlatProblem:
    """Problem data flattened to the condensed layout. Cost diagonals are
    broadcast over the horizon (``Qh (N*nx,)``, ``Rh`` unused — the reference
    drops the Uref cost term, src/tinympc/admm.cpp:79)."""

    Qh: jax.Array        # (N*nx,) diag Q tiled over knots
    Xref: jax.Array      # (N*nx,)
    XrefPinf_T: jax.Array  # (nx,) = Pinf^T-projected terminal ref (precomputed)
    x_min: jax.Array     # (N*nx,)
    x_max: jax.Array
    u_min: jax.Array     # (m*nu,)
    u_max: jax.Array
    rho: jax.Array


def flatten_problem(problem: Problem, cache: Cache) -> FlatProblem:
    """Flatten time-major Problem arrays into the condensed layout. The
    terminal-cost projection ``-Xref[-1] @ Pinf`` (reference:
    src/tinympc/admm.cpp:83) is hoisted here: it only depends on problem data,
    not iterates."""
    N, nx = problem.Xref.shape[-2:]
    return FlatProblem(
        Qh=jnp.tile(problem.Q, N),
        Xref=problem.Xref.reshape(-1),
        XrefPinf_T=jnp.matmul(problem.Xref[-1], cache.Pinf, precision=_HI),
        x_min=problem.x_min.reshape(-1),
        x_max=problem.x_max.reshape(-1),
        u_min=problem.u_min.reshape(-1),
        u_max=problem.u_max.reshape(-1),
        rho=cache.rho,
    )


def init_flat_state(
    batch: int, nx: int, nu: int, horizon: int, dtype: Any = jnp.float32
) -> FlatState:
    Nx = horizon * nx
    Mu = (horizon - 1) * nu
    fx = jnp.zeros((batch, Nx), dtype)
    fu = jnp.zeros((batch, Mu), dtype)
    sc = jnp.zeros((batch,), dtype)
    return FlatState(
        x0=jnp.zeros((batch, nx), dtype),
        X=fx, U=fu, Q=fx, R=fu, P=fx, D=fu,
        V=fx, Vnew=fx, Z=fu, Znew=fu, G=fx, Y=fu,
        primal_residual_state=sc, primal_residual_input=sc,
        dual_residual_state=sc, dual_residual_input=sc,
        status=jnp.zeros((batch,), jnp.int32),
        iter=jnp.zeros((batch,), jnp.int32),
    )


def condensed_iteration(
    s: FlatState,
    fp: FlatProblem,
    ops: CondensedOperators,
    settings: Settings,
    nx: int,
    *,
    cones=None,
    nu: int | None = None,
) -> FlatState:
    """One ADMM iteration, condensed. Mirrors reference
    src/tinympc/admm.cpp:117-150 stage order exactly; see :mod:`.admm` for the
    semantics being reproduced.

    ``cones`` (a :class:`..solver.cones.ConeSet`, static metadata) appends
    exact second-order-cone projections to the slack stage, composed after
    the box clip exactly as the scan tier's
    :func:`..solver.cones.cone_slack_update` — the flat slacks are viewed
    per-knot for the projection, so numerics match the scan tier
    bit-for-bit.  Requires ``nu`` (the flat layout alone does not determine
    the knot width)."""
    s = s.replace(iter=s.iter + 1)

    # --- forward pass: X = x0 Fx0^T + D Fd^T; U = x0 Gx0^T + D Gd^T ----------
    X = _mm(s.x0, ops.Fx0.T) + _mm(s.D, ops.Fd.T)
    U = _mm(s.x0, ops.Gx0.T) + _mm(s.D, ops.Gd.T)
    s = s.replace(X=X, U=U)

    # --- slack projection (reference: admm.cpp:45-61) ------------------------
    # Settings.alpha != 1: OSQP-style over-relaxation (opt-in, beyond-
    # reference — see solver/admm.py): the slack/dual stages see the
    # relaxed iterate; the true iterates (and residual definitions below)
    # are untouched.
    if settings.alpha != 1.0:
        a = settings.alpha
        Ur = a * s.U + (1.0 - a) * s.Z
        Xr = a * s.X + (1.0 - a) * s.V
    else:
        Ur, Xr = s.U, s.X
    Znew = Ur + s.Y
    Vnew = Xr + s.G
    if settings.en_input_bound:
        Znew = jnp.clip(Znew, fp.u_min, fp.u_max)
    if settings.en_state_bound:
        Vnew = jnp.clip(Vnew, fp.x_min, fp.x_max)
    if cones is not None and (cones.input_cones or cones.state_cones):
        from .cones import project_cone

        if cones.input_cones:
            if nu is None:
                raise ValueError("cones on the condensed tier require nu")
            Zk = Znew.reshape(Znew.shape[0], -1, nu)
            for cone in cones.input_cones:
                Zk = project_cone(Zk, cone)
            Znew = Zk.reshape(Znew.shape[0], -1)
        if cones.state_cones:
            Vk = Vnew.reshape(Vnew.shape[0], -1, nx)
            for cone in cones.state_cones:
                Vk = project_cone(Vk, cone)
            Vnew = Vk.reshape(Vnew.shape[0], -1)
    s = s.replace(Znew=Znew, Vnew=Vnew)

    # --- dual ascent (admm.cpp:67-71; relaxed iterates when alpha != 1) ------
    s = s.replace(Y=s.Y + Ur - s.Znew, G=s.G + Xr - s.Vnew)

    # --- linear cost refresh (admm.cpp:77-85) --------------------------------
    R = -fp.rho * (s.Znew - s.Y)
    Q = -(fp.Xref * fp.Qh) - fp.rho * (s.Vnew - s.G)
    p_term = -fp.XrefPinf_T - fp.rho * (s.Vnew[:, -nx:] - s.G[:, -nx:])
    P = s.P.at[:, -nx:].set(p_term)
    s = s.replace(R=R, Q=Q, P=P)

    # --- termination (admm.cpp:91-109) ---------------------------------------
    if settings.check_termination > 0:
        do_check = (s.iter % settings.check_termination) == 0
        pri_s = jnp.max(jnp.abs(s.X - s.Vnew), axis=-1)
        dua_s = jnp.max(jnp.abs(s.V - s.Vnew), axis=-1) * fp.rho
        pri_u = jnp.max(jnp.abs(s.U - s.Znew), axis=-1)
        dua_u = jnp.max(jnp.abs(s.Z - s.Znew), axis=-1) * fp.rho
        keep = lambda new, old: jnp.where(do_check, new, old)
        s = s.replace(
            primal_residual_state=keep(pri_s, s.primal_residual_state),
            dual_residual_state=keep(dua_s, s.dual_residual_state),
            primal_residual_input=keep(pri_u, s.primal_residual_input),
            dual_residual_input=keep(dua_u, s.dual_residual_input),
        )
        converged = do_check & (
            (pri_s < settings.abs_pri_tol)
            & (pri_u < settings.abs_pri_tol)
            & (dua_s < settings.abs_dua_tol)
            & (dua_u < settings.abs_dua_tol)
        )
    else:
        converged = jnp.zeros(s.iter.shape, bool)

    # --- slack save + backward pass, masked out on convergence ----------------
    # P = Qhead Hq^T + R Hr^T + p_term Hp^T; D likewise with Eq/Er/Ep.
    Qhead = Q[:, : -nx]
    P_new = _mm(Qhead, ops.Hq.T) + _mm(R, ops.Hr.T) + _mm(p_term, ops.Hp.T)
    D_new = _mm(Qhead, ops.Eq.T) + _mm(R, ops.Er.T) + _mm(p_term, ops.Ep.T)
    advanced = s.replace(V=s.Vnew, Z=s.Znew, P=P_new, D=D_new)

    def sel(a, b):
        mask = converged.reshape(converged.shape + (1,) * (a.ndim - 1))
        return jnp.where(mask, a, b)

    s = jax.tree.map(sel, s, advanced)
    status = jnp.where(converged, SOLVED, s.status)
    return s.replace(status=status.astype(s.status.dtype))


def solve_condensed(
    s: FlatState,
    fp: FlatProblem,
    ops: CondensedOperators,
    settings: Settings,
    nx: int,
    *,
    cones=None,
    nu: int | None = None,
) -> FlatState:
    """Condensed batched ADMM loop; same freeze-on-converge semantics as
    :func:`.batched.solve_batched`. ``cones``/``nu`` as in
    :func:`condensed_iteration`."""
    batch = s.iter.shape[0]
    step = lambda st: condensed_iteration(
        st, fp, ops, settings, nx, cones=cones, nu=nu
    )
    s = s.replace(
        status=jnp.full((batch,), UNSOLVED, s.status.dtype),
        iter=jnp.zeros((batch,), s.iter.dtype),
    )
    if settings.check_termination <= 0:
        return jax.lax.fori_loop(
            0,
            settings.max_iter,
            lambda _, st: step(st),
            s,
        )

    def body(st: FlatState) -> FlatState:
        done = st.status == SOLVED

        def sel(a, b):
            mask = done.reshape(done.shape + (1,) * (a.ndim - 1))
            return jnp.where(mask, a, b)

        return jax.tree.map(sel, st, step(st))

    def cond(st: FlatState) -> jax.Array:
        return jnp.any((st.iter < settings.max_iter) & (st.status != SOLVED))

    return jax.lax.while_loop(cond, body, s)


# --- conversions to/from the time-major State layout -------------------------

def flat_from_state(state, nx: int, nu: int) -> FlatState:
    """Convert a batched time-major :class:`..types.State` into FlatState."""
    B = state.x.shape[0]
    fl = lambda a: a.reshape(B, -1)
    return FlatState(
        x0=state.x[:, 0, :],
        X=fl(state.x), U=fl(state.u), Q=fl(state.q), R=fl(state.r),
        P=fl(state.p), D=fl(state.d), V=fl(state.v), Vnew=fl(state.vnew),
        Z=fl(state.z), Znew=fl(state.znew), G=fl(state.g), Y=fl(state.y),
        primal_residual_state=state.primal_residual_state,
        primal_residual_input=state.primal_residual_input,
        dual_residual_state=state.dual_residual_state,
        dual_residual_input=state.dual_residual_input,
        status=state.status, iter=state.iter,
    )


def state_from_flat(s: FlatState, nx: int, nu: int, horizon: int):
    """Convert FlatState back to the batched time-major State layout."""
    from ..types import State

    B = s.X.shape[0]
    un_x = lambda a: a.reshape(B, horizon, nx)
    un_u = lambda a: a.reshape(B, horizon - 1, nu)
    # Solver-internal X keeps the rolled-out first knot; restore measured x0.
    x = un_x(s.X).at[:, 0, :].set(s.x0)
    return State(
        x=x, u=un_u(s.U), q=un_x(s.Q), r=un_u(s.R), p=un_x(s.P), d=un_u(s.D),
        v=un_x(s.V), vnew=un_x(s.Vnew), z=un_u(s.Z), znew=un_u(s.Znew),
        g=un_x(s.G), y=un_u(s.Y),
        primal_residual_state=s.primal_residual_state,
        primal_residual_input=s.primal_residual_input,
        dual_residual_state=s.dual_residual_state,
        dual_residual_input=s.dual_residual_input,
        status=s.status, iter=s.iter,
    )
