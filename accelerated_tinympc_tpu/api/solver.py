"""High-level solver API: the counterpart of the reference's setup + FFI
surface.

The reference exposes two entry layers: ``tiny_codegen(nx, nu, N, A, B, Q, R,
bounds, rho, ...)`` for offline setup (reference: src/tinympc/codegen.hpp:10-15)
and a flat setter/getter C API over a global solver (``set_x0``/``set_xref``/
``set_umin``/.../``call_tiny_solve``/``get_x``/``get_u`` — reference:
src/tinympc/tiny_wrapper.hpp:14-23). :class:`TinyMPC` covers both roles as an
immutable-under-the-hood convenience object: construction runs the Riccati
precompute (the math half of codegen), setters return updated solvers
(functional, jit-friendly), and ``solve`` dispatches to the execution tier
(``scan`` | ``condensed`` | ``fused`` | ``block``).

Unlike the reference's one-global-solver-per-process design
(tiny_wrapper.hpp:6), any number of TinyMPC instances coexist, each optionally
batched over thousands of problem instances.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..precompute import CondensedOperators, condensed_operators, riccati_cache
from ..solver import admm
from ..solver.batched import batch_stats, init_state_batched, solve_batched
from ..types import Cache, Problem, Settings, State, init_state
from ..ops.fused_admm import (
    FusedCarry,
    PaddedProblem,
    fused_solve,
    pad_problem,
    unpad_states,
)

TIERS = ("scan", "condensed", "fused", "block")

# Module-level jitted entry points: stable function identity keeps the jit
# cache warm across TinyMPC.solve() calls (tracing the while_loop tiers
# eagerly costs seconds per call).
_solve_single = jax.jit(admm.solve)
_solve_batched = jax.jit(solve_batched)


@functools.lru_cache(maxsize=8)
def _jit_solve_cones(cones, batched: bool):
    # ConeSet is a NamedTuple of NamedTuples of static Python values —
    # hashable, so each cone configuration compiles once.
    from ..solver.cones import cone_slack_update

    project = cone_slack_update(cones)
    if batched:
        return jax.jit(
            lambda s, p, c, st: solve_batched(s, p, c, st, project=project)
        )
    return jax.jit(
        lambda s, p, c, st: admm.solve(s, p, c, st, project=project)
    )


@functools.lru_cache(maxsize=8)
def _jit_solve_condensed(cones=None, nu=None):
    from ..solver.condensed import solve_condensed

    def fn(s, fp, ops, settings, nx):
        return solve_condensed(s, fp, ops, settings, nx, cones=cones, nu=nu)

    return jax.jit(fn, static_argnums=(4,))


@functools.lru_cache(maxsize=16)
def _jit_fused(max_iter, check_termination, interpret, alpha=1.0):
    # Tolerances are traced kernel operands, so they stay out of the cache
    # key — changing tolerances never recompiles.
    def fn(x0, carry, pp, pri_tol, dua_tol):
        return fused_solve(
            x0, carry, pp, max_iter=max_iter,
            check_termination=check_termination,
            abs_pri_tol=pri_tol, abs_dua_tol=dua_tol,
            interpret=interpret, alpha=alpha,
        )

    return jax.jit(fn)


def _stats(state: State, settings: Settings) -> dict[str, Any]:
    """Batched solve stats: the aggregates of ``batch_stats`` plus the
    per-instance arrays every tier reports — ``iterations``, ``solved`` and
    ``residuals`` ``(B, 4)`` [pri_state, dua_state, pri_input, dua_input]
    as of the last termination check."""
    out = {k: np.asarray(v) for k, v in batch_stats(state, settings).items()}
    out["iterations"] = np.asarray(state.iter, np.int64)
    out["solved"] = np.asarray(state.status) == 1
    out["residuals"] = residuals_of(state)
    return out


def residuals_of(state) -> np.ndarray:
    """Per-instance ``(B, 4)`` residuals [pri_state, dua_state, pri_input,
    dua_input] of a batched ``State``."""
    return np.stack([
        np.asarray(state.primal_residual_state),
        np.asarray(state.dual_residual_state),
        np.asarray(state.primal_residual_input),
        np.asarray(state.dual_residual_input),
    ], axis=-1)


@dataclasses.dataclass
class TinyMPC:
    """One MPC problem bound to a solver tier and (optional) batch.

    Build with :meth:`setup` (runs the DARE precompute like the reference's
    codegen math, src/tinympc/codegen.cpp:254-292) or :meth:`from_parts` with
    a shipped cache (reference problem_data headers).
    """

    problem: Problem
    cache: Cache
    settings: Settings
    batch: int | None = None          # None = single instance
    tier: str = "scan"
    interpret: bool = False           # Pallas interpreter (CPU testing)
    # Second-order-cone constraints (solver/cones.py) — scan, condensed and
    # block tiers (the fused kernel runs box projections only).
    cones: Any = None
    # Fused tier, adaptive mode: > 0 enables the early-termination compaction
    # cascade (solver/cascade.py) with this segment length (must be a
    # multiple of check_termination). 0 = one monolithic adaptive call.
    compaction_segment: int = 0
    # Block-condensed tier (tier="block"): knots per dense block — the
    # long-horizon tier (solver/block_condensed.py).
    block: int = 32
    # tier-internal precompute (built lazily)
    _block_fn: Any = None
    _ops: CondensedOperators | None = None
    _pp: PaddedProblem | None = None
    # mutable solve state
    state: State | None = None
    _fused_carry: FusedCarry | None = None
    _fused_result: Any = None

    # ------------------------------------------------------------- setup ----
    @classmethod
    def setup(
        cls,
        A: np.ndarray,
        B: np.ndarray,
        Q: np.ndarray,
        R: np.ndarray,
        rho: float,
        horizon: int,
        *,
        x_min: np.ndarray | float | None = None,
        x_max: np.ndarray | float | None = None,
        u_min: np.ndarray | float | None = None,
        u_max: np.ndarray | float | None = None,
        settings: Settings | None = None,
        batch: int | None = None,
        tier: str = "scan",
        interpret: bool = False,
        dtype: Any = jnp.float32,
        cones: Any = None,
        compaction_segment: int = 0,
        block: int = 32,
    ) -> "TinyMPC":
        """Construct + precompute. Bounds default to ±inf (disabled in
        Settings when not provided, mirroring the reference's nullptr-enable
        logic, codegen.cpp:227-243); scalars broadcast over the horizon."""
        A = np.asarray(A, np.float64)
        Bm = np.asarray(B, np.float64)
        nx, nu = Bm.shape
        N, m = horizon, horizon - 1

        def expand(val, default, shape):
            if val is None:
                return np.full(shape, default)
            val = np.asarray(val, np.float64)
            if val.ndim <= 1:
                return np.broadcast_to(val, shape).copy()
            return val

        en_input = u_min is not None and u_max is not None
        en_state = x_min is not None and x_max is not None
        problem = Problem(
            A=jnp.asarray(A, dtype),
            B=jnp.asarray(Bm, dtype),
            Q=jnp.asarray(np.asarray(Q, np.float64), dtype),
            R=jnp.asarray(np.asarray(R, np.float64), dtype),
            u_min=jnp.asarray(expand(u_min, -np.inf, (m, nu)), dtype),
            u_max=jnp.asarray(expand(u_max, np.inf, (m, nu)), dtype),
            x_min=jnp.asarray(expand(x_min, -np.inf, (N, nx)), dtype),
            x_max=jnp.asarray(expand(x_max, np.inf, (N, nx)), dtype),
            Xref=jnp.zeros((N, nx), dtype),
            Uref=jnp.zeros((m, nu), dtype),
        )
        cache = riccati_cache(A, Bm, Q, R, rho, dtype=np.float32)
        if settings is None:
            settings = Settings()
        settings = settings.replace(
            en_input_bound=en_input, en_state_bound=en_state
        )
        return cls.from_parts(
            problem, cache, settings=settings, batch=batch, tier=tier,
            interpret=interpret, cones=cones,
            compaction_segment=compaction_segment, block=block,
        )

    @classmethod
    def from_parts(
        cls,
        problem: Problem,
        cache: Cache,
        *,
        settings: Settings | None = None,
        batch: int | None = None,
        tier: str = "scan",
        interpret: bool = False,
        cones: Any = None,
        compaction_segment: int = 0,
        block: int = 32,
    ) -> "TinyMPC":
        if tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
        if tier == "fused" and cones is not None:
            raise ValueError("the fused kernel runs box projections only; "
                             "SOC cones run on the scan/condensed/block tiers")
        self = cls(
            problem=problem,
            cache=cache,
            settings=settings or Settings(),
            batch=batch,
            tier=tier,
            interpret=interpret,
            cones=cones,
            compaction_segment=compaction_segment, block=block,
        )
        self._reset_state()
        return self

    def _reset_state(self) -> None:
        nx, nu, N = self.problem.nx, self.problem.nu, self.problem.horizon
        if self.batch is None:
            self.state = init_state(nx, nu, N)
        else:
            self.state = init_state_batched(self.batch, nx, nu, N)
        if self.tier == "fused":
            self._build_fused()
            b = self.batch or 1
            self._fused_carry = FusedCarry.zeros(b, self._pp)

    def _ensure_ops(self) -> CondensedOperators:
        if self._ops is None:
            self._ops = condensed_operators(
                self.cache,
                np.asarray(self.problem.A),
                np.asarray(self.problem.B),
                self.problem.horizon,
            )
        return self._ops

    def _bounded_problem(self) -> Problem:
        """Problem with disabled bound sets neutralized (the fused kernel
        clips unconditionally; scan/condensed honor the Settings flags —
        reference: src/tinympc/types.hpp:44-45 en_*_bound)."""
        prob = self.problem
        if not self.settings.en_input_bound:
            prob = prob.replace(
                u_min=jnp.full_like(prob.u_min, -jnp.inf),
                u_max=jnp.full_like(prob.u_max, jnp.inf),
            )
        if not self.settings.en_state_bound:
            prob = prob.replace(
                x_min=jnp.full_like(prob.x_min, -jnp.inf),
                x_max=jnp.full_like(prob.x_max, jnp.inf),
            )
        return prob

    def _build_fused(self) -> None:
        self._pp = pad_problem(
            self._bounded_problem(), self.cache, self._ensure_ops()
        )

    # ----------------------------------------------------------- setters ----
    # Functional analogues of the reference FFI setters
    # (reference: src/tinympc/tiny_wrapper.cpp:5-129).

    def set_x0(self, x0: np.ndarray | jax.Array) -> None:
        """Measurement injection (reference: tiny_wrapper.cpp:5-19). For a
        batched solver x0 is (batch, nx)."""
        x0 = jnp.asarray(x0, self.problem.A.dtype)
        self.state = self.state.replace(
            x=self.state.x.at[..., 0, :].set(x0)
        )

    def set_xref(self, Xref: np.ndarray | jax.Array) -> None:
        """Reference window update (reference: tiny_wrapper.cpp:21-41);
        invalidates the fused tier's baked reference vectors."""
        Xref = jnp.asarray(Xref, self.problem.A.dtype)
        self.problem = self.problem.replace(Xref=Xref)
        if self.tier == "fused":
            from ..ops.fused_admm import ref_vectors

            xref_q, pterm_c = ref_vectors(
                self._pp, self.problem.Q, self.cache.Pinf, Xref
            )
            self._pp = self._pp.replace(xref_q=xref_q, pterm_c=pterm_c)

    def set_bounds(
        self,
        u_min=None, u_max=None, x_min=None, x_max=None,
    ) -> None:
        """Box-bound updates (reference: tiny_wrapper.cpp:43-129). Providing
        a complete bound pair enables the corresponding constraint set
        (mirroring the reference's non-null enable logic,
        codegen.cpp:227-243) so every tier starts clipping."""
        rep = {}
        for name, val in (("u_min", u_min), ("u_max", u_max),
                          ("x_min", x_min), ("x_max", x_max)):
            if val is not None:
                rep[name] = jnp.broadcast_to(
                    jnp.asarray(val, self.problem.A.dtype),
                    getattr(self.problem, name).shape,
                )
        self.problem = self.problem.replace(**rep)
        if u_min is not None and u_max is not None:
            self.settings = self.settings.replace(en_input_bound=True)
        if x_min is not None and x_max is not None:
            self.settings = self.settings.replace(en_state_bound=True)
        if self.tier == "fused" and rep:
            self._build_fused()

    def reset_duals(self) -> None:
        """Zero y/g between MPC ticks (reference: tiny_wrapper.cpp:131-140)."""
        self.state = self.state.replace(
            y=jnp.zeros_like(self.state.y), g=jnp.zeros_like(self.state.g)
        )
        if self._fused_carry is not None:
            self._fused_carry = self._fused_carry.reset_duals()

    # ------------------------------------------------------------- solve ----
    def solve(self) -> dict[str, Any]:
        """Run the solver on the current state (reference:
        tiny_wrapper.cpp:142-150 ``call_tiny_solve``). Returns a stats dict;
        results via :meth:`get_u`/:meth:`get_x`."""
        if self.tier == "fused":
            return self._solve_fused()
        if self.tier == "condensed":
            return self._solve_condensed()
        if self.tier == "block":
            return self._solve_block()
        if self.batch is None:
            fn = (
                _jit_solve_cones(self.cones, batched=False)
                if self.cones is not None else _solve_single
            )
            self.state = fn(
                self.state, self.problem, self.cache, self.settings
            )
            return {
                "iterations": int(self.state.iter),
                "solved": bool(self.state.status == 1),
            }
        fn = (
            _jit_solve_cones(self.cones, batched=True)
            if self.cones is not None else _solve_batched
        )
        self.state = fn(
            self.state, self.problem, self.cache, self.settings
        )
        return _stats(self.state, self.settings)

    def rollout(
        self,
        n_ticks: int,
        *,
        Xref_total: jax.Array | None = None,
    ):
        """Run ``n_ticks`` of the reference's receding-horizon loop fully on
        device from the current ``x0`` (reference:
        examples/quadrotor_hovering.cpp:90-114 — dual reset, warm-started
        solve, pre-projection u0 applied, plant step; tracking with
        ``Xref_total`` slides the window per tick,
        quadrotor_tracking.cpp:101). Uses this object's settings
        (``max_iter``/``check_termination``/tolerances) per tick.

        Returns ``(x_final, us)`` with the leading batch axis dropped for
        single-instance solvers; the solver's warm-start state advances to
        the end of the rollout (continuations compose).
        """
        from .mpc import fused_mpc_rollout, mpc_rollout

        single = self.batch is None
        x0 = self.state.x[..., 0, :]
        if self.tier == "fused":
            if single:
                x0 = x0[None]
            xf, us, carry = fused_mpc_rollout(
                self._pp, x0, n_ticks, problem=self.problem,
                max_iter=self.settings.max_iter,
                check_termination=self.settings.check_termination,
                abs_pri_tol=float(self.settings.abs_pri_tol),
                abs_dua_tol=float(self.settings.abs_dua_tol),
                carry=self._fused_carry, interpret=self.interpret,
                Xref_total=Xref_total,
                Pinf=self.cache.Pinf if Xref_total is not None else None,
                alpha=self.settings.alpha,
            )
            self._fused_carry = carry
            self.state = self.state.replace(
                x=self.state.x.at[..., 0, :].set(xf[0] if single else xf)
            )
            if single:
                return xf[0], us[:, 0]
            return xf, us
        if self.cones is not None:
            raise ValueError(
                "rollouts with cones: drive the tick loop with "
                "solve()/reset_duals() on the scan tier")
        solver = None
        if self.tier == "block":
            # Long-horizon missions: block-condensed sweeps per tick
            # (scan-tier semantics; solver/block_condensed.py).
            from ..solver.block_condensed import solve_block

            if single:
                solver = lambda s, p: solve_block(
                    s, p, self.cache, self.settings, block=self.block)
            else:
                from ..solver.block_condensed import block_sweeps

                fwd, bwd = block_sweeps(
                    self.cache, self.problem.A, self.problem.B,
                    self.problem.horizon, self.block,
                )
                solver = lambda s, p: solve_batched(
                    s, p, self.cache, self.settings,
                    forward=fwd, backward=bwd,
                )
        st, xf, trace = mpc_rollout(
            self.problem, self.cache, self.settings, x0, n_ticks,
            Xref_total=Xref_total, state=self.state, batched=not single,
            solver=solver,
        )
        self.state = st.replace(x=st.x.at[..., 0, :].set(xf))
        return xf, trace.u

    def _solve_condensed(self) -> dict[str, Any]:
        from ..solver.condensed import (
            flat_from_state,
            flatten_problem,
            state_from_flat,
        )

        ops = self._ensure_ops()
        nx, nu, N = self.problem.nx, self.problem.nu, self.problem.horizon
        state = self.state
        single = self.batch is None
        if single:
            state = jax.tree.map(lambda a: a[None], state)
        fp = flatten_problem(self.problem, self.cache)
        out = _jit_solve_condensed(self.cones, nu if self.cones else None)(
            flat_from_state(state, nx, nu), fp, ops, self.settings, nx
        )
        state = state_from_flat(out, nx, nu, N)
        if single:
            state = jax.tree.map(lambda a: a[0], state)
            self.state = state
            return {
                "iterations": int(state.iter),
                "solved": bool(state.status == 1),
            }
        self.state = state
        return _stats(state, self.settings)

    def _solve_block(self) -> dict[str, Any]:
        """Block-condensed long-horizon sweeps (solver/block_condensed.py):
        scan-tier semantics, dense per-block contractions — the
        shared-plant long-horizon tier."""
        if self._block_fn is None:
            from ..solver.block_condensed import block_sweeps
            from ..solver.cones import cone_slack_update

            fwd, bwd = block_sweeps(
                self.cache, self.problem.A, self.problem.B,
                self.problem.horizon, self.block,
            )
            project = (cone_slack_update(self.cones)
                       if self.cones is not None else None)
            if self.batch is None:
                from ..types import SOLVED, UNSOLVED

                def single(st, p, c, settings):
                    st = st.replace(
                        status=jnp.asarray(UNSOLVED, st.status.dtype),
                        iter=jnp.zeros_like(st.iter),
                    )
                    step = lambda s: admm.admm_iteration(
                        s, p, c, settings,
                        forward=fwd, backward=bwd, project=project,
                    )
                    if settings.check_termination <= 0:
                        return jax.lax.fori_loop(
                            0, settings.max_iter, lambda _, s: step(s), st
                        )
                    return jax.lax.while_loop(
                        lambda s: (s.iter < settings.max_iter)
                        & (s.status != SOLVED),
                        step, st,
                    )

                self._block_fn = jax.jit(single)
            else:
                self._block_fn = jax.jit(
                    lambda st, p, c, settings: solve_batched(
                        st, p, c, settings, project=project,
                        forward=fwd, backward=bwd,
                    )
                )
        self.state = self._block_fn(
            self.state, self.problem, self.cache, self.settings
        )
        if self.batch is None:
            return {
                "iterations": int(self.state.iter),
                "solved": bool(self.state.status == 1),
            }
        return _stats(self.state, self.settings)

    def _solve_fused(self) -> dict[str, Any]:
        x0 = self.state.x[..., 0, :]
        if self.batch is None:
            x0 = x0[None]
        if self.compaction_segment and self.settings.check_termination > 0:
            from ..solver.cascade import cascade_solve

            res = cascade_solve(
                x0, self._fused_carry, self._pp,
                max_iter=self.settings.max_iter,
                check_termination=self.settings.check_termination,
                segment_iters=self.compaction_segment,
                abs_pri_tol=float(self.settings.abs_pri_tol),
                abs_dua_tol=float(self.settings.abs_dua_tol),
                interpret=self.interpret,
            )
        else:
            res = _jit_fused(
                self.settings.max_iter, self.settings.check_termination,
                self.interpret, self.settings.alpha,
            )(
                x0, self._fused_carry, self._pp,
                jnp.float32(self.settings.abs_pri_tol),
                jnp.float32(self.settings.abs_dua_tol),
            )
        self._fused_carry = res.carry
        self._fused_result = res
        stats = np.asarray(res.stats)
        # Residual columns are valid in both modes; the solved flag
        # (column 1) is tracked only in adaptive mode (check_termination > 0).
        return {
            "iterations_mean": float(stats[:, 0].mean()),
            "converged_fraction": float(stats[:, 1].mean()),
            "iterations": stats[:, 0].astype(np.int64),
            "solved": stats[:, 1] > 0.5,
            "residuals": stats[:, 2:6],
            "primal_residual_state_max": float(stats[:, 2].max()),
            "dual_residual_state_max": float(stats[:, 3].max()),
            "primal_residual_input_max": float(stats[:, 4].max()),
            "dual_residual_input_max": float(stats[:, 5].max()),
        }

    def solve_adaptive_rho(self, **kw) -> dict[str, Any]:
        """Solve with OSQP-style stall-guarded rho adaptation (beyond the
        reference, which bakes rho at build time — codegen.cpp:254-258).

        Single instance: runs :func:`..solver.adaptive_rho.solve_adaptive_rho`
        and adopts the adapted cache for subsequent solves. Batched: runs the
        fully on-device per-instance form
        (:func:`..solver.batched_ops.solve_adaptive_rho_batched`) with this
        solver's plant broadcast over the batch; per-instance rho/iters are
        returned in the stats dict. Keyword args pass through (chunk,
        adapt_factor, rho_min/max, ...).
        """
        from ..solver.adaptive_rho import solve_adaptive_rho
        from ..solver.batched_ops import solve_adaptive_rho_batched

        if self.batch is None:
            res = solve_adaptive_rho(
                self.state, self._bounded_problem(), self.cache,
                self.settings, **kw,
            )
            self.state = res.state
            self.cache = res.cache
            if self.tier == "fused":
                self._build_fused()  # operators bake rho — refresh
            return {
                "rho": res.rho,
                "iterations": res.iterations,
                "solved": res.converged,
                "rho_history": res.rho_history,
            }

        B = self.batch
        prob = self._bounded_problem()
        bcast = lambda a: jnp.broadcast_to(a, (B,) + a.shape)
        prob_b = jax.tree.map(bcast, prob)
        rho0 = jnp.full((B,), float(self.cache.rho), prob.A.dtype)
        res = solve_adaptive_rho_batched(
            self.state.x[:, 0, :], prob_b,
            bcast(prob.A), bcast(prob.B), bcast(prob.Q), bcast(prob.R),
            rho0, self.settings, **kw,
        )
        self._adaptive_rho_result = res
        return {
            "rho": np.asarray(res.rho),
            "iterations": np.asarray(res.total_iter),
            "solved": np.asarray(res.state.solved),
            "rounds": int(res.rounds),
            "converged_fraction": float(
                res.state.solved.astype(jnp.float32).mean()
            ),
        }

    # ------------------------------------------------------------ getters ----
    def get_u(self) -> np.ndarray:
        """Control trajectory (reference: tiny_wrapper.cpp:165-176). Shape
        (N-1, nu) or (batch, N-1, nu)."""
        if self.tier == "fused":
            if self._fused_result is None:  # pre-solve: zero state, like
                return np.asarray(self.state.u)  # the other tiers
            _nx, nu, N = self._pp.dims
            u = np.asarray(self._fused_result.U[:, : (N - 1) * nu])
            u = u.reshape(-1, N - 1, nu)
            return u[0] if self.batch is None else u
        return np.asarray(self.state.u)

    def get_x(self) -> np.ndarray:
        """State trajectory (reference: tiny_wrapper.cpp:152-163)."""
        if self.tier == "fused":
            if self._fused_result is None:
                return np.asarray(self.state.x)
            x = np.asarray(unpad_states(self._fused_result, self._pp))
            return x[0] if self.batch is None else x
        return np.asarray(self.state.x)
