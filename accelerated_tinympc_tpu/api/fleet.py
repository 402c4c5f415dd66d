"""Fleet API: one MPC problem per instance.

The reference binds one problem per process (global workspace, reference:
src/tinympc/tiny_wrapper.hpp:6). :class:`TinyMPCFleet` is the inversion —
thousands of *distinct* plants (and penalties) solved in one dispatch —
behind the same setter/getter surface as :class:`.solver.TinyMPC`:

* tier ``"scan"`` (default): the vmapped ``lax.scan`` sweeps with
  per-instance plants (:func:`..solver.batched.solve_batched`) — any
  horizon, shared SOC cones, per-instance adaptive rho
  (:func:`..solver.adaptive_scan.solve_adaptive_rho_scan`).
* tier ``"instance_ops"``: the per-instance-operator einsum tier
  (:mod:`..solver.batched_ops`) — same semantics as batched contractions,
  per-instance cone parameters/geometry, and the batched adaptive-rho loop.
* tier ``"block"``: per-instance block-condensed sweeps
  (:func:`..solver.block_condensed.solve_block_batched`).

Caches are built **on device** by the vmapped
:func:`..precompute.riccati_cache_jax` (then polished in float64, see
:meth:`TinyMPCFleet.setup`); pass ``host_precompute=True`` for the
reference's float64 host path (reference: examples/codegen_cartpole.cpp:9-11).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Problem, Settings

FLEET_TIERS = ("scan", "instance_ops", "block")


@dataclasses.dataclass
class TinyMPCFleet:
    """A batch of independent MPC problems, one plant per instance."""

    problem: Problem            # batch-leading leaves
    cache: Any                  # batch-leading Cache pytree
    settings: Settings
    tier: str = "scan"
    cones: Any = None
    # Per-instance cone overrides for the instance-ops tier (and its
    # adaptive-rho loop): (input_args, state_args) pytree from
    # solver.cones.make_cone_args.
    cone_args: Any = None
    # tier="block": knots per dense block (solver/block_condensed.py).
    block: int = 16
    # internals
    _ops: Any = None
    _carry: Any = None
    _x0: Any = None
    _last: Any = None

    # ------------------------------------------------------------- setup ----
    @classmethod
    def setup(
        cls,
        A: np.ndarray | jax.Array,
        B: np.ndarray | jax.Array,
        Q: np.ndarray | jax.Array,
        R: np.ndarray | jax.Array,
        rho: float | np.ndarray | jax.Array,
        horizon: int,
        *,
        x_min=None, x_max=None, u_min=None, u_max=None,
        settings: Settings | None = None,
        tier: str = "scan",
        cones: Any = None,
        cone_mu=None,
        cone_shift=None,
        cone_ball=None,
        cone_axis=None,
        host_precompute: bool = False,
        polish: bool = True,
        block: int = 16,
    ) -> "TinyMPCFleet":
        """Construct from per-instance plants: ``A (B, nx, nx)``,
        ``B (B, nx, nu)``, ``Q (B, nx)`` / ``R (B, nu)`` raw cost diagonals
        (broadcast a shared plant by stacking), ``rho`` scalar or ``(B,)``.
        Bounds are scalars or per-instance ``(B, k)`` arrays; enabled iff
        provided (the reference's nullptr-enable logic,
        codegen.cpp:227-243).

        ``polish=True`` (default) runs the f64 refinement on the
        device-built caches (see precompute.riccati_polish_f64) so fleet
        controls match f64-cache-driven controls within the 1e-4 parity
        bar; pass False to keep the raw f32 caches (setup latency over
        precision).

        ``tier`` picks the solve path (module docstring). ``cones`` adds
        static SOC constraints; ``cone_mu``/``cone_shift``
        (``(n_input_cones, B)``) override the parameters per instance and
        ``cone_ball``/``cone_axis`` (lists of ``(B, nu)`` 0/1 membership /
        ``(B,)`` axis indices per input cone) override the *geometry* —
        on the instance-ops tier, which runs the jnp masked projection
        (:func:`..solver.cones.project_cone_masked`)."""
        if tier not in FLEET_TIERS:
            raise ValueError(f"tier must be one of {FLEET_TIERS}")
        A = jnp.asarray(A, jnp.float32)
        Bm = jnp.asarray(B, jnp.float32)
        Q = jnp.asarray(Q, jnp.float32)
        R = jnp.asarray(R, jnp.float32)
        Bn, nx, nu = Bm.shape
        N, m = horizon, horizon - 1
        rho_b = jnp.broadcast_to(
            jnp.asarray(rho, jnp.float32).reshape(-1), (Bn,)
        )

        def expand(v, default, knots, k):
            if v is None:
                return jnp.full((Bn, knots, k), default, jnp.float32)
            v = jnp.asarray(v, jnp.float32)
            if v.ndim <= 1:
                v = jnp.broadcast_to(v, (Bn, knots, k))
            elif v.ndim == 2:  # (B, k) per-instance, time-uniform
                v = jnp.broadcast_to(v[:, None, :], (Bn, knots, k))
            return v

        en_input = u_min is not None and u_max is not None
        en_state = x_min is not None and x_max is not None
        problem = Problem(
            A=A, B=Bm, Q=Q, R=R,
            u_min=expand(u_min, -jnp.inf, m, nu),
            u_max=expand(u_max, jnp.inf, m, nu),
            x_min=expand(x_min, -jnp.inf, N, nx),
            x_max=expand(x_max, jnp.inf, N, nx),
            Xref=jnp.zeros((Bn, N, nx), jnp.float32),
            Uref=jnp.zeros((Bn, m, nu), jnp.float32),
        )
        if host_precompute:
            from ..precompute import riccati_cache

            caches = [
                riccati_cache(
                    np.asarray(A[b]), np.asarray(Bm[b]),
                    np.asarray(Q[b]), np.asarray(R[b]), float(rho_b[b]),
                )
                for b in range(Bn)
            ]
            cache = jax.tree.map(
                lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *caches
            )
        else:
            from ..precompute import riccati_caches_batched

            cache = jax.jit(riccati_caches_batched)(A, Bm, Q, R, rho_b)
        if polish and not host_precompute:
            # f64 refinement to the true fixed point (tol 1e-9): device
            # f32 builds land ~4e-5 off and drive controls ~7e-4 from the
            # f64 gold standard — above the 1e-4 parity bar. The polished
            # caches are the correctly-rounded f32 values of the true fixed
            # point (precompute.riccati_polish_f64).
            from ..precompute import riccati_polish_f64

            cache = riccati_polish_f64(cache, A, Bm, Q, R, rho_b)
        settings = (settings or Settings()).replace(
            en_input_bound=en_input, en_state_bound=en_state
        )
        cone_args = None
        has_ci = (
            cone_mu is not None or cone_shift is not None
            or cone_ball is not None or cone_axis is not None
        )
        if has_ci and cones is None:
            raise ValueError(
                "cone_mu/cone_shift/cone_ball/cone_axis override a base "
                "ConeSet — pass cones= as well"
            )
        if has_ci:
            if tier != "instance_ops":
                raise ValueError(
                    "per-instance cone parameters/geometry run on "
                    "tier='instance_ops'; the other tiers take a shared "
                    "ConeSet"
                )
            from ..solver.cones import make_cone_args

            cone_args = make_cone_args(
                cones, Bn, nx, nu, mu_u=cone_mu, shift_u=cone_shift,
                ball_u=cone_ball, axis_u=cone_axis,
            )
        self = cls(
            problem=problem, cache=cache, settings=settings, tier=tier,
            cones=cones, cone_args=cone_args, block=block,
        )
        self._build()
        return self

    def _build(self) -> None:
        nx, nu, N = self.dims
        if self.tier == "instance_ops":
            from ..solver.batched_ops import OpsState, build_instance_ops

            self._ops = jax.jit(build_instance_ops)(self.problem, self.cache)
            self._carry = OpsState.zeros(self.batch, N * nx, (N - 1) * nu)
            return
        from ..solver.batched import init_state_batched

        if self.tier == "block":
            from ..solver.block_condensed import block_ops_batched

            self._ops = block_ops_batched(
                self.cache, self.problem.A, self.problem.B, N, self.block
            )
        self._carry = init_state_batched(self.batch, nx, nu, N)

    # ----------------------------------------------------------- surface ----
    @property
    def batch(self) -> int:
        return self.problem.A.shape[0]

    @property
    def dims(self) -> tuple:
        return (
            self.problem.A.shape[-1], self.problem.B.shape[-1],
            self.problem.Xref.shape[-2],
        )

    def set_x0(self, x0s) -> None:
        """Per-instance measurements ``(B, nx)``."""
        x0s = jnp.asarray(x0s, jnp.float32)
        if x0s.shape != (self.batch, self.dims[0]):
            raise ValueError(
                f"x0s shape {x0s.shape} != ({self.batch}, {self.dims[0]})"
            )
        self._x0 = x0s

    def reset_duals(self) -> None:
        """Re-solve protocol: duals zeroed, slacks kept (reference:
        examples/quadrotor_hovering.cpp:99-104)."""
        if self.tier != "instance_ops":
            from ..types import reset_duals as _rd

            self._carry = _rd(self._carry)
        else:
            self._carry = self._carry.reset_duals()

    def set_bounds(self, u_min=None, u_max=None, x_min=None,
                   x_max=None) -> None:
        """Runtime bound updates (reference FFI set_umin/set_umax/...,
        tiny_wrapper.cpp:43-129): scalars, shared ``(knots, k)``, or
        per-instance ``(B, knots, k)`` arrays; providing a complete pair
        enables that constraint set. Carries survive the rebuild."""
        nx, nu, N = self.dims

        def expand(v, knots, k):
            v = jnp.asarray(v, jnp.float32)
            if v.ndim <= 1:
                return jnp.broadcast_to(v, (self.batch, knots, k))
            if v.ndim == 2:
                # (B, k) = per-instance time-uniform; (knots, k) = shared
                # schedule. Ambiguous only if B == knots AND k matches both
                # interpretations; per-instance wins there.
                if v.shape[0] == self.batch and v.shape[1] == k:
                    return jnp.broadcast_to(
                        v[:, None, :], (self.batch, knots, k)
                    )
                return jnp.broadcast_to(v[None], (self.batch, knots, k))
            return v

        upd = {}
        if u_min is not None and u_max is not None:
            upd["u_min"] = expand(u_min, N - 1, nu)
            upd["u_max"] = expand(u_max, N - 1, nu)
            self.settings = self.settings.replace(en_input_bound=True)
        if x_min is not None and x_max is not None:
            upd["x_min"] = expand(x_min, N, nx)
            upd["x_max"] = expand(x_max, N, nx)
            self.settings = self.settings.replace(en_state_bound=True)
        if not upd:
            return
        self.problem = self.problem.replace(**upd)
        carry = self._carry
        self._build()
        self._carry = carry

    def set_plants(self, A=None, B=None, Q=None, R=None, *,
                   refresh: str = "newton", polish: bool = False) -> None:
        """Online model update: replace per-instance dynamics and/or cost
        diagonals and refresh every Riccati cache on device — the
        system-identification / slowly-drifting-plant serving loop (no
        reference analogue: the reference bakes one plant at codegen time,
        codegen.cpp:245-292).

        ``refresh="newton"`` warm-starts Newton-Kleinman from the current
        gains (vmapped :func:`..precompute.riccati_newton_jax`). Newton
        requires the updated plant to still be stabilized by the old gain;
        instances where the drift broke that (the Stein sum diverges to
        non-finite values — detected per instance over every cache field)
        fall back automatically to the warm fixed point, so any drift size
        is safe and only the speed degrades. ``"fixed_point"`` always uses
        the warm fixed point. ``polish=True`` adds the f64 refinement
        (setup-grade precision). Carries are reset: duals/slacks against
        the old model are not warm starts for the new one."""
        from ..precompute import riccati_caches_batched

        if refresh not in ("newton", "fixed_point"):
            raise ValueError(
                f"refresh must be 'newton' or 'fixed_point', got {refresh!r}"
            )
        upd = {k: jnp.asarray(v, jnp.float32)
               for k, v in (("A", A), ("B", B), ("Q", Q), ("R", R))
               if v is not None}
        if not upd:
            return
        self.problem = self.problem.replace(**upd)
        p = self.problem
        rho_b = jnp.asarray(self.cache.rho, jnp.float32).reshape(-1)
        build = jax.jit(riccati_caches_batched, static_argnames=("newton",))
        cache = build(p.A, p.B, p.Q, p.R, rho_b, warm=self.cache,
                      newton=refresh == "newton")
        if refresh == "newton":
            # Non-finite in ANY cache field means drift destabilized that
            # instance's old gain (Newton's Stein sum diverged) — or the
            # overflow was confined to a derived term like the Quu solve.
            # Either way, rebuild via the warm fixed point (value iteration
            # converges for any stabilizable plant) and keep Newton's
            # result only where every field is finite.
            bad = ~jnp.stack([
                jnp.isfinite(leaf.reshape(leaf.shape[0], -1)).all(axis=1)
                for leaf in jax.tree.leaves(cache)
            ]).all(axis=0)
            if bool(bad.any()):
                fb = build(p.A, p.B, p.Q, p.R, rho_b, warm=self.cache)
                cache = jax.tree.map(
                    lambda n, o: jnp.where(
                        bad.reshape((-1,) + (1,) * (n.ndim - 1)), o, n
                    ),
                    cache, fb,
                )
        if polish:
            from ..precompute import riccati_polish_f64

            cache = riccati_polish_f64(cache, p.A, p.B, p.Q, p.R, rho_b)
        self.cache = cache
        self._build()

    def set_xref(self, Xref) -> None:
        """Per-instance reference trajectories ``(B, N, nx)`` (or a shared
        ``(N, nx)`` broadcast) — the reference FFI's ``set_xref``
        (tiny_wrapper.cpp:21-41) per instance; rebuilds the
        reference-dependent operands, carries kept."""
        nx, _nu, N = self.dims
        Xref = jnp.asarray(Xref, jnp.float32)
        if Xref.ndim == 2:
            Xref = jnp.broadcast_to(Xref, (self.batch, N, nx))
        self.problem = self.problem.replace(Xref=Xref)
        carry = self._carry
        self._build()
        self._carry = carry  # warm starts survive a reference update

    def solve(self) -> dict[str, Any]:
        """One batched solve from the current x0 / warm-start carries.
        ``settings.check_termination == 0`` is the deterministic
        fixed-iteration mode; ``> 0`` per-instance early termination."""
        if self._x0 is None:
            raise RuntimeError("call set_x0 first")
        s = self.settings
        nx, nu, N = self.dims
        if self.tier == "instance_ops":
            from ..solver.batched_ops import solve_instance_ops

            if s.alpha != 1.0:
                raise ValueError(
                    "Settings.alpha (over-relaxation) is implemented on the "
                    "scan/block/fused/condensed tiers; the instance-ops tier "
                    "runs the reference (alpha=1) schedule — use "
                    "tier='scan' or drop alpha"
                )
            st = jax.jit(
                solve_instance_ops,
                static_argnames=("cones", "dims"),
            )(
                self._x0, self._carry, self._ops, s,
                cones=self.cones, dims=(nx, nu), cone_args=self.cone_args,
            )
            self._carry = st
            self._last = (
                st.U.reshape(self.batch, N - 1, nu),
                st.X.reshape(self.batch, N, nx),
            )
            return {
                "iterations": np.asarray(st.iter, np.int64),
                "solved": np.asarray(st.solved),
                "residuals": np.stack([np.asarray(a) for a in (
                    st.pri_s, st.dua_s, st.pri_u, st.dua_u)], axis=-1),
                "iterations_mean": float(np.asarray(st.iter).mean()),
                "converged_fraction": float(np.asarray(st.solved).mean()),
            }
        # Batched-State tiers: tier="scan" (vmapped lax.scan sweeps with
        # per-instance plants) and tier="block" (per-instance dense block
        # operators, which stream from device memory every iteration —
        # block condensation pays off when the plant is SHARED and the
        # operators stay resident: TinyMPC(tier='block')).
        from ..solver.cones import cone_slack_update

        st = self._carry.replace(x=self._carry.x.at[:, 0, :].set(self._x0))
        project = (cone_slack_update(self.cones)
                   if self.cones is not None else None)
        if self.tier == "scan":
            from ..solver.batched import solve_batched

            st = jax.jit(
                lambda ss: solve_batched(
                    ss, self.problem, self.cache, s,
                    problem_axes=0, cache_axes=0, project=project,
                )
            )(st)
        else:
            from ..solver.block_condensed import solve_block_batched

            # Operators pass as traced args: closure capture would bake the
            # per-instance operator tree into the program as constants.
            om, ot, kb = self._ops
            st = jax.jit(
                lambda ss, m2, t2: solve_block_batched(
                    ss, self.problem, self.cache, s,
                    block=self.block, project=project, ops=(m2, t2, kb),
                )
            )(st, om, ot)
        self._carry = st
        self._last = (st.u, st.x)
        from .solver import residuals_of

        return {
            "iterations": np.asarray(st.iter, np.int64),
            "solved": np.asarray(st.status) == 1,
            "residuals": residuals_of(st),
            "iterations_mean": float(np.asarray(st.iter).mean()),
            "converged_fraction": float(
                (np.asarray(st.status) == 1).mean()
            ),
        }

    def get_u(self) -> jax.Array:
        """Final (pre-projection) controls ``(B, N-1, nu)`` — the reference
        applies pre-projection u."""
        if self._last is None:
            raise RuntimeError("no solve yet")
        return self._last[0]

    def get_x(self) -> jax.Array:
        """State trajectories ``(B, N, nx)``."""
        if self._last is None:
            raise RuntimeError("no solve yet")
        return self._last[1]

    def solve_adaptive_rho(self, engine: str = "auto",
                           **kw) -> dict[str, Any]:
        """Per-instance on-device rho adaptation; adopts the adapted caches
        for subsequent solves.

        ``engine="scan"`` (the ``"auto"`` choice for the scan and block
        tiers) runs the shape-unbound loop — any horizon, any nx
        (:func:`..solver.adaptive_scan.solve_adaptive_rho_scan`: scan-tier
        chunks + vmapped warm Newton-Kleinman refresh). ``engine="einsum"``
        (the ``"auto"`` choice for the instance-ops tier) runs the chunks on
        the per-instance-operator tier
        (:func:`..solver.batched_ops.solve_adaptive_rho_batched`, which
        honours per-instance ``cone_args``). Keyword args pass through."""
        if self._x0 is None:
            raise RuntimeError("call set_x0 first")
        if engine not in ("auto", "scan", "einsum"):
            raise ValueError(
                f"engine must be 'auto', 'scan' or 'einsum', got {engine!r}"
            )
        nx, nu, N = self.dims
        rho = jnp.asarray(self.cache.rho, jnp.float32).reshape(-1)
        p = self.problem
        if engine == "scan" or (engine == "auto"
                                and self.tier != "instance_ops"):
            from ..solver.adaptive_scan import solve_adaptive_rho_scan

            res = solve_adaptive_rho_scan(
                self._x0, p, p.A, p.B, p.Q, p.R, rho, self.settings, **kw,
            )
            self.cache = res.cache
            self._build()
            if self.tier != "instance_ops":
                self._carry = res.state
            self._last = (res.state.u, res.state.x)
            return {
                "rho": np.asarray(res.rho),
                "iterations": np.asarray(res.total_iter, np.int64),
                "solved": np.asarray(res.solved),
                "rounds": int(res.rounds),
            }
        from ..solver.batched_ops import solve_adaptive_rho_batched

        res = jax.jit(
            lambda x, r: solve_adaptive_rho_batched(
                x, p, p.A, p.B, p.Q, p.R, r, self.settings,
                cones=self.cones, cone_args=self.cone_args, **kw,
            )
        )(self._x0, rho)
        self.cache = res.cache
        self._build()  # re-build operators at the adapted rho
        st = res.state
        self._last = (
            st.U.reshape(self.batch, N - 1, nu),
            st.X.reshape(self.batch, N, nx),
        )
        return {
            "rho": np.asarray(res.rho),
            "iterations": np.asarray(res.total_iter, np.int64),
            "solved": np.asarray(st.solved),
            "rounds": int(res.rounds),
        }
