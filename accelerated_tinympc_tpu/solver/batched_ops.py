"""Per-instance-operator condensed tier: heterogeneous plants / penalties.

The reference binds one plant per process (global workspace, reference:
src/tinympc/tiny_wrapper.hpp:6) and one rho per *build* (baked by codegen,
reference: src/tinympc/codegen.cpp:254-258). This tier inverts both limits:
every instance in the batch carries its own condensed operator
set (distinct A/B/Q/R and/or distinct rho), built **on device** by vmapping
:func:`..precompute.riccati_cache_jax` + :func:`..precompute.condensed_operators_jax`,
and the ADMM iteration becomes a handful of batched contractions
(``einsum('bi,bij->bj')``) instead of the shared-operator matmuls of
:mod:`.condensed` / the fused kernel.

The iteration math is the *folded* form the fused kernel uses (see
ops/fused_admm.py module docstring): with ``W_q = -rho*[Eq^T; Ep^T]``,
``W_r = -rho*Er^T`` and ``const_d = xref_q@Eq^T + pterm_c@Ep^T``, each
iteration is 4 batched matvecs + elementwise chains — stage-for-stage the
reference schedule (src/tinympc/admm.cpp:117-150) with identical warm-start
and early-exit semantics.

On top of it, :func:`solve_adaptive_rho_batched` runs the OSQP-style
stall-guarded rho adaptation (see :mod:`.adaptive_rho`) *per instance*,
entirely on device: chunked iterations, per-instance residual-imbalance
tests, per-instance dual rescaling, and a vmapped on-device Riccati + operator
refresh each round. A batch where some instances carry a rho mis-scaled by
orders of magnitude converges within a small multiple of the well-scaled
instances' iterations — the production form of the round-1 prototype.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..precompute import condensed_operators_jax, riccati_caches_batched
from ..types import Cache, Problem, Settings

_HI = jax.lax.Precision.HIGHEST


class InstanceOps(NamedTuple):
    """Batch-leading condensed operators + problem vectors, one set per
    instance. Shapes: B batch, Dx = N*nx, Du = (N-1)*nu."""

    Fx0T: jax.Array    # (B, nx, Dx)
    Gx0T: jax.Array    # (B, nx, Du)
    W_fd: jax.Array    # (B, Du, Dx)
    W_gd: jax.Array    # (B, Du, Du)
    W_q: jax.Array     # (B, Dx, Du)  -rho folded
    W_r: jax.Array     # (B, Du, Du)  -rho folded
    const_d: jax.Array  # (B, Du)
    u_min: jax.Array   # (B, Du)
    u_max: jax.Array
    x_min: jax.Array   # (B, Dx)
    x_max: jax.Array
    rho: jax.Array     # (B,)


def build_instance_ops(problem: Problem, cache: Cache) -> InstanceOps:
    """Build per-instance operators from batch-leading problem/cache pytrees
    (every leaf carries a leading batch axis). Jittable; differentiably cheap
    next to the solve it feeds."""
    nx = problem.A.shape[-1]
    N = problem.Xref.shape[-2]

    def one(prob: Problem, ca: Cache) -> InstanceOps:
        ops = condensed_operators_jax(ca, prob.A, prob.B, N)
        EqT = ops.Eq.T                      # (m*nx, Du)
        EpT = ops.Ep.T                      # (nx, Du)
        Wqp = jnp.concatenate([EqT, EpT], axis=0)   # (Dx, Du)
        rho = ca.rho.astype(prob.A.dtype)
        xref_q = -(prob.Xref * prob.Q).reshape(-1)  # (Dx,)
        pterm_c = -jnp.matmul(prob.Xref[-1], ca.Pinf, precision=_HI)  # (nx,)
        const_d = (
            jnp.matmul(xref_q[: EqT.shape[0]], EqT, precision=_HI)
            + jnp.matmul(pterm_c, EpT, precision=_HI)
        )
        return InstanceOps(
            Fx0T=ops.Fx0.T, Gx0T=ops.Gx0.T,
            W_fd=ops.Fd.T, W_gd=ops.Gd.T,
            W_q=-rho * Wqp, W_r=-rho * ops.Er.T,
            const_d=const_d,
            u_min=prob.u_min.reshape(-1), u_max=prob.u_max.reshape(-1),
            x_min=prob.x_min.reshape(-1), x_max=prob.x_max.reshape(-1),
            rho=rho,
        )

    return jax.vmap(one)(problem, cache)


def build_instance_ops_from_plants(
    A: jax.Array, B: jax.Array, Q: jax.Array, R: jax.Array, rho: jax.Array,
    problem: Problem, riccati: str = "auto",
) -> tuple[InstanceOps, Cache]:
    """On-device cache + operator build for a batch of distinct plants.

    ``A (B,nx,nx)``, ``B (B,nx,nu)``, ``Q/R (B,nx)/(B,nu)`` raw cost
    diagonals, ``rho (B,)``; ``problem`` supplies batch-leading bounds/Xref.
    Returns the operators plus the batched Riccati caches (reference math:
    src/tinympc/codegen.cpp:268-292, run per instance on device; ``riccati``
    selects the builder as in :func:`solve_adaptive_rho_batched`).
    """
    if riccati not in ("auto", "vmap"):
        raise ValueError(f"unknown riccati builder {riccati!r}")
    caches = riccati_caches_batched(A, B, Q, R, rho)
    prob_b = problem.replace(A=A, B=B, Q=Q, R=R)
    return build_instance_ops(prob_b, caches), caches


class OpsState(NamedTuple):
    """Iterate set of the per-instance tier (flat, batch-leading)."""

    D: jax.Array   # (B, Du)
    Y: jax.Array
    G: jax.Array   # (B, Dx)
    Z: jax.Array
    V: jax.Array
    U: jax.Array   # (B, Du) final pre-projection controls
    X: jax.Array   # (B, Dx)
    pri_s: jax.Array  # (B,) residuals at the last check
    dua_s: jax.Array
    pri_u: jax.Array
    dua_u: jax.Array
    solved: jax.Array  # (B,) bool
    iter: jax.Array    # (B,) int32

    @staticmethod
    def zeros(batch: int, Dx: int, Du: int, dtype=jnp.float32) -> "OpsState":
        fu = jnp.zeros((batch, Du), dtype)
        fx = jnp.zeros((batch, Dx), dtype)
        sc = jnp.zeros((batch,), dtype)
        return OpsState(
            D=fu, Y=fu, G=fx, Z=fu, V=fx, U=fu, X=fx,
            pri_s=sc, dua_s=sc, pri_u=sc, dua_u=sc,
            solved=jnp.zeros((batch,), bool),
            iter=jnp.zeros((batch,), jnp.int32),
        )

    def reset_duals(self) -> "OpsState":
        return self._replace(Y=jnp.zeros_like(self.Y),
                             G=jnp.zeros_like(self.G))


def _bmv(v: jax.Array, M: jax.Array) -> jax.Array:
    """Batched row-vector x matrix: (B, i) x (B, i, j) -> (B, j)."""
    return jnp.einsum("bi,bij->bj", v, M, precision=_HI)


def _project_cones(Wk, cone_list, args):
    """Apply each cone to per-knot vectors ``Wk (B, K, dim)``; ``args``
    (optional) is the matching tuple of per-instance override tuples from
    :func:`.cones.make_cone_args` — any non-None field switches that cone
    to the masked (per-instance-geometry) projection."""
    from .cones import project_cone, project_cone_masked

    for ci, cone in enumerate(cone_list):
        ov = None if args is None else args[ci]
        if ov is None or all(e is None for e in ov):
            Wk = project_cone(Wk, cone)
        else:
            mu_c, sh_c, bm, am = ov
            Wk = project_cone_masked(
                Wk, cone, ball_mask=bm, axis_mask=am, mu=mu_c, shift=sh_c
            )
    return Wk


def _iteration(D, Y, G, Xb, Ub, ops: InstanceOps, cones=None,
               dims=None, cone_args=None):
    """One folded condensed iteration, per-instance operators (same schedule
    as ops/fused_admm._iteration; reference: src/tinympc/admm.cpp:117-150).
    ``cones`` (static ConeSet) appends exact SOC projections after the box
    clips — the flat slacks view per-knot via ``dims = (nx, nu)``;
    ``cone_args`` (traced, :func:`.cones.make_cone_args`) overrides cone
    parameters/geometry per instance."""
    X = Xb + _bmv(D, ops.W_fd)
    U = Ub + _bmv(D, ops.W_gd)
    S = U + Y
    Znew = jnp.clip(S, ops.u_min, ops.u_max)
    if cones is not None and cones.input_cones:
        Zk = Znew.reshape(Znew.shape[0], -1, dims[1])
        Zk = _project_cones(
            Zk, cones.input_cones,
            None if cone_args is None else cone_args[0],
        )
        Znew = Zk.reshape(Znew.shape[0], -1)
    Yn = S - Znew
    T = X + G
    Vnew = jnp.clip(T, ops.x_min, ops.x_max)
    if cones is not None and cones.state_cones:
        Vk = Vnew.reshape(Vnew.shape[0], -1, dims[0])
        Vk = _project_cones(
            Vk, cones.state_cones,
            None if cone_args is None else cone_args[1],
        )
        Vnew = Vk.reshape(Vnew.shape[0], -1)
    Gn = T - Vnew
    Dn = _bmv(Vnew - Gn, ops.W_q) + _bmv(Znew - Yn, ops.W_r) + ops.const_d
    return Dn, Yn, Gn, Znew, Vnew, U, X


def solve_instance_ops(
    x0: jax.Array,
    state: OpsState,
    ops: InstanceOps,
    settings: Settings,
    *,
    cones=None,
    dims=None,
    cone_args=None,
) -> OpsState:
    """Batched solve with one operator set per instance.

    Freeze-on-converge semantics identical to :func:`.batched.solve_batched`
    (an instance's trajectory matches its standalone solve; early exit skips
    the slack save + backward pass — reference: src/tinympc/admm.cpp:135-144).
    ``check_termination == 0`` runs the deterministic fixed-iteration mode.
    ``cones``/``dims=(nx, nu)`` as in :func:`_iteration` (static; required
    together); ``cone_args`` (traced, :func:`.cones.make_cone_args`) adds
    per-instance cone parameter/geometry overrides.
    """
    if cones is not None and dims is None:
        raise ValueError("cones on the instance-ops tier require dims")
    Xb = _bmv(x0, ops.Fx0T)
    Ub = _bmv(x0, ops.Gx0T)
    max_iter = settings.max_iter
    ce = settings.check_termination
    state = state._replace(
        solved=jnp.zeros_like(state.solved),
        iter=jnp.zeros_like(state.iter),
    )

    if ce <= 0:
        def fbody(_, st: OpsState) -> OpsState:
            Dn, Yn, Gn, Znew, Vnew, U, X = _iteration(
                st.D, st.Y, st.G, Xb, Ub, ops, cones, dims, cone_args
            )
            return st._replace(D=Dn, Y=Yn, G=Gn, Z=Znew, V=Vnew, U=U, X=X,
                               iter=st.iter + 1)

        st = jax.lax.fori_loop(0, max_iter, fbody, state)
        # Residual stats from the final iterate set (solved flag untracked,
        # as in the fixed fused kernel).
        pri_s = jnp.max(jnp.abs(st.X - st.V), axis=-1)
        pri_u = jnp.max(jnp.abs(st.U - st.Z), axis=-1)
        return st._replace(pri_s=pri_s, pri_u=pri_u)

    def body(st: OpsState) -> OpsState:
        Dn, Yn, Gn, Znew, Vnew, U, X = _iteration(
            st.D, st.Y, st.G, Xb, Ub, ops, cones, dims, cone_args
        )
        it = st.iter + 1
        checking = (it % ce) == 0
        pri_s = jnp.max(jnp.abs(X - Vnew), axis=-1)
        dua_s = ops.rho * jnp.max(jnp.abs(st.V - Vnew), axis=-1)
        pri_u = jnp.max(jnp.abs(U - Znew), axis=-1)
        dua_u = ops.rho * jnp.max(jnp.abs(st.Z - Znew), axis=-1)
        conv = checking & (
            (pri_s < settings.abs_pri_tol) & (pri_u < settings.abs_pri_tol)
            & (dua_s < settings.abs_dua_tol) & (dua_u < settings.abs_dua_tol)
        )
        keep = lambda new, old: jnp.where(checking, new, old)
        # Converged instances keep pre-backward D and pre-save Z/V; duals and
        # U/X advanced this iteration (reference early-exit dataflow).
        mu = conv[:, None]
        adv = st._replace(
            D=jnp.where(mu, st.D, Dn), Y=Yn, G=Gn,
            Z=jnp.where(mu, st.Z, Znew), V=jnp.where(mu, st.V, Vnew),
            U=U, X=X,
            pri_s=keep(pri_s, st.pri_s), dua_s=keep(dua_s, st.dua_s),
            pri_u=keep(pri_u, st.pri_u), dua_u=keep(dua_u, st.dua_u),
            solved=st.solved | conv, iter=it,
        )
        # Frozen instances don't advance at all.
        frozen = st.solved

        def sel(a, b):
            m = frozen.reshape(frozen.shape + (1,) * (a.ndim - 1))
            return jnp.where(m, a, b)

        return jax.tree.map(sel, st, adv)

    def cond(st: OpsState) -> jax.Array:
        return jnp.any((st.iter < max_iter) & (~st.solved))

    return jax.lax.while_loop(cond, body, state)


class AdaptiveRhoBatchedResult(NamedTuple):
    state: OpsState
    rho: jax.Array          # (B,) final per-instance rho
    cache: Cache            # batch-leading caches at the final rho
    rounds: jax.Array       # () int32 chunks executed
    total_iter: jax.Array   # (B,) iterations run per instance


def _bcast(v: jax.Array, like: jax.Array) -> jax.Array:
    """Reshape a per-instance scalar ``(B,)`` to broadcast against
    ``like (B, ...)``."""
    return v.reshape(v.shape + (1,) * (like.ndim - 1))


def solve_adaptive_rho_batched(
    x0: jax.Array,
    problem: Problem,
    A: jax.Array, B: jax.Array, Q: jax.Array, R: jax.Array, rho0: jax.Array,
    settings: Settings,
    *,
    chunk: int = 25,
    max_rounds: int = 40,
    adapt_factor: float = 5.0,
    stall_factor: float = 1.5,
    rho_min: float = 1e-2,
    rho_max: float = 1e3,
    refresh: str = "exact",
    trust: float = 2.0,
    fd_eps: float = 0.05,
    cones=None,
    cone_args=None,
    riccati: str = "auto",
) -> AdaptiveRhoBatchedResult:
    """Per-instance OSQP-style rho adaptation, fully on device (jittable).

    Semantics per instance mirror :func:`.adaptive_rho.solve_adaptive_rho`
    (which see): ``chunk``-iteration segments; between segments an instance
    whose progress stalled *and* whose residual imbalance exceeds
    ``adapt_factor`` rescales its rho by ``sqrt(pri/dua)`` (clipped), rescales
    its duals by ``rho_old/rho_new``, and refreshes its Riccati cache +
    condensed operators on device (vmapped). Well-scaled instances never
    trigger the guard and follow the fixed-rho trajectory exactly.

    ``refresh`` selects the cache-refresh strategy after a rho update:

    * ``"exact"`` — rebuild caches + operators on rounds where some
      instance's rho changed (a ``lax.cond`` skips otherwise).  The Riccati
      fixed point warm-starts from the carried ``Pinf``/``Kinf`` (the
      contraction re-converges in a few steps instead of ~100 cold ones —
      the vmapped while_loop's cost is the slowest instance's step count),
      and per-instance masked selects keep every rho-unchanged instance's
      operators bit-stable.
    * ``"first_order"`` — first-order adaptive caching (PAPERS.md, "Robust
      and Efficient Embedded Convex Optimization through First-Order
      Adaptive Caching"): hold the operator pytree and a per-instance
      d/drho sensitivity and refresh by an axpy
      ``ops(rho) ~= ops(c) + d_ops * (rho - c)`` — an elementwise FMA
      instead of a Riccati fixed point + horizon scan.  When an instance's
      rho leaves its multiplicative trust region ``[c/trust, c*trust]``,
      one warm-started exact build re-anchors the out-of-trust instances
      and refreshes their sensitivity by the secant through the old and new
      anchors (one build per recenter round, not three; in-trust instances
      keep their anchor untouched, preserving bit-stability).  TinyMPC's
      primal update is already an approximation (steady-state gains on a
      finite horizon); inside the trust region the O((drho/c)^2) operator
      error perturbs the solution well below the adaptation's own tolerance
      scale — see tests/test_batched_ops.py for the accuracy pin.  NB: with
      this module's OSQP-style stall guard, updates only fire at imbalance
      > ``adapt_factor`` — every step is a factor >= sqrt(adapt_factor),
      which exceeds the default trust region, so ``first_order`` recenters
      on every update and costs about ``exact`` + axpy overhead.  It pays off under *gradual* rho
      policies (small factors every chunk); for the default policy prefer
      ``exact``.
    * ``"cold"`` — unconditional cold rebuild every round (the round-1
      semantics; kept as the reference point for ``exact``).

    ``A/B/Q/R (B, ...)`` are per-instance plants (share a plant by
    broadcasting); ``rho0 (B,)`` initial penalties; ``problem`` supplies
    batch-leading bounds/Xref. Termination inside chunks uses the
    ``settings`` tolerances with ``check_termination`` cadence.
    ``cones`` (static ConeSet) adds SOC projections to every chunk's slack
    stage (adaptive-rho SOC MPC); ``cone_args``
    (:func:`.cones.make_cone_args`) overrides cone parameters/geometry per
    instance.

    ``riccati`` selects the cache builder inside refreshes (all through
    :func:`..precompute.riccati_caches_batched`): ``"vmap"``/``"auto"``
    (the warm-started vmapped fixed point) or ``"newton"`` (fixed-point
    initial build + Newton-Kleinman warm refreshes, which converge to the
    true DARE fixed point rather than the reference-truncated iterate).
    """
    if getattr(settings, "alpha", 1.0) != 1.0:
        raise ValueError(
            "Settings.alpha is not implemented on the einsum adaptive tier "
            "(reference alpha=1 schedule); use solve_adaptive_rho_scan"
        )
    if refresh not in ("exact", "first_order", "cold"):
        raise ValueError(
            f"refresh must be 'exact', 'first_order' or 'cold', "
            f"got {refresh!r}"
        )
    batch = x0.shape[0]
    nx = A.shape[-1]
    N = problem.Xref.shape[-2]
    nu = B.shape[-1]
    Dx, Du = N * nx, (N - 1) * nu
    chunk_settings = settings.replace(max_iter=chunk)
    first_order = refresh == "first_order"
    if riccati not in ("auto", "vmap", "newton"):
        raise ValueError(f"unknown riccati builder {riccati!r}")

    def build(rho, warm=None):
        caches = riccati_caches_batched(A, B, Q, R, rho, warm=warm,
                                        newton=riccati == "newton")
        prob_b = problem.replace(A=A, B=B, Q=Q, R=R)
        return build_instance_ops(prob_b, caches), caches

    def sel_inst(mask, a, b):
        """Per-instance select over a batch-leading pytree."""
        return jax.tree.map(
            lambda x, y: jnp.where(_bcast(mask, x), x, y), a, b
        )

    def build_sens(rho):
        """Operators at ``rho`` + d/drho by per-instance central
        differences (three vmapped builds; entry only — recenters use the
        secant). Every leaf is differenced uniformly: rho-independent
        leaves (bounds) cancel to zero and the ``rho`` leaf's derivative is
        exactly 1, so the axpy reproduces it."""
        lo, _ = build(rho * (1.0 - fd_eps))
        hi, _ = build(rho * (1.0 + fd_eps))
        ops0, caches = build(rho)
        inv = 1.0 / (2.0 * fd_eps * rho)
        dops = jax.tree.map(
            lambda h, l: (h - l) * _bcast(inv, h), hi, lo
        )
        return ops0, dops, caches

    def axpy(ops0, dops, delta):
        return jax.tree.map(
            lambda o, d: o + d * _bcast(delta, o), ops0, dops
        )

    def round_body(carry):
        rnd, st, rho, prev_max, ops, anchor = carry
        solved_in = st.solved
        iter_in = st.iter
        nxt = solve_instance_ops(
            x0, st, ops, chunk_settings, cones=cones, dims=(nx, nu),
            cone_args=cone_args,
        )
        nxt = nxt._replace(
            iter=iter_in + nxt.iter,           # accumulate across rounds
            solved=nxt.solved | solved_in,
        )

        # Instances already solved in an earlier round stay frozen verbatim
        # (solve_instance_ops resets status at entry, so re-select here).
        def sel(a, b):
            m = solved_in.reshape(solved_in.shape + (1,) * (a.ndim - 1))
            return jnp.where(m, a, b)

        st = jax.tree.map(sel, st, nxt)
        pri = jnp.maximum(st.pri_s, st.pri_u)
        dua = jnp.maximum(st.dua_s, st.dua_u)
        max_res = jnp.maximum(pri, dua)
        stalled = max_res * stall_factor > prev_max
        ratio = jnp.sqrt(jnp.maximum(pri, 1e-12) / jnp.maximum(dua, 1e-12))
        imbalanced = (ratio > adapt_factor) | (ratio < 1.0 / adapt_factor)
        do_adapt = stalled & imbalanced & (~st.solved)
        new_rho = jnp.where(
            do_adapt, jnp.clip(rho * ratio, rho_min, rho_max), rho
        )
        changed = new_rho != rho
        scale = jnp.where(changed, rho / new_rho, 1.0)[:, None]
        st = st._replace(Y=st.Y * scale, G=st.G * scale)
        prev_max = jnp.where(changed, jnp.inf, max_res)

        if first_order:
            center, ops0, dops, caches0 = anchor

            outside = (new_rho > center * trust) | (new_rho * trust < center)

            def recenter():
                ops_new, caches_new = build(new_rho, warm=caches0)
                denom = new_rho - center
                inv = jnp.where(jnp.abs(denom) > 1e-12, 1.0 / denom, 0.0)
                dsec = jax.tree.map(
                    lambda n, o: (n - o) * _bcast(inv, n), ops_new, ops0
                )
                return (
                    jnp.where(outside, new_rho, center),
                    sel_inst(outside, ops_new, ops0),
                    sel_inst(outside, dsec, dops),
                    sel_inst(outside, caches_new, caches0),
                )

            center, ops0, dops, caches0 = jax.lax.cond(
                jnp.any(outside), recenter,
                lambda: (center, ops0, dops, caches0),
            )
            ops = axpy(ops0, dops, new_rho - center)
            anchor = (center, ops0, dops, caches0)
        elif refresh == "cold":
            # Round-1 semantics: unconditional cold rebuild every round.
            ops, _ = build(new_rho)
        else:
            (caches,) = anchor

            def rebuild():
                ops_new, caches_new = build(new_rho, warm=caches)
                return (
                    sel_inst(changed, ops_new, ops),
                    sel_inst(changed, caches_new, caches),
                )

            ops, caches = jax.lax.cond(
                jnp.any(changed), rebuild, lambda: (ops, caches)
            )
            anchor = (caches,)
        return rnd + 1, st, new_rho, prev_max, ops, anchor

    def round_cond(carry):
        rnd, st = carry[0], carry[1]
        return jnp.logical_and(rnd < max_rounds, jnp.any(~st.solved))

    st0 = OpsState.zeros(batch, Dx, Du, x0.dtype)
    rho0 = rho0.astype(x0.dtype)
    if first_order:
        ops_init, dops_init, caches_init = build_sens(rho0)
        anchor0 = (rho0, ops_init, dops_init, caches_init)
    elif refresh == "cold":
        ops_init, _ = build(rho0)
        anchor0 = ()
    else:
        ops_init, caches_init = build(rho0)
        anchor0 = (caches_init,)  # mode is static; exact carries warm state
    rounds, st, rho, _, _, _ = jax.lax.while_loop(
        round_cond, round_body,
        (jnp.zeros((), jnp.int32), st0, rho0,
         jnp.full((batch,), jnp.inf, x0.dtype), ops_init, anchor0),
    )
    _ops, caches = build(rho)
    return AdaptiveRhoBatchedResult(
        state=st, rho=rho, cache=caches, rounds=rounds, total_iter=st.iter
    )


def solve_adaptive_rho_chunked(
    x0: jax.Array,
    problem: Problem,
    A: jax.Array, B: jax.Array, Q: jax.Array, R: jax.Array, rho0: jax.Array,
    settings: Settings,
    *,
    batch_chunk: int = 4096,
    cone_args=None,
    **kwargs: Any,
) -> AdaptiveRhoBatchedResult:
    """Host-chunked dispatch of :func:`solve_adaptive_rho_batched` for
    batches beyond a single dispatch's practical ceiling.

    The einsum tier materializes O(Du*Dx) condensed operators per instance
    (~13 kB at nx=12/nu=4/N=10, x3 transient sets inside a refresh round),
    so one giant dispatch holds several copies of the whole operator set in
    device memory. This wrapper splits the batch into ``batch_chunk``-sized dispatches (the
    tail chunk padded by repeating instance 0, results dropped) and
    concatenates per-instance results.

    Semantics: instances adapt independently, instances solved in an earlier
    round are frozen verbatim (see ``round_body``), and an unconverged
    instance keeps its own chunk's round loop alive exactly as long as it
    would the full batch's — so chunking is **bit-exact against any other
    dispatch of the same chunk shape** (tested), and matches the one-call
    full-batch result to f32 reassociation tolerance (XLA's lowering of the
    batched contractions depends on the batch dimension, so residuals — and
    hence adapted rho values on rescued instances — can drift at the last
    ulp across dispatch shapes). Only the scalar ``rounds`` diagnostic is
    chunk-local; it is returned as the max over chunks.

    Not jittable (it is the dispatch split itself); each chunk compiles once
    and reuses the executable. ``cone_args`` / batch-leading ``problem``
    leaves / per-instance plants are sliced per chunk automatically.
    """
    batch = x0.shape[0]
    if batch <= batch_chunk:
        return solve_adaptive_rho_batched(
            x0, problem, A, B, Q, R, rho0, settings,
            cone_args=cone_args, **kwargs,
        )

    def take(tree, idx):
        return jax.tree.map(
            lambda v: v[idx]
            if (hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == batch)
            else v,
            tree,
        )

    run = jax.jit(
        lambda x0c, probc, Ac, Bc, Qc, Rc, rhoc, cac:
        solve_adaptive_rho_batched(
            x0c, probc, Ac, Bc, Qc, Rc, rhoc, settings,
            cone_args=cac, **kwargs,
        )
    )
    parts = []
    for lo in range(0, batch, batch_chunk):
        idx = jnp.arange(lo, lo + batch_chunk)
        idx = jnp.where(idx < batch, idx, 0)   # tail pad: repeat instance 0
        parts.append(run(
            x0[idx], take(problem, idx), take(A, idx), take(B, idx),
            take(Q, idx), take(R, idx), rho0[idx], take(cone_args, idx),
        ))

    def cat(trees):
        return jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0)[:batch], *trees
        )

    return AdaptiveRhoBatchedResult(
        state=cat([p.state for p in parts]),
        rho=cat([p.rho for p in parts]),
        cache=cat([p.cache for p in parts]),
        rounds=jnp.max(jnp.stack([p.rounds for p in parts])),
        total_iter=cat([p.total_iter for p in parts]),
    )
