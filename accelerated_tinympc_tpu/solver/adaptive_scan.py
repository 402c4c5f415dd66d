"""Per-instance adaptive rho on the scan tier: any horizon, any nx.

The einsum tier's adaptive loop
(:func:`.batched_ops.solve_adaptive_rho_batched`) carries O((N nu)^2)
condensed operators per instance (short horizons only). This module closes
the remaining cell of the capability matrix — **adaptive
rho at long horizons and large state dimensions** — by running the
OSQP-style round loop (reference rho-in-the-cache anchor:
src/tinympc/codegen.cpp:254-292 — the adaptation re-runs that bake per
instance on device) with the iteration chunks on the *scan tier*
(:func:`.batched.solve_batched` semantics, per-instance plants) and the
cache refresh on the vmapped jnp builders — warm Newton-Kleinman
(:func:`..precompute.riccati_newton_jax`, quadratic outers from the
rho-independent closed-loop gain) or the warm fixed point. The scan tier
consumes the :class:`..types.Cache` directly, so a refresh needs **no
operand repack at all**.

One ``lax.while_loop`` end to end, mirroring the einsum tier's round
structure decision-for-decision (chunked solves with per-instance freezing, stall x
imbalance guard, sqrt(pri/dua) rescale, dual rescale by rho_old/rho_new,
instances solved in an earlier round frozen verbatim) — pinned against
the einsum tier in tests/test_adaptive_scan.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..types import SOLVED, Cache, Problem, Settings, State
from .batched import _freeze, init_state_batched, solve_batched


class AdaptiveScanResult(NamedTuple):
    state: State            # final batched solver state (warm-start ready)
    rho: jax.Array          # (B,) final per-instance rho
    cache: Cache            # batch-leading caches at the final rho
    solved: jax.Array       # (B,) bool
    total_iter: jax.Array   # (B,) int32
    rounds: jax.Array       # () int32


@functools.partial(
    jax.jit,
    static_argnames=(
        "chunk", "max_rounds", "adapt_factor", "stall_factor", "rho_min",
        "rho_max", "riccati", "settings", "block",
    ),
)
def solve_adaptive_rho_scan(
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
    riccati: str = "newton",
    block: int = 0,
) -> AdaptiveScanResult:
    """OSQP-style per-instance rho adaptation on the scan tier (see module
    docstring). ``A/B/Q/R`` are per-instance ``(B, ...)`` plants,
    ``rho0 (B,)``, ``problem`` batch-leading bounds/Xref (as the other
    adaptive tiers). ``riccati``: ``"newton"`` (warm Newton-Kleinman —
    any nx) or ``"vmap"`` (warm fixed point). ``block > 0`` runs the
    chunks with block-condensed sweeps (shared-plant batches only — see
    :mod:`.block_condensed` on per-instance block operators).
    Jittable end to end."""
    from ..precompute import riccati_caches_batched

    if riccati not in ("newton", "vmap"):
        raise ValueError(f"riccati must be 'newton' or 'vmap', got {riccati!r}")
    batch = x0.shape[0]
    nx, nu = A.shape[-1], B.shape[-1]
    N = problem.Xref.shape[-2]
    if block:
        raise NotImplementedError(
            "block-sweep chunks need a shared plant; per-instance plants "
            "use the scan sweeps (block=0)"
        )

    def build_caches(rho, warm=None):
        return riccati_caches_batched(A, B, Q, R, rho, warm=warm,
                                      newton=riccati == "newton")

    prob_b = problem.replace(A=A, B=B, Q=Q, R=R)
    rho0 = jnp.asarray(rho0, jnp.float32)
    caches0 = build_caches(rho0)
    chunk_settings = settings.replace(
        max_iter=chunk,
        check_termination=max(1, settings.check_termination),
    )

    def run_chunk(st, caches):
        return solve_batched(
            st, prob_b, caches, chunk_settings,
            problem_axes=0, cache_axes=0,
        )

    def body(carry):
        rnd, st, caches, rho, prev_max, solved_in, iters = carry
        res = run_chunk(st, caches)
        # Instances solved in an earlier round stay frozen verbatim (the
        # chunk re-solves them from the warm state; discard that).
        st2 = _freeze(solved_in, st, res)
        solved_now = res.status == SOLVED
        pri = jnp.maximum(res.primal_residual_state,
                          res.primal_residual_input)
        dua = jnp.maximum(res.dual_residual_state, res.dual_residual_input)
        pri = jnp.where(solved_in, jnp.maximum(
            st.primal_residual_state, st.primal_residual_input), pri)
        dua = jnp.where(solved_in, jnp.maximum(
            st.dual_residual_state, st.dual_residual_input), dua)
        iters = jnp.where(solved_in, iters, iters + res.iter)
        solved = solved_in | solved_now

        # OSQP-style stall x imbalance guard (as the other tiers).
        max_res = jnp.maximum(pri, dua)
        stalled = max_res * stall_factor > prev_max
        ratio = jnp.sqrt(
            jnp.maximum(pri, 1e-12) / jnp.maximum(dua, 1e-12)
        )
        imbalanced = (ratio > adapt_factor) | (ratio < 1.0 / adapt_factor)
        do_adapt = stalled & imbalanced & (~solved)
        new_rho = jnp.where(
            do_adapt, jnp.clip(rho * ratio, rho_min, rho_max), rho
        )
        changed = new_rho != rho
        prev_max = jnp.where(changed, jnp.inf, max_res)

        # Dual rescale by rho_old/rho_new.
        scale = jnp.where(changed, rho / new_rho, jnp.ones_like(rho))
        st2 = st2.replace(
            y=st2.y * scale[:, None, None],
            g=st2.g * scale[:, None, None],
        )

        # Warm cache refresh; unchanged instances keep their cache bits
        # verbatim (no repack stage exists on this tier at all).
        new_caches = build_caches(new_rho, warm=caches)
        caches2 = jax.tree.map(
            lambda n, o: jnp.where(
                changed.reshape((-1,) + (1,) * (n.ndim - 1)), n, o
            ),
            new_caches, caches,
        )
        return (rnd + 1, st2, caches2, new_rho, prev_max, solved, iters)

    def cond(carry):
        rnd, solved = carry[0], carry[5]
        return jnp.logical_and(rnd < max_rounds, jnp.any(~solved))

    st0 = init_state_batched(batch, nx, nu, N)
    st0 = st0.replace(x=st0.x.at[:, 0, :].set(x0))
    (rounds, st, caches, rho, _pm, solved, iters) = jax.lax.while_loop(
        cond, body,
        (jnp.zeros((), jnp.int32), st0, caches0, rho0,
         jnp.full((batch,), jnp.inf, jnp.float32),
         jnp.zeros((batch,), bool), jnp.zeros((batch,), jnp.int32)),
    )
    return AdaptiveScanResult(
        state=st, rho=rho, cache=caches, solved=solved,
        total_iter=iters, rounds=rounds,
    )
