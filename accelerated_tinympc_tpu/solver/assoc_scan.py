"""Associative-scan horizon sweeps: the long-horizon (sequence-parallel) tier.

The reference's two horizon sweeps are strictly sequential loops of dependent
matvecs (reference: src/tinympc/admm.cpp:27-37 forward rollout, :15-22
backward gradient recursion) — latency O(N). Both are *affine* recurrences:

    forward:   x_{i+1} = Acl x_i + b_i,   Acl = A - B Kinf,  b_i = -B d_i
    backward:  p_i     = M p_{i+1} + c_i, M = AmBKt,        c_i = q_i - Kinf^T r_i

Affine maps compose associatively ((A2,b2)∘(A1,b1) = (A2 A1, A2 b1 + b2)), so
each sweep is a ``lax.associative_scan`` of depth O(log N) — sequence
parallelism for the MPC horizon (SURVEY.md §5 "Long-context" row). Extra
work is O(N nx^3) matmul FLOPs; for horizons in the hundreds this trades
cheap FLOPs for a ~N/log N latency cut on the critical path.

Semantics identical to the scan tier (same dropped coeff_d2p term etc.);
tested for parity. Sweeps are single-instance; batch with ``vmap``. Use via ``admm_iteration(..., forward=forward_pass_assoc,
backward=backward_pass_assoc)`` or :func:`solve_assoc`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import Cache, Problem, Settings, State
from .admm import admm_iteration

_HI = jax.lax.Precision.HIGHEST


def _compose(l, r):
    """Composition of affine maps: apply ``l`` (earlier) then ``r``."""
    Al, bl = l
    Ar, br = r
    A = jnp.matmul(Ar, Al, precision=_HI)
    b = jnp.einsum("...ij,...j->...i", Ar, bl, precision=_HI) + br
    return A, b


def forward_pass_assoc(state: State, problem: Problem, cache: Cache) -> State:
    """Parallel-prefix LQR rollout (semantics of reference admm.cpp:27-37).

    Single-instance shapes (``d (m, nu)``); batch via ``vmap``."""
    m = state.d.shape[0]
    Acl = problem.A - jnp.matmul(problem.B, cache.Kinf, precision=_HI)
    b = -jnp.matmul(state.d, problem.B.T, precision=_HI)       # (m, nx)
    A_elems = jnp.broadcast_to(Acl, (m,) + Acl.shape)
    # prefix_i = f_i ∘ ... ∘ f_0  =>  x_{i+1} = prefix_i(x_0)
    Ap, bp = jax.lax.associative_scan(_compose, (A_elems, b), axis=0)
    x0 = state.x[0]
    x_tail = jnp.einsum("nij,j->ni", Ap, x0, precision=_HI) + bp
    x = jnp.concatenate([x0[None, :], x_tail], axis=0)
    u = -jnp.matmul(x[:-1], cache.Kinf.T, precision=_HI) - state.d
    return state.replace(x=x, u=u)


def backward_pass_assoc(state: State, problem: Problem, cache: Cache) -> State:
    """Parallel-suffix Riccati gradient recursion (semantics of reference
    admm.cpp:15-22; coeff_d2p term dropped as there)."""
    m = state.r.shape[0]
    M = cache.AmBKt
    c = state.q[:-1] - jnp.matmul(
        state.r, cache.Kinf, precision=_HI
    )  # (m, nx): q_i - Kinf^T r_i  (r @ Kinf == Kinf^T r, rowwise)
    A_elems = jnp.broadcast_to(M, (m,) + M.shape)
    # suffix_i = f_i ∘ f_{i+1} ∘ ... ∘ f_{m-1}  =>  p_i = suffix_i(p_{N-1}).
    # Realize by flipping, prefix-scanning, flipping back.
    A_f = jnp.flip(A_elems, axis=0)
    c_f = jnp.flip(c, axis=0)
    Ap, bp = jax.lax.associative_scan(_compose, (A_f, c_f), axis=0)
    Ap = jnp.flip(Ap, axis=0)
    bp = jnp.flip(bp, axis=0)
    p_term = state.p[-1]
    p_head = jnp.einsum("nij,j->ni", Ap, p_term, precision=_HI) + bp
    p = jnp.concatenate([p_head, p_term[None, :]], axis=0)
    # d_i = Quu_inv (B^T p_{i+1} + r_i)
    Btp = jnp.matmul(p[1:], problem.B, precision=_HI)
    d = jnp.matmul(Btp + state.r, cache.Quu_inv.T, precision=_HI)
    return state.replace(p=p, d=d)


def solve_assoc(
    state: State, problem: Problem, cache: Cache, settings: Settings
) -> State:
    """ADMM loop with associative-scan sweeps (same loop semantics as
    :func:`..solver.admm.solve`)."""
    from ..types import SOLVED, UNSOLVED

    state = state.replace(
        status=jnp.asarray(UNSOLVED, state.status.dtype),
        iter=jnp.zeros_like(state.iter),
    )
    step = lambda s: admm_iteration(
        s, problem, cache, settings,
        forward=forward_pass_assoc, backward=backward_pass_assoc,
    )
    if settings.check_termination <= 0:
        return jax.lax.fori_loop(
            0, settings.max_iter, lambda _, s: step(s), state
        )

    def cond(s: State):
        return (s.iter < settings.max_iter) & (s.status != SOLVED)

    return jax.lax.while_loop(cond, step, state)
