"""Pure-jnp ADMM solver core — semantic reference implementation.

This module is the functional counterpart of the reference solver core
(reference: src/tinympc/admm.cpp): one pure function per stage, composed into
``admm_iteration``/``solve``. The horizon sweeps use ``lax.scan``; early
termination uses ``lax.while_loop``. It is the *exactness* tier — the
ground-truth semantics every accelerated path (condensed operators, Pallas
kernels, sharded batches) is tested against.

Stage ordering and warm-start semantics replicated exactly
(reference: src/tinympc/admm.cpp:111-152; see also SURVEY.md §3.1):

1. ``forward_pass`` runs *first* each iteration, consuming ``d`` from the
   previous iteration (or the previous solve — warm start; zeros cold).
2. slack -> dual -> linear-cost updates.
3. Termination checked every ``check_termination`` iterations; on convergence
   the iteration exits *without* saving ``v/z`` and *without* the backward pass.
4. Otherwise ``v = vnew``, ``z = znew``, then ``backward_pass_grad`` closes the
   iteration.

Deliberately replicated quirks (do not "fix"):
- ``update_linear_cost`` multiplies ``Xref`` by whatever diagonal ``Q`` sits in
  the workspace (raw in the examples, rho-augmented in codegen output)
  (reference: src/tinympc/admm.cpp:81).
- The ``Uref`` term in ``r`` is dropped (commented out in reference
  src/tinympc/admm.cpp:79), as is the always-zero ``coeff_d2p`` term in the
  backward pass (src/tinympc/admm.cpp:20).
- Dual residuals scale by rho; primal/dual residuals compare pre-projection
  iterates against new slacks and old-vs-new slacks respectively
  (src/tinympc/admm.cpp:95-98).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import SOLVED, UNSOLVED, Cache, Problem, Settings, State

_HI = jax.lax.Precision.HIGHEST


def _scoped(name):
    """Tag a stage with jax.named_scope so profiler traces show the ADMM
    stages by name (SURVEY.md §5 tracing row)."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def _mv(M: jax.Array, v: jax.Array) -> jax.Array:
    """Matrix-vector product at full f32 precision (HIGHEST: never TF32)."""
    return jnp.matmul(M, v, precision=_HI)


@_scoped("admm/forward_pass")
def forward_pass(state: State, problem: Problem, cache: Cache) -> State:
    """LQR rollout: u_i = -Kinf x_i - d_i; x_{i+1} = A x_i + B u_i
    (reference: src/tinympc/admm.cpp:27-37)."""

    def step(x_i, d_i):
        u_i = -_mv(cache.Kinf, x_i) - d_i
        x_next = _mv(problem.A, x_i) + _mv(problem.B, u_i)
        return x_next, (u_i, x_next)

    _, (u, x_tail) = jax.lax.scan(step, state.x[0], state.d)
    x = jnp.concatenate([state.x[:1], x_tail], axis=0)
    return state.replace(u=u, x=x)


@_scoped("admm/update_slack")
def update_slack(state: State, problem: Problem, settings: Settings) -> State:
    """Project slack variables onto the box constraints
    (reference: src/tinympc/admm.cpp:45-61)."""
    znew = state.u + state.y
    vnew = state.x + state.g
    if settings.en_input_bound:
        znew = jnp.minimum(problem.u_max, jnp.maximum(problem.u_min, znew))
    if settings.en_state_bound:
        vnew = jnp.minimum(problem.x_max, jnp.maximum(problem.x_min, vnew))
    return state.replace(znew=znew, vnew=vnew)


@_scoped("admm/update_dual")
def update_dual(state: State) -> State:
    """Scaled dual ascent (reference: src/tinympc/admm.cpp:67-71)."""
    return state.replace(
        y=state.y + state.u - state.znew,
        g=state.g + state.x - state.vnew,
    )


@_scoped("admm/update_linear_cost")
def update_linear_cost(state: State, problem: Problem, cache: Cache) -> State:
    """Refresh linear cost terms from references, slacks and duals
    (reference: src/tinympc/admm.cpp:77-85)."""
    r = -cache.rho * (state.znew - state.y)
    q = -(problem.Xref * problem.Q) - cache.rho * (state.vnew - state.g)
    p_terminal = -_mv(problem.Xref[-1], cache.Pinf) - cache.rho * (
        state.vnew[-1] - state.g[-1]
    )
    p = state.p.at[-1].set(p_terminal)
    return state.replace(r=r, q=q, p=p)


def compute_residuals(state: State, cache: Cache) -> tuple[jax.Array, ...]:
    """Max-abs primal/dual residuals (reference: src/tinympc/admm.cpp:95-98)."""
    pri_state = jnp.max(jnp.abs(state.x - state.vnew))
    dua_state = jnp.max(jnp.abs(state.v - state.vnew)) * cache.rho
    pri_input = jnp.max(jnp.abs(state.u - state.znew))
    dua_input = jnp.max(jnp.abs(state.z - state.znew)) * cache.rho
    return pri_state, dua_state, pri_input, dua_input


@_scoped("admm/backward_pass_grad")
def backward_pass_grad(state: State, problem: Problem, cache: Cache) -> State:
    """Riccati backward gradient recursion
    (reference: src/tinympc/admm.cpp:15-22; coeff_d2p term dropped as there)."""
    Bt = problem.B.T
    Kt = cache.Kinf.T

    def step(p_next, inp):
        q_i, r_i = inp
        d_i = _mv(cache.Quu_inv, _mv(Bt, p_next) + r_i)
        p_i = q_i + _mv(cache.AmBKt, p_next) - _mv(Kt, r_i)
        return p_i, (d_i, p_i)

    _, (d, p_head) = jax.lax.scan(
        step, state.p[-1], (state.q[:-1], state.r), reverse=True
    )
    p = jnp.concatenate([p_head, state.p[-1:]], axis=0)
    return state.replace(d=d, p=p)


def admm_iteration(
    state: State, problem: Problem, cache: Cache, settings: Settings,
    *,
    forward=None,
    backward=None,
    project=None,
) -> State:
    """One full ADMM iteration with the reference's exact stage ordering and
    early-exit data flow (reference: src/tinympc/admm.cpp:117-150).

    ``forward``/``backward`` override the horizon-sweep realizations (same
    signature as :func:`forward_pass`/:func:`backward_pass_grad`) — used by the
    associative-scan long-horizon tier; semantics must match exactly.
    ``project`` overrides the slack projection (same signature as
    :func:`update_slack`) — used by the second-order-cone extension
    (:mod:`.cones`); the default is the reference's box clip.
    """
    forward = forward or forward_pass
    backward = backward or backward_pass_grad
    project = project or update_slack
    state = state.replace(iter=state.iter + 1)
    state = forward(state, problem, cache)
    if settings.alpha != 1.0:
        # OSQP-style over-relaxation (beyond-reference, opt-in — the
        # reference's dual ascent is the alpha=1 case, admm.cpp:67-71):
        # the slack projection and dual update see the relaxed iterate
        # alpha*u + (1-alpha)*z_old; the true iterates (and hence the
        # residual definitions, linear-cost stage, and backward pass)
        # are untouched.
        a = settings.alpha
        relaxed = state.replace(
            u=a * state.u + (1.0 - a) * state.z,
            x=a * state.x + (1.0 - a) * state.v,
        )
        relaxed = project(relaxed, problem, settings)
        relaxed = update_dual(relaxed)
        state = state.replace(
            znew=relaxed.znew, vnew=relaxed.vnew,
            y=relaxed.y, g=relaxed.g,
        )
    else:
        state = project(state, problem, settings)
        state = update_dual(state)
    state = update_linear_cost(state, problem, cache)

    if settings.check_termination > 0:
        do_check = (state.iter % settings.check_termination) == 0
        pri_s, dua_s, pri_u, dua_u = compute_residuals(state, cache)
        # Residual fields persist between checks (reference stores them in the
        # workspace only at check iterations — src/tinympc/admm.cpp:93-98).
        keep = lambda new, old: jnp.where(do_check, new, old)
        state = state.replace(
            primal_residual_state=keep(pri_s, state.primal_residual_state),
            dual_residual_state=keep(dua_s, state.dual_residual_state),
            primal_residual_input=keep(pri_u, state.primal_residual_input),
            dual_residual_input=keep(dua_u, state.dual_residual_input),
        )
        converged = do_check & (
            (pri_s < settings.abs_pri_tol)
            & (pri_u < settings.abs_pri_tol)
            & (dua_s < settings.abs_dua_tol)
            & (dua_u < settings.abs_dua_tol)
        )
    else:
        converged = jnp.asarray(False)

    # On convergence the reference returns *before* saving slacks and running the
    # backward pass (src/tinympc/admm.cpp:135-144); replicate by masking.
    advanced = backward(
        state.replace(v=state.vnew, z=state.znew), problem, cache
    )
    pick = lambda on_conv, on_cont: jax.tree.map(
        lambda a, b: jnp.where(converged, a, b), on_conv, on_cont
    )
    state = pick(state, advanced)
    status = jnp.where(converged, SOLVED, state.status)
    return state.replace(status=status.astype(state.status.dtype))


def solve(
    state: State, problem: Problem, cache: Cache, settings: Settings,
    *, project=None,
) -> State:
    """Run the ADMM loop to convergence or ``max_iter``
    (reference: src/tinympc/admm.cpp:111-152).

    Returns the final state; ``state.status == SOLVED`` corresponds to the
    reference's exitflag 0, anything else to exitflag 1. With
    ``check_termination == 0`` this is a fixed-iteration ``fori_loop``
    (deterministic mode for benchmarking and golden parity). ``project``
    overrides the slack projection (see :func:`admm_iteration`).
    """
    state = state.replace(
        status=jnp.asarray(UNSOLVED, state.status.dtype),
        iter=jnp.zeros_like(state.iter),
    )
    step = lambda s: admm_iteration(
        s, problem, cache, settings, project=project
    )
    if settings.check_termination <= 0:
        return jax.lax.fori_loop(
            0, settings.max_iter, lambda _, s: step(s), state
        )

    def cond(s: State):
        return (s.iter < settings.max_iter) & (s.status != SOLVED)

    return jax.lax.while_loop(cond, step, state)
