"""Randomized cross-tier consistency fuzzing: for random stabilizable plants
across (nx, nu, N) shapes, all solver tiers (scan, assoc, condensed, block,
fused, instance-ops — and the coned variants of each that supports cones)
must agree on the same ADMM trajectory (fixed iterations; tolerances scaled
for f32 drift)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import random_lti_problem
from accelerated_tinympc_tpu.ops.fused_admm import (
    FusedCarry,
    fused_solve,
    pad_problem,
)
from accelerated_tinympc_tpu.precompute import condensed_operators, riccati_cache
from accelerated_tinympc_tpu.solver import admm
from accelerated_tinympc_tpu.solver.assoc_scan import solve_assoc
from accelerated_tinympc_tpu.solver.batched import init_state_batched, solve_batched
from accelerated_tinympc_tpu.solver.condensed import (
    flatten_problem,
    init_flat_state,
    solve_condensed,
)

SHAPES = [
    (2, 1, 4),
    (4, 2, 8),
    (7, 3, 12),
    (12, 4, 10),
    (9, 5, 17),
]
ITERS = 15
B = 4


@pytest.mark.parametrize("nx,nu,N", SHAPES)
def test_all_tiers_agree(nx, nu, N):
    problem, rho = random_lti_problem(seed=nx * 31 + nu, nx=nx, nu=nu,
                                      horizon=N)
    cache = riccati_cache(
        np.asarray(problem.A), np.asarray(problem.B),
        np.asarray(problem.Q), np.asarray(problem.R), rho,
    )
    rng = np.random.default_rng(nx + nu + N)
    x0s = jnp.asarray(rng.standard_normal((B, nx)) * 0.3, jnp.float32)
    settings = atm.Settings(max_iter=ITERS, check_termination=0)

    # scan tier (batched)
    st = init_state_batched(B, nx, nu, N)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    u_scan = np.asarray(
        jax.jit(lambda s: solve_batched(s, problem, cache, settings))(st).u
    )

    # assoc tier (vmapped)
    sts = jax.tree.map(
        lambda a: a, st
    )
    u_assoc = np.asarray(
        jax.jit(
            jax.vmap(lambda s: solve_assoc(s, problem, cache, settings))
        )(sts).u
    )

    # condensed tier
    ops = condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), N
    )
    fp = flatten_problem(problem, cache)
    fs = init_flat_state(B, nx, nu, N).replace(x0=x0s)
    out = jax.jit(
        lambda s: solve_condensed(s, fp, ops, settings, nx)
    )(fs)
    u_cond = np.asarray(out.U).reshape(B, N - 1, nu)

    # fused tier (interpreter)
    pp = pad_problem(problem, cache, ops)
    res = fused_solve(
        x0s, FusedCarry.zeros(B, pp), pp, max_iter=ITERS,
        check_termination=0, interpret=True,
    )
    u_fused = np.asarray(
        res.U[:, : (N - 1) * nu]
    ).reshape(B, N - 1, nu)

    # instance-ops tier (per-instance plants degenerate to a shared one)
    from accelerated_tinympc_tpu.solver.batched_ops import (
        OpsState, build_instance_ops, solve_instance_ops,
    )

    bcast = lambda t: jax.tree.map(
        lambda a: jnp.broadcast_to(
            jnp.asarray(a), (B,) + jnp.asarray(a).shape
        ), t
    )
    iops = build_instance_ops(bcast(problem), bcast(cache))
    ist = solve_instance_ops(
        x0s, OpsState.zeros(B, N * nx, (N - 1) * nu), iops, settings,
        dims=(nx, nu),
    )
    u_iops = np.asarray(ist.U).reshape(B, N - 1, nu)

    # block-condensed tier
    from accelerated_tinympc_tpu.solver.block_condensed import solve_block

    u_block = np.asarray(
        jax.jit(jax.vmap(
            lambda s: solve_block(s, problem, cache, settings, block=4)
        ))(st).u
    )

    scale = max(1.0, np.abs(u_scan).max())
    tol = 2e-4 * scale
    np.testing.assert_allclose(u_assoc, u_scan, rtol=0, atol=tol,
                               err_msg="assoc")
    np.testing.assert_allclose(u_block, u_scan, rtol=0, atol=tol,
                               err_msg="block")
    np.testing.assert_allclose(u_cond, u_scan, rtol=0, atol=tol,
                               err_msg="condensed")
    np.testing.assert_allclose(u_fused, u_scan, rtol=0, atol=tol,
                               err_msg="fused")
    np.testing.assert_allclose(u_iops, u_scan, rtol=0, atol=tol,
                               err_msg="instance_ops")


CONE_SHAPES = [(4, 2, 8), (12, 4, 10), (9, 5, 17)]


@pytest.mark.parametrize("nx,nu,N", CONE_SHAPES)
def test_coned_tiers_agree(nx, nu, N):
    """Every cone-capable tier agrees on the coned trajectory: scan
    (projection override), condensed, block, instance-ops."""
    from accelerated_tinympc_tpu.solver.batched_ops import (
        OpsState, build_instance_ops, solve_instance_ops,
    )
    from accelerated_tinympc_tpu.solver.cones import (
        Cone, ConeSet, cone_slack_update,
    )

    problem, rho = random_lti_problem(seed=nx * 7 + nu, nx=nx, nu=nu,
                                      horizon=N)
    cache = riccati_cache(
        np.asarray(problem.A), np.asarray(problem.B),
        np.asarray(problem.Q), np.asarray(problem.R), rho,
    )
    cones = ConeSet(
        input_cones=(Cone(ball=(0,), axis=1, mu=0.8, shift=1.5),),
        state_cones=(Cone(ball=(0,), axis=1, mu=1.2, shift=2.0),),
    )
    rng = np.random.default_rng(nx * 13 + N)
    x0s = jnp.asarray(rng.standard_normal((B, nx)) * 0.3, jnp.float32)
    settings = atm.Settings(max_iter=ITERS, check_termination=0)

    st = init_state_batched(B, nx, nu, N)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    u_scan = np.asarray(jax.jit(lambda s: solve_batched(
        s, problem, cache, settings, project=cone_slack_update(cones)
    ))(st).u)
    scale = max(1.0, np.abs(u_scan).max())
    tol = 2e-4 * scale

    ops = condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), N
    )
    fp = flatten_problem(problem, cache)
    fs = init_flat_state(B, nx, nu, N).replace(x0=x0s)
    out = jax.jit(lambda s: solve_condensed(
        s, fp, ops, settings, nx, cones=cones, nu=nu
    ))(fs)
    np.testing.assert_allclose(
        np.asarray(out.U).reshape(B, N - 1, nu), u_scan,
        rtol=0, atol=tol, err_msg="condensed",
    )

    from accelerated_tinympc_tpu.solver.block_condensed import solve_block

    u_block = np.asarray(jax.jit(jax.vmap(lambda s: solve_block(
        s, problem, cache, settings, block=4,
        project=cone_slack_update(cones),
    )))(st).u)
    np.testing.assert_allclose(u_block, u_scan, rtol=0, atol=tol,
                               err_msg="block")

    bcast = lambda t: jax.tree.map(
        lambda a: jnp.broadcast_to(
            jnp.asarray(a), (B,) + jnp.asarray(a).shape
        ), t
    )
    iops = build_instance_ops(bcast(problem), bcast(cache))
    ist = solve_instance_ops(
        x0s, OpsState.zeros(B, N * nx, (N - 1) * nu), iops, settings,
        cones=cones, dims=(nx, nu),
    )
    np.testing.assert_allclose(
        np.asarray(ist.U).reshape(B, N - 1, nu), u_scan,
        rtol=0, atol=tol, err_msg="instance_ops",
    )


@pytest.mark.parametrize("nx,nu,N", [s for s in SHAPES if s[0] >= 3])
def test_masked_cone_tiers_agree(nx, nu, N):
    """Per-instance cone geometry fuzz: random (ball, axis, mu, shift) per
    instance on the state vector; the instance-ops tier's jnp masked
    projection must match a per-instance scan run with the equivalent
    *static* cone."""
    from accelerated_tinympc_tpu.solver.batched_ops import (
        OpsState, build_instance_ops, solve_instance_ops,
    )
    from accelerated_tinympc_tpu.solver.cones import (
        Cone, ConeSet, cone_slack_update, make_cone_args,
    )

    problem, rho = random_lti_problem(seed=nx * 5 + nu, nx=nx, nu=nu,
                                      horizon=N)
    cache = riccati_cache(
        np.asarray(problem.A), np.asarray(problem.B),
        np.asarray(problem.Q), np.asarray(problem.R), rho,
    )
    rng = np.random.default_rng(nx * 17 + N)
    x0s = jnp.asarray(rng.standard_normal((B, nx)) * 0.3, jnp.float32)
    settings = atm.Settings(max_iter=ITERS, check_termination=0)

    balls, axes = [], []
    for _ in range(B):
        ax = int(rng.integers(0, nx))
        others = [j for j in range(nx) if j != ax]
        bl = tuple(sorted(rng.choice(others, 2, replace=False).tolist()))
        axes.append(ax)
        balls.append(bl)
    mus = (0.6 + rng.random(B)).astype(np.float32)
    shifts = (1.0 + rng.random(B)).astype(np.float32)
    base = Cone(ball=balls[0], axis=axes[0], mu=1.0, shift=1.0)
    cones = ConeSet(state_cones=(base,))
    ball_arr = np.zeros((B, nx), np.float32)
    for b in range(B):
        ball_arr[b, list(balls[b])] = 1.0
    axis_arr = np.asarray(axes, np.int64)

    # Per-instance scan reference at the equivalent static cone.
    u_ref = []
    for b in range(B):
        cset = ConeSet(state_cones=(Cone(
            ball=balls[b], axis=axes[b], mu=float(mus[b]),
            shift=float(shifts[b]),
        ),))
        st1 = init_state_batched(1, nx, nu, N)
        st1 = st1.replace(x=st1.x.at[:, 0, :].set(x0s[b:b + 1]))
        u_ref.append(np.asarray(jax.jit(lambda s, _c=cset: solve_batched(
            s, problem, cache, settings, project=cone_slack_update(_c)
        ))(st1).u)[0])
    u_ref = np.stack(u_ref)
    tol = 2e-4 * max(1.0, np.abs(u_ref).max())

    bcast = lambda t: jax.tree.map(
        lambda a: jnp.broadcast_to(
            jnp.asarray(a), (B,) + jnp.asarray(a).shape
        ), t
    )
    ca = make_cone_args(cones, B, nx, nu, mu_x=mus[None], shift_x=shifts[None],
                        ball_x=[ball_arr], axis_x=[axis_arr])
    iops = build_instance_ops(bcast(problem), bcast(cache))
    ist = solve_instance_ops(
        x0s, OpsState.zeros(B, N * nx, (N - 1) * nu), iops, settings,
        cones=cones, dims=(nx, nu), cone_args=ca,
    )
    np.testing.assert_allclose(
        np.asarray(ist.U).reshape(B, N - 1, nu), u_ref,
        rtol=0, atol=tol, err_msg="instance_ops",
    )
