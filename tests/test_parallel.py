"""Sharded batch solves on the 8-virtual-device CPU mesh (SURVEY.md §4 item 5):
sharding must not change numerics, and global stats must be correctly psum'd."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
from accelerated_tinympc_tpu.parallel.mesh import (
    BATCH_AXIS,
    make_batch_mesh,
    replicate,
    shard_batch,
    sharded_solve,
    summarize_stats,
)
from accelerated_tinympc_tpu.solver.batched import init_state_batched, solve_batched

B = 16  # 2 instances per device on the 8-device test mesh


@pytest.fixture(scope="module")
def setup():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    problem, cache, x0 = quadrotor_hovering_setup()
    rng = np.random.default_rng(3)
    x0s = jnp.asarray(
        np.asarray(x0)[None] + 0.1 * rng.standard_normal((B, 12)), jnp.float32
    )
    return problem, cache, x0s


def _state_for(problem, x0s):
    st = init_state_batched(x0s.shape[0], problem.nx, problem.nu, problem.horizon)
    return st.replace(x=st.x.at[:, 0, :].set(x0s))


def test_sharded_matches_unsharded(setup):
    problem, cache, x0s = setup
    settings = atm.Settings(
        abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=400, check_termination=1
    )
    mesh = make_batch_mesh(8)
    solve_fn = sharded_solve(mesh, settings)
    state = shard_batch(_state_for(problem, x0s), mesh)
    problem_r = replicate(problem, mesh)
    cache_r = replicate(cache, mesh)
    got, stats = solve_fn(state, problem_r, cache_r)

    want = jax.jit(
        lambda s: solve_batched(s, problem, cache, settings)
    )(_state_for(problem, x0s))

    np.testing.assert_array_equal(np.asarray(got.iter), np.asarray(want.iter))
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(want.status))
    np.testing.assert_allclose(
        np.asarray(got.u), np.asarray(want.u), rtol=0, atol=1e-4
    )

    s = summarize_stats(stats)
    assert s["n_total"] == B
    assert s["converged_fraction"] == pytest.approx(
        float(np.mean(np.asarray(want.status) == atm.SOLVED))
    )
    assert s["iterations_max"] == float(np.max(np.asarray(want.iter)))
    assert s["iterations_mean"] == pytest.approx(
        float(np.mean(np.asarray(want.iter))), rel=1e-6
    )


def test_output_sharding_preserved(setup):
    problem, cache, x0s = setup
    settings = atm.Settings(max_iter=10, check_termination=0)
    mesh = make_batch_mesh(8)
    solve_fn = sharded_solve(mesh, settings)
    state = shard_batch(_state_for(problem, x0s), mesh)
    got, _ = solve_fn(state, replicate(problem, mesh), replicate(cache, mesh))
    shard_axes = got.u.sharding.spec
    assert shard_axes[0] == BATCH_AXIS, (
        "solve output must stay batch-sharded (no implicit gather)"
    )


def test_uneven_convergence_stats(setup):
    """Stats reduce correctly when devices hold instances with different
    convergence behavior."""
    problem, cache, x0s = setup
    settings = atm.Settings(
        abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=150, check_termination=1
    )
    mesh = make_batch_mesh(8)
    solve_fn = sharded_solve(mesh, settings)
    state = shard_batch(_state_for(problem, x0s), mesh)
    got, stats = solve_fn(state, replicate(problem, mesh), replicate(cache, mesh))
    s = summarize_stats(stats)
    statuses = np.asarray(got.status)
    assert s["n_converged"] if "n_converged" in s else True
    assert s["converged_fraction"] == pytest.approx(
        float(np.mean(statuses == atm.SOLVED))
    )


def test_sharded_fused_solve(setup):
    """Fused kernel per shard under shard_map (Pallas interpreter on the CPU
    mesh): matches the unsharded fused solve, stats psum correctly."""
    from accelerated_tinympc_tpu.ops import FusedCarry, fused_solve, pad_problem
    from accelerated_tinympc_tpu.parallel import sharded_fused_solve
    from accelerated_tinympc_tpu.precompute import condensed_operators

    problem, cache, x0s = setup
    ops = condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon
    )
    pp = pad_problem(problem, cache, ops)
    mesh = make_batch_mesh(8)
    solve = sharded_fused_solve(
        mesh, pp, max_iter=20, check_termination=0, interpret=True,
    )
    carry = FusedCarry.zeros(B, pp)
    x0_sh = shard_batch(x0s, mesh)
    carry_sh = shard_batch(carry, mesh)
    res, stats = solve(x0_sh, carry_sh)
    assert res.U.sharding.spec[0] == BATCH_AXIS
    assert float(stats["n_total"]) == B
    want = fused_solve(
        x0s, carry, pp, max_iter=20, check_termination=0, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(res.U), np.asarray(want.U), rtol=0, atol=1e-5
    )


def test_sharded_block_solver_hook(setup):
    """The block-condensed tier under the mesh (round 5): sharded_solve's
    solver hook with block sweeps matches the unsharded block solve."""
    from accelerated_tinympc_tpu.parallel import replicate, sharded_solve
    from accelerated_tinympc_tpu.solver.block_condensed import block_sweeps

    problem, cache, x0s = setup
    settings = atm.Settings(max_iter=15, check_termination=1)
    fwd, bwd = block_sweeps(cache, problem.A, problem.B, problem.horizon, 4)
    mesh = make_batch_mesh(8)
    solve = sharded_solve(
        mesh, settings,
        solver=lambda s, p, c: solve_batched(
            s, p, c, settings, forward=fwd, backward=bwd),
    )
    st = init_state_batched(B, 12, 4, 10)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    out, stats = solve(
        shard_batch(st, mesh), replicate(problem, mesh),
        replicate(cache, mesh),
    )
    assert float(stats["n_total"]) == B
    want = jax.jit(lambda s: solve_batched(
        s, problem, cache, settings, forward=fwd, backward=bwd))(st)
    np.testing.assert_array_equal(np.asarray(out.iter), np.asarray(want.iter))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(want.u),
                               rtol=0, atol=1e-5)
