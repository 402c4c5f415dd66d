"""OSQP-style over-relaxation (Settings.alpha — beyond-reference, opt-in;
the reference's dual ascent is the alpha=1 case, reference:
src/tinympc/admm.cpp:67-71). Contracts:

* alpha=1.0 (the default) is bit-identical to the pre-round-5 schedules —
  the whole golden/parity suite pins that implicitly; here we pin it
  explicitly against an alpha-free run.
* alpha=1.6 converges to the same constrained solution (same fixed point:
  relaxation changes the iteration map, not its fixed points) in fewer
  iterations on the shipped hovering workload.
* scan tier, fused kernel and condensed tier agree schedule-for-schedule
  at alpha=1.6 (both adaptive and fixed mode), including with SOC cones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
from accelerated_tinympc_tpu.ops.fused_admm import (
    FusedCarry,
    fused_solve,
    pad_problem,
    unpad_states,
)
from accelerated_tinympc_tpu.precompute import condensed_operators
from accelerated_tinympc_tpu.solver.batched import (
    batch_stats,
    init_state_batched,
    solve_batched,
)

B = 8


@pytest.fixture(scope="module")
def setup():
    problem, cache, x0 = quadrotor_hovering_setup()
    ops = condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon
    )
    pp = pad_problem(problem, cache, ops)
    rng = np.random.default_rng(7)
    x0s = jnp.asarray(
        np.asarray(x0)[None] + 0.1 * rng.standard_normal((B, x0.size)),
        jnp.float32,
    )
    return problem, cache, pp, x0s


def _run_scan(problem, cache, x0s, settings):
    st = init_state_batched(
        x0s.shape[0], problem.nx, problem.nu, problem.horizon
    )
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    return jax.jit(lambda s: solve_batched(s, problem, cache, settings))(st)


def test_alpha_one_is_bit_identical(setup):
    problem, cache, _pp, x0s = setup
    base = _run_scan(
        problem, cache, x0s, atm.Settings(max_iter=30, check_termination=1)
    )
    one = _run_scan(
        problem, cache, x0s,
        atm.Settings(max_iter=30, check_termination=1, alpha=1.0),
    )
    np.testing.assert_array_equal(np.asarray(base.u), np.asarray(one.u))
    np.testing.assert_array_equal(np.asarray(base.iter), np.asarray(one.iter))


def test_relaxation_accelerates_constraint_bound_workload(setup):
    """On the hard regime — cold hovering solves with strongly active input
    constraints, where plain ADMM stalls (pri_u plateaus ~1e-2) — alpha=1.6
    reaches tol 0.01 in measurably fewer iterations AND leaves ~4x smaller
    residuals at a fixed budget."""
    problem, cache, _pp, x0s = setup
    tols = dict(abs_pri_tol=0.01, abs_dua_tol=0.01)
    base = _run_scan(
        problem, cache, x0s,
        atm.Settings(max_iter=500, check_termination=1, **tols),
    )
    rel = _run_scan(
        problem, cache, x0s,
        atm.Settings(max_iter=500, check_termination=1, alpha=1.6, **tols),
    )
    it_b = np.asarray(base.iter, np.float64)
    it_r = np.asarray(rel.iter, np.float64)
    assert it_r.mean() < 0.95 * it_b.mean(), (it_b, it_r)
    # Fixed-budget residual comparison on the instances neither solved.
    both = (np.asarray(base.status) != atm.SOLVED) & (
        np.asarray(rel.status) != atm.SOLVED
    )
    if both.any():
        rb = np.asarray(base.primal_residual_input)[both]
        rr = np.asarray(rel.primal_residual_input)[both]
        assert rr.mean() < rb.mean(), (rb, rr)


def test_relaxation_slows_easy_solves_documented_negative():
    """The measured negative (why alpha stays opt-in): on easy instances
    whose constraints are inactive, alpha=1 sets z_new = u immediately while
    alpha=1.6 turns the slack settle into a |1-alpha| geometric filter —
    iteration counts RISE (3 -> ~9 at tol 0.02 on the random-LTI
    population). Deterministic; pinned so the guidance stays honest."""
    from accelerated_tinympc_tpu.models import random_lti_problem
    from accelerated_tinympc_tpu.precompute import riccati_cache

    p, rho = random_lti_problem(seed=0, nx=8, nu=3, horizon=10)
    c = riccati_cache(np.asarray(p.A), np.asarray(p.B), np.asarray(p.Q),
                      np.asarray(p.R), rho)
    x0r = jnp.asarray(
        np.random.default_rng(0).standard_normal((8, 8)) * 0.4, jnp.float32
    )
    outs = {}
    for a in (1.0, 1.6):
        st = init_state_batched(8, 8, 3, 10)
        st = st.replace(x=st.x.at[:, 0, :].set(x0r))
        s = atm.Settings(max_iter=100, check_termination=1,
                         abs_pri_tol=0.02, abs_dua_tol=0.02, alpha=a)
        outs[a] = jax.jit(lambda ss: solve_batched(ss, p, c, s))(st)
    assert bool(jnp.all(outs[1.0].status == atm.SOLVED))
    assert bool(jnp.all(outs[1.6].status == atm.SOLVED))
    assert (np.asarray(outs[1.6].iter).mean()
            > np.asarray(outs[1.0].iter).mean())


def test_fused_matches_scan_at_alpha(setup):
    problem, cache, pp, x0s = setup
    settings = atm.Settings(max_iter=60, check_termination=1, alpha=1.6)
    want = _run_scan(problem, cache, x0s, settings)
    got = fused_solve(
        x0s, FusedCarry.zeros(B, pp), pp, max_iter=60, check_termination=1,
        interpret=True, alpha=1.6,
    )
    stats = np.asarray(got.stats)
    np.testing.assert_array_equal(
        stats[:, 0].astype(np.int64), np.asarray(want.iter)
    )
    np.testing.assert_array_equal(stats[:, 1] > 0.5,
                                  np.asarray(want.status) == atm.SOLVED)
    nu, N = pp.dims[1], pp.dims[2]
    u = np.asarray(got.U[:, : nu * (N - 1)]).reshape(B, N - 1, nu)
    np.testing.assert_allclose(u, np.asarray(want.u), rtol=0, atol=1e-4)


def test_fused_fixed_mode_matches_scan_at_alpha(setup):
    problem, cache, pp, x0s = setup
    settings = atm.Settings(max_iter=25, check_termination=0, alpha=1.6)
    want = _run_scan(problem, cache, x0s, settings)
    got = fused_solve(
        x0s, FusedCarry.zeros(B, pp), pp, max_iter=25, check_termination=0,
        interpret=True, alpha=1.6,
    )
    x = np.asarray(unpad_states(got, pp))
    np.testing.assert_allclose(x, np.asarray(want.x), rtol=0, atol=2e-4)


def test_relaxation_composes_with_cones(setup):
    from accelerated_tinympc_tpu.solver.cones import (
        Cone, ConeSet, cone_slack_update,
    )

    problem, cache, pp, x0s = setup
    cones = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=1.0),))
    settings = atm.Settings(max_iter=40, check_termination=1, alpha=1.6)
    st = init_state_batched(B, problem.nx, problem.nu, problem.horizon)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    want = jax.jit(lambda s: solve_batched(
        s, problem, cache, settings, project=cone_slack_update(cones)
    ))(st)
    from accelerated_tinympc_tpu.solver.condensed import (
        flatten_problem, init_flat_state, solve_condensed,
    )

    ops = condensed_operators(cache, np.asarray(problem.A),
                              np.asarray(problem.B), problem.horizon)
    fs = init_flat_state(B, problem.nx, problem.nu,
                         problem.horizon).replace(x0=x0s)
    got = jax.jit(lambda s: solve_condensed(
        s, flatten_problem(problem, cache), ops, settings, problem.nx,
        cones=cones, nu=problem.nu,
    ))(fs)
    np.testing.assert_array_equal(np.asarray(got.iter),
                                  np.asarray(want.iter))
    u = np.asarray(got.U).reshape(B, problem.horizon - 1, problem.nu)
    np.testing.assert_allclose(u, np.asarray(want.u), rtol=0, atol=1e-4)


def test_in_kernel_mission_at_alpha(setup):
    """The relaxed iteration threads through the fused-kernel mission
    (scan of kernel solves) exactly like the scan-tier mission."""
    from accelerated_tinympc_tpu.api import fused_mpc_rollout, mpc_rollout

    problem, cache, pp, x0s = setup
    settings = atm.Settings(max_iter=20, check_termination=1, alpha=1.6)
    xf_k, us_k, _ = fused_mpc_rollout(
        pp, x0s, 4, problem=problem, max_iter=20, check_termination=1,
        interpret=True, alpha=1.6)
    _st, xf_s, trace = jax.jit(lambda x: mpc_rollout(
        problem, cache, settings, x, 4, batched=True))(x0s)
    np.testing.assert_allclose(np.asarray(us_k), np.asarray(trace.u),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(xf_k), np.asarray(xf_s),
                               rtol=0, atol=1e-4)


def test_condensed_matches_scan_at_alpha(setup):
    """The condensed tier honors Settings.alpha with the scan tier's
    schedules (every TinyMPC tier honors alpha)."""
    from accelerated_tinympc_tpu.precompute import condensed_operators as _co
    from accelerated_tinympc_tpu.solver.condensed import (
        flatten_problem, init_flat_state, solve_condensed,
    )

    problem, cache, _pp, x0s = setup
    settings = atm.Settings(max_iter=60, check_termination=1, alpha=1.6)
    want = _run_scan(problem, cache, x0s, settings)
    ops = _co(cache, np.asarray(problem.A), np.asarray(problem.B),
              problem.horizon)
    fp = flatten_problem(problem, cache)
    fs = init_flat_state(B, problem.nx, problem.nu,
                         problem.horizon).replace(x0=x0s)
    out = jax.jit(
        lambda s: solve_condensed(s, fp, ops, settings, problem.nx)
    )(fs)
    np.testing.assert_array_equal(np.asarray(out.iter),
                                  np.asarray(want.iter))
    u = np.asarray(out.U).reshape(B, problem.horizon - 1, problem.nu)
    np.testing.assert_allclose(u, np.asarray(want.u), rtol=0, atol=1e-4)
