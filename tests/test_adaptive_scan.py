"""Adaptive rho on the scan tier (solver/adaptive_scan.py): the
shape-unbound member of the adaptive family — any horizon, any nx, no
condensed operators, no repack stage. Round structure must match the
einsum tier decision-for-decision at matched shapes, and the capability
must actually rescue mis-scaled instances at shapes NO other adaptive
tier covers (long horizon + nx>16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import random_lti_problem
from accelerated_tinympc_tpu.solver.adaptive_scan import (
    solve_adaptive_rho_scan,
)

B, NX, NU, N = 6, 8, 3, 10


@pytest.fixture(scope="module")
def plants():
    problems = [
        random_lti_problem(seed=s, nx=NX, nu=NU, horizon=N)[0]
        for s in range(B)
    ]
    prob_b = jax.tree.map(lambda *xs: jnp.stack(xs), *problems)
    rng = np.random.default_rng(3)
    x0s = jnp.asarray(rng.standard_normal((B, NX)) * 0.4, jnp.float32)
    A = jnp.stack([p.A for p in problems])
    Bm = jnp.stack([p.B for p in problems])
    Q = jnp.stack([p.Q for p in problems])
    R = jnp.stack([p.R for p in problems])
    return prob_b, A, Bm, Q, R, x0s


def test_matches_einsum_tier_schedules(plants):
    """Same adaptation decisions as solve_adaptive_rho_batched at a
    matched short-horizon shape (rounds, rho endpoints, converged set)."""
    from accelerated_tinympc_tpu.solver.batched_ops import (
        solve_adaptive_rho_batched,
    )

    prob_b, A, Bm, Q, R, x0s = plants
    rho0 = jnp.asarray([1.0, 1.0, 1e-3, 1e-3, 1e3, 1e3], jnp.float32)
    settings = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                            check_termination=1)
    kw = dict(chunk=25, max_rounds=40)
    want = jax.jit(
        lambda x, r: solve_adaptive_rho_batched(
            x, prob_b, A, Bm, Q, R, r, settings, riccati="vmap", **kw)
    )(x0s, rho0)
    got = solve_adaptive_rho_scan(
        x0s, prob_b, A, Bm, Q, R, rho0, settings, riccati="vmap", **kw)
    assert bool(jnp.all(got.solved))
    np.testing.assert_array_equal(np.asarray(got.solved),
                                  np.asarray(want.state.solved))
    np.testing.assert_allclose(np.asarray(got.rho[:2]), [1.0, 1.0])
    np.testing.assert_allclose(np.asarray(got.rho), np.asarray(want.rho),
                               rtol=5e-2)
    got_rounds = np.ceil(np.asarray(got.total_iter) / kw["chunk"])
    want_rounds = np.ceil(np.asarray(want.total_iter) / kw["chunk"])
    np.testing.assert_array_equal(got_rounds, want_rounds)
    U_want = np.asarray(want.state.U).reshape(B, N - 1, NU)
    np.testing.assert_allclose(np.asarray(got.state.u), U_want,
                               rtol=0, atol=5e-2)


def test_newton_matches_fixed_point_refresh(plants):
    prob_b, A, Bm, Q, R, x0s = plants
    rho0 = jnp.asarray([1.0, 1.0, 1e-3, 1e-3, 1e3, 1e3], jnp.float32)
    settings = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                            check_termination=1)
    kw = dict(chunk=25, max_rounds=40)
    fp = solve_adaptive_rho_scan(
        x0s, prob_b, A, Bm, Q, R, rho0, settings, riccati="vmap", **kw)
    nt = solve_adaptive_rho_scan(
        x0s, prob_b, A, Bm, Q, R, rho0, settings, riccati="newton", **kw)
    np.testing.assert_array_equal(np.asarray(nt.solved),
                                  np.asarray(fp.solved))
    np.testing.assert_allclose(np.asarray(nt.rho), np.asarray(fp.rho),
                               rtol=5e-2)


def test_rescues_at_uncovered_shape():
    """A long horizon (N=96) and a wide state (nx=18) at once. Mis-scaled rho
    instances converge via adaptation where fixed rho does not in the
    same budget."""
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched, solve_batched,
    )
    from accelerated_tinympc_tpu.precompute import riccati_cache

    B2, nx2, nu2, N2 = 4, 18, 4, 96
    problems = [random_lti_problem(seed=s, nx=nx2, nu=nu2, horizon=N2)[0]
                for s in range(B2)]
    prob_b = jax.tree.map(lambda *xs: jnp.stack(xs), *problems)
    A = jnp.stack([p.A for p in problems])
    Bm = jnp.stack([p.B for p in problems])
    Q = jnp.stack([p.Q for p in problems])
    R = jnp.stack([p.R for p in problems])
    rng = np.random.default_rng(5)
    x0s = jnp.asarray(rng.standard_normal((B2, nx2)) * 0.3, jnp.float32)
    rho0 = jnp.asarray([1e-3, 1e3, 1e-3, 1e3], jnp.float32)
    settings = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                            check_termination=1)
    got = solve_adaptive_rho_scan(
        x0s, prob_b, A, Bm, Q, R, rho0, settings,
        chunk=25, max_rounds=40, riccati="newton")
    assert bool(jnp.all(got.solved)), np.asarray(got.total_iter)

    # Fixed rho at the same total budget: not all converge.
    caches = []
    for b in range(B2):
        caches.append(riccati_cache(
            np.asarray(A[b]), np.asarray(Bm[b]), np.asarray(Q[b]),
            np.asarray(R[b]), float(rho0[b])))
    cache_b = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *caches)
    st = init_state_batched(B2, nx2, nu2, N2)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    budget = int(np.asarray(got.rounds)) * 25
    fixed = jax.jit(lambda ss: solve_batched(
        ss, prob_b, cache_b,
        settings.replace(max_iter=budget), problem_axes=0, cache_axes=0,
    ))(st)
    assert not bool(jnp.all(fixed.status == atm.SOLVED))
