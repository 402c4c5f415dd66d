"""Per-instance-operator tier: parity against the scan tier on heterogeneous
plants, and batched adaptive rho (rescues mis-scaled penalties without
touching well-scaled instances). SURVEY.md §4 item 4 extended to the
per-instance-plant configuration the reference cannot express
(reference: src/tinympc/tiny_wrapper.hpp:6 one problem per process)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import random_lti_problem
from accelerated_tinympc_tpu.precompute import riccati_cache
from accelerated_tinympc_tpu.solver import admm
from accelerated_tinympc_tpu.solver.batched_ops import (
    OpsState,
    build_instance_ops,
    build_instance_ops_from_plants,
    solve_adaptive_rho_batched,
    solve_instance_ops,
)
from accelerated_tinympc_tpu.types import init_state

B = 6
NX, NU, N = 8, 3, 10


@pytest.fixture(scope="module")
def plants():
    """B distinct random plants + per-plant f64 host caches + random x0s."""
    problems, caches = [], []
    for seed in range(B):
        p, rho = random_lti_problem(seed=seed, nx=NX, nu=NU, horizon=N)
        problems.append(p)
        caches.append(riccati_cache(
            np.asarray(p.A), np.asarray(p.B), np.asarray(p.Q),
            np.asarray(p.R), rho,
        ))
    prob_b = jax.tree.map(lambda *xs: jnp.stack(xs), *problems)
    cache_b = jax.tree.map(lambda *xs: jnp.stack(jnp.asarray(xs)), *caches)
    rng = np.random.default_rng(3)
    x0s = jnp.asarray(rng.standard_normal((B, NX)) * 0.4, jnp.float32)
    return problems, caches, prob_b, cache_b, x0s


def _scan_single(problem, cache, x0, settings):
    st = init_state(NX, NU, N)
    st = st.replace(x=st.x.at[0, :].set(x0))
    return jax.jit(admm.solve)(st, problem, cache, settings)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_parity_vs_scan(plants, mode):
    problems, caches, prob_b, cache_b, x0s = plants
    if mode == "fixed":
        settings = atm.Settings(max_iter=30, check_termination=0)
    else:
        settings = atm.Settings(max_iter=300, check_termination=1,
                                abs_pri_tol=0.02, abs_dua_tol=0.02)
    ops = jax.jit(build_instance_ops)(prob_b, cache_b)
    st = jax.jit(
        lambda x, s: solve_instance_ops(x, s, ops, settings)
    )(x0s, OpsState.zeros(B, N * NX, (N - 1) * NU))

    for i in range(B):
        want = _scan_single(problems[i], caches[i], x0s[i], settings)
        np.testing.assert_allclose(
            np.asarray(st.U[i]).reshape(N - 1, NU), np.asarray(want.u),
            rtol=0, atol=2e-4,
        )
        if mode == "adaptive":
            assert int(st.iter[i]) == int(want.iter)
            assert bool(st.solved[i]) == (int(want.status) == atm.SOLVED)


def test_on_device_plant_build(plants):
    """Fully on-device cache + operator build matches the host f64 path to
    f32 tolerance (vmapped riccati_cache_jax — reference math:
    src/tinympc/codegen.cpp:268-292)."""
    problems, caches, prob_b, cache_b, x0s = plants
    A = jnp.stack([p.A for p in problems])
    Bm = jnp.stack([p.B for p in problems])
    Q = jnp.stack([p.Q for p in problems])
    R = jnp.stack([p.R for p in problems])
    rho = jnp.ones((B,), jnp.float32)
    ops_dev, caches_dev = jax.jit(build_instance_ops_from_plants)(
        A, Bm, Q, R, rho, prob_b
    )
    ops_host = build_instance_ops(prob_b, cache_b)
    for k in ("W_fd", "W_gd", "W_q", "W_r", "const_d"):
        np.testing.assert_allclose(
            np.asarray(getattr(ops_dev, k)),
            np.asarray(getattr(ops_host, k)),
            rtol=1e-3, atol=2e-4,
        )


def test_adaptive_rho_batched_rescues_misscaled(plants):
    """Instances with rho mis-scaled by 3-4 orders of magnitude converge
    within a small multiple of the well-scaled instances' iterations, and
    well-scaled instances follow the fixed-rho trajectory exactly (the stall
    guard never fires for them)."""
    problems, caches, prob_b, cache_b, x0s = plants
    A = jnp.stack([p.A for p in problems])
    Bm = jnp.stack([p.B for p in problems])
    Q = jnp.stack([p.Q for p in problems])
    R = jnp.stack([p.R for p in problems])
    # Instances 0/1 good rho, 2/3 rho 1e-3 (4 orders off vs ~1-10), 4/5 1e3.
    rho0 = jnp.asarray([1.0, 1.0, 1e-3, 1e-3, 1e3, 1e3], jnp.float32)
    settings = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                            check_termination=1)
    res = jax.jit(
        lambda x, r: solve_adaptive_rho_batched(
            x, prob_b, A, Bm, Q, R, r, settings,
            chunk=25, max_rounds=40,
        )
    )(x0s, rho0)
    assert bool(jnp.all(res.state.solved)), np.asarray(res.total_iter)
    iters = np.asarray(res.total_iter, np.float64)
    good = iters[:2].max()
    bad = iters[2:].max()
    assert bad <= 8 * good + 100, (good, bad)
    # Good-rho instances: rho untouched.
    np.testing.assert_allclose(np.asarray(res.rho[:2]), [1.0, 1.0])

    # And: the mis-scaled instances without adaptation do NOT converge in the
    # same budget (the rescue is real).
    ops0, _ = build_instance_ops_from_plants(A, Bm, Q, R, rho0, prob_b)
    fixed = jax.jit(
        lambda x, s: solve_instance_ops(
            x, s, ops0,
            settings.replace(max_iter=int(res.rounds) * 25),
        )
    )(x0s, OpsState.zeros(B, N * NX, (N - 1) * NU))
    assert not bool(jnp.all(fixed.solved[2:]))


def test_warm_start_reset_duals(plants):
    """OpsState.reset_duals zeroes y/g only (reference:
    tiny_wrapper.cpp:131-140 semantics)."""
    problems, caches, prob_b, cache_b, x0s = plants
    ops = build_instance_ops(prob_b, cache_b)
    settings = atm.Settings(max_iter=10, check_termination=0)
    st = solve_instance_ops(
        x0s, OpsState.zeros(B, N * NX, (N - 1) * NU), ops, settings
    )
    st2 = st.reset_duals()
    assert np.all(np.asarray(st2.Y) == 0) and np.all(np.asarray(st2.G) == 0)
    np.testing.assert_array_equal(np.asarray(st2.D), np.asarray(st.D))


def test_adaptive_rho_first_order_refresh(plants):
    """First-order adaptive caching (PAPERS.md): the axpy refresh mode
    rescues the same mis-scaled-rho instances as the exact rebuild, with
    matching final controls (the O(drho^2) operator error stays below the
    adaptation tolerance scale) and untouched well-scaled instances."""
    problems, caches, prob_b, cache_b, x0s = plants
    A = jnp.stack([p.A for p in problems])
    Bm = jnp.stack([p.B for p in problems])
    Q = jnp.stack([p.Q for p in problems])
    R = jnp.stack([p.R for p in problems])
    rho0 = jnp.asarray([1.0, 1.0, 1e-3, 1e-3, 1e3, 1e3], jnp.float32)
    settings = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                            check_termination=1)

    def run(refresh):
        return jax.jit(
            lambda x, r: solve_adaptive_rho_batched(
                x, prob_b, A, Bm, Q, R, r, settings,
                chunk=25, max_rounds=40, refresh=refresh,
            )
        )(x0s, rho0)

    exact = run("exact")
    fo = run("first_order")
    assert bool(jnp.all(fo.state.solved))
    # Well-scaled instances follow the fixed-rho path bit-for-bit in both
    # modes (their rho never moves, so the Taylor delta is exactly zero and
    # the axpy returns the anchor operators verbatim).
    np.testing.assert_allclose(np.asarray(fo.rho[:2]), [1.0, 1.0])
    np.testing.assert_array_equal(
        np.asarray(fo.state.U[:2]), np.asarray(exact.state.U[:2])
    )
    # Rescued instances land on solutions consistent with the exact-refresh
    # mode at the adaptation tolerance scale.
    du = np.max(np.abs(np.asarray(fo.state.U) - np.asarray(exact.state.U)))
    assert du < 5e-2, du
    # The rescue budget stays in the same ballpark as exact refresh.
    assert int(jnp.max(fo.total_iter)) <= 2 * int(jnp.max(exact.total_iter)) + 100


def test_instance_ops_cones(plants):
    """SOC cones in the per-instance-operator tier: parity vs the scan
    tier's cone path on distinct plants, and through the batched
    adaptive-rho loop (coned adaptive SOC MPC converges)."""
    from accelerated_tinympc_tpu.solver.cones import (
        Cone, ConeSet, cone_slack_update,
    )

    problems, caches, prob_b, cache_b, x0s = plants
    cones = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=1.0,
                                      shift=2.0),))
    settings = atm.Settings(max_iter=40, check_termination=0)
    ops = build_instance_ops(prob_b, cache_b)
    st = solve_instance_ops(
        x0s, OpsState.zeros(B, N * NX, (N - 1) * NU), ops, settings,
        cones=cones, dims=(NX, NU),
    )
    from accelerated_tinympc_tpu.solver.batched import solve_batched

    bst = init_state(NX, NU, N)
    import jax as _jax

    stb = _jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape).copy(), bst
    )
    stb = stb.replace(x=stb.x.at[:, 0, :].set(x0s))
    want = solve_batched(
        stb, prob_b, cache_b, settings,
        problem_axes=0, cache_axes=0, project=cone_slack_update(cones),
    )
    np.testing.assert_allclose(
        np.asarray(st.U), np.asarray(want.u.reshape(B, -1)),
        rtol=0, atol=2e-5,
    )

    # Coned adaptive rho: mis-scaled instances still get rescued with the
    # cone enforced every chunk.
    A = jnp.stack([p.A for p in problems])
    Bm = jnp.stack([p.B for p in problems])
    Q = jnp.stack([p.Q for p in problems])
    R = jnp.stack([p.R for p in problems])
    rho0 = jnp.asarray([1.0, 1.0, 1e-3, 1e-3, 1e3, 1e3], jnp.float32)
    asets = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                         check_termination=1)
    res = jax.jit(
        lambda x, r: solve_adaptive_rho_batched(
            x, prob_b, A, Bm, Q, R, r, asets,
            chunk=25, max_rounds=40, cones=cones,
        )
    )(x0s, rho0)
    assert bool(jnp.all(res.state.solved)), np.asarray(res.total_iter)


def test_adaptive_rho_chunked(plants):
    """solve_adaptive_rho_chunked (batches split into fixed-size
    dispatches): bit-exact vs per-chunk dispatches of the same shape (incl. a
    non-divisible padded tail), and matches the one-call full-batch result
    to f32 reassociation tolerance."""
    from accelerated_tinympc_tpu.solver import solve_adaptive_rho_chunked

    problems, caches, prob_b, cache_b, x0s = plants
    A = jnp.stack([p.A for p in problems])
    Bm = jnp.stack([p.B for p in problems])
    Q = jnp.stack([p.Q for p in problems])
    R = jnp.stack([p.R for p in problems])
    rho0 = jnp.asarray([1.0, 1.0, 1e-3, 1e-3, 1e3, 1e3], jnp.float32)
    settings = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                            check_termination=1)
    kw = dict(chunk=25, max_rounds=40)

    # Bit-exactness vs manual same-shape dispatches (batch_chunk=3 divides).
    part3 = solve_adaptive_rho_chunked(
        x0s, prob_b, A, Bm, Q, R, rho0, settings, batch_chunk=3, **kw,
    )
    run3 = jax.jit(
        lambda x, pb, a, bm, q, r, rh: solve_adaptive_rho_batched(
            x, pb, a, bm, q, r, rh, settings, **kw)
    )
    tk = lambda t, s: jax.tree.map(lambda v: v[s], t)
    for s in (slice(0, 3), slice(3, 6)):
        want = run3(x0s[s], tk(prob_b, s), A[s], Bm[s], Q[s], R[s], rho0[s])
        np.testing.assert_array_equal(np.asarray(part3.rho[s]),
                                      np.asarray(want.rho))
        np.testing.assert_array_equal(np.asarray(part3.state.U[s]),
                                      np.asarray(want.state.U))
        np.testing.assert_array_equal(np.asarray(part3.total_iter[s]),
                                      np.asarray(want.total_iter))

    # Full-batch cross-check (different dispatch shape => f32 tolerance).
    full = jax.jit(
        lambda x, r: solve_adaptive_rho_batched(
            x, prob_b, A, Bm, Q, R, r, settings, **kw)
    )(x0s, rho0)
    for bc in (3, 4):   # 4 exercises the padded tail (6 = 4 + 2pad)
        part = solve_adaptive_rho_chunked(
            x0s, prob_b, A, Bm, Q, R, rho0, settings,
            batch_chunk=bc, **kw,
        )
        np.testing.assert_array_equal(np.asarray(part.state.solved),
                                      np.asarray(full.state.solved))
        np.testing.assert_allclose(np.asarray(part.rho),
                                   np.asarray(full.rho), rtol=2e-2)
        np.testing.assert_allclose(np.asarray(part.state.U),
                                   np.asarray(full.state.U),
                                   rtol=0, atol=5e-3)
        # Untouched (well-scaled) instances are unaffected by batch shape
        # at the schedule level.
        np.testing.assert_array_equal(np.asarray(part.total_iter[:2]),
                                      np.asarray(full.total_iter[:2]))
