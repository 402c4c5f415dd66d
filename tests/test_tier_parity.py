"""Parity of the XLA tiers with the scan tier, which holds the reference
semantics (reference: src/tinympc/admm.cpp:111-152): block-condensed and
per-instance-operator tiers at long horizons, fixed and adaptive modes,
per-knot bounds, per-instance cone geometry, the vmapped Riccati / Newton
builders against the host float64 precompute, and scan-of-solve missions.

Adaptive-mode parity means identical per-instance iteration counts (same
check schedule, same early exits) and controls inside the 1e-4 bar.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.api import fleet_mpc_rollout, mpc_rollout
from accelerated_tinympc_tpu.models import (
    quadrotor_hovering_setup,
    quadrotor_tracking_setup,
    random_lti_plants,
    random_lti_problem,
)
from accelerated_tinympc_tpu.precompute import (
    riccati_cache,
    riccati_cache_jax,
    riccati_newton_jax,
    riccati_polish_f64,
)
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched,
    solve_batched,
)
from accelerated_tinympc_tpu.solver.cones import Cone, ConeSet

B = 4
U_TOL = 1e-4


def _settings(mode, iters, tol=2e-2, check=2):
    if mode == "fixed":
        return atm.Settings(max_iter=iters, check_termination=0)
    return atm.Settings(max_iter=iters, check_termination=check,
                        abs_pri_tol=tol, abs_dua_tol=tol)


def _per_knot(problem):
    """Input bounds that tighten along the horizon (time-varying box)."""
    m, nu = problem.u_min.shape
    ramp = jnp.linspace(1.0, 3.0, m, dtype=jnp.float32)[:, None]
    return problem.replace(u_min=-ramp * jnp.ones((1, nu)),
                           u_max=ramp * jnp.ones((1, nu)))


@functools.lru_cache(maxsize=None)
def _long_horizon(N):
    problem, rho = random_lti_problem(seed=N, nx=6, nu=2, horizon=N)
    cache = riccati_cache(np.asarray(problem.A), np.asarray(problem.B),
                          np.asarray(problem.Q), np.asarray(problem.R), rho)
    rng = np.random.default_rng(N)
    x0s = jnp.asarray(rng.standard_normal((B, 6)) * 0.3, jnp.float32)
    return problem, cache, x0s


def _tinympc_u(problem, cache, settings, x0s, tier, **kw):
    m = atm.TinyMPC.from_parts(problem, cache, settings=settings,
                               batch=x0s.shape[0], tier=tier, **kw)
    m.set_x0(x0s)
    info = m.solve()
    return np.asarray(info["iterations"]), np.asarray(m.get_u())


@pytest.mark.parametrize("bounds", ["uniform", "per_knot"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("block", [8, 32])
@pytest.mark.parametrize("N", [64, 256])
def test_block_matches_scan(N, block, mode, bounds):
    """TinyMPC(tier="block") vs tier="scan" at long horizons."""
    problem, cache, x0s = _long_horizon(N)
    if bounds == "per_knot":
        problem = _per_knot(problem)
    iters = 20 if mode == "fixed" else 300
    settings = _settings(mode, iters)
    it_s, u_s = _tinympc_u(problem, cache, settings, x0s, "scan")
    it_b, u_b = _tinympc_u(problem, cache, settings, x0s, "block",
                           block=block)
    np.testing.assert_array_equal(it_b, it_s)
    np.testing.assert_allclose(u_b, u_s, rtol=0,
                               atol=U_TOL * max(1.0, np.abs(u_s).max()))
    if mode == "adaptive":
        assert it_s.min() < iters  # the early exit is exercised


@functools.lru_cache(maxsize=None)
def _fleet(N):
    A, Bm, Q, R = random_lti_plants(B, 6, 2, seed=N)
    rng = np.random.default_rng(N + 1)
    x0s = (rng.standard_normal((B, 6)) * 0.8).astype(np.float32)
    return A, Bm, Q, R, x0s


@pytest.mark.parametrize("bounds", ["uniform", "per_knot"])
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("N", [10, 64])
def test_instance_ops_matches_vmapped_scan(N, mode, bounds):
    """The per-instance-operator tier vs the vmapped scan tier with the same
    per-instance plants. (Its operators are dense in the horizon, O(N^2)
    blocks per instance, so long horizons belong to the scan/block tiers.)"""
    A, Bm, Q, R, x0s = _fleet(N)
    settings = _settings(mode, 20 if mode == "fixed" else 80)
    kw = dict(rho=1.0, horizon=N, settings=settings, polish=False)
    if bounds == "per_knot":
        ramp = np.linspace(0.4, 1.5, N - 1, dtype=np.float32)[None, :, None]
        lim = np.broadcast_to(ramp, (B, N - 1, 2))
        kw.update(u_min=-lim, u_max=lim)
    else:
        kw.update(u_min=-1.0, u_max=1.0)
    out = {}
    for tier in ("scan", "instance_ops"):
        f = atm.TinyMPCFleet.setup(A, Bm, Q, R, tier=tier, **kw)
        f.set_x0(x0s)
        info = f.solve()
        out[tier] = (info["iterations"], np.asarray(f.get_u()))
    np.testing.assert_array_equal(out["instance_ops"][0], out["scan"][0])
    np.testing.assert_allclose(out["instance_ops"][1], out["scan"][1],
                               rtol=0, atol=U_TOL)


GEOMETRIES = {
    "input_xy_z": ("input", (0, 1), 2, (1, 2), 0),
    "input_single_ball": ("input", (0,), 1, (2,), 3),
    "state_pos_glide": ("state", (0, 1), 2, (3, 4), 5),
    "state_mixed": ("state", (0,), 2, (1, 3), 4),
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_instance_ops_per_instance_cone_geometry(geometry):
    """Per-instance (ball, axis, mu, shift) on the instance-ops tier: each
    instance matches a scan solve with its geometry as a static cone."""
    from accelerated_tinympc_tpu.solver.batched_ops import (
        OpsState, build_instance_ops, solve_instance_ops,
    )
    from accelerated_tinympc_tpu.solver.cones import (
        cone_slack_update, make_cone_args,
    )

    side, ball_a, axis_a, ball_b, axis_b = GEOMETRIES[geometry]
    nx, nu, N = 6, 4, 8
    problem, rho = random_lti_problem(seed=3, nx=nx, nu=nu, horizon=N)
    cache = riccati_cache(np.asarray(problem.A), np.asarray(problem.B),
                          np.asarray(problem.Q), np.asarray(problem.R), rho)
    dim = nu if side == "input" else nx
    mus = np.asarray([0.6, 0.9, 1.2, 0.7], np.float32)
    shifts = np.asarray([1.0, 1.5, 2.0, 1.2], np.float32)
    geo = [(ball_a, axis_a), (ball_b, axis_b)] * 2
    ball = np.zeros((B, dim), np.float32)
    for b, (bl, _ax) in enumerate(geo):
        ball[b, list(bl)] = 1.0
    axis = np.asarray([ax for _bl, ax in geo], np.int64)
    base = Cone(ball=ball_a, axis=axis_a, mu=1.0, shift=1.0)
    cones = (ConeSet(input_cones=(base,)) if side == "input"
             else ConeSet(state_cones=(base,)))
    sfx = "_u" if side == "input" else "_x"
    args = make_cone_args(cones, B, nx, nu, **{
        "mu" + sfx: mus[None], "shift" + sfx: shifts[None],
        "ball" + sfx: [ball], "axis" + sfx: [axis]})
    settings = atm.Settings(max_iter=25, check_termination=0)
    rng = np.random.default_rng(11)
    x0s = jnp.asarray(rng.standard_normal((B, nx)) * 0.3, jnp.float32)
    bc = lambda t: jax.tree.map(lambda a: jnp.broadcast_to(
        jnp.asarray(a), (B,) + jnp.shape(a)), t)
    ist = solve_instance_ops(
        x0s, OpsState.zeros(B, N * nx, (N - 1) * nu),
        build_instance_ops(bc(problem), bc(cache)), settings, cones=cones,
        dims=(nx, nu), cone_args=args)
    got = np.asarray(ist.U).reshape(B, N - 1, nu)
    for b, (bl, ax) in enumerate(geo):
        cone = Cone(ball=bl, axis=ax, mu=float(mus[b]), shift=float(shifts[b]))
        cset = (ConeSet(input_cones=(cone,)) if side == "input"
                else ConeSet(state_cones=(cone,)))
        st = init_state_batched(1, nx, nu, N)
        st = st.replace(x=st.x.at[:, 0, :].set(x0s[b:b + 1]))
        want = jax.jit(lambda s, c=cset: solve_batched(
            s, problem, cache, settings, project=cone_slack_update(c)))(st)
        np.testing.assert_allclose(got[b], np.asarray(want.u)[0], rtol=0,
                                   atol=2e-4 * max(1.0, np.abs(got).max()),
                                   err_msg=f"instance {b}")


def _plant(name):
    if name == "hovering":
        p, c, _ = quadrotor_hovering_setup()
        return np.asarray(p.A), np.asarray(p.B), np.asarray(p.Q), \
            np.asarray(p.R), float(c.rho)
    if name == "cartpole":
        from accelerated_tinympc_tpu.models import cartpole as cp

        return cp.A, cp.B, cp.Q_DIAG, cp.R_DIAG, cp.RHO
    seed = int(name.split("_")[1])
    p, rho = random_lti_problem(seed=seed, nx=4 + 4 * seed, nu=2 + seed,
                                horizon=5)
    return np.asarray(p.A), np.asarray(p.B), np.asarray(p.Q), \
        np.asarray(p.R), rho


@pytest.mark.parametrize("builder", ["fixed_point", "newton", "polish_f64"])
@pytest.mark.parametrize("plant", ["hovering", "cartpole", "lti_0", "lti_1",
                                   "lti_2"])
def test_vmapped_riccati_builders_match_host_f64(plant, builder):
    """The on-device builders against the host float64 precompute
    (reference: src/tinympc/codegen.cpp:268-292). The f32 fixed point stops
    at the reference's 1e-5 Kinf-delta rule like the host; Newton and the
    f64 polish converge to the true DARE fixed point (host at tol 1e-12)."""
    A, Bm, Q, R, rho = _plant(plant)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    if builder == "fixed_point":
        want = riccati_cache(A, Bm, Q, R, rho, dtype=np.float64)
        got = jax.jit(jax.vmap(riccati_cache_jax))(
            f32(A)[None], f32(Bm)[None], f32(Q)[None], f32(R)[None],
            jnp.full((1,), rho, jnp.float32))
        tol = 2e-3
    else:
        want = riccati_cache(A, Bm, Q, R, rho, tol=1e-12, max_iters=100000,
                             dtype=np.float64)
        warm = riccati_cache(A, Bm, Q, R, rho, dtype=np.float32)
        if builder == "newton":
            got = jax.jit(jax.vmap(lambda a, b, q, r, p, k: riccati_newton_jax(
                a, b, q, r, p, k, tol=1e-7)))(
                f32(A)[None], f32(Bm)[None], f32(Q)[None], f32(R)[None],
                jnp.full((1,), rho, jnp.float32), f32(warm.Kinf)[None])
            tol = 2e-3
        else:
            cache0 = jax.tree.map(lambda a: f32(a)[None], warm)
            got = riccati_polish_f64(
                cache0, f32(A)[None], f32(Bm)[None], f32(Q)[None],
                f32(R)[None], jnp.full((1,), rho, jnp.float32))
            tol = 1e-5
    # (coeff_d2p vanishes at the fixed point — reference admm.cpp:20 drops
    # it — so only its absolute size is meaningful.)
    for field in ("Kinf", "Pinf", "Quu_inv", "AmBKt"):
        g = np.asarray(getattr(got, field))[0]
        w = np.asarray(getattr(want, field))
        rel = np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-12)
        assert rel < tol, (field, rel)
    d2p = np.max(np.abs(np.asarray(got.coeff_d2p)))
    assert d2p < 1e-2 * max(1.0, np.max(np.abs(np.asarray(want.Pinf))))


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("scenario", ["hovering", "tracking"])
def test_scan_mission_matches_host_loop(scenario, mode):
    """mpc_rollout (the whole tick loop under one lax.scan) reproduces a
    host-driven loop of TinyMPC.solve / reset_duals tick for tick."""
    if scenario == "hovering":
        problem, cache, x0 = quadrotor_hovering_setup()
        Xref_total = None
    else:
        problem, cache, x0, Xref_total = quadrotor_tracking_setup()
        Xref_total = jnp.asarray(Xref_total, jnp.float32)
    settings = _settings(mode, 30)
    T = 12
    _st, xf, trace = jax.jit(lambda x: mpc_rollout(
        problem, cache, settings, x, T, Xref_total=Xref_total))(
        jnp.asarray(x0, jnp.float32))
    m = atm.TinyMPC.from_parts(problem, cache, settings=settings)
    x = jnp.asarray(x0, jnp.float32)
    for t in range(T):
        if Xref_total is not None:
            m.set_xref(Xref_total[t:t + problem.horizon])
        m.reset_duals()
        m.set_x0(x)
        info = m.solve()
        assert info["iterations"] == int(trace.iters[t])
        u0 = jnp.asarray(m.get_u()[0])
        np.testing.assert_allclose(np.asarray(trace.u[t]), np.asarray(u0),
                                   rtol=0, atol=1e-5)
        x = problem.A @ x + problem.B @ u0
    np.testing.assert_allclose(np.asarray(xf), np.asarray(x), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("scenario", ["hovering", "tracking"])
def test_fused_mission_matches_scan_mission(scenario, mode):
    """fused_mpc_rollout (scan of kernel solves, interpreter) vs the
    scan-tier mission: u0 traces within the parity bar."""
    from accelerated_tinympc_tpu.api import fused_mpc_rollout
    from accelerated_tinympc_tpu.ops import pad_problem
    from accelerated_tinympc_tpu.precompute import condensed_operators

    if scenario == "hovering":
        problem, cache, x0 = quadrotor_hovering_setup()
        Xref_total = None
    else:
        problem, cache, x0, Xref_total = quadrotor_tracking_setup()
        Xref_total = jnp.asarray(Xref_total, jnp.float32)
    settings = _settings(mode, 30, tol=1e-3, check=1)
    pp = pad_problem(problem, cache, condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B),
        problem.horizon))
    x0s = jnp.tile(jnp.asarray(x0, jnp.float32), (3, 1))
    T = 10
    xf, us, _ = fused_mpc_rollout(
        pp, x0s, T, problem=problem, max_iter=30,
        check_termination=settings.check_termination,
        abs_pri_tol=1e-3, abs_dua_tol=1e-3, interpret=True,
        Xref_total=Xref_total,
        Pinf=cache.Pinf if Xref_total is not None else None)
    _st, xf_s, trace = jax.jit(lambda x: mpc_rollout(
        problem, cache, settings, x, T, Xref_total=Xref_total,
        batched=True))(x0s)
    np.testing.assert_allclose(np.asarray(us), np.asarray(trace.u),
                               rtol=0, atol=U_TOL)
    np.testing.assert_allclose(np.asarray(xf), np.asarray(xf_s), rtol=0,
                               atol=U_TOL)


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_fleet_mission_matches_per_instance_missions(mode):
    """fleet_mpc_rollout (per-instance plants) equals running each plant's
    own mpc_rollout."""
    A, Bm, Q, R, x0s = _fleet(10)
    settings = _settings(mode, 30)
    f = atm.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=10,
                               u_min=-1.0, u_max=1.0, settings=settings,
                               polish=False)
    T = 6
    _st, xf, trace = jax.jit(lambda x: fleet_mpc_rollout(
        f.problem, f.cache, f.settings, x, T))(jnp.asarray(x0s))
    for b in range(B):
        prob = jax.tree.map(lambda a: a[b], f.problem)
        ca = jax.tree.map(lambda a: a[b], f.cache)
        _s, xb, tb = jax.jit(lambda x: mpc_rollout(
            prob, ca, f.settings, x, T))(jnp.asarray(x0s[b]))
        np.testing.assert_array_equal(np.asarray(trace.iters[:, b]),
                                      np.asarray(tb.iters))
        np.testing.assert_allclose(np.asarray(trace.u[:, b]),
                                   np.asarray(tb.u), rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(xf[b]), np.asarray(xb),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("tier", ["scan", "condensed", "block", "fused"])
def test_every_tier_reports_per_instance_iterations(tier):
    """Batched TinyMPC.solve reports per-instance iterations/solved on
    every tier, equal to the scan tier's."""
    problem, cache, x0 = quadrotor_hovering_setup()
    rng = np.random.default_rng(2)
    x0s = jnp.asarray(np.asarray(x0)[None] + 0.1 * rng.standard_normal(
        (5, 12)), jnp.float32)
    settings = atm.Settings(max_iter=300, check_termination=1,
                            abs_pri_tol=0.05, abs_dua_tol=0.05)
    kw = {"interpret": True} if tier == "fused" else {}
    it_s, u_s = _tinympc_u(problem, cache, settings, x0s, "scan")
    it, u = _tinympc_u(problem, cache, settings, x0s, tier, **kw)
    assert it.shape == (5,)
    np.testing.assert_array_equal(it, it_s)
    np.testing.assert_allclose(u, u_s, rtol=0, atol=U_TOL)
