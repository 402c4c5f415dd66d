"""Second-order-cone constraint extension (solver/cones.py) — a capability
beyond the reference's box-only slack projection (reference:
src/tinympc/admm.cpp:45-61)."""

import jax
import jax.numpy as jnp
import numpy as np

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.solver import admm
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched,
    solve_batched,
)
from accelerated_tinympc_tpu.solver.cones import (
    Cone,
    ConeSet,
    cone_slack_update,
    cone_violation,
    project_cone,
)

THRUST_CONE = Cone(ball=(0, 1), axis=2, mu=0.5)


def _in_cone(w, cone, tol=1e-6):
    v = np.asarray(w)[..., list(cone.ball)]
    a = np.linalg.norm(v, axis=-1)
    return np.all(a <= cone.mu * np.asarray(w)[..., cone.axis] + tol)


def test_projection_cases():
    """The three closed-form cases: interior unchanged, polar to zero,
    otherwise onto the boundary with the residual orthogonal to the cone."""
    cone = THRUST_CONE
    inside = jnp.asarray([0.1, 0.1, 1.0, 7.0])
    np.testing.assert_allclose(
        np.asarray(project_cone(inside, cone)), np.asarray(inside)
    )

    polar = jnp.asarray([0.2, 0.0, -1.0, -3.0])  # mu*||v|| <= -s
    got = np.asarray(project_cone(polar, cone))
    np.testing.assert_allclose(got[:3], 0.0, atol=1e-7)
    assert got[3] == -3.0  # untouched coordinate

    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((256, 4)) * 2.0, jnp.float32)
    p = project_cone(w, cone)
    assert _in_cone(p, cone)
    # Projection is idempotent and the boundary case lands on the boundary.
    np.testing.assert_allclose(
        np.asarray(project_cone(p, cone)), np.asarray(p), atol=1e-6
    )
    # Euclidean optimality: no feasible perturbation is closer to w.
    pn, wn = np.asarray(p), np.asarray(w)
    d0 = np.linalg.norm(pn - wn, axis=-1)
    for _ in range(20):
        q = pn + rng.standard_normal(pn.shape).astype(np.float32) * 0.05
        # pull candidate into the cone exactly
        q = np.asarray(project_cone(jnp.asarray(q), cone))
        d1 = np.linalg.norm(q - wn, axis=-1)
        assert np.all(d0 <= d1 + 1e-5)


def test_shifted_cone():
    """A shift translates the apex: projection onto the shifted cone equals
    shift-project-unshift with the unshifted cone (hover-relative thrust
    cones, Cone.shift)."""
    base = Cone(ball=(0, 1), axis=2, mu=0.8)
    shifted = base._replace(shift=2.5)
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((64, 4)) * 3.0, jnp.float32)
    got = project_cone(w, shifted)
    w_shift = w.at[..., 2].add(2.5)
    want = project_cone(w_shift, base).at[..., 2].add(-2.5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)
    assert float(cone_violation(got, shifted)) <= 1e-6


def test_no_cones_is_identity_path():
    """An empty ConeSet produces bit-identical results to the plain solve
    (the golden-verified path is untouched)."""
    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    settings = atm.Settings(max_iter=30, check_termination=0)
    state = atm.set_x0(atm.init_state(12, 4, 10), jnp.asarray(x0))
    plain = jax.jit(lambda s: admm.solve(s, problem, cache, settings))(state)
    coned = jax.jit(
        lambda s: admm.solve(
            s, problem, cache, settings,
            project=cone_slack_update(ConeSet()),
        )
    )(state)
    np.testing.assert_array_equal(np.asarray(plain.u), np.asarray(coned.u))
    np.testing.assert_array_equal(np.asarray(plain.x), np.asarray(coned.x))


def _landing_setup(horizon=15, dt=0.1):
    """3D point-mass double integrator — the canonical SOC-MPC plant
    (powered descent / thrust-tilt). x = [pos(3), vel(3)], u = accel(3)."""
    I3 = np.eye(3)
    A = np.block([[I3, dt * I3], [0 * I3, I3]])
    B = np.vstack([0.5 * dt * dt * I3, dt * I3])
    Q = np.concatenate([np.full(3, 10.0), np.full(3, 1.0)])
    R = np.full(3, 1.0)
    rho = 1.0
    problem = atm.Problem(
        A=jnp.asarray(A, jnp.float32),
        B=jnp.asarray(B, jnp.float32),
        Q=jnp.asarray(Q, jnp.float32),
        R=jnp.asarray(R, jnp.float32),
        u_min=jnp.full((horizon - 1, 3), -10.0, jnp.float32),
        u_max=jnp.full((horizon - 1, 3), 10.0, jnp.float32),
        x_min=jnp.full((horizon, 6), -100.0, jnp.float32),
        x_max=jnp.full((horizon, 6), 100.0, jnp.float32),
        Xref=jnp.zeros((horizon, 6), jnp.float32),
        Uref=jnp.zeros((horizon - 1, 3), jnp.float32),
    )
    from accelerated_tinympc_tpu.precompute import riccati_cache

    cache = riccati_cache(A, B, Q, R, rho)
    return problem, cache


def test_thrust_cone_end_to_end():
    """Thrust-tilt input cone ||u_xy|| <= mu * u_z on the landing plant: the
    unconstrained solve violates it (braking sideways costs nothing
    vertically), the coned solve converges with the cone satisfied and the
    applied control in consensus with the slack."""
    problem, cache = _landing_setup()
    cone = Cone(ball=(0, 1), axis=2, mu=1.0)
    x0 = jnp.asarray([3.0, -2.0, 4.0, -1.0, 1.0, -1.5], jnp.float32)
    # Cone only (boxes disabled) — the exact-projection single-set case.
    settings = atm.Settings(
        max_iter=1000, check_termination=1,
        en_input_bound=False, en_state_bound=False,
    )
    state = atm.set_x0(atm.init_state(6, 3, 15), x0)

    plain = jax.jit(lambda s: admm.solve(s, problem, cache, settings))(state)
    assert float(cone_violation(plain.znew, cone)) > 0.1  # cone is binding

    cones = ConeSet(input_cones=(cone,))
    res = jax.jit(
        lambda s: admm.solve(
            s, problem, cache, settings, project=cone_slack_update(cones)
        )
    )(state)
    assert int(res.status) == atm.types.SOLVED
    assert float(cone_violation(res.znew, cone)) <= 1e-6
    # Primal/slack consensus: applied u is within tolerance of the cone.
    assert float(jnp.max(jnp.abs(res.u - res.znew))) < 2e-3
    assert float(cone_violation(res.u, cone)) < 5e-3


def test_batched_matches_single():
    """solve_batched with a cone projection reproduces per-instance single
    solves exactly (vmap semantics hold for the override)."""
    problem, cache, x0 = atm.models.quadrotor_hovering_setup()
    cones = ConeSet(input_cones=(THRUST_CONE,))
    project = cone_slack_update(cones)
    settings = atm.Settings(max_iter=40, check_termination=0)
    rng = np.random.default_rng(1)
    B = 6
    x0s = jnp.asarray(
        np.asarray(x0)[None] + rng.standard_normal((B, 12)) * 0.5,
        jnp.float32,
    )
    st = init_state_batched(B, 12, 4, 10)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    batched = jax.jit(
        lambda s: solve_batched(s, problem, cache, settings, project=project)
    )(st)
    for b in range(B):
        single = jax.jit(
            lambda s: admm.solve(s, problem, cache, settings, project=project)
        )(atm.set_x0(atm.init_state(12, 4, 10), x0s[b]))
        # atol 5e-5: vmap changes how XLA fuses the cone-norm arithmetic,
        # so batched and single round differently (measured 1.1e-5 worst).
        np.testing.assert_allclose(
            np.asarray(batched.u[b]), np.asarray(single.u), rtol=0, atol=5e-5
        )


def test_api_cones():
    """TinyMPC surfaces cones on the scan and block tiers (same schedule
    and controls); the fused kernel runs box projections only and refuses
    cones."""
    import pytest

    problem, cache = _landing_setup()
    cone = Cone(ball=(0, 1), axis=2, mu=1.0)
    cones = ConeSet(input_cones=(cone,))
    settings = atm.Settings(
        max_iter=1000, check_termination=1,
        en_input_bound=False, en_state_bound=False,
    )
    x0 = np.asarray([3.0, -2.0, 4.0, -1.0, 1.0, -1.5], np.float32)
    mpc = atm.TinyMPC.from_parts(
        problem, cache, settings=settings, cones=cones
    )
    mpc.set_x0(x0)
    info = mpc.solve()
    assert info["solved"]
    assert float(cone_violation(mpc.state.znew, cone)) <= 1e-6

    blk = atm.TinyMPC.from_parts(
        problem, cache, settings=settings, tier="block", block=5,
        cones=cones,
    )
    blk.set_x0(x0)
    bi = blk.solve()
    assert bi["solved"] and bi["iterations"] == info["iterations"]
    np.testing.assert_allclose(
        np.asarray(blk.get_u()), np.asarray(mpc.get_u()),
        rtol=0, atol=5e-5,
    )
    with pytest.raises(ValueError, match="box projections only"):
        atm.TinyMPC.from_parts(problem, cache, tier="fused", cones=cones)


def test_api_per_instance_cone_params():
    """A per-instance tilt-limit sweep (cone_mu) through the fleet's
    instance-ops tier matches per-instance scan runs at each static mu;
    invalid configurations raise."""
    import pytest

    problem, cache = _landing_setup()
    base = Cone(ball=(0, 1), axis=2, mu=1.0)
    cones = ConeSet(input_cones=(base,))
    B = 6
    mus = np.linspace(0.4, 1.2, B).astype(np.float32)
    settings = atm.Settings(max_iter=200, check_termination=2,
                            abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    rng = np.random.default_rng(7)
    x0s = jnp.asarray(
        np.asarray([3.0, -2.0, 4.0, -1.0, 1.0, -1.5])[None]
        + rng.standard_normal((B, 6)) * 0.4, jnp.float32,
    )
    rep = lambda a: np.repeat(np.asarray(a)[None], B, axis=0)
    fleet = atm.TinyMPCFleet.setup(
        rep(problem.A), rep(problem.B), rep(problem.Q), rep(problem.R),
        rho=float(cache.rho), horizon=problem.horizon, settings=settings,
        tier="instance_ops", cones=cones, cone_mu=mus[None], polish=False,
    )
    fleet.set_x0(x0s)
    info = fleet.solve()
    for b in range(B):
        cset = ConeSet(input_cones=(base._replace(mu=float(mus[b])),))
        one = atm.TinyMPC.from_parts(
            problem, cache, settings=fleet.settings, cones=cset
        )
        one.set_x0(x0s[b])
        oi = one.solve()
        assert int(info["iterations"][b]) == int(oi["iterations"]), b
        np.testing.assert_allclose(
            np.asarray(fleet.get_u())[b], np.asarray(one.get_u()),
            rtol=0, atol=1e-4, err_msg=f"instance {b}",
        )
    with pytest.raises(ValueError, match="pass cones"):
        atm.TinyMPCFleet.setup(
            rep(problem.A), rep(problem.B), rep(problem.Q), rep(problem.R),
            rho=1.0, horizon=problem.horizon, cone_mu=mus[None],
            tier="instance_ops", polish=False,
        )


def test_condensed_tier_cones():
    """The condensed (dense-operator) tier supports cones: same solution as
    the scan tier, reachable through TinyMPC(tier="condensed", cones=...)."""
    problem, cache = _landing_setup()
    cone = Cone(ball=(0, 1), axis=2, mu=1.0)
    cones = ConeSet(input_cones=(cone,))
    settings = atm.Settings(
        max_iter=400, check_termination=1,
        en_input_bound=False, en_state_bound=False,
    )
    x0 = np.asarray([3.0, -2.0, 4.0, -1.0, 1.0, -1.5], np.float32)

    scan = atm.TinyMPC.from_parts(
        problem, cache, settings=settings, cones=cones
    )
    cond = atm.TinyMPC.from_parts(
        problem, cache, settings=settings, tier="condensed", cones=cones
    )
    for m in (scan, cond):
        m.set_x0(x0)
    i_scan = scan.solve()
    i_cond = cond.solve()
    assert i_cond["solved"]
    # Identical check schedule and matching controls (the condensed sweeps
    # regroup matmul partial sums, so a few f32 ulp of drift accumulate).
    assert i_cond["iterations"] == i_scan["iterations"]
    np.testing.assert_allclose(
        np.asarray(cond.get_u()), np.asarray(scan.get_u()),
        rtol=0, atol=5e-5,
    )
    assert float(cone_violation(cond.state.znew, cone)) <= 1e-6

    # State cones on the condensed tier as well (glideslope).
    gcones = ConeSet(state_cones=(Cone(ball=(0, 1), axis=2, mu=1.5),))
    x0g = np.asarray([2.0, 1.0, 4.0, 1.5, 0.0, -1.0], np.float32)
    scan_g = atm.TinyMPC.from_parts(
        problem, cache, settings=settings, cones=gcones
    )
    cond_g = atm.TinyMPC.from_parts(
        problem, cache, settings=settings, tier="condensed", cones=gcones
    )
    for m in (scan_g, cond_g):
        m.set_x0(x0g)
    i_s = scan_g.solve()
    i_c = cond_g.solve()
    assert i_c["solved"] and i_c["iterations"] == i_s["iterations"]
    np.testing.assert_allclose(
        np.asarray(cond_g.get_u()), np.asarray(scan_g.get_u()),
        rtol=0, atol=5e-5,
    )


def test_state_cone():
    """Glideslope cone on position, ||pos_xy|| <= mu * pos_z: the approach
    trajectory stays inside the cone (x0 itself must satisfy it — like a
    violated state box, an infeasible x0 can never reach consensus)."""
    problem, cache = _landing_setup()
    cone = Cone(ball=(0, 1), axis=2, mu=1.5)
    cones = ConeSet(state_cones=(cone,))
    settings = atm.Settings(
        max_iter=1000, check_termination=1,
        en_input_bound=False, en_state_bound=False,
    )
    x0 = jnp.asarray([2.0, 1.0, 4.0, 1.5, 0.0, -1.0], jnp.float32)
    state = atm.set_x0(atm.init_state(6, 3, 15), x0)
    res = jax.jit(
        lambda s: admm.solve(
            s, problem, cache, settings, project=cone_slack_update(cones)
        )
    )(state)
    assert int(res.status) == atm.types.SOLVED
    assert float(cone_violation(res.vnew, cone)) <= 1e-6


def test_coned_mission_scan_tier():
    """Receding-horizon mission with a thrust cone on the scan tier
    (mpc_rollout with the cone projection as the per-tick solver): every
    tick's slack obeys the cone, and the landers descend toward the pad."""
    from accelerated_tinympc_tpu.api import mpc_rollout

    problem, cache = _landing_setup()
    cones = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=1.0),))
    settings = atm.Settings(max_iter=150, check_termination=0)
    project = cone_slack_update(cones)
    x0s = jnp.asarray([[3.0, -2.0, 6.0, -1.0, 1.0, -1.5],
                       [1.0, 2.0, 5.0, 0.5, -0.5, -1.0]], jnp.float32)
    st, xf, trace = jax.jit(lambda x: mpc_rollout(
        problem, cache, settings, x, 25, batched=True,
        solver=lambda s, p: solve_batched(s, p, cache, settings,
                                          project=project),
    ))(x0s)
    assert float(cone_violation(st.znew, cones.input_cones[0])) <= 1e-5
    assert float(cone_violation(trace.u, cones.input_cones[0])) < 5e-2
    assert float(xf[0, 2]) < float(x0s[0, 2]) - 1.0
    assert float(xf[1, 2]) < float(x0s[1, 2]) - 0.2


def test_aot_export_with_cones(tmp_path):
    """AOT export bakes the cone projection: the serialized artifact
    reproduces the live coned solve."""
    from accelerated_tinympc_tpu.api.export import (
        export_batched_solve, load_exported, save_exported,
    )
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched as _isb, solve_batched as _sb,
    )

    problem, cache = _landing_setup()
    cones = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=1.0),))
    settings = atm.Settings(
        max_iter=120, check_termination=2,
        en_input_bound=False, en_state_bound=False,
    )
    exported = export_batched_solve(
        problem, cache, settings, batch=3, cones=cones
    )
    f = tmp_path / "coned.jaxexport"
    save_exported(f, exported)
    solve = load_exported(f)
    rng = np.random.default_rng(4)
    x0s = jnp.asarray(
        np.asarray([3.0, -2.0, 4.0, -1.0, 1.0, -1.5])[None]
        + rng.standard_normal((3, 6)) * 0.3, jnp.float32,
    )
    got = solve(x0s)
    st = _isb(3, 6, 3, 15)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    want = jax.jit(lambda s: _sb(
        s, problem, cache, settings,
        project=cone_slack_update(cones),
    ))(st)
    np.testing.assert_array_equal(np.asarray(got["u"]), np.asarray(want.u))
    np.testing.assert_array_equal(
        np.asarray(got["iterations"]), np.asarray(want.iter)
    )


def test_project_cone_masked_matches_static():
    """project_cone_masked with masks/params encoding a cone's static
    values reproduces project_cone exactly (same closed form, mask-weighted
    sums add exact zeros); per-instance overrides match per-instance static
    projections at those values."""
    from accelerated_tinympc_tpu.solver.cones import project_cone_masked

    rng = np.random.default_rng(0)
    B, K, dim = 12, 5, 4
    w = jnp.asarray(rng.standard_normal((B, K, dim)) * 2.0, jnp.float32)
    cone = Cone(ball=(0, 1), axis=2, mu=0.7, shift=1.5)

    # All-default (static) masks.
    got = project_cone_masked(w, cone)
    want = project_cone(w, cone)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=1e-6)

    # Explicit masks encoding the static geometry.
    bm = np.zeros((B, dim), np.float32); bm[:, [0, 1]] = 1.0
    am = np.zeros((B, dim), np.float32); am[:, 2] = 1.0
    got2 = project_cone_masked(
        w, cone, ball_mask=jnp.asarray(bm), axis_mask=jnp.asarray(am),
        mu=jnp.full((B,), 0.7, jnp.float32),
        shift=jnp.full((B,), 1.5, jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(got2), np.asarray(want),
                               rtol=0, atol=1e-6)

    # Heterogeneous geometry: half the batch uses a different ball/axis/mu;
    # each half matches a static projection at its own cone.
    h = B // 2
    alt = Cone(ball=(1, 3), axis=0, mu=1.2, shift=1.5)
    bm[h:] = 0.0; bm[h:, [1, 3]] = 1.0
    am[h:] = 0.0; am[h:, 0] = 1.0
    mu = np.full((B,), 0.7, np.float32); mu[h:] = 1.2
    got3 = project_cone_masked(
        w, cone, ball_mask=jnp.asarray(bm), axis_mask=jnp.asarray(am),
        mu=jnp.asarray(mu), shift=jnp.full((B,), 1.5, jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(got3[:h]), np.asarray(want[:h]),
                               rtol=0, atol=1e-6)
    want_alt = project_cone(w[h:], alt)
    np.testing.assert_allclose(np.asarray(got3[h:]), np.asarray(want_alt),
                               rtol=0, atol=1e-6)


def test_cone_override_validation():
    """Pack-time validation of per-instance cone overrides: out-of-range
    axis indices and ball/axis lane overlap (incl. the only-axis-overridden
    trap where the static ball covers the new axis) raise; orphan overrides
    without a base ConeSet raise at the fleet surface."""
    import pytest

    import accelerated_tinympc_tpu as atm
    from accelerated_tinympc_tpu.solver.cones import make_cone_args

    B, nx, nu = 6, 12, 4
    cones = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=0.5),))
    axis_oob = np.full(B, nu, np.int64)          # one past the end
    axis_overlap = np.zeros(B, np.int64)         # inside the static ball
    fn = lambda **kw: make_cone_args(cones, B, nx, nu, **kw)
    with pytest.raises(ValueError, match="axis indices"):
        fn(axis_u=[axis_oob])
    with pytest.raises(ValueError, match="overlap"):
        fn(axis_u=[axis_overlap])
    # Disjoint override of both passes.
    ball = np.zeros((B, nu), np.float32)
    ball[:, [1, 2]] = 1.0
    make_cone_args(cones, B, nx, nu, ball_u=[ball], axis_u=[axis_overlap])
    # Fleet: overrides without cones= is an error, not a silent drop.
    rng = np.random.default_rng(0)
    A = np.eye(4, dtype=np.float32)[None].repeat(B, 0)
    Bm = rng.standard_normal((B, 4, 2)).astype(np.float32)
    Q = np.ones((B, 4), np.float32)
    R = np.ones((B, 2), np.float32)
    with pytest.raises(ValueError, match="pass cones"):
        atm.TinyMPCFleet.setup(
            A, Bm, Q, R, rho=1.0, horizon=5,
            cone_axis=[np.zeros(B, np.int64)], host_precompute=True,
        )


def test_project_cone_masked_properties():
    """Property check over random per-instance geometries: the masked
    projection lands in the (per-instance) cone, is idempotent, and leaves
    non-cone coordinates untouched."""
    from accelerated_tinympc_tpu.solver.cones import project_cone_masked

    rng = np.random.default_rng(5)
    B, K, dim = 64, 4, 6
    w = jnp.asarray(rng.standard_normal((B, K, dim)) * 3.0, jnp.float32)
    cone = Cone(ball=(0, 1), axis=2, mu=0.6, shift=0.5)
    # Random disjoint geometry per instance: pick an axis, then 2 ball
    # coords from the rest.
    axes = rng.integers(0, dim, B)
    bm = np.zeros((B, dim), np.float32)
    am = np.zeros((B, dim), np.float32)
    for b in range(B):
        am[b, axes[b]] = 1.0
        others = [j for j in range(dim) if j != axes[b]]
        bm[b, rng.choice(others, 2, replace=False)] = 1.0
    mu = (0.3 + rng.random(B)).astype(np.float32)
    shift = (rng.random(B) - 0.3).astype(np.float32)
    kw = dict(ball_mask=jnp.asarray(bm), axis_mask=jnp.asarray(am),
              mu=jnp.asarray(mu), shift=jnp.asarray(shift))
    p1 = project_cone_masked(w, cone, **kw)
    p2 = project_cone_masked(p1, cone, **kw)
    # Idempotent.
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p1),
                               rtol=0, atol=2e-6)
    # Feasible: ||p[ball]|| <= mu (p[axis] + shift) + tol, per instance.
    p = np.asarray(p1)
    a = np.sqrt(((p * bm[:, None, :]) ** 2).sum(-1))
    s = (p * am[:, None, :]).sum(-1) + shift[:, None]
    assert np.all(a <= mu[:, None] * s + 1e-5)
    # Untouched coordinates pass through exactly.
    other = 1.0 - bm - am
    np.testing.assert_array_equal(
        np.asarray(w) * other[:, None, :], p * other[:, None, :]
    )
