"""Fleet API (api/fleet.py): the per-instance-plant capability behind the
TinyMPC-style surface — distinct plants, every fleet tier, cones, adaptive
rho, plant refresh, on-device missions. The reference's
one-problem-per-process limitation inverted (reference:
src/tinympc/tiny_wrapper.hpp:6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import random_lti_problem

B, NX, NU, N = 12, 8, 3, 10


@pytest.fixture(scope="module")
def plants():
    As, Bs, Qs, Rs = [], [], [], []
    for seed in range(B):
        p, _rho = random_lti_problem(seed=seed, nx=NX, nu=NU, horizon=N)
        As.append(np.asarray(p.A)); Bs.append(np.asarray(p.B))
        Qs.append(np.asarray(p.Q)); Rs.append(np.asarray(p.R))
    rng = np.random.default_rng(1)
    x0s = rng.standard_normal((B, NX)).astype(np.float32) * 0.4
    return (np.stack(As), np.stack(Bs), np.stack(Qs), np.stack(Rs), x0s)


def test_fleet_tiers_agree(plants):
    """scan (default) and instance_ops tiers produce matching per-instance
    results (distinct plants, adaptive mode, identical schedules)."""
    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=150, check_termination=2,
                        abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    fleets = {}
    for tier in ("scan", "instance_ops"):
        f = atm.TinyMPCFleet.setup(
            A, Bm, Q, R, rho=1.0, horizon=N,
            u_min=-2.0, u_max=2.0, settings=sets, tier=tier,
        )
        f.set_x0(x0s)
        fleets[tier] = (f, f.solve())
    fh, ih = fleets["scan"]
    fo, io = fleets["instance_ops"]
    np.testing.assert_array_equal(ih["iterations"], io["iterations"])
    np.testing.assert_array_equal(ih["solved"], io["solved"])
    np.testing.assert_allclose(
        np.asarray(fh.get_u()), np.asarray(fo.get_u()), rtol=0, atol=5e-5
    )


def test_fleet_warm_start_and_compaction(plants):
    """Warm-started re-solve protocol through the fleet surface on the
    default (scan) tier vs instance_ops."""
    test_fleet_warm_start_every_tier(plants, "instance_ops")


@pytest.mark.parametrize("tier", ["scan", "instance_ops", "block"])
def test_fleet_warm_start_every_tier(plants, tier):
    """Warm-started re-solve protocol through the fleet surface on every
    tier: carries persist, duals reset, and the warm re-solve follows the
    same schedule as the scan tier's."""
    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=200, check_termination=2,
                        abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    ref = atm.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=N,
                                 settings=sets, polish=False)
    f = atm.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=N,
                               settings=sets, tier=tier, polish=False,
                               block=5)
    for g in (ref, f):
        g.set_x0(x0s)
    i1, i2 = ref.solve(), f.solve()
    np.testing.assert_array_equal(i1["iterations"], i2["iterations"])
    for g in (ref, f):
        g.reset_duals()
        g.set_x0(x0s * 0.9)
    j1, j2 = ref.solve(), f.solve()
    np.testing.assert_array_equal(j1["iterations"], j2["iterations"])
    assert j2["iterations"].mean() < i2["iterations"].mean()
    np.testing.assert_allclose(np.asarray(ref.get_u()), np.asarray(f.get_u()),
                               rtol=0, atol=1e-4)


def test_fleet_adaptive_rho(plants):
    """Batched adaptive rho through the fleet surface rescues mis-scaled
    instances and adopts the adapted caches."""
    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                        check_termination=1)
    f = atm.TinyMPCFleet.setup(
        A, Bm, Q, R,
        rho=np.asarray([1.0] * 6 + [1e-3] * 3 + [1e3] * 3, np.float32),
        horizon=N, settings=sets, tier="instance_ops",
    )
    f.set_x0(x0s)
    info = f.solve_adaptive_rho(chunk=25, max_rounds=40)
    assert bool(np.all(info["solved"])), info["iterations"]
    # well-scaled instances untouched
    np.testing.assert_allclose(info["rho"][:6], 1.0)


def test_fleet_cones(plants):
    """SOC cones through the fleet surface (default scan tier, shared
    ConeSet)."""
    from accelerated_tinympc_tpu.solver.cones import (
        Cone, ConeSet, cone_violation,
    )

    A, Bm, Q, R, x0s = plants
    cones = ConeSet(input_cones=(Cone(ball=(0, 1), axis=2, mu=1.0,
                                      shift=2.0),))
    sets = atm.Settings(max_iter=150, check_termination=2,
                        abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    f = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N, settings=sets,
        cones=cones,
    )
    f.set_x0(x0s)
    info = f.solve()
    assert info["converged_fraction"] > 0.5
    # Slack-consensus controls approach the cone for solved instances.
    u = np.asarray(f.get_u())[info["solved"]]
    assert float(cone_violation(jnp.asarray(u), cones.input_cones[0])) < 0.1


def test_fleet_rollout_on_device(plants):
    """On-device fleet rollout (lax.scan over ticks, scan-tier solve with
    per-instance plants inside) matches a host-driven tick loop through the
    fleet API."""
    from accelerated_tinympc_tpu.api import fleet_mpc_rollout

    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=25, check_termination=0)
    f = atm.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=N,
                               settings=sets)
    ticks = 4
    _st, xf, trace = jax.jit(
        lambda x: fleet_mpc_rollout(f.problem, f.cache, sets, x, ticks)
    )(jnp.asarray(x0s))
    x = jnp.asarray(x0s)
    for t in range(ticks):
        f.set_x0(x)
        f.solve()
        u0 = f.get_u()[:, 0, :]
        np.testing.assert_allclose(
            np.asarray(trace.u[t]), np.asarray(u0), rtol=0, atol=1e-5
        )
        x = (jnp.einsum("bij,bj->bi", f.problem.A, x)
             + jnp.einsum("bij,bj->bi", f.problem.B, u0))
        f.reset_duals()
    np.testing.assert_allclose(
        np.asarray(xf), np.asarray(x), rtol=0, atol=1e-5
    )


def test_fleet_rollout_adaptive_matches_host(plants):
    """fleet_mpc_rollout with check_termination > 0 gives each tick the
    per-instance early exit; ticks must match a host loop running the fleet
    API at the same termination settings."""
    from accelerated_tinympc_tpu.api import fleet_mpc_rollout

    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=60, check_termination=2,
                        abs_pri_tol=1e-3, abs_dua_tol=1e-3)
    f = atm.TinyMPCFleet.setup(A, Bm, Q, R, rho=1.0, horizon=N,
                               settings=sets)
    ticks = 3
    _st, xf, trace = jax.jit(
        lambda x: fleet_mpc_rollout(f.problem, f.cache, sets, x, ticks)
    )(jnp.asarray(x0s))
    x = jnp.asarray(x0s)
    for t in range(ticks):
        f.set_x0(x)
        info = f.solve()
        np.testing.assert_array_equal(np.asarray(trace.iters[t]),
                                      info["iterations"])
        u0 = f.get_u()[:, 0, :]
        np.testing.assert_allclose(
            np.asarray(trace.u[t]), np.asarray(u0), rtol=0, atol=1e-5
        )
        x = (jnp.einsum("bij,bj->bi", f.problem.A, x)
             + jnp.einsum("bij,bj->bi", f.problem.B, u0))
        f.reset_duals()
    np.testing.assert_allclose(
        np.asarray(xf), np.asarray(x), rtol=0, atol=1e-4
    )


def test_fleet_set_xref(plants):
    """Per-instance reference update: each instance tracks its own setpoint
    (reference FFI set_xref, per instance)."""
    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=120, check_termination=2,
                        abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    f = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N, settings=sets,
    )
    rng = np.random.default_rng(2)
    # Small distinct setpoints (positions only meaningful for random LTI —
    # just check the solver chases different references per instance).
    refs = jnp.asarray(
        np.repeat(rng.standard_normal((B, 1, NX)) * 0.2, N, axis=1),
        jnp.float32,
    )
    f.set_xref(refs)
    f.set_x0(x0s)
    f.solve()
    uA = np.asarray(f.get_u())
    # Against per-instance scan solves with the same references.
    from accelerated_tinympc_tpu.solver.batched import (
        init_state_batched, solve_batched,
    )

    st = init_state_batched(B, NX, NU, N)
    st = st.replace(x=st.x.at[:, 0, :].set(jnp.asarray(x0s)))
    want = solve_batched(
        st, f.problem, f.cache, f.settings, problem_axes=0, cache_axes=0,
    )
    np.testing.assert_allclose(
        uA, np.asarray(want.u), rtol=0, atol=5e-4
    )


def test_fleet_set_bounds(plants):
    """Runtime bound updates through the fleet surface: a tightened
    per-instance input box binds (controls clamp to it at consensus)."""
    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=200, check_termination=2,
                        abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    f = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N, settings=sets,
    )
    f.set_x0(x0s * 3.0)  # large excursions so bounds bind
    f.solve()
    u_free = np.asarray(f.get_u())
    # Clamp at half of each instance's free peak so the box genuinely binds.
    peak = np.abs(u_free).max()
    cap = float(0.5 * peak)
    lim = np.full((B, NU), cap, np.float32)
    f.set_bounds(u_min=-lim, u_max=lim)
    f.set_x0(x0s * 3.0)
    f.reset_duals()
    info = f.solve()
    u_box = np.asarray(f.get_u())
    solved = info["solved"]
    assert solved.mean() > 0.5
    # Consensus controls respect the tightened box (ADMM tolerance scale).
    assert np.abs(u_box[solved]).max() <= cap * 1.1 + 1e-3


def test_fleet_per_instance_cones_tiers_agree(plants):
    """Per-instance cone mu + ball/axis geometry through the fleet surface:
    the instance-ops tier's jnp masked projection (project_cone_masked)
    agrees per instance with scan-tier solves that carry each group's
    geometry as a static ConeSet."""
    from accelerated_tinympc_tpu.solver.cones import Cone, ConeSet

    A, Bm, Q, R, x0s = plants
    base = Cone(ball=(0, 1), axis=2, mu=1.0, shift=2.0)
    h = B // 2
    mu = np.where(np.arange(B) < h, 0.6, 1.1).astype(np.float32)
    ball = np.zeros((B, NU), np.float32)
    ball[:h, [0, 1]] = 1.0
    ball[h:, [1, 2]] = 1.0
    axis = np.full(B, 2, np.int64)
    axis[h:] = 0
    sets = atm.Settings(max_iter=150, check_termination=2,
                        abs_pri_tol=5e-3, abs_dua_tol=5e-3)
    fo = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N, settings=sets, tier="instance_ops",
        cones=ConeSet(input_cones=(base,)), cone_mu=mu[None, :],
        cone_ball=[ball], cone_axis=[axis], polish=False,
    )
    fo.set_x0(x0s)
    io = fo.solve()
    groups = ((slice(0, h), Cone(ball=(0, 1), axis=2, mu=0.6, shift=2.0)),
              (slice(h, B), Cone(ball=(1, 2), axis=0, mu=1.1, shift=2.0)))
    for sl, cone in groups:
        fs = atm.TinyMPCFleet.setup(
            A[sl], Bm[sl], Q[sl], R[sl], rho=1.0, horizon=N, settings=sets,
            cones=ConeSet(input_cones=(cone,)), polish=False,
        )
        fs.set_x0(x0s[sl])
        is_ = fs.solve()
        np.testing.assert_array_equal(is_["iterations"], io["iterations"][sl])
        np.testing.assert_allclose(
            np.asarray(fs.get_u()), np.asarray(fo.get_u())[sl],
            rtol=0, atol=1e-4,
        )
    with pytest.raises(ValueError, match="instance_ops"):
        atm.TinyMPCFleet.setup(
            A, Bm, Q, R, rho=1.0, horizon=N, settings=sets,
            cones=ConeSet(input_cones=(base,)), cone_mu=mu[None, :],
            polish=False,
        )


def test_fleet_cache_precision(plants):
    """Fleet controls driven by device-built (polished) caches match
    controls driven by host-f64 caches at the same tol within the 1e-4
    parity bar (expected ~1e-6; the unpolished f32 caches land further
    off)."""
    from accelerated_tinympc_tpu.precompute import riccati_cache

    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=60, check_termination=0)
    f_dev = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N,
        u_min=-2.0, u_max=2.0, settings=sets,
        polish=True,
    )
    # Host gold standard at the polish's own tolerance (both sides converge
    # to the true fixed point, so truncation offsets cancel).
    caches = [
        riccati_cache(A[b], Bm[b], Q[b], R[b], 1.0, tol=1e-9)
        for b in range(B)
    ]
    cache_host = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *caches
    )
    f_host = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N,
        u_min=-2.0, u_max=2.0, settings=sets,
        host_precompute=True,
    )
    # swap in the tol-1e-9 host caches (host_precompute uses tol 1e-5)
    f_host.cache = cache_host
    f_host._build()

    f_dev.set_x0(x0s)
    f_host.set_x0(x0s)
    f_dev.solve()
    f_host.solve()
    du = np.max(np.abs(np.asarray(f_dev.get_u()) - np.asarray(f_host.get_u())))
    assert du < 1e-4, du

    # And the unpolished build genuinely misses the bar (the polish is real).
    f_raw = atm.TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N,
        u_min=-2.0, u_max=2.0, settings=sets,
        polish=False,
    )
    f_raw.set_x0(x0s)
    f_raw.solve()
    du_raw = np.max(np.abs(np.asarray(f_raw.get_u())
                           - np.asarray(f_host.get_u())))
    assert du_raw > du, (du_raw, du)


def test_fleet_adaptive_rho_engines_agree(plants):
    """solve_adaptive_rho(engine='scan') (the default for the scan tier)
    and engine='einsum' agree on adaptation decisions (rho, solved set,
    chunk rounds)."""
    A, Bm, Q, R, x0s = plants
    rho0 = np.concatenate([np.full(B // 2, 1.0), np.full(B - B // 2, 1e-3)])
    sets = atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                        check_termination=1)
    outs = {}
    for engine in ("einsum", "scan"):
        f = atm.TinyMPCFleet.setup(
            A, Bm, Q, R, rho=rho0, horizon=N,
            u_min=-2.0, u_max=2.0, settings=sets, polish=False,
        )
        f.set_x0(x0s)
        outs[engine] = f.solve_adaptive_rho(
            engine=engine, chunk=25, max_rounds=40, riccati="vmap",
        )
    e, h = outs["einsum"], outs["scan"]
    np.testing.assert_array_equal(e["solved"], h["solved"])
    assert e["solved"].all()
    np.testing.assert_allclose(e["rho"], h["rho"], rtol=5e-2)
    np.testing.assert_array_equal(
        np.ceil(e["iterations"] / 25), np.ceil(h["iterations"] / 25)
    )


def test_fleet_set_plants_online_refresh(plants):
    """set_plants: online model drift + warm Newton cache refresh on
    device (the default refresh)."""
    test_fleet_set_plants_refresh(plants, "newton")


@pytest.mark.parametrize("refresh", ["newton", "fixed_point"])
def test_fleet_set_plants_refresh(plants, refresh):
    """set_plants: online model drift + warm cache refresh on device.
    Drifted caches must match a cold setup of the drifted plants (f32
    envelope), and the subsequent solve must match the cold fleet's solve
    at control tolerance."""
    from accelerated_tinympc_tpu.api.fleet import TinyMPCFleet

    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=25, check_termination=0)
    fleet = TinyMPCFleet.setup(
        A, Bm, Q, R, rho=1.0, horizon=N, settings=sets,
        polish=False,
        u_min=np.full((B, NU), -2.0), u_max=np.full((B, NU), 2.0),
    )
    rng = np.random.default_rng(11)
    A2 = A + 0.01 * rng.standard_normal(A.shape).astype(np.float32)
    B2 = Bm + 0.01 * rng.standard_normal(Bm.shape).astype(np.float32)
    fleet.set_plants(A=A2, B=B2, refresh=refresh)
    cold = TinyMPCFleet.setup(
        A2, B2, Q, R, rho=1.0, horizon=N, settings=sets,
        polish=False,
        u_min=np.full((B, NU), -2.0), u_max=np.full((B, NU), 2.0),
    )
    for f in ("Kinf", "Pinf", "Quu_inv", "AmBKt"):
        g = np.asarray(getattr(fleet.cache, f))
        w = np.asarray(getattr(cold.cache, f))
        rel = np.max(np.abs(g - w)) / (np.abs(w).max() + 1.0)
        assert rel < 2e-3, (f, rel)
    fleet.set_x0(x0s)
    cold.set_x0(x0s)
    fleet.solve()
    cold.solve()
    np.testing.assert_allclose(
        np.asarray(fleet.get_u()), np.asarray(cold.get_u()),
        rtol=0, atol=1e-3,
    )


def test_fleet_block_tier(plants):
    """tier="block": per-instance block-condensed sweeps behind the fleet
    surface — schedule-identical to the instance_ops tier, warm re-solve
    protocol composes."""
    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=40, check_termination=1)
    outs = {}
    for tier in ("block", "instance_ops"):
        f = atm.TinyMPCFleet.setup(
            A, Bm, Q, R, rho=1.0, horizon=N, u_min=-2.0, u_max=2.0,
            settings=sets, tier=tier, polish=False,
            block=4,
        )
        f.set_x0(x0s)
        outs[tier] = (f, f.solve())
    fb, ib = outs["block"]
    fo, io = outs["instance_ops"]
    np.testing.assert_array_equal(ib["iterations"], io["iterations"])
    np.testing.assert_array_equal(ib["solved"], io["solved"])
    np.testing.assert_allclose(
        np.asarray(fb.get_u()), np.asarray(fo.get_u()), rtol=0, atol=1e-4
    )
    # warm re-solve: duals reset, slacks kept -> immediate convergence
    fb.reset_duals()
    fb.set_x0(x0s)
    i2 = fb.solve()
    assert int(np.asarray(i2["iterations"]).max()) <= 5


def test_fleet_scan_tier(plants):
    """tier="scan" (the default): vmapped scan sweeps with per-instance
    plants behind the fleet surface; schedule-identical to instance_ops."""
    A, Bm, Q, R, x0s = plants
    sets = atm.Settings(max_iter=40, check_termination=1)
    outs = {}
    for tier in ("scan", "instance_ops"):
        f = atm.TinyMPCFleet.setup(
            A, Bm, Q, R, rho=1.0, horizon=N, u_min=-2.0, u_max=2.0,
            settings=sets, tier=tier, polish=False,
        )
        f.set_x0(x0s)
        outs[tier] = (f, f.solve())
    fs, is_ = outs["scan"]
    fo, io = outs["instance_ops"]
    np.testing.assert_array_equal(is_["iterations"], io["iterations"])
    np.testing.assert_allclose(
        np.asarray(fs.get_u()), np.asarray(fo.get_u()), rtol=0, atol=1e-4
    )
    fs.reset_duals()
    fs.set_x0(x0s)
    i2 = fs.solve()
    assert int(np.asarray(i2["iterations"]).max()) <= 5
