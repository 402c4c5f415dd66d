"""API layer tests: TinyMPC object parity across tiers, on-device MPC rollout
vs the host-loop golden driver, serialization round-trips, AOT export."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.api import (
    TinyMPC,
    export_batched_solve,
    load_exported,
    mpc_rollout,
    save_exported,
)
from accelerated_tinympc_tpu.models import (
    cartpole_problem,
    quadrotor_hovering_setup,
    CARTPOLE_RHO,
)
from accelerated_tinympc_tpu.utils import (
    load_problem_cache,
    save_problem_cache,
)

from golden_utils import run_mpc_loop


class TestTinyMPCObject:
    def test_setup_runs_precompute(self):
        from accelerated_tinympc_tpu.models import cartpole

        mpc = TinyMPC.setup(
            cartpole.A, cartpole.B, cartpole.Q_DIAG, cartpole.R_DIAG,
            rho=CARTPOLE_RHO, horizon=10,
            x_min=-5.0, x_max=5.0, u_min=-5.0, u_max=5.0,
        )
        assert mpc.cache.Kinf.shape == (1, 4)
        assert mpc.settings.en_input_bound and mpc.settings.en_state_bound

    def test_bounds_disabled_when_absent(self):
        from accelerated_tinympc_tpu.models import cartpole

        mpc = TinyMPC.setup(
            cartpole.A, cartpole.B, cartpole.Q_DIAG, cartpole.R_DIAG,
            rho=CARTPOLE_RHO, horizon=10,
        )
        assert not mpc.settings.en_input_bound
        assert not mpc.settings.en_state_bound

    @pytest.mark.parametrize("tier", ["scan", "fused"])
    def test_single_instance_solve(self, tier):
        problem, cache, x0 = quadrotor_hovering_setup()
        mpc = TinyMPC.from_parts(
            problem, cache,
            settings=atm.Settings(max_iter=30, check_termination=0),
            tier=tier,
            interpret=(tier == "fused"),  # Pallas interpreter on CPU tests
        )
        mpc.set_x0(jnp.asarray(x0, jnp.float32))
        mpc.solve()
        u = mpc.get_u()
        assert u.shape == (9, 4)
        assert np.all(np.isfinite(u))

    def test_tiers_agree(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=30, check_termination=0)
        us = {}
        for tier in ("scan", "condensed", "fused"):
            mpc = TinyMPC.from_parts(
                problem, cache, settings=settings, tier=tier,
                interpret=(tier == "fused"),
            )
            mpc.set_x0(jnp.asarray(x0, jnp.float32))
            mpc.solve()
            us[tier] = mpc.get_u()
        np.testing.assert_allclose(
            us["scan"], us["fused"], rtol=0, atol=1e-4
        )
        np.testing.assert_allclose(
            us["scan"], us["condensed"], rtol=0, atol=1e-4
        )

    def test_batched_solve_and_stats(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        mpc = TinyMPC.from_parts(
            problem, cache,
            settings=atm.Settings(
                abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=400
            ),
            batch=4,
        )
        rng = np.random.default_rng(0)
        x0s = np.asarray(x0)[None] + 0.05 * rng.standard_normal((4, 12))
        mpc.set_x0(jnp.asarray(x0s, jnp.float32))
        stats = mpc.solve()
        assert stats["converged_fraction"] == 1.0
        assert mpc.get_u().shape == (4, 9, 4)


class TestOnDeviceMPC:
    """The fully-fused device rollout must reproduce the host-loop driver used
    for golden parity (same per-tick semantics)."""

    def test_matches_host_loop_hovering(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=20, check_termination=0)
        x0j = jnp.asarray(x0, jnp.float32)

        _, xf, trace = jax.jit(
            lambda x: mpc_rollout(problem, cache, settings, x, 40)
        )(x0j)
        x_host, u_host, _ = run_mpc_loop(problem, cache, settings, x0, steps=40)
        np.testing.assert_allclose(
            np.asarray(trace.u), u_host, rtol=0, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(trace.x), x_host, rtol=0, atol=1e-4
        )

    def test_batched_rollout(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=15, check_termination=0)
        rng = np.random.default_rng(1)
        x0s = jnp.asarray(
            np.asarray(x0)[None] + 0.05 * rng.standard_normal((3, 12)),
            jnp.float32,
        )
        _, xf, trace = jax.jit(
            lambda x: mpc_rollout(problem, cache, settings, x, 30, batched=True)
        )(x0s)
        assert trace.u.shape == (30, 3, 4)
        # each instance behaves like its standalone rollout
        _, _, solo = jax.jit(
            lambda x: mpc_rollout(problem, cache, settings, x, 30)
        )(x0s[1])
        np.testing.assert_allclose(
            np.asarray(trace.u[:, 1]), np.asarray(solo.u), rtol=0, atol=1e-4
        )

    def test_tracking_window_slides(self):
        from accelerated_tinympc_tpu.models import quadrotor_tracking_setup

        problem, cache, x0, Xref_total = quadrotor_tracking_setup()
        settings = atm.Settings(max_iter=15, check_termination=0)
        T = 60
        _, _, trace = jax.jit(
            lambda x: mpc_rollout(
                problem, cache, settings, x, T,
                Xref_total=jnp.asarray(Xref_total, jnp.float32),
            )
        )(jnp.asarray(x0, jnp.float32))
        from accelerated_tinympc_tpu.api import tracking_error

        err = np.asarray(tracking_error(trace, jnp.asarray(Xref_total, jnp.float32)))
        # tracking stays tight along the y-axis line (reference example's
        # qualitative bar: per-tick error decays/stays small)
        assert err[10:].max() < 0.3


class TestSerialization:
    def test_problem_cache_roundtrip(self, tmp_path):
        problem, cache, _ = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=42, check_termination=3)
        f = tmp_path / "bundle.npz"
        save_problem_cache(f, problem, cache, settings)
        p2, c2, s2 = load_problem_cache(f)
        np.testing.assert_array_equal(np.asarray(problem.A), np.asarray(p2.A))
        np.testing.assert_array_equal(
            np.asarray(cache.Kinf), np.asarray(c2.Kinf)
        )
        assert s2.max_iter == 42 and s2.check_termination == 3


class TestAOTExport:
    def test_export_roundtrip(self, tmp_path):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=10, check_termination=0)
        exported = export_batched_solve(problem, cache, settings, batch=2)
        f = tmp_path / "solve.jaxexport"
        save_exported(f, exported)
        solve = load_exported(f)
        x0s = jnp.tile(jnp.asarray(x0, jnp.float32), (2, 1))
        out = solve(x0s)
        # matches the live solver
        from accelerated_tinympc_tpu.solver.batched import (
            init_state_batched,
            solve_batched,
        )

        st = init_state_batched(2, 12, 4, 10)
        st = st.replace(x=st.x.at[:, 0, :].set(x0s))
        want = solve_batched(st, problem, cache, settings)
        np.testing.assert_allclose(
            np.asarray(out["u"]), np.asarray(want.u), rtol=0, atol=1e-6
        )


class TestFusedRollout:
    def test_fused_rollout_matches_jnp_rollout(self):
        from accelerated_tinympc_tpu.api import fused_mpc_rollout
        from accelerated_tinympc_tpu.ops import pad_problem
        from accelerated_tinympc_tpu.precompute import condensed_operators

        problem, cache, x0 = quadrotor_hovering_setup()
        ops = condensed_operators(
            cache, np.asarray(problem.A), np.asarray(problem.B),
            problem.horizon,
        )
        pp = pad_problem(problem, cache, ops)
        x0s = jnp.tile(jnp.asarray(x0, jnp.float32), (2, 1))
        xf, us, carry = fused_mpc_rollout(
            pp, x0s, 15, problem=problem, max_iter=20, interpret=True
        )
        settings = atm.Settings(max_iter=20, check_termination=0)
        _, xf_ref, trace = jax.jit(
            lambda x: mpc_rollout(problem, cache, settings, x, 15)
        )(x0s[0])
        np.testing.assert_allclose(
            np.asarray(us[:, 0, :]), np.asarray(trace.u), rtol=0, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(xf[0]), np.asarray(xf_ref), rtol=0, atol=1e-4
        )

    def test_fused_rollout_adaptive_matches_jnp(self):
        # check_termination > 0 routes each tick through the adaptive
        # freezing kernel (the warm-tick fast path); trajectories must match
        # the scan tier's early-exiting rollout tick for tick.
        from accelerated_tinympc_tpu.api import fused_mpc_rollout
        from accelerated_tinympc_tpu.ops import pad_problem
        from accelerated_tinympc_tpu.precompute import condensed_operators

        problem, cache, x0 = quadrotor_hovering_setup()
        ops = condensed_operators(
            cache, np.asarray(problem.A), np.asarray(problem.B),
            problem.horizon,
        )
        pp = pad_problem(problem, cache, ops)
        x0s = jnp.tile(jnp.asarray(x0, jnp.float32), (2, 1))
        T = 12
        xf, us, carry = fused_mpc_rollout(
            pp, x0s, T, problem=problem, max_iter=40,
            check_termination=1, interpret=True,
        )
        settings = atm.Settings(max_iter=40, check_termination=1)
        _, xf_ref, trace = jax.jit(
            lambda x: mpc_rollout(problem, cache, settings, x, T)
        )(x0s[0])
        np.testing.assert_allclose(
            np.asarray(us[:, 0, :]), np.asarray(trace.u), rtol=0, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(xf[0]), np.asarray(xf_ref), rtol=0, atol=1e-4
        )

    def test_tinympc_rollout_method(self):
        # TinyMPC.rollout drives the reference loop from the object surface
        # on both tiers; warm state advances (continuations compose).
        problem, cache, x0 = quadrotor_hovering_setup()
        x0 = jnp.asarray(x0, jnp.float32)
        sets = atm.Settings(max_iter=40, check_termination=1)
        m = atm.TinyMPC.from_parts(problem, cache, settings=sets)
        m.set_x0(x0)
        xf, us = m.rollout(70)
        assert us.shape == (70, 4)
        assert float(jnp.linalg.norm(xf - problem.Xref[1])) < 0.01
        xf2, us2 = m.rollout(5)   # warm continuation
        assert us2.shape == (5, 4)

        m2 = atm.TinyMPC.from_parts(problem, cache, settings=sets, batch=4)
        m2.set_x0(jnp.tile(x0, (4, 1)))
        xf3, us3 = m2.rollout(6)
        m3 = atm.TinyMPC.from_parts(problem, cache, settings=sets,
                                    tier="fused", interpret=True, batch=4)
        m3.set_x0(jnp.tile(x0, (4, 1)))
        xf4, us4 = m3.rollout(6)
        np.testing.assert_allclose(np.asarray(us3), np.asarray(us4),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(xf3), np.asarray(xf4),
                                   rtol=0, atol=1e-4)

    def test_fused_tracking_matches_jnp(self):
        from accelerated_tinympc_tpu.api import fused_mpc_rollout
        from accelerated_tinympc_tpu.models import quadrotor_tracking_setup
        from accelerated_tinympc_tpu.ops import pad_problem
        from accelerated_tinympc_tpu.precompute import condensed_operators

        problem, cache, x0, Xref_total = quadrotor_tracking_setup()
        ops = condensed_operators(
            cache, np.asarray(problem.A), np.asarray(problem.B),
            problem.horizon,
        )
        pp = pad_problem(problem, cache, ops)
        Xref_dev = jnp.asarray(Xref_total, jnp.float32)
        x0s = jnp.asarray(x0, jnp.float32)[None]
        T = 25
        xf, us, _ = fused_mpc_rollout(
            pp, x0s, T, problem=problem, max_iter=15, interpret=True,
            Xref_total=Xref_dev, Pinf=cache.Pinf,
        )
        settings = atm.Settings(max_iter=15, check_termination=0)
        _, xf_ref, trace = jax.jit(
            lambda x: mpc_rollout(
                problem, cache, settings, x, T, Xref_total=Xref_dev
            )
        )(x0s[0])
        np.testing.assert_allclose(
            np.asarray(us[:, 0, :]), np.asarray(trace.u), rtol=0, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(xf[0]), np.asarray(xf_ref), rtol=0, atol=1e-4
        )


class TestTierBoundConsistency:
    """Bound semantics must agree across tiers (review finding): set_bounds
    enables clipping everywhere, and disabled bound sets are inert on the
    fused tier too."""

    def test_set_bounds_enables_flags(self):
        from accelerated_tinympc_tpu.models import cartpole

        mpc = TinyMPC.setup(
            cartpole.A, cartpole.B, cartpole.Q_DIAG, cartpole.R_DIAG,
            rho=CARTPOLE_RHO, horizon=10,
        )
        assert not mpc.settings.en_input_bound
        mpc.set_bounds(u_min=-0.1, u_max=0.1, x_min=-5.0, x_max=5.0)
        assert mpc.settings.en_input_bound and mpc.settings.en_state_bound
        mpc.settings = mpc.settings.replace(max_iter=30, check_termination=0)
        x0 = jnp.asarray([0.5, 0, 0.2, 0], jnp.float32)

        mpc.set_x0(x0)
        mpc.solve()
        u_bounded = mpc.get_u()
        # the projected slack iterate lives inside the new box
        assert float(jnp.abs(mpc.state.znew).max()) <= 0.1 + 1e-6
        # and the (pre-projection) controls are pulled well below unbounded
        unb = TinyMPC.setup(
            cartpole.A, cartpole.B, cartpole.Q_DIAG, cartpole.R_DIAG,
            rho=CARTPOLE_RHO, horizon=10,
            settings=mpc.settings.replace(
                en_input_bound=False, en_state_bound=False
            ),
        )
        unb.set_x0(x0)
        unb.solve()
        assert np.abs(u_bounded).max() < np.abs(unb.get_u()).max()

    def test_disabled_bounds_inert_on_fused(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(
            max_iter=20, check_termination=0,
            en_input_bound=False, en_state_bound=False,
        )
        us = {}
        for tier in ("scan", "fused"):
            mpc = TinyMPC.from_parts(
                problem, cache, settings=settings, tier=tier,
                interpret=(tier == "fused"),
            )
            mpc.set_x0(jnp.asarray(x0, jnp.float32))
            mpc.solve()
            us[tier] = mpc.get_u()
        np.testing.assert_allclose(us["scan"], us["fused"], rtol=0, atol=1e-4)

    def test_get_before_solve(self):
        problem, cache, _ = quadrotor_hovering_setup()
        mpc = TinyMPC.from_parts(problem, cache, tier="fused", interpret=True)
        assert mpc.get_u().shape == (9, 4)
        assert np.all(mpc.get_u() == 0)

    def test_set_xref_updates_fused_reference(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=20, check_termination=0)
        mpc = TinyMPC.from_parts(
            problem, cache, settings=settings, tier="fused", interpret=True
        )
        mpc.set_x0(jnp.asarray(x0, jnp.float32))
        mpc.solve()
        u_hover = mpc.get_u()
        new_ref = jnp.zeros_like(problem.Xref)
        mpc.set_xref(new_ref)
        mpc._fused_carry = mpc._fused_carry.zeros(1, mpc._pp)  # cold restart
        mpc.solve()
        u_zero = mpc.get_u()
        assert np.abs(u_hover - u_zero).max() > 1e-3  # reference took effect


def test_export_fused_serializes_for_cuda(tmp_path):
    """The fused export lowers the Triton kernel for CUDA and serializes
    from any host (the artifact runs only on the card)."""
    from accelerated_tinympc_tpu.api import export_fused_solve
    from accelerated_tinympc_tpu.ops import pad_problem
    from accelerated_tinympc_tpu.precompute import condensed_operators
    from jax import export as jax_export

    problem, cache, _x0 = quadrotor_hovering_setup()
    pp = pad_problem(problem, cache, condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon))
    exported = export_fused_solve(pp, 64, max_iter=5)
    assert exported.platforms == ("cuda",)
    f = tmp_path / "fused.jaxexport"
    save_exported(f, exported)
    back = jax_export.deserialize(f.read_bytes())
    assert [a.shape for a in back.in_avals] == [
        (64, 12), (64, pp.Dup), (64, pp.Dup), (64, pp.Dxp), (64, pp.Dup),
        (64, pp.Dxp)]


@pytest.mark.gpu
def test_export_fused_roundtrip(tmp_path):
    """The exported fused kernel runs on the card and reproduces the live
    solve. (Serialization itself is checked on any host by
    test_export_fused_serializes_for_cuda; it needs the optional
    flatbuffers package.)"""
    from accelerated_tinympc_tpu.api import export_fused_solve
    from accelerated_tinympc_tpu.ops import FusedCarry, fused_solve, pad_problem
    from accelerated_tinympc_tpu.precompute import condensed_operators

    problem, cache, x0 = quadrotor_hovering_setup()
    ops = condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon
    )
    pp = pad_problem(problem, cache, ops)
    exported = export_fused_solve(pp, 256, max_iter=50)
    x0s = jnp.tile(jnp.asarray(x0, jnp.float32), (256, 1))
    c = FusedCarry.zeros(256, pp)
    out = jax.jit(exported.call)(x0s, c.D, c.Y, c.G, c.Z, c.V)
    want = jax.jit(lambda x, cc: fused_solve(x, cc, pp, max_iter=50))(x0s, c)
    np.testing.assert_allclose(
        np.asarray(out["U"]), np.asarray(want.U), rtol=0, atol=1e-6
    )


def test_repeated_solve_warm_starts_consistently():
    """Repeated solve() without resets warm-starts from the previous result
    on every tier (reference: repeated call_tiny_solve over the persistent
    workspace) — tiers must agree after each call, and the second result must
    differ from the first (proving state carried)."""
    problem, cache, x0 = quadrotor_hovering_setup()
    settings = atm.Settings(max_iter=30, check_termination=0)
    results = {}
    for tier in ("scan", "fused"):
        mpc = TinyMPC.from_parts(
            problem, cache, settings=settings, tier=tier,
            interpret=(tier == "fused"),
        )
        mpc.set_x0(jnp.asarray(x0, jnp.float32))
        mpc.solve()
        first = mpc.get_u().copy()
        mpc.solve()
        second = mpc.get_u().copy()
        results[tier] = (first, second)
        assert np.abs(second - first).max() > 1e-4, f"{tier}: no warm start"
    for idx, name in ((0, "first"), (1, "second")):
        np.testing.assert_allclose(
            results["scan"][idx], results["fused"][idx], rtol=0, atol=2e-4,
            err_msg=name,
        )


class TestAdaptiveRhoAPI:
    """solve_adaptive_rho reachable from TinyMPC (production adaptive
    rho; beyond reference codegen.cpp:254-258 fixed-rho
    baking)."""

    def _setup(self, rho, batch=None):
        from accelerated_tinympc_tpu.models import random_lti_problem
        from accelerated_tinympc_tpu.precompute import riccati_cache

        problem, _ = random_lti_problem(seed=5, nx=8, nu=3, horizon=10)
        cache = riccati_cache(
            np.asarray(problem.A), np.asarray(problem.B),
            np.asarray(problem.Q), np.asarray(problem.R), rho,
        )
        mpc = TinyMPC.from_parts(
            problem, cache,
            settings=atm.Settings(abs_pri_tol=0.02, abs_dua_tol=0.02,
                                  check_termination=1, max_iter=1000),
            batch=batch,
        )
        return mpc

    def test_single_misscaled_rescued(self):
        mpc = self._setup(rho=1e-3)
        rng = np.random.default_rng(0)
        mpc.set_x0(jnp.asarray(rng.standard_normal(8) * 0.4, jnp.float32))
        out = mpc.solve_adaptive_rho(chunk=25, max_total_iter=1500)
        assert out["solved"]
        assert out["rho"] != 1e-3  # the guard fired and moved rho
        # The adapted cache is adopted: a plain solve now converges fast.
        stats = mpc.solve()
        assert stats["solved"]

    def test_batched_misscaled_rescued(self):
        B = 4
        mpc = self._setup(rho=1e-3, batch=B)
        rng = np.random.default_rng(1)
        mpc.set_x0(jnp.asarray(rng.standard_normal((B, 8)) * 0.4, jnp.float32))
        out = mpc.solve_adaptive_rho(chunk=25, max_rounds=40)
        # Contract: per-instance results surface through the API. Rescue
        # efficacy on genuinely stalling instances is covered in
        # tests/test_batched_ops.py (this plant happens to converge at the
        # mis-scaled rho within budget, so the stall guard rightly may not
        # fire for every instance).
        assert out["converged_fraction"] == 1.0
        assert out["rho"].shape == (B,) and out["iterations"].shape == (B,)


def test_fused_tol_change_no_recompile():
    """Tolerances are traced kernel operands: changing them must not create a
    new jit entry."""
    from accelerated_tinympc_tpu.api import solver as solver_mod

    problem, cache, x0 = quadrotor_hovering_setup()
    mpc = TinyMPC.from_parts(
        problem, cache,
        settings=atm.Settings(max_iter=40, check_termination=1,
                              abs_pri_tol=0.05, abs_dua_tol=0.05),
        tier="fused", interpret=True,
    )
    mpc.set_x0(x0)
    solver_mod._jit_fused.cache_clear()
    mpc.solve()
    info1 = solver_mod._jit_fused.cache_info()
    mpc.settings = mpc.settings.replace(abs_pri_tol=0.02, abs_dua_tol=0.03)
    mpc.solve()
    info2 = solver_mod._jit_fused.cache_info()
    assert info1.misses == info2.misses == 1  # same compiled entry reused
