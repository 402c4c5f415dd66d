"""End-to-end golden parity: the engine (f32) vs trajectories dumped from the
compiled, unmodified reference solver (double; generated cartpole code: float).

Goldens produced by tools/golden/golden_quadrotor.cpp (linked against
/root/reference/src/tinympc/admm.cpp) and the reference codegen's emitted
cartpole project. Parity bar: max control-input error < 1e-4 at
matched horizon/iteration count.
"""

import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import (
    cartpole_problem,
    quadrotor_hovering_setup,
    quadrotor_tracking_setup,
)
from accelerated_tinympc_tpu.precompute import riccati_cache

from golden_utils import load_solve0_csv, load_traj_csv, run_mpc_loop

U_TOL = 1e-4  # control-parity bound


class TestHoveringFixedIterations:
    """70-tick hovering loop at a fixed 50 ADMM iterations per solve
    (deterministic: no early-exit nondeterminism, SURVEY.md §4)."""

    @pytest.fixture(scope="class")
    def run(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=50, check_termination=0)
        got = run_mpc_loop(problem, cache, settings, x0, steps=70)
        want = load_traj_csv("hovering_fixed50", 12, 4)
        return got, want

    def test_controls_match(self, run):
        (_, u0, _), want = run
        np.testing.assert_allclose(u0, want["u0"], rtol=0, atol=U_TOL)

    def test_states_match(self, run):
        (x0, _, _), want = run
        np.testing.assert_allclose(x0, want["x0"], rtol=0, atol=1e-3)


class TestHoveringAdaptive:
    """Reference default settings: tol 1e-3, max_iter 100, check every iteration
    (reference: examples/quadrotor_hovering.cpp:73-78)."""

    @pytest.fixture(scope="class")
    def run(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=100, check_termination=1)
        got = run_mpc_loop(problem, cache, settings, x0, steps=70)
        want = load_traj_csv("hovering_adaptive", 12, 4)
        return got, want

    def test_controls_match(self, run):
        (_, u0, _), want = run
        np.testing.assert_allclose(u0, want["u0"], rtol=0, atol=U_TOL)

    def test_iteration_counts_track_f32(self, run):
        # The f32 tier documents its drift envelope: f32-vs-double residuals
        # can flip an occasional borderline termination check. The EXACT
        # schedule-parity guarantee lives in TestAdaptiveScheduleExactF64
        # below (matched precision).
        (_, _, iters), want = run
        agree = np.mean(iters == want["iters"])
        assert agree >= 0.9, (iters.tolist(), want["iters"].tolist())
        assert np.max(np.abs(iters - want["iters"])) <= 5


class TestAdaptiveScheduleExactF64:
    """At matched precision (x64 scan tier vs the double reference binary),
    the adaptive termination schedule agrees EXACTLY on every tick — the
    residual checks (reference: src/tinympc/admm.cpp:91-109) and early-exit
    semantics leave no room for disagreement once the 1e-7-level f32 iterate
    drift is removed. Retires the f32 tier's 10% knife-edge allowance as the
    best available schedule-parity bound."""

    def test_hovering_iteration_counts_exact(self):
        import jax
        import jax.numpy as jnp

        with jax.enable_x64(True):
            problem, cache, x0 = quadrotor_hovering_setup(dtype=jnp.float64)
            settings = atm.Settings(max_iter=100, check_termination=1)
            _, u0, iters = run_mpc_loop(
                problem, cache, settings, x0, steps=70, dtype=jnp.float64
            )
        want = load_traj_csv("hovering_adaptive", 12, 4)
        np.testing.assert_array_equal(iters, want["iters"])
        np.testing.assert_allclose(u0, want["u0"], rtol=0, atol=1e-9)

    def test_tracking_iteration_counts_exact(self):
        import jax
        import jax.numpy as jnp

        with jax.enable_x64(True):
            problem, cache, x0, Xref_total = quadrotor_tracking_setup(
                dtype=jnp.float64
            )
            settings = atm.Settings(max_iter=100, check_termination=1)
            _, u0, iters = run_mpc_loop(
                problem, cache, settings, x0, steps=290,
                Xref_total=Xref_total, dtype=jnp.float64,
            )
        want = load_traj_csv("tracking_adaptive", 12, 4)
        np.testing.assert_array_equal(iters, want["iters"])
        np.testing.assert_allclose(u0, want["u0"], rtol=0, atol=1e-9)


class TestFirstSolveWorkspace:
    """Deep parity of the *entire workspace* after one 50-iteration solve —
    catches any stage-ordering or masking drift that trajectory-level tests
    could average away."""

    @pytest.fixture(scope="class")
    def run(self):
        problem, cache, x0 = quadrotor_hovering_setup()
        settings = atm.Settings(max_iter=50, check_termination=0)
        state = atm.set_x0(
            atm.reset_duals(atm.init_state(12, 4, 10)), np.asarray(x0, np.float32)
        )
        state = atm.solve(state, problem, cache, settings)
        want = load_solve0_csv("hovering_fixed50", 10, 12, 4)
        return state, want

    @pytest.mark.parametrize(
        "field,tol",
        [
            ("x", 2e-4), ("u", 1e-4), ("q", 2e-3), ("r", 1e-3),
            ("p", 2e-2), ("d", 1e-4), ("v", 2e-4), ("vnew", 2e-4),
            ("z", 1e-4), ("znew", 1e-4), ("g", 2e-4), ("y", 1e-4),
        ],
    )
    def test_field(self, run, field, tol):
        state, want = run
        got = np.asarray(getattr(state, field))
        scale = max(1.0, np.max(np.abs(want[field])))
        np.testing.assert_allclose(got, want[field], rtol=0, atol=tol * scale)

    def test_iter(self, run):
        state, want = run
        assert int(state.iter) == int(want["iter"][0])


class TestTracking:
    """290-tick sliding-window tracking of the 20 Hz y-axis-line trajectory
    (reference: examples/quadrotor_tracking.cpp:84-118)."""

    @pytest.mark.parametrize(
        "golden,max_iter,check",
        [("tracking_fixed25", 25, 0), ("tracking_adaptive", 100, 1)],
    )
    def test_controls_match(self, golden, max_iter, check):
        problem, cache, x0, Xref_total = quadrotor_tracking_setup()
        settings = atm.Settings(max_iter=max_iter, check_termination=check)
        _, u0, _ = run_mpc_loop(
            problem, cache, settings, x0, steps=290, Xref_total=Xref_total
        )
        want = load_traj_csv(golden, 12, 4)
        np.testing.assert_allclose(u0, want["u0"], rtol=0, atol=U_TOL)


class TestCartpole:
    """300-step cartpole stabilization against the reference codegen's emitted
    float32 project (reference: examples/codegen_cartpole.cpp:73-124 loop)."""

    @pytest.mark.parametrize(
        "golden,max_iter,check",
        [("cartpole_fixed40", 40, 0), ("cartpole_adaptive", 150, 1)],
    )
    def test_controls_match(self, golden, max_iter, check):
        problem = cartpole_problem()
        from accelerated_tinympc_tpu.models import cartpole as cp

        # The generated project stores rho-augmented Q/R in the workspace
        # (reference: src/tinympc/codegen.cpp:254-258,349-357).
        cache = riccati_cache(cp.A, cp.B, cp.Q_DIAG, cp.R_DIAG, cp.RHO)
        problem = problem.replace(
            Q=problem.Q + np.float32(cp.RHO), R=problem.R + np.float32(cp.RHO)
        )
        settings = atm.Settings(max_iter=max_iter, check_termination=check)
        x0 = np.array([0.0, 0.0, 0.1, 0.0])
        _, u0, _ = run_mpc_loop(problem, cache, settings, x0, steps=300)
        want = load_traj_csv(golden, 4, 1)
        np.testing.assert_allclose(u0, want["u0"], rtol=0, atol=U_TOL)


class TestFusedVsReferenceGolden:
    """The fused kernel tier (via the interpreter) reproduces the reference
    C++ binary end-to-end: 70 hovering ticks at fixed 50 iterations against
    the golden trajectory dumped from the unmodified reference solver."""

    def test_fused_rollout_matches_reference(self):
        from accelerated_tinympc_tpu.api import fused_mpc_rollout
        from accelerated_tinympc_tpu.ops import pad_problem
        from accelerated_tinympc_tpu.precompute import condensed_operators
        import jax.numpy as jnp

        problem, cache, x0 = quadrotor_hovering_setup()
        ops = condensed_operators(
            cache, np.asarray(problem.A), np.asarray(problem.B),
            problem.horizon,
        )
        pp = pad_problem(problem, cache, ops)
        _, us, _ = fused_mpc_rollout(
            pp, jnp.asarray(x0, jnp.float32)[None], 70, problem=problem,
            max_iter=50, interpret=True,
        )
        want = load_traj_csv("hovering_fixed50", 12, 4)
        np.testing.assert_allclose(
            np.asarray(us[:, 0, :]), want["u0"], rtol=0, atol=U_TOL
        )


class TestFusedAdaptiveVsReferenceGolden:
    """Adaptive mode end-to-end against the reference binary: 70 warm-started
    hovering ticks at the reference's default settings (tol 1e-3, check every
    iteration, max 100) must reproduce the golden per-tick iteration counts
    and controls — the strongest adaptive-semantics check (early exit, frozen
    state, dual reset, warm-started slacks)."""

    def test_fused_adaptive_rollout_matches_reference(self):
        import jax.numpy as jnp
        from accelerated_tinympc_tpu.ops import (
            FusedCarry, fused_solve, pad_problem,
        )
        from accelerated_tinympc_tpu.precompute import condensed_operators

        problem, cache, x0 = quadrotor_hovering_setup()
        ops = condensed_operators(
            cache, np.asarray(problem.A), np.asarray(problem.B),
            problem.horizon,
        )
        pp = pad_problem(problem, cache, ops)
        want = load_traj_csv("hovering_adaptive", 12, 4)

        x = jnp.asarray(x0, jnp.float32)[None]
        carry = FusedCarry.zeros(1, pp)
        iters, u0s = [], []
        for _ in range(70):
            res = fused_solve(
                x, carry.reset_duals(), pp, max_iter=100,
                check_termination=1, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                interpret=True,
            )
            carry = res.carry
            u0 = res.U[:, :4]
            iters.append(int(res.stats[0, 0]))
            u0s.append(np.asarray(u0[0]))
            x = (x @ problem.A.T) + (u0 @ problem.B.T)

        np.testing.assert_allclose(
            np.stack(u0s), want["u0"], rtol=0, atol=U_TOL
        )
        # Iteration counts track the reference's; f32-vs-double residuals at
        # the tolerance boundary may shift an occasional tick by a few iters.
        diff = np.abs(np.asarray(iters) - want["iters"])
        assert np.mean(diff == 0) > 0.8, (iters, want["iters"].tolist())
        assert diff.max() <= 5, (iters, want["iters"].tolist())
