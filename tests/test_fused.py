"""Fused kernel (Pallas, Triton route) vs the jnp tiers, via the Pallas
interpreter on CPU (SURVEY.md §4: kernel paths must be testable without the
card). Semantics bar: same schedule as the reference iteration, controls
inside the 1e-4 parity band, identical iteration counts / convergence flags
in adaptive mode."""

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
    unpad_controls,
    unpad_states,
)
from accelerated_tinympc_tpu.precompute import condensed_operators
from accelerated_tinympc_tpu.utils.parity import compare_schedules
from accelerated_tinympc_tpu.solver.batched import init_state_batched, solve_batched

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
    st = init_state_batched(x0s.shape[0], problem.nx, problem.nu, problem.horizon)
    st = st.replace(x=st.x.at[:, 0, :].set(x0s))
    return jax.jit(lambda s: solve_batched(s, problem, cache, settings))(st)


class TestFixedIterations:
    @pytest.fixture(scope="class")
    def result(self, setup):
        problem, cache, pp, x0s = setup
        carry = FusedCarry.zeros(B, pp)
        got = fused_solve(
            x0s, carry, pp, max_iter=25, check_termination=0, batch_tile=16,
            interpret=True,
        )
        want = _run_scan(
            problem, cache, x0s, atm.Settings(max_iter=25, check_termination=0)
        )
        return got, want, pp

    def test_controls(self, result):
        got, want, pp = result
        u = np.asarray(got.U[:, : pp.dims[1] * (pp.dims[2] - 1)]).reshape(
            B, pp.dims[2] - 1, pp.dims[1]
        )
        np.testing.assert_allclose(
            u, np.asarray(want.u), rtol=0, atol=1e-4
        )

    def test_states(self, result):
        got, want, pp = result
        x = np.asarray(unpad_states(got, pp))
        np.testing.assert_allclose(x, np.asarray(want.x), rtol=0, atol=2e-4)

    def test_warm_start_carries(self, result):
        got, want, pp = result
        nu, N = pp.dims[1], pp.dims[2]
        Du = nu * (N - 1)
        np.testing.assert_allclose(
            np.asarray(got.carry.D[:, :Du]),
            np.asarray(want.d).reshape(B, -1),
            rtol=0, atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(got.carry.Y[:, :Du]),
            np.asarray(want.y).reshape(B, -1),
            rtol=0, atol=1e-4,
        )

    def test_padded_lanes_stay_zero(self, result):
        got, _want, pp = result
        nu, N = pp.dims[1], pp.dims[2]
        Du, Dx = nu * (N - 1), pp.dims[0] * N
        assert np.all(np.asarray(got.U[:, Du:]) == 0)
        assert np.all(np.asarray(got.X[:, Dx:]) == 0)
        assert np.all(np.asarray(got.carry.G[:, Dx:]) == 0)


class TestAdaptive:
    @pytest.fixture(scope="class")
    def result(self, setup):
        problem, cache, pp, x0s = setup
        carry = FusedCarry.zeros(B, pp)
        got = fused_solve(
            x0s, carry, pp, max_iter=400, check_termination=1,
            abs_pri_tol=0.05, abs_dua_tol=0.05, batch_tile=16, interpret=True,
        )
        want = _run_scan(
            problem, cache, x0s,
            atm.Settings(
                abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=400,
                check_termination=1,
            ),
        )
        return got, want, pp

    def test_iterations_and_status(self, result):
        got, want, _pp = result
        np.testing.assert_array_equal(
            np.asarray(got.stats[:, 0]).astype(int), np.asarray(want.iter)
        )
        solved = np.asarray(got.stats[:, 1]) > 0.5
        np.testing.assert_array_equal(
            solved, np.asarray(want.status) == atm.SOLVED
        )

    def test_iterations_diverge(self, result):
        got, _want, _pp = result
        assert len(set(np.asarray(got.stats[:, 0]).tolist())) > 1

    def test_controls(self, result):
        got, want, pp = result
        u0 = np.asarray(unpad_controls(got, pp))
        np.testing.assert_allclose(
            u0, np.asarray(want.u[:, 0, :]), rtol=0, atol=1e-4
        )

    def test_residual_stats(self, result):
        got, want, _pp = result
        res = np.asarray(got.stats[:, 2:6])
        want_res = np.stack(
            [
                np.asarray(want.primal_residual_state),
                np.asarray(want.dual_residual_state),
                np.asarray(want.primal_residual_input),
                np.asarray(want.dual_residual_input),
            ],
            axis=-1,
        )
        np.testing.assert_allclose(res, want_res, rtol=0, atol=3e-4)


class TestWideHorizon:
    """Generality beyond the hovering widths: N=22 -> Dx=264 -> Dxp=512,
    Du=84 -> Dup=128."""

    @pytest.fixture(scope="class")
    def wide_setup(self):
        from accelerated_tinympc_tpu.models import random_lti_problem
        from accelerated_tinympc_tpu.precompute import riccati_cache

        problem, rho = random_lti_problem(seed=11, nx=12, nu=4, horizon=22)
        cache = riccati_cache(
            np.asarray(problem.A), np.asarray(problem.B),
            np.asarray(problem.Q), np.asarray(problem.R), rho,
        )
        ops = condensed_operators(
            cache, np.asarray(problem.A), np.asarray(problem.B), 22
        )
        pp = pad_problem(problem, cache, ops)
        assert pp.Dxp == 512 and pp.Dup == 128  # the case under test
        rng = np.random.default_rng(2)
        x0s = jnp.asarray(rng.standard_normal((8, 12)) * 0.3, jnp.float32)
        return problem, cache, pp, x0s

    @pytest.mark.parametrize("mode", ["fixed", "adaptive"])
    def test_parity_vs_scan(self, wide_setup, mode):
        problem, cache, pp, x0s = wide_setup
        carry = FusedCarry.zeros(8, pp)
        if mode == "fixed":
            got = fused_solve(
                x0s, carry, pp, max_iter=20, check_termination=0,
                batch_tile=16, interpret=True,
            )
            settings = atm.Settings(max_iter=20, check_termination=0)
        else:
            got = fused_solve(
                x0s, carry, pp, max_iter=100, check_termination=1,
                abs_pri_tol=0.05, abs_dua_tol=0.05, batch_tile=16,
                interpret=True,
            )
            settings = atm.Settings(
                abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=100,
                check_termination=1,
            )
        want = _run_scan(problem, cache, x0s, settings)
        u = np.asarray(got.U[:, : 21 * 4]).reshape(8, 21, 4)
        np.testing.assert_allclose(
            u, np.asarray(want.u), rtol=1e-4, atol=2e-4
        )
        if mode == "adaptive":
            np.testing.assert_array_equal(
                np.asarray(got.stats[:, 0]).astype(int), np.asarray(want.iter)
            )


def test_non_tile_multiple_batch(setup):
    """Batches that aren't tile multiples are padded internally and sliced
    back (serving-friendly; TinyMPC produces such batches)."""
    problem, cache, pp, x0s = setup
    x0_odd = x0s[:5]
    got = fused_solve(
        x0_odd, FusedCarry.zeros(5, pp), pp, max_iter=20,
        check_termination=0, batch_tile=16, interpret=True,
    )
    assert got.U.shape[0] == 5 and got.stats.shape[0] == 5
    want = fused_solve(
        x0s[:8], FusedCarry.zeros(8, pp), pp, max_iter=20,
        check_termination=0, batch_tile=16, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(got.U), np.asarray(want.U[:5]), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize("batch_tile", [16, 32, 64])
def test_batch_tile_invariance(setup, batch_tile):
    """Rows are independent: the tile size changes the grid, not the
    per-instance iterates or adaptive schedules."""
    problem, cache, pp, x0s = setup
    kw = dict(max_iter=200, check_termination=1, abs_pri_tol=0.05,
              abs_dua_tol=0.05, interpret=True)
    ref = fused_solve(x0s, FusedCarry.zeros(B, pp), pp, batch_tile=16, **kw)
    got = fused_solve(x0s, FusedCarry.zeros(B, pp), pp,
                      batch_tile=batch_tile, **kw)
    np.testing.assert_array_equal(np.asarray(got.stats[:, 0]),
                                  np.asarray(ref.stats[:, 0]))
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch_tile", [0, 8, 24])
def test_batch_tile_must_be_pow2_ge16(setup, batch_tile):
    problem, cache, pp, x0s = setup
    with pytest.raises(ValueError, match="power of two"):
        fused_solve(x0s, FusedCarry.zeros(B, pp), pp, max_iter=2,
                    batch_tile=batch_tile, interpret=True)


@pytest.mark.parametrize("check", [5, 10])
def test_check_interval_schedule(setup, check):
    """Checks fire only at multiples of ``check_termination`` (reference
    admm.cpp:93); counts equal the scan tier's at that cadence."""
    problem, cache, pp, x0s = setup
    got = fused_solve(
        x0s, FusedCarry.zeros(B, pp), pp, max_iter=400,
        check_termination=check, abs_pri_tol=0.05, abs_dua_tol=0.05,
        interpret=True,
    )
    want = _run_scan(problem, cache, x0s, atm.Settings(
        abs_pri_tol=0.05, abs_dua_tol=0.05, max_iter=400,
        check_termination=check))
    iters = np.asarray(got.stats[:, 0]).astype(int)
    np.testing.assert_array_equal(iters, np.asarray(want.iter))
    assert np.all(iters % check == 0)


def test_alpha_relaxation_matches_scan(setup):
    """Settings.alpha (over-relaxation) is honoured in-kernel exactly like
    the scan tier's admm_iteration."""
    problem, cache, pp, x0s = setup
    got = fused_solve(x0s, FusedCarry.zeros(B, pp), pp, max_iter=30,
                      alpha=1.6, interpret=True)
    want = _run_scan(problem, cache, x0s, atm.Settings(
        max_iter=30, check_termination=0, alpha=1.6))
    u = np.asarray(got.U[:, :36]).reshape(B, 9, 4)
    np.testing.assert_allclose(u, np.asarray(want.u), rtol=0, atol=1e-4)


def test_warm_carry_continuation(setup):
    """Fixed mode is a pure map on the carries: two chained 10-iteration
    solves equal one 20-iteration solve (the warm-start contract)."""
    problem, cache, pp, x0s = setup
    one = fused_solve(x0s, FusedCarry.zeros(B, pp), pp, max_iter=20,
                      interpret=True)
    a = fused_solve(x0s, FusedCarry.zeros(B, pp), pp, max_iter=10,
                    interpret=True)
    b = fused_solve(x0s, a.carry, pp, max_iter=10, interpret=True)
    np.testing.assert_allclose(np.asarray(b.U), np.asarray(one.U),
                               rtol=0, atol=1e-5)


def test_tracking_operands_match_scan(setup):
    """xref_q/pterm_c override the baked reference (tracking window) with
    the same controls as a scan solve on that reference."""
    from accelerated_tinympc_tpu.ops.fused_admm import ref_vectors

    problem, cache, pp, x0s = setup
    rng = np.random.default_rng(3)
    Xref = jnp.asarray(0.2 * rng.standard_normal(problem.Xref.shape),
                       jnp.float32)
    xq, pc = ref_vectors(pp, problem.Q, cache.Pinf, Xref)
    got = fused_solve(x0s, FusedCarry.zeros(B, pp), pp, max_iter=25,
                      xref_q=xq, pterm_c=pc, interpret=True)
    want = _run_scan(problem.replace(Xref=Xref), cache, x0s,
                     atm.Settings(max_iter=25, check_termination=0))
    u = np.asarray(got.U[:, :36]).reshape(B, 9, 4)
    np.testing.assert_allclose(u, np.asarray(want.u), rtol=0, atol=1e-4)


def test_per_knot_bounds_match_scan(setup):
    """Time-varying (per-knot) input bounds pass through the flattened
    bound rows."""
    problem, cache, _pp, x0s = setup
    m = problem.horizon - 1
    ramp = jnp.linspace(0.05, 0.5, m)[:, None] * jnp.ones((1, problem.nu))
    prob = problem.replace(u_min=-ramp, u_max=ramp)
    ops = condensed_operators(
        cache, np.asarray(prob.A), np.asarray(prob.B), prob.horizon
    )
    pp = pad_problem(prob, cache, ops)
    got = fused_solve(x0s, FusedCarry.zeros(B, pp), pp, max_iter=30,
                      interpret=True)
    want = _run_scan(prob, cache, x0s,
                     atm.Settings(max_iter=30, check_termination=0))
    u = np.asarray(got.U[:, :36]).reshape(B, 9, 4)
    np.testing.assert_allclose(u, np.asarray(want.u), rtol=0, atol=1e-4)
    assert float(jnp.abs(want.znew).max()) <= 0.5 + 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("check", [0, 1])
def test_kernel_compiled_for_card_matches_scan(setup, check):
    """The kernel as Triton compiles it for the card (no interpreter)
    matches the scan tier: controls within the parity bar; adaptive counts
    equal up to the knife-edge rule of utils.parity.compare_schedules."""
    problem, cache, pp, x0s = setup
    tol = 0.05
    kw = dict(max_iter=100, check_termination=check, abs_pri_tol=tol,
              abs_dua_tol=tol)
    got = jax.jit(lambda x: fused_solve(x, FusedCarry.zeros(B, pp), pp,
                                        **kw))(x0s)
    want = _run_scan(problem, cache, x0s, atm.Settings(**kw))
    u = np.asarray(got.U[:, :36]).reshape(B, 9, 4)
    if not check:
        np.testing.assert_allclose(u, np.asarray(want.u), rtol=0, atol=1e-4)
        return
    r_s = np.stack([np.asarray(want.primal_residual_state),
                    np.asarray(want.dual_residual_state),
                    np.asarray(want.primal_residual_input),
                    np.asarray(want.dual_residual_input)], axis=-1)
    ok, err, detail = compare_schedules(
        (np.asarray(got.stats[:, 0]).astype(int), got.stats[:, 2:6], u),
        (np.asarray(want.iter), r_s, want.u), atm.Settings(**kw),
        max_share=1.0 / B)
    assert ok, (err, detail)
