"""Compaction cascade (solver/cascade.py) vs one long adaptive fused call.

The cascade must be *iteration-exact*: segmenting the adaptive kernel at
check-schedule multiples and compacting converged instances out of the batch
may not change any instance's iteration count or convergence flag, and the
iterates must match (rows are independent, so compaction moves rows between
programs without changing their arithmetic).  Reference anchor for the
semantics preserved: src/tinympc/admm.cpp:91-152 (check cadence, early exit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
from accelerated_tinympc_tpu.ops.fused_admm import (
    FusedCarry,
    fused_solve,
    pad_problem,
)
from accelerated_tinympc_tpu.precompute import condensed_operators
from accelerated_tinympc_tpu.solver.cascade import cascade_solve

B = 12


@pytest.fixture(scope="module")
def setup():
    problem, cache, x0 = quadrotor_hovering_setup()
    ops = condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), problem.horizon
    )
    pp = pad_problem(problem, cache, ops)
    rng = np.random.default_rng(11)
    # Mixed difficulty: small perturbations converge in a handful of
    # iterations, large ones run long — the spread the cascade exploits.
    scale = np.repeat([0.01, 0.2, 1.5], B // 3)[:, None]
    x0s = jnp.asarray(
        np.asarray(x0)[None] + scale * rng.standard_normal((B, x0.size)),
        jnp.float32,
    )
    return pp, x0s


def _single(x0s, carry, pp, **kw):
    """One adaptive call, jitted like every cascade segment (operators as
    traced arguments, so both programs see the same arithmetic)."""
    return jax.jit(lambda x, c, p: fused_solve(x, c, p, **kw))(x0s, carry, pp)


def _assert_results_equal(got, want, atol=0.0):
    """Scheduling (iteration counts, convergence flags) must be bit-exact;
    iterates within ``atol``."""
    np.testing.assert_array_equal(
        np.asarray(got.stats[:, :2]), np.asarray(want.stats[:, :2])
    )
    def cmp(a, b, msg):
        a, b = np.asarray(a), np.asarray(b)
        if atol == 0.0:
            np.testing.assert_array_equal(a, b, err_msg=msg)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=atol,
                                       err_msg=msg)
    cmp(got.U, want.U, "U")
    cmp(got.X, want.X, "X")
    for f in FusedCarry._fields:
        cmp(getattr(got.carry, f), getattr(want.carry, f), f"carry.{f}")
    cmp(got.stats, want.stats, "stats")


def test_cascade_matches_single_call(setup):
    pp, x0s = setup
    carry = FusedCarry.zeros(B, pp)
    kw = dict(
        max_iter=60, check_termination=1, abs_pri_tol=0.2, abs_dua_tol=0.2,
        batch_tile=16, interpret=True,
    )
    want = _single(x0s, carry, pp, **kw)
    got = cascade_solve(
        x0s, carry, pp, segment_iters=10, min_bucket=4, **kw
    )
    # Sanity: the workload actually exercises compaction (instances leave
    # the batch at several different segment boundaries; some never do).
    it = np.asarray(want.stats[:, 0])
    assert it.min() <= 40 and it.max() == 60
    _assert_results_equal(got, want, atol=1e-4)


def test_cascade_bit_exact_unpacked(setup):
    """Compaction moves rows between programs without changing any row's
    arithmetic, so the cascade is bit-for-bit the single call."""
    pp, x0s = setup
    carry = FusedCarry.zeros(B, pp)
    kw = dict(
        max_iter=60, check_termination=1, abs_pri_tol=0.2, abs_dua_tol=0.2,
        batch_tile=16, interpret=True,
    )
    want = _single(x0s, carry, pp, **kw)
    got = cascade_solve(x0s, carry, pp, segment_iters=10, min_bucket=4, **kw)
    assert np.asarray(want.stats[:, 0]).min() < 60
    _assert_results_equal(got, want)


def test_cascade_check_interval_alignment(setup):
    """check_termination > 1 with segment boundaries at check multiples."""
    pp, x0s = setup
    carry = FusedCarry.zeros(B, pp)
    kw = dict(
        max_iter=45, check_termination=5, abs_pri_tol=0.2, abs_dua_tol=0.2,
        batch_tile=16, interpret=True,
    )
    want = _single(x0s, carry, pp, **kw)
    got = cascade_solve(x0s, carry, pp, segment_iters=15, min_bucket=4, **kw)
    _assert_results_equal(got, want, atol=1e-4)


def test_cascade_single_segment_fallback(setup):
    """max_iter <= segment_iters degenerates to one fused_solve call."""
    pp, x0s = setup
    carry = FusedCarry.zeros(B, pp)
    kw = dict(
        max_iter=8, check_termination=1, abs_pri_tol=0.2, abs_dua_tol=0.2,
        batch_tile=16, interpret=True,
    )
    want = _single(x0s, carry, pp, **kw)
    got = cascade_solve(x0s, carry, pp, segment_iters=20, **kw)
    _assert_results_equal(got, want)


def test_api_compaction(setup):
    """TinyMPC fused tier with compaction_segment matches the monolithic
    adaptive path on iteration counts and convergence flags."""
    import accelerated_tinympc_tpu as atm

    problem, cache, x0 = quadrotor_hovering_setup()
    _, x0s = setup
    settings = atm.Settings(
        max_iter=60, check_termination=1, abs_pri_tol=0.2, abs_dua_tol=0.2
    )

    def run(**kw):
        mpc = atm.TinyMPC.from_parts(
            problem, cache, settings=settings, batch=B, tier="fused",
            interpret=True, **kw,
        )
        mpc.set_x0(np.asarray(x0s))
        return mpc.solve()

    plain = run()
    casc = run(compaction_segment=10)
    np.testing.assert_array_equal(casc["iterations"], plain["iterations"])
    np.testing.assert_array_equal(casc["solved"], plain["solved"])
    assert plain["converged_fraction"] > 0.5


def test_cascade_validation(setup):
    pp, x0s = setup
    carry = FusedCarry.zeros(B, pp)
    with pytest.raises(ValueError, match="adaptive mode"):
        cascade_solve(x0s, carry, pp, check_termination=0, interpret=True)
    with pytest.raises(ValueError, match="multiple of"):
        cascade_solve(
            x0s, carry, pp, check_termination=4, segment_iters=10,
            interpret=True,
        )


def test_cascade_tracking_operands(setup):
    """Reference-window operands pass through every segment: iteration-exact
    vs one adaptive call on the same window."""
    from accelerated_tinympc_tpu.ops.fused_admm import ref_vectors

    problem, cache, _x0 = quadrotor_hovering_setup()
    pp, x0s = setup
    Xref = problem.Xref * 0.5
    xq, pc = ref_vectors(pp, problem.Q, cache.Pinf, Xref)
    carry = FusedCarry.zeros(B, pp)
    kw = dict(max_iter=60, check_termination=2, abs_pri_tol=0.2,
              abs_dua_tol=0.2, interpret=True, xref_q=xq, pterm_c=pc)
    want = _single(x0s, carry, pp, **kw)
    got = cascade_solve(x0s, carry, pp, segment_iters=10, min_bucket=4, **kw)
    _assert_results_equal(got, want, atol=1e-5)
