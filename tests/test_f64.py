"""Double-precision parity tier.

The reference's root build runs ``tinytype=double`` (reference:
src/tinympc/glob_opts.hpp:3); the JAX engine's production tiers are f32 with
``Precision.HIGHEST`` matmuls. This suite pins an ``enable_x64`` scan-tier
solve against the independent native double runtime at ~1e-10 (same cache,
pure iteration arithmetic) and documents the f32 tier's drift envelope
against the f64 ground truth (must stay inside the 1e-4 parity bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import quadrotor_hovering_setup
from accelerated_tinympc_tpu.native import NativeSolver
from accelerated_tinympc_tpu.precompute import riccati_cache
from accelerated_tinympc_tpu.solver import admm
from accelerated_tinympc_tpu.types import Cache, init_state

MAX_ITER = 30


@pytest.fixture(scope="module")
def native():
    problem, cache, x0 = quadrotor_hovering_setup()
    ns = NativeSolver(
        np.asarray(problem.A, np.float64), np.asarray(problem.B, np.float64),
        np.asarray(problem.Q, np.float64), np.asarray(problem.R, np.float64),
        rho=float(cache.rho), horizon=10,
        max_iter=MAX_ITER, check_termination=0,
    )
    ns.set_bounds(u_min=-0.5, u_max=0.5, x_min=-5.0, x_max=5.0)
    ns.set_xref(np.asarray(problem.Xref, np.float64))
    return problem, ns, np.asarray(x0, np.float64)


def _scan_solve(problem, cache, x0, dtype):
    """One fixed-iteration scan-tier solve in the given dtype."""
    st = init_state(12, 4, 10, dtype)
    st = st.replace(x=st.x.at[0, :].set(jnp.asarray(x0, dtype)))
    prob = jax.tree.map(lambda a: jnp.asarray(a, dtype), problem)
    ca = jax.tree.map(lambda a: jnp.asarray(a, dtype), cache)
    settings = atm.Settings(max_iter=MAX_ITER, check_termination=0)
    out = jax.jit(admm.solve)(st, prob, ca, settings)
    return np.asarray(out.u, np.float64)


def test_f64_scan_matches_native_double(native):
    """Same f64 cache on both sides -> differences are pure iteration
    arithmetic; the x64 scan tier tracks the native double solver to 1e-10."""
    problem, ns, x0 = native
    with jax.enable_x64(True):
        nc = ns.get_cache()
        cache = Cache(
            rho=jnp.asarray(5.0, jnp.float64),
            Kinf=jnp.asarray(nc["Kinf"], jnp.float64),
            Pinf=jnp.asarray(nc["Pinf"], jnp.float64),
            Quu_inv=jnp.asarray(nc["Quu_inv"], jnp.float64),
            AmBKt=jnp.asarray(nc["AmBKt"], jnp.float64),
            coeff_d2p=jnp.zeros((12, 4), jnp.float64),
        )
        u64 = _scan_solve(problem, cache, x0, jnp.float64)
    ns.reset_duals()
    ns.set_x0(x0)
    ns.solve()
    u_native = ns.get_u().reshape(9, 4)
    err = np.max(np.abs(u64 - u_native))
    assert err < 1e-10, err


def test_f32_drift_envelope(native):
    """The f32 scan tier stays inside the 1e-4 control parity bar relative to
    the f64 ground truth over the reference's full iteration budget."""
    problem, ns, x0 = native
    cache64 = riccati_cache(
        np.asarray(problem.A, np.float64), np.asarray(problem.B, np.float64),
        np.asarray(problem.Q, np.float64), np.asarray(problem.R, np.float64),
        5.0, dtype=np.float64,
    )
    with jax.enable_x64(True):
        u64 = _scan_solve(problem, cache64, x0, jnp.float64)
    u32 = _scan_solve(problem, cache64, x0, jnp.float32)
    drift = np.max(np.abs(u64 - u32))
    assert drift < 1e-4, drift


def test_f64_block_tier_matches_scan():
    """Block-condensed sweeps vs scan sweeps at float64: the only
    difference is summation order, so x64 pins the tiers together at
    1e-10 — the exactness contract behind the f32 FMA-band tolerance
    (round 5, solver/block_condensed.py)."""
    from accelerated_tinympc_tpu.models import random_lti_problem
    from accelerated_tinympc_tpu.precompute import riccati_cache
    from accelerated_tinympc_tpu.solver import admm
    from accelerated_tinympc_tpu.solver.block_condensed import solve_block

    with jax.enable_x64(True):
        p, rho = random_lti_problem(seed=2, nx=8, nu=3, horizon=65)
        c = riccati_cache(np.asarray(p.A), np.asarray(p.B),
                          np.asarray(p.Q), np.asarray(p.R), rho)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p)
        c64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), c)
        st = init_state(8, 3, 65, jnp.float64)
        x0 = np.random.default_rng(0).standard_normal(8) * 0.3
        st = st.replace(x=st.x.at[0, :].set(jnp.asarray(x0, jnp.float64)))
        settings = atm.Settings(max_iter=40, check_termination=1)
        a = jax.jit(admm.solve)(st, p64, c64, settings)
        b = jax.jit(
            lambda ss: solve_block(ss, p64, c64, settings, block=16)
        )(st)
        assert int(a.iter) == int(b.iter)
        err = float(jnp.max(jnp.abs(a.u - b.u)))
        assert err < 1e-10, err
