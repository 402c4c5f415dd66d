"""float32 products must never run in TF32 without anyone noticing.

On the GPU, a float32 ``dot_general`` without ``precision=HIGHEST`` may run
in TF32 (cuBLAS) and, inside a Pallas kernel on the Triton route, DEFAULT and
HIGH lower to TF32 outright. TF32 keeps about three decimal digits; over a
100-iteration ADMM solve that drifts the controls past the 1e-4 parity bar.
These tests walk the jaxprs of every solver tier, the Riccati builders and
the fused kernel (including the kernel body inside ``pallas_call``) and
require every f32 ``dot_general`` to be HIGHEST. The card-marked test checks
the end effect on the card itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accelerated_tinympc_tpu as atm
from accelerated_tinympc_tpu.models import (
    quadrotor_hovering_setup,
    random_lti_plants,
)
from accelerated_tinympc_tpu.ops import FusedCarry, fused_solve, pad_problem
from accelerated_tinympc_tpu.precompute import (
    condensed_operators,
    condensed_operators_jax,
    riccati_cache_jax,
    riccati_newton_jax,
)
from accelerated_tinympc_tpu.solver.batched import (
    init_state_batched,
    solve_batched,
)
from accelerated_tinympc_tpu.solver.batched_ops import (
    OpsState,
    build_instance_ops,
    solve_instance_ops,
)
from accelerated_tinympc_tpu.solver.block_condensed import block_sweeps
from accelerated_tinympc_tpu.solver.condensed import (
    flatten_problem,
    init_flat_state,
    solve_condensed,
)

_HI = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _sub_jaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _f32_dots(jaxpr):
    """Every f32 dot_general in ``jaxpr`` and its sub-jaxprs (loop bodies,
    branches, nested jits, Pallas kernel bodies)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _f32_dots(sub)


def _assert_all_highest(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    dots = list(_f32_dots(jaxpr))
    assert dots, "no f32 dot_general found; the walk missed the solver"
    bad = [e for e in dots if e.params["precision"] != _HI]
    assert not bad, [str(e.params["precision"]) for e in bad]
    return len(dots)


@pytest.fixture(scope="module")
def hover():
    problem, cache, x0 = quadrotor_hovering_setup()
    x0s = jnp.tile(jnp.asarray(x0, jnp.float32), (4, 1))
    st = init_state_batched(4, 12, 4, 10)
    return problem, cache, x0s, st.replace(x=st.x.at[:, 0, :].set(x0s))


@pytest.mark.parametrize("check", [0, 1])
def test_scan_tier_is_highest(hover, check):
    problem, cache, _x0s, st = hover
    s = atm.Settings(max_iter=3, check_termination=check)
    _assert_all_highest(lambda t: solve_batched(t, problem, cache, s), st)


@pytest.mark.parametrize("check", [0, 1])
def test_condensed_tier_is_highest(hover, check):
    problem, cache, x0s, _st = hover
    ops = condensed_operators(cache, np.asarray(problem.A),
                              np.asarray(problem.B), 10)
    fp = flatten_problem(problem, cache)
    fs = init_flat_state(4, 12, 4, 10).replace(x0=x0s)
    s = atm.Settings(max_iter=3, check_termination=check)
    _assert_all_highest(lambda f: solve_condensed(f, fp, ops, s, 12), fs)


def test_block_tier_is_highest(hover):
    problem, cache, _x0s, st = hover
    fwd, bwd = block_sweeps(cache, problem.A, problem.B, 10, 4)
    s = atm.Settings(max_iter=3, check_termination=1)
    _assert_all_highest(lambda t: solve_batched(
        t, problem, cache, s, forward=fwd, backward=bwd), st)


def test_instance_ops_tier_is_highest(hover):
    problem, cache, x0s, _st = hover
    bc = lambda t: jax.tree.map(lambda a: jnp.broadcast_to(
        jnp.asarray(a), (4,) + jnp.shape(a)), t)
    s = atm.Settings(max_iter=3, check_termination=1)

    def run(p, c, x):
        ops = build_instance_ops(p, c)
        return solve_instance_ops(x, OpsState.zeros(4, 120, 36), ops, s,
                                  dims=(12, 4))

    _assert_all_highest(run, bc(problem), bc(cache), x0s)


@pytest.mark.parametrize("builder", ["fixed_point", "newton", "operators"])
def test_riccati_builders_are_highest(builder):
    A, B, Q, R = (jnp.asarray(a) for a in random_lti_plants(2, 6, 2, seed=0))
    rho = jnp.ones((2,), jnp.float32)
    if builder == "fixed_point":
        fn = jax.vmap(riccati_cache_jax)
        args = (A, B, Q, R, rho)
    elif builder == "newton":
        K0 = jnp.zeros((2, 2, 6), jnp.float32)
        fn = jax.vmap(riccati_newton_jax)
        args = (A, B, Q, R, rho, K0)
    else:
        caches = jax.vmap(riccati_cache_jax)(A, B, Q, R, rho)
        fn = jax.vmap(lambda c, a, b: condensed_operators_jax(c, a, b, 5))
        args = (caches, A, B)
    _assert_all_highest(fn, *args)


@pytest.mark.parametrize("check", [0, 2])
def test_fused_kernel_is_highest(hover, check):
    """The walk reaches into the pallas_call kernel body: all four in-loop
    matmuls and the x0/reference contractions outside it are HIGHEST."""
    problem, cache, x0s, _st = hover
    pp = pad_problem(problem, cache, condensed_operators(
        cache, np.asarray(problem.A), np.asarray(problem.B), 10))
    n = _assert_all_highest(
        lambda x, c: fused_solve(x, c, pp, max_iter=3,
                                 check_termination=check),
        x0s, FusedCarry.zeros(4, pp))
    assert n >= 4 + 2 + 2  # kernel body + x0 terms + const_d


def test_mission_is_highest(hover):
    problem, cache, x0s, _st = hover
    s = atm.Settings(max_iter=3, check_termination=1)
    _assert_all_highest(lambda x: atm.api.mpc_rollout(
        problem, cache, s, x, 2, batched=True), x0s)


@pytest.mark.gpu
def test_f32_products_on_card_are_ieee():
    """On the card, HIGHEST f32 products keep f32 accuracy (~1e-6 relative)
    where TF32 would show ~1e-3; the fused kernel's HIGHEST dots likewise."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(jax.jit(lambda x, y: jnp.matmul(
        x, y, precision=jax.lax.Precision.HIGHEST))(a, b))
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 1e-5, rel
