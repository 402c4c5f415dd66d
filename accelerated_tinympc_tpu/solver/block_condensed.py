"""Block-condensed horizon sweeps: the long-horizon tier.

The plain scan tier spends its sequential sweeps issuing O(N) *tiny*
contractions (an (nx, nx) matvec per knot), so at long horizons the sweeps
are bound by the latency of one small step after another, not by FLOPs.
This tier removes that bound: condense each *block* of ``kb`` knots into
dense affine operators
(the :class:`..precompute.CondensedOperators` math restricted to a block —
reference recursions: src/tinympc/admm.cpp:27-37 forward rollout, :15-22
backward gradient) and run the sweeps as ``lax.scan`` over N/kb blocks of
dense matmuls — ``(B, kb*nu) @ (kb*nu, kb*nx)`` contractions with depth
48-128 instead of 8, and kb-times fewer sequential steps.

The arithmetic inflates by ~kb*nu/nx per forward block (dense block
operator vs sparse knot recurrence): extra FLOPs bought for fewer, larger
steps. Iterates, elementwise stages, and the ADMM
loop semantics are exactly :mod:`.admm`'s (this module only overrides the
two horizon sweeps through :func:`..solver.admm.admm_iteration`'s
``forward``/``backward`` hooks, like the associative-scan tier); block
boundaries change only the floating-point summation order (parity within
the usual FMA band, pinned in tests/test_block_condensed.py).

Use when N is large and the plant is SHARED across the batch (the
operators then stay cache-resident and amortize over every instance). For
per-instance plants each instance's operator tree streams from device
memory every iteration, which favours the vmapped scan tier
(``TinyMPCFleet(tier="scan")``). ``block=16`` covers N-1 with a tail block
when ``kb`` does not divide N-1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import Cache, Problem, Settings, State
from .admm import admm_iteration

_HI = jax.lax.Precision.HIGHEST


class _BlockOps(NamedTuple):
    """Sliced condensed operators for one block size ``s`` (horizon s+1):
    forward ``x_{1..s} = Fx x_start + Fd d_blk``, ``u = Gx x_start + Gd
    d_blk``; backward ``d_blk = Eq q_blk + Er r_blk + Ep p_end``,
    ``p_{0..s-1} = Hq q_blk + Hr r_blk + Hp p_end``."""

    Fx: jax.Array  # (s*nx, nx)
    Fd: jax.Array  # (s*nx, s*nu)
    Gx: jax.Array  # (s*nu, nx)
    Gd: jax.Array  # (s*nu, s*nu)
    Hq: jax.Array  # (s*nx, s*nx)
    Hr: jax.Array  # (s*nx, s*nu)
    Hp: jax.Array  # (s*nx, nx)
    Eq: jax.Array  # (s*nu, s*nx)
    Er: jax.Array  # (s*nu, s*nu)
    Ep: jax.Array  # (s*nu, nx)


def _slice_ops(o, s: int, nx: int) -> _BlockOps:
    return _BlockOps(
        Fx=o.Fx0[nx:], Fd=o.Fd[nx:], Gx=o.Gx0, Gd=o.Gd,
        Hq=o.Hq[: s * nx], Hr=o.Hr[: s * nx], Hp=o.Hp[: s * nx],
        Eq=o.Eq, Er=o.Er, Ep=o.Ep,
    )


def _ops_for_size(cache: Cache, A, B, s: int) -> _BlockOps:
    from ..precompute import condensed_operators

    nx = np.asarray(A).shape[0]
    # Operators in the cache dtype: the f64 exactness contract
    # (tests/test_f64.py) needs f64 operators, not f32-rounded ones.
    dt = np.dtype(jnp.asarray(cache.Kinf).dtype)
    o = condensed_operators(cache, np.asarray(A), np.asarray(B), s + 1,
                            dtype=dt)
    return jax.tree.map(jnp.asarray, _slice_ops(o, s, nx))


def block_sizes(horizon: int, block: int) -> tuple[int, int, int]:
    """``(kb, q, r)``: m = N-1 covered by q blocks of kb knots + a tail of
    r (kb clamped to m)."""
    m = int(horizon) - 1
    kb = max(1, min(int(block), m))
    q, r = divmod(m, kb)
    return kb, q, r


def _make_sweeps(ops_main, ops_tail, horizon: int, kb: int,
                 nx: int, nu: int):
    """``(forward, backward)`` sweep overrides from unbatched block
    operators (for per-instance plants the overrides are built inside the
    vmap, so the operator leaves arrive unbatched here)."""
    N = int(horizon)
    m = N - 1
    q, r = divmod(m, kb)
    mv = functools.partial(jnp.matmul, precision=_HI)

    def forward(state: State, problem: Problem, cache_: Cache) -> State:
        d = state.d
        x_start = state.x[0]
        xs = [state.x[:1]]
        us = []
        if q:
            o = ops_main
            d_main = d[: q * kb].reshape(q, kb * nu)

            def step(xc, db):
                U = mv(o.Gx, xc) + mv(o.Gd, db)
                X = mv(o.Fx, xc) + mv(o.Fd, db)
                return X[-nx:], (U, X)

            x_start, (U_m, X_m) = jax.lax.scan(step, x_start, d_main)
            us.append(U_m.reshape(q * kb, nu))
            xs.append(X_m.reshape(q * kb, nx))
        if r:
            o = ops_tail
            db = d[q * kb:].reshape(r * nu)
            us.append((mv(o.Gx, x_start) + mv(o.Gd, db)).reshape(r, nu))
            xs.append((mv(o.Fx, x_start) + mv(o.Fd, db)).reshape(r, nx))
        return state.replace(
            u=jnp.concatenate(us, axis=0), x=jnp.concatenate(xs, axis=0)
        )

    def backward(state: State, problem: Problem, cache_: Cache) -> State:
        qv, rv = state.q, state.r
        p_end = state.p[-1]
        tail = None
        if r:
            o = ops_tail
            Qb = qv[m - r: m].reshape(r * nx)
            Rb = rv[m - r:].reshape(r * nu)
            D = mv(o.Eq, Qb) + mv(o.Er, Rb) + mv(o.Ep, p_end)
            P = mv(o.Hq, Qb) + mv(o.Hr, Rb) + mv(o.Hp, p_end)
            tail = (D.reshape(r, nu), P.reshape(r, nx))
            p_carry = P[:nx]
        else:
            p_carry = p_end
        main = None
        if q:
            o = ops_main
            Q_main = qv[: q * kb].reshape(q, kb * nx)
            R_main = rv[: q * kb].reshape(q, kb * nu)

            def step(pc, inp):
                Qb, Rb = inp
                D = mv(o.Eq, Qb) + mv(o.Er, Rb) + mv(o.Ep, pc)
                P = mv(o.Hq, Qb) + mv(o.Hr, Rb) + mv(o.Hp, pc)
                return P[:nx], (D, P)

            _, (D_m, P_m) = jax.lax.scan(
                step, p_carry, (Q_main, R_main), reverse=True
            )
            main = (D_m.reshape(q * kb, nu), P_m.reshape(q * kb, nx))
        ds = [b[0] for b in (main, tail) if b is not None]
        ps = [b[1] for b in (main, tail) if b is not None]
        return state.replace(
            d=jnp.concatenate(ds, axis=0),
            p=jnp.concatenate(ps + [state.p[-1:]], axis=0),
        )

    return forward, backward


def block_sweeps(cache: Cache, A, B, horizon: int, block: int = 16):
    """Build ``(forward, backward)`` sweep overrides for
    :func:`..solver.admm.admm_iteration` — shared plant, operators built
    host-side in float64 (single-instance ``State``; vmap for batches —
    the block matmuls then become ``(B, kb*nu) @ ...`` batched
    contractions)."""
    kb, q, r = block_sizes(horizon, block)
    nx, nu = np.asarray(B).shape
    ops_main = _ops_for_size(cache, A, B, kb) if q else None
    ops_tail = _ops_for_size(cache, A, B, r) if r else None
    return _make_sweeps(ops_main, ops_tail, horizon, kb, nx, nu)


def block_ops_batched(cache_b: Cache, A_b, B_b, horizon: int,
                      block: int = 16):
    """Per-instance block operators, built ON DEVICE (vmapped
    :func:`..precompute.condensed_operators_jax` per block size) — the
    fleet long-horizon path. Returns ``(ops_main_b, ops_tail_b, kb)``
    with a leading batch axis on every operator leaf (either entry None
    when that size is absent). Memory: the dominant leaf is
    ``Hq (B, kb*nx, kb*nx)`` — size kb to taste."""
    from ..precompute import condensed_operators_jax

    kb, q, r = block_sizes(horizon, block)
    nx = A_b.shape[-1]

    def build(s):
        return jax.jit(jax.vmap(
            lambda c, a, b: _slice_ops(
                condensed_operators_jax(c, a, b, s + 1), s, nx
            )
        ))(cache_b, A_b, B_b)

    return (build(kb) if q else None), (build(r) if r else None), kb


def solve_block_batched(
    state: State, problem_b: Problem, cache_b: Cache, settings: Settings,
    *, block: int = 16, project=None, ops=None,
) -> State:
    """Batched per-instance-plant solve with block-condensed sweeps
    (semantics per instance identical to
    :func:`..solver.batched.solve_batched` with ``problem_axes=0``; the
    per-instance sweeps are built inside the vmap from the batched
    operators of :func:`block_ops_batched`, which ``ops`` can supply
    prebuilt to amortize across solves).

    With per-instance plants the block operators cannot stay resident —
    every instance's ~kb^2-scaled operator tree streams from device memory
    each iteration (speed on the card: not measured). Block condensation
    pays off when the plant is SHARED
    (:func:`solve_block`); for fleets use
    ``TinyMPCFleet(tier="scan")``. Kept for completeness and parity
    coverage."""
    from ..types import SOLVED, UNSOLVED
    from .batched import _freeze

    N = state.x.shape[-2]
    nx, nu = problem_b.B.shape[-2:]
    if ops is None:
        ops = block_ops_batched(cache_b, problem_b.A, problem_b.B, N, block)
    ops_main_b, ops_tail_b, kb = ops

    extra = [o for o in (ops_main_b, ops_tail_b) if o is not None]
    have = (ops_main_b is not None, ops_tail_b is not None)

    def one(s, p, c, *opsx):
        i = 0
        om = ot = None
        if have[0]:
            om = opsx[i]
            i += 1
        if have[1]:
            ot = opsx[i]
        fwd, bwd = _make_sweeps(om, ot, N, kb, nx, nu)
        return admm_iteration(
            s, p, c, settings, forward=fwd, backward=bwd, project=project
        )

    iterate = jax.vmap(one, in_axes=(0,) * (3 + len(extra)))

    batch = state.iter.shape[0]
    state = state.replace(
        status=jnp.full((batch,), UNSOLVED, state.status.dtype),
        iter=jnp.zeros((batch,), state.iter.dtype),
    )
    if settings.check_termination <= 0:
        return jax.lax.fori_loop(
            0, settings.max_iter,
            lambda _, s: iterate(s, problem_b, cache_b, *extra),
            state,
        )

    def body(s: State) -> State:
        done = s.status == SOLVED
        return _freeze(done, s, iterate(s, problem_b, cache_b, *extra))

    def cond(s: State) -> jax.Array:
        return jnp.any((s.iter < settings.max_iter) & (s.status != SOLVED))

    return jax.lax.while_loop(cond, body, state)


def solve_block(
    state: State, problem: Problem, cache: Cache, settings: Settings,
    *, block: int = 16, project=None,
) -> State:
    """ADMM loop with block-condensed sweeps (same loop semantics as
    :func:`..solver.admm.solve`; reference src/tinympc/admm.cpp:111-152)."""
    from ..types import SOLVED, UNSOLVED

    N = state.x.shape[-2]
    forward, backward = block_sweeps(cache, problem.A, problem.B, N, block)
    state = state.replace(
        status=jnp.asarray(UNSOLVED, state.status.dtype),
        iter=jnp.zeros_like(state.iter),
    )
    step = lambda s: admm_iteration(
        s, problem, cache, settings,
        forward=forward, backward=backward, project=project,
    )
    if settings.check_termination <= 0:
        return jax.lax.fori_loop(
            0, settings.max_iter, lambda _, s: step(s), state
        )

    def cond(s: State):
        return (s.iter < settings.max_iter) & (s.status != SOLVED)

    return jax.lax.while_loop(cond, step, state)
