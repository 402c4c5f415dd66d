"""Offline precompute: infinite-horizon Riccati cache + condensed horizon operators.

This is the on-device replacement for the *math* half of the reference's codegen
(reference: src/tinympc/codegen.cpp:254-292): rho-augment the diagonal costs, run
the infinite-horizon discrete Riccati fixed point, and cache the matrices the ADMM
solver needs. Emitting C++ source files is replaced by constructing pytrees (and,
for deployment, AOT export / serialization in api/export.py).

Two implementations:

- :func:`riccati_cache` — host-side NumPy in float64. The reference insists the
  Riccati precompute run in double (examples/codegen_cartpole.cpp:9-11 "For
  codegen, change it to double, otherwise, Riccati may fail"); precompute is
  offline so there is no reason to put it on the accelerator.
- :func:`riccati_cache_jax` — jittable/vmappable JAX version (``lax.while_loop``)
  for on-device cache construction over large batches of random plants.

Plus :func:`condensed_operators`: the dense-matmul reformulation. Both horizon sweeps
of the ADMM iteration (forward rollout, reference src/tinympc/admm.cpp:27-37;
backward Riccati gradient recursion, admm.cpp:15-22) are *affine* recurrences, so
each sweep collapses into a single dense matmul against a precomputed operator.
That turns the per-iteration hot path from 2*(N-1) dependent (12x12)-class matvecs
into two dense matmuls over the batch.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .types import Cache

# Fixed-point controls (reference: src/tinympc/codegen.cpp:273-285).
RICCATI_MAX_ITERS = 1000
RICCATI_TOL = 1e-5


def rho_augmented_costs(Q, R, rho):
    """Q += rho, R += rho elementwise on the diagonals (reference:
    src/tinympc/codegen.cpp:254-258)."""
    return Q + rho, R + rho


def riccati_cache(
    A: np.ndarray,
    B: np.ndarray,
    Q: np.ndarray,
    R: np.ndarray,
    rho: float,
    *,
    max_iters: int = RICCATI_MAX_ITERS,
    tol: float = RICCATI_TOL,
    dtype: Any = np.float32,
) -> Cache:
    """Infinite-horizon Riccati fixed point in float64 on the host.

    Mirrors reference src/tinympc/codegen.cpp:268-292 exactly: P0 = rho*I,
    iterate Kinf/Pinf until max|dKinf| < 1e-5 (cap ``max_iters``), then cache
    Quu_inv, AmBKt, coeff_d2p. ``Q``/``R`` are the *raw* diagonal vectors; the
    rho augmentation happens here.
    """
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    Qa, Ra = rho_augmented_costs(
        np.asarray(Q, np.float64), np.asarray(R, np.float64), float(rho)
    )
    Q1 = np.diag(Qa)
    R1 = np.diag(Ra)

    nx, nu = B.shape
    Ktp1 = np.zeros((nu, nx))
    Ptp1 = float(rho) * np.eye(nx)
    Kinf = np.zeros((nu, nx))
    Pinf = np.zeros((nx, nx))
    for _ in range(max_iters):
        Kinf = np.linalg.solve(R1 + B.T @ Ptp1 @ B, B.T @ Ptp1 @ A)
        Pinf = Q1 + A.T @ Ptp1 @ (A - B @ Kinf)
        if np.max(np.abs(Kinf - Ktp1)) < tol:
            break
        Ktp1 = Kinf
        Ptp1 = Pinf

    Quu_inv = np.linalg.inv(R1 + B.T @ Pinf @ B)
    AmBKt = (A - B @ Kinf).T
    coeff_d2p = Kinf.T @ R1 - AmBKt @ Pinf @ B

    # NumPy leaves: keeps float64 intact regardless of jax_enable_x64; JAX
    # converts on first jitted use.
    as_dt = lambda m: np.asarray(m, dtype)
    return Cache(
        rho=as_dt(rho), Kinf=as_dt(Kinf), Pinf=as_dt(Pinf),
        Quu_inv=as_dt(Quu_inv), AmBKt=as_dt(AmBKt), coeff_d2p=as_dt(coeff_d2p),
    )


def _cho_factor_small(M: jax.Array) -> list[list[jax.Array]]:
    """Unrolled Cholesky of a static-tiny SPD matrix (statically sized Python
    loops -> straight-line arithmetic, no dynamic control flow). Returns the
    lower factor as a list-of-scalar-arrays so callers can stay vmappable.

    For the (nu, nu)-class SPD matrices of this solver an unrolled Cholesky
    is straight-line elementwise arithmetic that fuses and vmaps cleanly
    inside a ``lax.while_loop``, where a batched LU would launch its own
    small kernels per step."""
    n = M.shape[0]
    L: list[list[Any]] = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j, j] - sum((L[j][k] * L[j][k] for k in range(j)), start=0.0)
        ljj = jnp.sqrt(s)
        L[j][j] = ljj
        inv_ljj = 1.0 / ljj
        for i in range(j + 1, n):
            L[i][j] = (
                M[i, j] - sum((L[i][k] * L[j][k] for k in range(j)), start=0.0)
            ) * inv_ljj
    return L


def _cho_solve_small(L: list[list[jax.Array]], Bm: jax.Array) -> jax.Array:
    """Solve ``(L L^T) X = Bm`` for the unrolled factor of
    :func:`_cho_factor_small`; ``Bm`` is (n, m) with static tiny n."""
    n = len(L)
    y: list[Any] = []
    for i in range(n):
        y.append(
            (Bm[i] - sum((L[i][k] * y[k] for k in range(i)), start=0.0))
            / L[i][i]
        )
    x: list[Any] = [None] * n
    for i in reversed(range(n)):
        x[i] = (
            y[i] - sum((L[k][i] * x[k] for k in range(i + 1, n)), start=0.0)
        ) / L[i][i]
    return jnp.stack(x, axis=0)


def _spd_solve_small(M: jax.Array, Bm: jax.Array) -> jax.Array:
    """``M^{-1} Bm`` for static-tiny SPD ``M`` via unrolled Cholesky."""
    return _cho_solve_small(_cho_factor_small(M), Bm)


def _spd_inv_small(M: jax.Array) -> jax.Array:
    """Inverse of a static-tiny SPD matrix via unrolled Cholesky."""
    return _spd_solve_small(M, jnp.eye(M.shape[0], dtype=M.dtype))


def riccati_cache_jax(
    A: jax.Array,
    B: jax.Array,
    Q: jax.Array,
    R: jax.Array,
    rho: jax.Array,
    *,
    max_iters: int = RICCATI_MAX_ITERS,
    tol: float = RICCATI_TOL,
    P0: jax.Array | None = None,
    K0: jax.Array | None = None,
) -> Cache:
    """Jittable/vmappable Riccati fixed point (same math as :func:`riccati_cache`).

    Uses ``lax.while_loop`` with the reference's iteration cap and Kinf-delta
    stopping rule. Runs in the caller's dtype; for well-conditioned plants f32
    is adequate, but prefer the host float64 path for offline cache builds.

    ``P0``/``K0`` warm-start the fixed point (e.g. from the cache at a
    nearby rho — the adaptive-rho refresh case, solver/batched_ops.py):
    iteration count drops from O(100) to the few steps the contraction needs
    to re-converge. The fixed point and stopping rule are unchanged; a
    warm start that is already converged exits after one verification step.

    The inner ``R1 + B^T P B`` solves use :func:`_spd_solve_small` (unrolled
    Cholesky) rather than ``jnp.linalg.solve`` — the matrix is SPD by
    construction (see `_cho_factor_small`).
    """
    nx, nu = B.shape
    dtype = A.dtype
    Qa, Ra = rho_augmented_costs(Q, R, rho)
    R1 = jnp.diag(Ra)

    hi = jax.lax.Precision.HIGHEST

    def step(carry):
        i, K, P, _delta = carry
        BtP = jnp.matmul(B.T, P, precision=hi)
        # Symmetrize before the Cholesky solve: the recursion below drifts
        # P (and hence R1 + B'PB) measurably asymmetric mid-iteration — an
        # artifact that LU tolerates but a triangular factorization must not
        # see. The fixed point itself is symmetric, so this changes nothing
        # the reference's stopping rule observes.
        M = R1 + jnp.matmul(BtP, B, precision=hi)
        Knew = _spd_solve_small(
            0.5 * (M + M.T), jnp.matmul(BtP, A, precision=hi)
        )
        Pnew = jnp.diag(Qa) + jnp.matmul(
            A.T, jnp.matmul(P, A - jnp.matmul(B, Knew, precision=hi), precision=hi),
            precision=hi,
        )
        Pnew = 0.5 * (Pnew + Pnew.T)
        return i + 1, Knew, Pnew, jnp.max(jnp.abs(Knew - K))

    def cond(carry):
        i, _K, _P, delta = carry
        return jnp.logical_and(i < max_iters, delta >= tol)

    init = (
        jnp.zeros((), jnp.int32),
        jnp.zeros((nu, nx), dtype) if K0 is None else K0.astype(dtype),
        rho.astype(dtype) * jnp.eye(nx, dtype=dtype)
        if P0 is None else P0.astype(dtype),
        jnp.asarray(jnp.inf, dtype),
    )
    _, Kinf, Pinf, _ = jax.lax.while_loop(cond, step, init)

    Mq = R1 + jnp.matmul(
        jnp.matmul(B.T, Pinf, precision=hi), B, precision=hi
    )
    Quu_inv = _spd_inv_small(0.5 * (Mq + Mq.T))
    AmBK = A - jnp.matmul(B, Kinf, precision=hi)
    AmBKt = AmBK.T
    coeff_d2p = jnp.matmul(Kinf.T, R1, precision=hi) - jnp.matmul(
        AmBKt, jnp.matmul(Pinf, B, precision=hi), precision=hi
    )
    return Cache(
        rho=rho.astype(dtype), Kinf=Kinf, Pinf=Pinf,
        Quu_inv=Quu_inv, AmBKt=AmBKt, coeff_d2p=coeff_d2p,
    )


@functools.partial(jax.jit, static_argnames=("max_iters", "tol"))
def _riccati_polish_jit(A, B, Q, R, rho, P0, K0, *, max_iters, tol):
    return jax.vmap(
        lambda a, b, q, r, p, Pw, Kw: riccati_cache_jax(
            a, b, q, r, p, max_iters=max_iters, tol=tol, P0=Pw, K0=Kw
        )
    )(A, B, Q, R, rho, P0, K0)


def riccati_newton_jax(
    A: jax.Array,
    B: jax.Array,
    Q: jax.Array,
    R: jax.Array,
    rho: jax.Array,
    K0: jax.Array,
    *,
    tol: float = 1e-9,
    max_outer: int = 20,
    inner_iters: int = 18,
) -> Cache:
    """Jittable/vmappable Newton-Kleinman DARE solve from a stabilizing
    warm gain ``K0``. Each outer step evaluates the closed loop
    ``A - B K`` and solves the Stein equation
    ``P = (A-BK)^T P (A-BK) + Q + K^T R K`` exactly by ``inner_iters``
    squarings (effective horizon 2^inner_iters), then updates the gain.
    Quadratic outer convergence makes warm solves a handful of outers where
    the linear fixed point needs hundreds-to-thousands of iterations at
    tight ``tol`` on slow plants — which is exactly the f64-polish regime.
    Precondition: ``K0`` stabilizes ``(A, B)``; otherwise the Stein sum
    diverges and the result is non-finite (loud, never silent — callers
    check and fall back to the fixed point). Converges to the true DARE
    fixed point, not the reference's truncated iterate."""
    nx, nu = B.shape
    dtype = A.dtype
    Qa, Ra = rho_augmented_costs(Q, R, rho)
    R1 = jnp.diag(Ra)
    hi = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=hi)

    def kgain(P):
        BtP = mm(B.T, P)
        M = R1 + mm(BtP, B)
        return _spd_solve_small(0.5 * (M + M.T), mm(BtP, A))

    def outer(carry):
        i, K, _P, _delta = carry
        M = A - mm(B, K)
        W = jnp.diag(Qa) + mm(K.T, mm(R1, K))

        def dbl(_, c):
            S, Mj = c
            return (S + mm(Mj.T, mm(S, Mj)), mm(Mj, Mj))

        S, _ = jax.lax.fori_loop(0, inner_iters, dbl, (W, M))
        Pn = 0.5 * (S + S.T)
        Kn = kgain(Pn)
        return i + 1, Kn, Pn, jnp.max(jnp.abs(Kn - K))

    def cond(carry):
        i, _K, _P, delta = carry
        return jnp.logical_and(i < max_outer, delta >= tol)

    init = (
        jnp.zeros((), jnp.int32), K0.astype(dtype),
        jnp.zeros((nx, nx), dtype), jnp.asarray(jnp.inf, dtype),
    )
    _, Kinf, Pinf, _ = jax.lax.while_loop(cond, outer, init)

    Mq = R1 + mm(mm(B.T, Pinf), B)
    Quu_inv = _spd_inv_small(0.5 * (Mq + Mq.T))
    AmBKt = (A - mm(B, Kinf)).T
    coeff_d2p = mm(Kinf.T, R1) - mm(AmBKt, mm(Pinf, B))
    return Cache(
        rho=rho.astype(dtype), Kinf=Kinf, Pinf=Pinf,
        Quu_inv=Quu_inv, AmBKt=AmBKt, coeff_d2p=coeff_d2p,
    )


def riccati_caches_batched(
    A: jax.Array, B: jax.Array, Q: jax.Array, R: jax.Array, rho: jax.Array,
    *,
    warm: Cache | None = None,
    newton: bool = False,
    newton_tol: float = 1e-6,
) -> Cache:
    """Batch-leading Riccati caches for per-instance plants, on device.

    Cold builds run the vmapped fixed point (:func:`riccati_cache_jax`).
    With ``warm`` (a batch-leading :class:`Cache`), the fixed point starts
    from its ``Pinf``/``Kinf``; with ``newton=True`` as well, a warm
    Newton-Kleinman solve (:func:`riccati_newton_jax`) runs from its gain
    instead — the fast refresh after a rho change (the old gain always
    stabilizes its own plant). Shared by every per-instance tier (fleet
    setup, plant refresh, adaptive rho)."""
    if warm is None:
        return jax.vmap(riccati_cache_jax)(A, B, Q, R, rho)
    if newton:
        return jax.vmap(
            lambda a, b, q, r, p, K0: riccati_newton_jax(
                a, b, q, r, p, K0, tol=newton_tol
            )
        )(A, B, Q, R, rho, warm.Kinf)
    return jax.vmap(
        lambda a, b, q, r, p, P0, K0: riccati_cache_jax(
            a, b, q, r, p, P0=P0, K0=K0
        )
    )(A, B, Q, R, rho, warm.Pinf, warm.Kinf)


@functools.partial(jax.jit, static_argnames=("tol",))
def _riccati_polish_newton_jit(A, B, Q, R, rho, K0, *, tol):
    return jax.vmap(
        lambda a, b, q, r, p, Kw: riccati_newton_jax(
            a, b, q, r, p, Kw, tol=tol
        )
    )(A, B, Q, R, rho, K0)


def riccati_polish_f64(
    cache: Cache,
    A: jax.Array, B: jax.Array, Q: jax.Array, R: jax.Array, rho: jax.Array,
    *,
    max_iters: int = RICCATI_MAX_ITERS,
    tol: float = 1e-9,
    batch_chunk: int = 4096,
) -> Cache:
    """float64 polish of a device-built f32 cache batch.

    The f32 fixed point lands ~4e-5 (relative) off the true cache — it drives
    controls ~7e-4 off the reference, above the 1e-4 parity bar. This
    re-solves in float64 on device (under ``jax.enable_x64``) to a tighter
    ``tol``, recomputes the cache terms in f64, and casts back to f32 — the returned caches are the correctly
    rounded f32 values of the true fixed point. Warm-started from the f32
    solution, the contraction only has to close the remaining ~4e-5, so the
    polish costs a fraction of a cold build. Anchor: the reference's own
    double-precision insistence for the offline bake
    (examples/codegen_cartpole.cpp:9-11, glob_opts.hpp:3).

    The polish runs Newton-Kleinman from the converged f32 gain (always
    stabilizing for its own plant — :func:`riccati_newton_jax`): quadratic
    convergence closes 4e-5 -> 1e-9 in 2-3 outers where the linear fixed
    point needs hundreds-to-thousands of f64 iterations on slow plants.
    Any instance whose Newton solve comes back non-finite (cannot happen
    for a truly converged warm gain; guarded anyway) is re-polished with
    the warm fixed point.

    ``batch_chunk``: batches above this size run as host-dispatched chunks
    of exactly this size (the last chunk padded by repeating its first
    instance — instances are independent, so padding changes nothing), so
    one compiled executable per chunk shape serves every fleet size.
    """
    Bn = jnp.asarray(A).shape[0]
    rho_b = jnp.broadcast_to(jnp.asarray(rho).reshape(-1), (Bn,))
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(a).astype(jnp.float64)

        def run(Ab, Bb, Qb, Rb, rb, P0b, K0b):
            out = _riccati_polish_newton_jit(
                f64(Ab), f64(Bb), f64(Qb), f64(Rb), f64(rb), f64(K0b),
                tol=tol,
            )
            bad = ~jnp.stack([
                jnp.isfinite(lf.reshape(lf.shape[0], -1)).all(axis=1)
                for lf in jax.tree.leaves(out)
            ]).all(axis=0)
            if bool(bad.any()):
                fb = _riccati_polish_jit(
                    f64(Ab), f64(Bb), f64(Qb), f64(Rb), f64(rb),
                    f64(P0b), f64(K0b), max_iters=max_iters, tol=tol,
                )
                out = jax.tree.map(
                    lambda n, o: jnp.where(
                        bad.reshape((-1,) + (1,) * (n.ndim - 1)), o, n
                    ),
                    out, fb,
                )
            return out

        if Bn <= batch_chunk:
            out = run(A, B, Q, R, rho_b, cache.Pinf, cache.Kinf)
        else:
            parts = []
            for lo in range(0, Bn, batch_chunk):
                hi = min(lo + batch_chunk, Bn)
                sl = lambda a: jnp.asarray(a)[lo:hi]
                args = [sl(A), sl(B), sl(Q), sl(R), sl(rho_b),
                        sl(cache.Pinf), sl(cache.Kinf)]
                pad = batch_chunk - (hi - lo)
                if pad:
                    args = [
                        jnp.concatenate(
                            [a, jnp.broadcast_to(a[:1],
                                                 (pad,) + a.shape[1:])], 0
                        )
                        for a in args
                    ]
                res = run(*args)
                if pad:
                    res = jax.tree.map(lambda a: a[:hi - lo], res)
                parts.append(res)
            out = jax.tree.map(
                lambda *xs: jnp.concatenate(xs, axis=0), *parts
            )
        out32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), out)
    return out32


class CondensedOperators(NamedTuple):
    """Dense affine operators condensing the two horizon sweeps.

    Forward rollout (reference src/tinympc/admm.cpp:27-37): with
    ``u_i = -Kinf x_i - d_i`` and ``x_{i+1} = A x_i + B u_i``, the closed loop is
    ``x_{i+1} = (A - B Kinf) x_i - B d_i`` — affine in ``(x0, d)``. Stacking the
    horizon: ``vec(x) = Fx0 @ x0 + Fd @ vec(d)`` and
    ``vec(u) = Gx0 @ x0 + Gd @ vec(d)``.

    Backward gradient recursion (reference src/tinympc/admm.cpp:15-22):
    ``p_i = q_i + AmBKt p_{i+1} - Kinf^T r_i`` (terminal ``p_{N-1}`` given),
    ``d_i = Quu_inv (B^T p_{i+1} + r_i)`` — affine in ``(q, r, p_{N-1})``:
    ``vec(p) = Hq @ vec(q_{0..N-2}) + Hr @ vec(r) + Hp @ p_{N-1}`` and
    ``vec(d) = Eq @ vec(q_{0..N-2}) + Er @ vec(r) + Ep @ p_{N-1}``.

    Shapes (N = horizon, m = N-1):
      Fx0 (N*nx, nx),  Fd (N*nx, m*nu),  Gx0 (m*nu, nx),  Gd (m*nu, m*nu)
      Hq (N*nx, m*nx), Hr (N*nx, m*nu),  Hp (N*nx, nx)
      Eq (m*nu, m*nx), Er (m*nu, m*nu),  Ep (m*nu, nx)

    The dropped ``coeff_d2p`` term in the reference backward pass (always-zero,
    commented out at src/tinympc/admm.cpp:20) is likewise omitted here.
    """

    Fx0: jax.Array
    Fd: jax.Array
    Gx0: jax.Array
    Gd: jax.Array
    Hq: jax.Array
    Hr: jax.Array
    Hp: jax.Array
    Eq: jax.Array
    Er: jax.Array
    Ep: jax.Array


def condensed_operators_jax(
    cache: Cache,
    A: jax.Array,
    B: jax.Array,
    horizon: int,
) -> CondensedOperators:
    """Jittable/vmappable condensed-operator build (same math as
    :func:`condensed_operators`, which see for the derivation).

    This is the on-device half of the per-instance-plant fast tier: vmapping
    it over a leading plant axis (together with :func:`riccati_cache_jax`)
    builds one operator set per instance entirely on device — the capability
    the reference's one-problem-per-process design rules out (reference:
    src/tinympc/tiny_wrapper.hpp:6). Horizon is static; tracing cost is
    O(N^2) small blocks, intended for MCU-class horizons (the assoc-scan tier
    covers long horizons).
    """
    K = cache.Kinf
    AmBKt = cache.AmBKt
    Quu_inv = cache.Quu_inv
    Kt = K.T
    N = int(horizon)
    m = N - 1
    nx, nu = B.shape
    dtype = A.dtype
    hi = jax.lax.Precision.HIGHEST
    mm = functools.partial(jnp.matmul, precision=hi)
    zx = jnp.zeros((nx, nx), dtype)
    zxu = jnp.zeros((nx, nu), dtype)
    zux = jnp.zeros((nu, nx), dtype)
    zu = jnp.zeros((nu, nu), dtype)

    Acl = A - mm(B, K)
    powers = [jnp.eye(nx, dtype=dtype)]
    for _ in range(N - 1):
        powers.append(mm(Acl, powers[-1]))
    pB = [-mm(p, B) for p in powers]  # -Acl^k B

    # forward: x_i = Acl^i x0 + sum_{j<i} Acl^{i-1-j} (-B) d_j;  u_i = -K x_i - d_i
    Fx0 = jnp.concatenate(powers, axis=0)
    Fd = jnp.block([
        [pB[i - 1 - j] if j < i else zxu for j in range(m)] for i in range(N)
    ])
    Gx0 = jnp.concatenate([-mm(K, powers[i]) for i in range(m)], axis=0)
    Gd = jnp.block([
        [-jnp.eye(nu, dtype=dtype) if j == i
         else (-mm(K, pB[i - 1 - j]) if j < i else zu) for j in range(m)]
        for i in range(m)
    ])

    # backward: p_i = sum_{j>=i} AmBKt^{j-i} (q_j - K^T r_j) + AmBKt^{N-1-i} p_{N-1}
    Mp = [jnp.eye(nx, dtype=dtype)]
    for _ in range(N - 1):
        Mp.append(mm(AmBKt, Mp[-1]))
    MpKt = [-mm(p, Kt) for p in Mp]
    Hq = jnp.block([
        [Mp[j - i] if j >= i else zx for j in range(m)]
        for i in range(N - 1)
    ] + [[zx for _ in range(m)]])
    Hr = jnp.block([
        [MpKt[j - i] if j >= i else zxu for j in range(m)]
        for i in range(N - 1)
    ] + [[zxu for _ in range(m)]])
    Hp = jnp.concatenate([Mp[N - 1 - i] for i in range(N - 1)]
                         + [jnp.eye(nx, dtype=dtype)], axis=0)

    # d_i = Quu_inv (B^T p_{i+1} + r_i)
    QB = mm(Quu_inv, B.T)
    Eq = jnp.block([
        [mm(QB, Hq[(i + 1) * nx:(i + 2) * nx, j * nx:(j + 1) * nx])
         for j in range(m)] for i in range(m)
    ])
    Er = jnp.block([
        [(Quu_inv if j == i else zu)
         + mm(QB, Hr[(i + 1) * nx:(i + 2) * nx, j * nu:(j + 1) * nu])
         for j in range(m)] for i in range(m)
    ])
    Ep = jnp.concatenate(
        [mm(QB, Hp[(i + 1) * nx:(i + 2) * nx]) for i in range(m)], axis=0
    )
    return CondensedOperators(
        Fx0=Fx0, Fd=Fd, Gx0=Gx0, Gd=Gd, Hq=Hq, Hr=Hr, Hp=Hp,
        Eq=Eq, Er=Er, Ep=Ep,
    )


def condensed_operators(
    cache: Cache,
    A: np.ndarray,
    B: np.ndarray,
    horizon: int,
    *,
    dtype: Any = np.float32,
) -> CondensedOperators:
    """Build the condensed horizon operators in float64 on the host."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    K = np.asarray(cache.Kinf, np.float64)
    AmBKt = np.asarray(cache.AmBKt, np.float64)
    Quu_inv = np.asarray(cache.Quu_inv, np.float64)
    Kt = K.T
    N = horizon
    m = N - 1
    nx, nu = B.shape
    Acl = A - B @ K  # closed-loop transition

    # --- forward: x_i as affine function of (x0, d) ---------------------------
    # x_0 = x0; x_{i+1} = Acl x_i - B d_i
    Fx0 = np.zeros((N * nx, nx))
    Fd = np.zeros((N * nx, m * nu))
    powers = [np.eye(nx)]
    for _ in range(N - 1):
        powers.append(Acl @ powers[-1])
    for i in range(N):
        Fx0[i * nx:(i + 1) * nx] = powers[i]
        for j in range(i):  # x_i depends on d_j for j < i
            Fd[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = -powers[i - 1 - j] @ B
    # u_i = -K x_i - d_i
    Gx0 = np.zeros((m * nu, nx))
    Gd = np.zeros((m * nu, m * nu))
    for i in range(m):
        Gx0[i * nu:(i + 1) * nu] = -K @ powers[i]
        Gd[i * nu:(i + 1) * nu, i * nu:(i + 1) * nu] = -np.eye(nu)
        for j in range(i):
            Gd[i * nu:(i + 1) * nu, j * nu:(j + 1) * nu] = -K @ (-powers[i - 1 - j] @ B)

    # --- backward: (p, d) as affine functions of (q_{0..N-2}, r, p_{N-1}) ----
    # p_{N-1} passes through; p_i = q_i + AmBKt p_{i+1} - K^T r_i for i = N-2..0
    Hq = np.zeros((N * nx, m * nx))
    Hr = np.zeros((N * nx, m * nu))
    Hp = np.zeros((N * nx, nx))
    Mpowers = [np.eye(nx)]  # AmBKt^k
    for _ in range(N - 1):
        Mpowers.append(AmBKt @ Mpowers[-1])
    Hp[(N - 1) * nx:] = np.eye(nx)
    for i in range(N - 1):
        # p_i = sum_{j=i}^{N-2} AmBKt^{j-i} (q_j - K^T r_j) + AmBKt^{N-1-i} p_{N-1}
        Hp[i * nx:(i + 1) * nx] = Mpowers[N - 1 - i]
        for j in range(i, N - 1):
            Hq[i * nx:(i + 1) * nx, j * nx:(j + 1) * nx] = Mpowers[j - i]
            Hr[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = -Mpowers[j - i] @ Kt
    # d_i = Quu_inv (B^T p_{i+1} + r_i)
    QB = Quu_inv @ B.T
    Eq = np.zeros((m * nu, m * nx))
    Er = np.zeros((m * nu, m * nu))
    Ep = np.zeros((m * nu, nx))
    for i in range(m):
        Er[i * nu:(i + 1) * nu, i * nu:(i + 1) * nu] = Quu_inv
        # p_{i+1} rows of (Hq, Hr, Hp)
        r0 = (i + 1) * nx
        Eq[i * nu:(i + 1) * nu] += QB @ Hq[r0:r0 + nx]
        Er[i * nu:(i + 1) * nu] += QB @ Hr[r0:r0 + nx]
        Ep[i * nu:(i + 1) * nu] = QB @ Hp[r0:r0 + nx]

    as_dt = lambda mmat: jnp.asarray(mmat, dtype)
    return CondensedOperators(
        Fx0=as_dt(Fx0), Fd=as_dt(Fd), Gx0=as_dt(Gx0), Gd=as_dt(Gd),
        Hq=as_dt(Hq), Hr=as_dt(Hr), Hp=as_dt(Hp),
        Eq=as_dt(Eq), Er=as_dt(Er), Ep=as_dt(Ep),
    )
