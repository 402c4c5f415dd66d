"""Fused ADMM solve: the whole batched solve as one Pallas kernel (Triton route).

The condensed formulation (:mod:`..solver.condensed`) turns each ADMM
iteration into a handful of small matmuls plus elementwise chains. Run as
plain XLA, every ``(B, Dx)`` iterate goes through device memory every
iteration (about 3 FLOP per byte at the hovering shape). Here one program
owns a block of ``batch_tile`` instances and runs *all* iterations of the
solve on it with the iterates held on chip: device-memory traffic is one read
of the warm-start carries and one write of the results per *solve*.

Semantics: stage-for-stage the reference iteration (reference:
src/tinympc/admm.cpp:111-152): a fixed-iteration mode (the reference with
termination checks disabled — deterministic benchmarking/golden tier) and an
adaptive mode with per-instance convergence freezing that replicates the early
exit (residual definitions per reference src/tinympc/admm.cpp:91-109; exit
skips the slack save + backward pass, admm.cpp:135-144). Per-instance
iteration counts equal the scan tier's.

Layout:

* **Folded iteration.** The reference's linear-cost stage (admm.cpp:77-85)
  and backward sweep (admm.cpp:15-22) collapse: with
  ``Q = xref_q − ρ(Vnew−Gn)``, ``R = −ρ(Znew−Yn)`` and the terminal costate
  refresh, the condensed backward output is
  ``Dn = (Vnew−Gn) @ W_q + (Znew−Yn) @ W_r + const_d`` where
  ``W_q = −ρ·[Eqᵀ; Epᵀ]``, ``W_r = −ρ·Erᵀ`` are baked offline (float64) and
  ``const_d = xref_q@Eqᵀ + pterm_c@Epᵀ`` is iteration-invariant and
  computed outside the kernel, like the ``x0`` terms of the forward pass.
  Four matmuls per iteration.
* **Power-of-two widths.** Triton blocks are powers of two, at least 16 wide
  for a matmul operand: hovering's ``Dx = 120`` and ``Du = 36`` pad to 128
  and 64. Padded lanes stay identically zero through every stage (zero
  operator rows/cols, zero bounds, zero reference terms).
* **One program per block of instances**, the iteration loop inside it.
  In adaptive mode each program leaves its loop once all of its rows have
  converged; converged rows are frozen by row masks.

Every matmul passes ``precision=HIGHEST``: on this route DEFAULT and HIGH
lower to TF32, whose three decimal digits drift a 100-iteration solve past
the 1e-4 control-parity bar.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..precompute import CondensedOperators
from ..types import Cache, Problem, pytree_dataclass, static_field

# Instances per program (a power of two >= 16, the smallest matmul block
# Triton takes) and warps per program. 32 x 8 was the fastest of the
# {16, 32, 64} x {2, 4, 8} sweep on an H100 at hovering widths (PERF.md);
# with 4 warps or fewer the iterates no longer fit in registers and the
# kernel runs 3-7x slower.
DEFAULT_BATCH_TILE = 32
DEFAULT_NUM_WARPS = 8
# Stats columns per instance: iters, solved, pri_state, dua_state,
# pri_input, dua_input (two zero columns pad to a power of two).
STATS = 8
_HI = jax.lax.Precision.HIGHEST


def _width(n: int) -> int:
    """Smallest power of two >= max(n, 16)."""
    return 1 << max(4, (int(n) - 1).bit_length())


@pytree_dataclass
class PaddedProblem:
    """Condensed operators + problem vectors in the kernel's padded layout.

    All ``W_*`` are stored transposed, ``(in, out)``, so every contraction is
    ``Y = X @ W``. ``Dxp``/``Dup`` are the padded state/input widths.
    ``W_fx``/``W_gx``/``W_eq``/``W_ep`` are applied outside the kernel (the
    ``x0`` terms and the reference fold into ``const_d``).
    """

    W_fx: jax.Array    # (nx, Dxp)   x0 -> X
    W_gx: jax.Array    # (nx, Dup)   x0 -> U
    W_fd: jax.Array    # (Dup, Dxp)  D  -> X
    W_gd: jax.Array    # (Dup, Dup)  D  -> U
    W_q: jax.Array     # (Dxp, Dup)  (Vnew-Gn) -> D  [-rho folded]
    W_r: jax.Array     # (Dup, Dup)  (Znew-Yn) -> D  [-rho folded]
    W_eq: jax.Array    # (Dxp, Dup)  Eq^T (zero terminal rows)
    W_ep: jax.Array    # (Dxp, Dup)  Ep^T at the terminal rows
    xref_q: jax.Array  # (1, Dxp)  = -(Xref * Qdiag)
    pterm_c: jax.Array  # (1, Dxp) = -Xref[-1] @ Pinf in the terminal lanes
    u_min: jax.Array   # (1, Dup)
    u_max: jax.Array
    x_min: jax.Array   # (1, Dxp)
    x_max: jax.Array
    rho: jax.Array     # ()
    dims: tuple = static_field()  # (nx, nu, horizon)

    @property
    def Dxp(self) -> int:
        nx, _nu, N = self.dims
        return _width(N * nx)

    @property
    def Dup(self) -> int:
        _nx, nu, N = self.dims
        return _width((N - 1) * nu)


def _pad(core: np.ndarray, rows: int, cols: int, row0: int = 0) -> np.ndarray:
    out = np.zeros((rows, cols), np.float64)
    out[row0:row0 + core.shape[0], : core.shape[1]] = core
    return out


def pad_problem(
    problem: Problem, cache: Cache, ops: CondensedOperators,
    dtype: Any = jnp.float32,
) -> PaddedProblem:
    """Build the padded kernel layout (host-side, float64 until the cast)."""
    nx, nu, N = problem.nx, problem.nu, problem.horizon
    Dx, Du = N * nx, (N - 1) * nu
    Dxp, Dup = _width(Dx), _width(Du)
    t0 = Dx - nx  # first terminal-knot lane
    o = {k: np.asarray(getattr(ops, k), np.float64) for k in ops._fields}
    rho = float(np.asarray(cache.rho, np.float64))
    f64 = lambda a: np.asarray(a, np.float64)
    row = lambda v, w: _pad(f64(v).reshape(1, -1), 1, w)
    # Backward operator with the terminal-costate rows folded in
    # (reference: admm.cpp:15-22 backward sweep + admm.cpp:83-84 terminal
    # costate refresh — both rho-scaled linear-cost contractions).
    Eqp = np.vstack([o["Eq"].T, o["Ep"].T])  # (Dx, Du)
    pterm = np.zeros(Dx)
    pterm[t0:] = -f64(problem.Xref[-1]) @ f64(cache.Pinf)
    arrays = dict(
        W_fx=_pad(o["Fx0"].T, nx, Dxp),
        W_gx=_pad(o["Gx0"].T, nx, Dup),
        W_fd=_pad(o["Fd"].T, Dup, Dxp),
        W_gd=_pad(o["Gd"].T, Dup, Dup),
        W_q=_pad(-rho * Eqp, Dxp, Dup),
        W_r=_pad(-rho * o["Er"].T, Dup, Dup),
        W_eq=_pad(o["Eq"].T, Dxp, Dup),
        W_ep=_pad(o["Ep"].T, Dxp, Dup, row0=t0),
        xref_q=row(-(f64(problem.Xref) * f64(problem.Q)), Dxp),
        pterm_c=row(pterm, Dxp),
        u_min=row(problem.u_min, Dup),
        u_max=row(problem.u_max, Dup),
        x_min=row(problem.x_min, Dxp),
        x_max=row(problem.x_max, Dxp),
        rho=np.asarray(rho),
    )
    return PaddedProblem(
        **{k: jnp.asarray(v, dtype) for k, v in arrays.items()},
        dims=(nx, nu, N),
    )


def ref_vectors(
    pp: PaddedProblem, Q: jax.Array, Pinf: jax.Array, Xref: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Device-side ``(xref_q, pterm_c)`` for a new horizon window (tracking
    mode, reference: quadrotor_tracking.cpp:101 slides the window each
    tick): two tiny jnp ops, no re-packing of operators. ``Q`` is the (nx,)
    cost diagonal, ``Pinf`` the (nx, nx) cache matrix, ``Xref`` the (N, nx)
    window."""
    nx, _nu, N = pp.dims
    Dx = N * nx
    dtype = pp.xref_q.dtype
    xref_q = jnp.zeros((1, pp.Dxp), dtype).at[0, :Dx].set(
        -(Xref * Q).reshape(-1).astype(dtype)
    )
    pterm = -jnp.matmul(Xref[-1], Pinf, precision=_HI).astype(dtype)
    pterm_c = jnp.zeros((1, pp.Dxp), dtype).at[0, Dx - nx:Dx].set(pterm)
    return xref_q, pterm_c


class FusedCarry(NamedTuple):
    """Warm-start carries persisting across MPC ticks, ``(B, Dup)`` /
    ``(B, Dxp)``. The reference keeps these in its global workspace between
    tiny_solve calls (examples/quadrotor_hovering.cpp:99-104 resets only the
    duals)."""

    D: jax.Array  # (B, Dup)
    Y: jax.Array  # (B, Dup)
    G: jax.Array  # (B, Dxp)
    Z: jax.Array  # (B, Dup)
    V: jax.Array  # (B, Dxp)

    @staticmethod
    def zeros(batch: int, pp: PaddedProblem, dtype=jnp.float32) -> "FusedCarry":
        fu = jnp.zeros((batch, pp.Dup), dtype)
        fx = jnp.zeros((batch, pp.Dxp), dtype)
        return FusedCarry(D=fu, Y=fu, G=fx, Z=fu, V=fx)

    def reset_duals(self) -> "FusedCarry":
        """Zero y/g between ticks (reference: tiny_wrapper.cpp:131-140)."""
        return self._replace(Y=jnp.zeros_like(self.Y), G=jnp.zeros_like(self.G))


class FusedResult(NamedTuple):
    """Kernel outputs. ``U``/``X`` are the final pre-projection iterates (the
    reference applies pre-projection u — examples/quadrotor_hovering.cpp:104-110).
    ``stats[:, 0]`` iterations, ``stats[:, 1]`` solved flag, ``stats[:, 2:6]``
    residuals [pri_state, dua_state, pri_input, dua_input]."""

    U: jax.Array
    X: jax.Array
    carry: FusedCarry
    stats: jax.Array  # (B, STATS) float32


def _iteration(D, Y, G, Z, V, W, consts, alpha: float):
    """One folded condensed ADMM iteration on on-chip values.

    Stage order is the reference's (src/tinympc/admm.cpp:117-150): forward
    pass (admm.cpp:27-37, x0 terms hoisted into ``Xb``/``Ub``), slack
    projection (admm.cpp:45-61), dual ascent (admm.cpp:67-71), then the
    linear-cost + backward stages folded into the ``W_q``/``W_r``
    contraction. ``alpha != 1`` is OSQP-style over-relaxation
    (``Settings.alpha``): the slack/dual stages see
    ``alpha * U + (1 - alpha) * Z``; the returned iterates ``U``/``X`` are
    untouched.
    """
    w_fd, w_gd, w_q, w_r = W
    Xb, Ub, const_d, u_min, u_max, x_min, x_max = consts
    dot = functools.partial(pl.dot, precision=_HI)
    X = Xb + dot(D, w_fd)
    U = Ub + dot(D, w_gd)
    if alpha != 1.0:
        Ur = alpha * U + (1.0 - alpha) * Z
        Xr = alpha * X + (1.0 - alpha) * V
    else:
        Ur, Xr = U, X
    S = Ur + Y
    Znew = jnp.minimum(jnp.maximum(S, u_min), u_max)
    Yn = S - Znew
    T = Xr + G
    Vnew = jnp.minimum(jnp.maximum(T, x_min), x_max)
    Gn = T - Vnew
    Dn = dot(Vnew - Gn, w_q) + dot(Znew - Yn, w_r) + const_d
    return Dn, Yn, Gn, Znew, Vnew, U, X


def _residuals(X, Vnew, V, U, Znew, Z, rho):
    """Per-row residuals (reference admm.cpp:95-98): pre-projection iterates
    vs new slacks; old-vs-new slacks scaled by rho."""
    rmax = lambda a: jnp.max(jnp.abs(a), axis=1)
    return (rmax(X - Vnew), rho * rmax(V - Vnew),
            rmax(U - Znew), rho * rmax(Z - Znew))


def _kernel(
    sc_ref, xb_ref, ub_ref, d_ref, y_ref, g_ref, z_ref, v_ref,
    cd_ref, umin_ref, umax_ref, xmin_ref, xmax_ref,
    wfd_ref, wgd_ref, wq_ref, wr_ref,
    u_out, x_out, d_out, y_out, g_out, z_out, v_out, st_out,
    *, max_iter: int, check_every: int, alpha: float,
):
    """One program: ``batch_tile`` instances through the whole solve.

    ``check_every == 0`` is the fixed-iteration mode (residual stats from
    the final iteration; the solved flag stays 0). Otherwise the adaptive
    mode: at every ``check_every``-th iteration each still-live row checks
    convergence; a row that converges keeps the exact early-exit result set
    (duals advanced, slack save + backward pass skipped — reference
    admm.cpp:135-144) and is frozen by masks from then on. The loop ends
    when every row of the program has converged or at ``max_iter``."""
    rho, pri_tol, dua_tol = sc_ref[0], sc_ref[1], sc_ref[2]
    W = (wfd_ref[...], wgd_ref[...], wq_ref[...], wr_ref[...])
    consts = (xb_ref[...], ub_ref[...], cd_ref[...], umin_ref[...],
              umax_ref[...], xmin_ref[...], xmax_ref[...])
    iterate = functools.partial(_iteration, W=W, consts=consts, alpha=alpha)
    D, Y, G, Z, V = (d_ref[...], y_ref[...], g_ref[...], z_ref[...],
                     v_ref[...])
    if check_every <= 0:
        def body(_, c):
            return iterate(*c)[:5]

        D, Y, G, Z, V = jax.lax.fori_loop(0, max_iter - 1, body,
                                          (D, Y, G, Z, V))
        Dn, Yn, Gn, Zn, Vn, U, X = iterate(D, Y, G, Z, V)
        r = _residuals(X, Vn, V, U, Zn, Z, rho)
        itf = jnp.full(r[0].shape, float(max_iter), jnp.float32)
        done = jnp.zeros_like(itf)
        D, Y, G, Z, V = Dn, Yn, Gn, Zn, Vn
    else:
        def cond(c):
            return (c[0] < max_iter) & (jnp.min(c[1]) < 0.5)

        def body(c):
            k, done, D, Y, G, Z, V, U, X, itf, *r = c
            k = k + 1
            Dn, Yn, Gn, Zn, Vn, Un, Xn = iterate(D, Y, G, Z, V)
            rn = _residuals(Xn, Vn, V, Un, Zn, Z, rho)
            live = done < 0.5
            rec = live & (k % check_every == 0)
            newly = rec & (rn[0] < pri_tol) & (rn[2] < pri_tol) \
                & (rn[1] < dua_tol) & (rn[3] < dua_tol)
            adv, step = live[:, None], (live & ~newly)[:, None]
            return (
                k, jnp.where(newly, 1.0, done),
                jnp.where(step, Dn, D), jnp.where(adv, Yn, Y),
                jnp.where(adv, Gn, G), jnp.where(step, Zn, Z),
                jnp.where(step, Vn, V), jnp.where(adv, Un, U),
                jnp.where(adv, Xn, X),
                jnp.where(newly, k.astype(jnp.float32), itf),
                *(jnp.where(rec, a, b) for a, b in zip(rn, r)),
            )

        zr = jnp.zeros((D.shape[0],), jnp.float32)
        init = (jnp.int32(0), zr, D, Y, G, Z, V,
                jnp.zeros_like(D), jnp.zeros_like(G), zr, zr, zr, zr, zr)
        _, done, D, Y, G, Z, V, U, X, itf, *r = jax.lax.while_loop(
            cond, body, init)
        itf = jnp.where(done > 0.5, itf, float(max_iter))
    u_out[...] = U
    x_out[...] = X
    d_out[...] = D
    y_out[...] = Y
    g_out[...] = G
    z_out[...] = Z
    v_out[...] = V
    col = jax.lax.broadcasted_iota(jnp.int32, st_out.shape, 1)
    st = jnp.zeros(st_out.shape, jnp.float32)
    for j, a in enumerate((itf, done, *r)):
        st = st + jnp.where(col == j, a[:, None], 0.0)
    st_out[...] = st


def fused_solve(
    x0: jax.Array,
    carry: FusedCarry,
    pp: PaddedProblem,
    *,
    max_iter: int = 100,
    check_termination: int = 0,
    abs_pri_tol: float | jax.Array = 1e-3,
    abs_dua_tol: float | jax.Array = 1e-3,
    batch_tile: int = DEFAULT_BATCH_TILE,
    num_warps: int = DEFAULT_NUM_WARPS,
    interpret: bool = False,
    xref_q: jax.Array | None = None,
    pterm_c: jax.Array | None = None,
    alpha: float = 1.0,
) -> FusedResult:
    """Run the fused whole-solve kernel over a batch.

    ``x0`` is ``(B, nx)``; carries are padded per instance
    (:class:`FusedCarry`); batches that are not a multiple of
    ``batch_tile`` are padded internally and sliced back.
    ``check_termination == 0`` selects the fixed-iteration mode, otherwise
    the adaptive freezing mode with checks every ``check_termination``
    iterations. Tolerances are traced operands — changing them does not
    recompile. ``xref_q``/``pterm_c`` override the baked reference vectors
    (tracking mode — build them with :func:`ref_vectors`).
    ``interpret=True`` runs the Pallas interpreter (CPU testing).
    """
    if max_iter < 1:
        raise ValueError("the fused tier runs at least one iteration; "
                         "use the scan tier for max_iter=0")
    if batch_tile < 16 or batch_tile & (batch_tile - 1):
        raise ValueError(f"batch_tile must be a power of two >= 16, "
                         f"got {batch_tile}")
    Dxp, Dup = pp.Dxp, pp.Dup
    B = x0.shape[0]
    dtype = x0.dtype
    xq = pp.xref_q if xref_q is None else xref_q
    pc = pp.pterm_c if pterm_c is None else pterm_c
    const_d = (jnp.matmul(xq, pp.W_eq, precision=_HI)
               + jnp.matmul(pc, pp.W_ep, precision=_HI))
    B_pad = -(-B // batch_tile) * batch_tile
    if B_pad != B:
        padr = lambda a: jnp.pad(a, ((0, B_pad - B), (0, 0)))
        x0 = padr(x0)
        carry = FusedCarry(*(padr(a) for a in carry))
    Xb = jnp.matmul(x0, pp.W_fx, precision=_HI)
    Ub = jnp.matmul(x0, pp.W_gx, precision=_HI)
    sc = jnp.stack([
        jnp.asarray(pp.rho, jnp.float32).reshape(()),
        jnp.asarray(abs_pri_tol, jnp.float32).reshape(()),
        jnp.asarray(abs_dua_tol, jnp.float32).reshape(()),
        jnp.zeros((), jnp.float32),
    ])

    rows = lambda w: pl.BlockSpec((batch_tile, w), lambda i: (i, 0))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    vecs = (const_d, pp.u_min, pp.u_max, pp.x_min, pp.x_max)
    ws = (pp.W_fd, pp.W_gd, pp.W_q, pp.W_r)
    widths = (Dup, Dxp, Dup, Dup, Dxp, Dup, Dxp)  # U X D Y G Z V
    kernel = functools.partial(
        _kernel, max_iter=max_iter, check_every=max(0, check_termination),
        alpha=alpha,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(B_pad // batch_tile,),
        in_specs=[whole(sc), rows(Dxp), rows(Dup), rows(Dup), rows(Dup),
                  rows(Dxp), rows(Dup), rows(Dxp)]
        + [whole(a) for a in vecs + ws],
        out_specs=[rows(w) for w in widths] + [rows(STATS)],
        out_shape=[jax.ShapeDtypeStruct((B_pad, w), dtype) for w in widths]
        + [jax.ShapeDtypeStruct((B_pad, STATS), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="fused_admm_solve",
    )(sc, Xb, Ub, *carry, *vecs, *ws)
    U, X, D, Y, G, Z, V, stats = (a[:B] for a in outs)
    return FusedResult(
        U=U, X=X, carry=FusedCarry(D=D, Y=Y, G=G, Z=Z, V=V), stats=stats
    )


def unpad_controls(result: FusedResult, pp: PaddedProblem) -> jax.Array:
    """First-knot controls ``(B, nu)`` from the padded flat U."""
    _nx, nu, _N = pp.dims
    return result.U[:, :nu]


def unpad_states(result: FusedResult, pp: PaddedProblem) -> jax.Array:
    """Full state trajectories ``(B, N, nx)`` from the padded flat X."""
    nx, _nu, N = pp.dims
    return result.X[:, : N * nx].reshape(result.X.shape[0], N, nx)
