"""Early-termination compaction cascade over the fused adaptive kernel.

The adaptive fused kernel freezes converged instances in place: their rows
keep executing full iterations inside their program until every row of the
program has converged (ops/fused_admm.py). That is semantically exact but
means one straggler pins its whole program at ``max_iter`` cost — the
reference has the same all-or-nothing structure per solve, just with a batch
of one (reference: src/tinympc/admm.cpp:117-152, the loop either exits for
*the* problem or runs on).

:func:`cascade_solve` reclaims that compute at the dispatch level: run the
kernel ``segment_iters`` iterations at a time, pull converged instances out
of the batch between segments, and re-dispatch only the survivors, compacted
into power-of-two buckets (each bucket size compiles once; the pow-2 ladder
bounds the number of kernel variants at log2(B)). The kernel's whole loop
state is the :class:`..ops.fused_admm.FusedCarry` and checks fire at in-call
iteration multiples of ``check_termination``, so a segment boundary at a
multiple of the check interval is invisible to the iterate sequence: the
cascade is *iteration-exact* against one long adaptive call — same iteration
counts, same convergence flags, same check schedule (tests/test_cascade.py).

Cost model: one long call costs ``B * max_iter`` row-iterations; the cascade
costs ``sum_s bucket_s * segment_iters`` plus three dispatches per segment
(kernel; jitted scatter-into-output + solved-flag readback; jitted
compaction gather) and one compile per new bucket size. Results land in
preallocated output buffers via per-segment donated scatters — there is no
final assembly pass. On workloads where most instances converge early
(warm-started MPC re-solves, mixed-difficulty sweeps) the reclaimed tail
dominates; for tightly-clustered convergence use one plain
:func:`..ops.fused_admm.fused_solve` call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fused_admm import (
    DEFAULT_BATCH_TILE,
    FusedCarry,
    FusedResult,
    PaddedProblem,
    fused_solve,
)

__all__ = ["cascade_solve"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


@functools.lru_cache(maxsize=64)
def _jit_segment(seg_iters, check_every, batch_tile, interpret):
    """One compiled cascade segment (the bucket shape enters via tracing)."""

    def fn(x0, carry, pp, pri_tol, dua_tol, xref_q, pterm_c):
        return fused_solve(
            x0, carry, pp, max_iter=seg_iters,
            check_termination=check_every,
            abs_pri_tol=pri_tol, abs_dua_tol=dua_tol,
            batch_tile=batch_tile, interpret=interpret,
            xref_q=xref_q, pterm_c=pterm_c,
        )

    return jax.jit(fn)


@jax.jit
def _compact(x0_b, carry, loc):
    """Gather the surviving instances' x0/carry into the next bucket in one
    dispatch (jit retraces per (in-shape, out-shape) pair automatically)."""
    return x0_b[loc], jax.tree.map(lambda a: a[loc], carry)


def _rows(res, off):
    return (res.U, res.X, res.stats.at[:, 0].add(off)) + tuple(res.carry)


@functools.partial(jax.jit, donate_argnums=0)
def _scatter(out, res, idx, off):
    """Scatter one segment's full result rows into the (B+1)-row output
    buffers at their original batch indices (padding rows target row B, the
    discard slot) and hand back the solved-flag column for host bucket
    sizing. Buffers are donated so the update is in place on device. Later
    segments overwrite the rows that kept iterating, so segment order gives
    last-write-wins assembly for free."""
    out = tuple(buf.at[idx].set(r) for buf, r in zip(out, _rows(res, off)))
    return out, res.stats[:, 1]


@functools.partial(jax.jit, static_argnums=2)
def _scatter_init(res, idx, B, off):
    """First-segment variant of :func:`_scatter`: creates the zeroed
    (B+1)-row buffers inside the same dispatch."""
    out = tuple(
        jnp.zeros((B + 1, r.shape[1]), r.dtype).at[idx].set(r)
        for r in _rows(res, off)
    )
    return out, res.stats[:, 1]


@functools.partial(jax.jit, static_argnums=1)
def _finalize(out, B):
    """Drop the discard row from every output buffer in one dispatch."""
    return tuple(a[:B] for a in out)


def cascade_solve(
    x0: jax.Array,
    carry: FusedCarry,
    pp: PaddedProblem,
    *,
    max_iter: int = 100,
    check_termination: int = 1,
    segment_iters: int | None = None,
    segment_growth: float = 4.0,
    abs_pri_tol: float = 1e-3,
    abs_dua_tol: float = 1e-3,
    batch_tile: int = DEFAULT_BATCH_TILE,
    min_bucket: int | None = None,
    interpret: bool = False,
    xref_q: jax.Array | None = None,
    pterm_c: jax.Array | None = None,
) -> FusedResult:
    """Adaptive fused solve with between-segment batch compaction.

    Drop-in equivalent of ``fused_solve(..., check_termination>0)`` — same
    arguments, same :class:`FusedResult` (full original batch order) — but
    converged instances stop consuming rows at the next segment boundary.

    ``segment_iters`` (default: ~25, rounded to a multiple of
    ``check_termination``) must be a multiple of ``check_termination`` so the
    in-call check schedule composes to the single-call schedule. Segments
    grow geometrically by ``segment_growth`` (rounded to check multiples):
    the survivors of each compaction are the hard instances, which converge
    rarely, so longer late segments trade useless compaction opportunities
    for fewer dispatches. This is a host-side orchestration loop (one device
    sync per segment) — not jittable; call it from the MPC outer loop, not
    inside one.
    """
    if check_termination <= 0:
        raise ValueError(
            "cascade_solve requires adaptive mode (check_termination > 0); "
            "fixed-iteration solves cannot converge early"
        )
    if segment_iters is None:
        segment_iters = check_termination * max(
            1, round(25 / check_termination)
        )
    if segment_iters % check_termination != 0:
        raise ValueError(
            f"segment_iters ({segment_iters}) must be a multiple of "
            f"check_termination ({check_termination}) so the check schedule "
            "matches a single adaptive call"
        )
    if segment_growth < 1.0:
        raise ValueError("segment_growth must be >= 1.0")

    B = x0.shape[0]
    if min_bucket is None:
        min_bucket = min(batch_tile, B)
    pri = jnp.float32(abs_pri_tol)
    dua = jnp.float32(abs_dua_tol)
    if max_iter <= segment_iters:
        return _jit_segment(max_iter, check_termination, batch_tile,
                            interpret)(x0, carry, pp, pri, dua, xref_q,
                                       pterm_c)

    # Current active block: device arrays of `bucket` rows whose first
    # `n_active` rows are live instances (rest are duplicate padding), plus
    # the host-side map from local row -> original batch index. Iteration
    # counts compose as offset + in-segment value under last-write-wins
    # (unsolved rows report the segment's full length, so offsets telescope
    # across overwrites).
    active_idx = np.arange(B, dtype=np.int32)
    x0_b, carry_b = x0, carry
    done_iters = 0
    cur_seg = segment_iters
    out = None
    while True:
        n_active = active_idx.size
        k = min(cur_seg, max_iter - done_iters)
        seg = _jit_segment(k, check_termination, batch_tile, interpret)
        res = seg(x0_b, carry_b, pp, pri, dua, xref_q, pterm_c)
        idx = np.full(res.stats.shape[0], B, np.int32)
        idx[:n_active] = active_idx
        off = jnp.float32(done_iters)
        if out is None:
            out, solved_col = _scatter_init(res, jnp.asarray(idx), B, off)
        else:
            out, solved_col = _scatter(out, res, jnp.asarray(idx), off)
        done_iters += k
        if done_iters >= max_iter:
            break
        solved = np.asarray(jax.device_get(solved_col))[:n_active] > 0.5
        keep = np.nonzero(~solved)[0]
        if keep.size == 0:
            break
        # Geometric segment growth, kept on the check-interval grid (any
        # multiple-of-check segmentation preserves the global schedule).
        cur_seg = max(
            check_termination,
            int(cur_seg * segment_growth)
            // check_termination * check_termination,
        )
        active_idx = active_idx[keep]
        bucket = min(B, max(min_bucket, _next_pow2(keep.size)))
        local = np.concatenate([
            keep, np.full(bucket - keep.size, keep[-1], keep.dtype),
        ])
        x0_b, carry_b = _compact(x0_b, res.carry, jnp.asarray(local))

    out = _finalize(out, B)
    return FusedResult(
        U=out[0], X=out[1], carry=FusedCarry(*out[3:]), stats=out[2],
    )
