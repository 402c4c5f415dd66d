"""Second-order-cone constraints — a beyond-reference capability.

The reference projects slacks onto box constraints only
(reference: src/tinympc/admm.cpp:45-61); thrust-limited quadrotors and
powered-descent problems additionally need second-order cones
``||w[ball]|| <= mu * w[axis]`` (e.g. a thrust-tilt cone on the input).
This module adds axis-aligned SOC projection to the ADMM slack stage for the
jnp tiers via the ``project`` override of
:func:`..solver.admm.admm_iteration` — cones are *static* Python metadata,
so code paths without cones trace byte-identically to the golden-verified
reference semantics.

Projection of ``(v, s)`` onto ``K = {(v, s): ||v|| <= mu s}`` is the
standard closed form (Boyd & Vandenberghe, §8.1.1 exercise; also the
projection used by OSQP-style conic solvers):

* ``||v|| <= mu s``            -> already in the cone, unchanged;
* ``mu ||v|| <= -s``           -> in the polar cone, project to 0;
* otherwise                    -> ``c = (mu ||v|| + s) / (mu^2 + 1)``,
  result ``(v * mu c / ||v||, c)`` on the cone boundary.

When both box bounds and cones are active the slack stage composes them
sequentially (box clip, then each cone in order). The composition is the
standard practical heuristic for intersections under ADMM — it is *not* the
exact projection onto the intersection; ADMM still converges to a point
satisfying every set applied last in a fixed point, and the final slack is
verified against each cone in the tests. Use cones alone (bounds disabled)
for the exact-single-set case.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..types import Problem, Settings, State
from .admm import update_slack


class Cone(NamedTuple):
    """One axis-aligned second-order cone
    ``||w[ball]|| <= mu * (w[axis] + shift)``.

    ``ball``/``axis`` index the per-knot decision vector (input ``u_i`` or
    state ``x_i``); static Python values so traced code specializes on them.
    ``shift`` translates the cone apex along the axis — e.g. a thrust-tilt
    cone on *hover-relative* inputs (the LTI deviation form absorbs constant
    gravity) is ``||u_xy|| <= mu * (u_z + g_hover)``.
    """

    ball: tuple[int, ...]
    axis: int
    mu: float
    shift: float = 0.0


class ConeSet(NamedTuple):
    """Static cone constraints for a problem: cones on the input vector at
    every knot, and/or on the state vector at every knot."""

    input_cones: tuple[Cone, ...] = ()
    state_cones: tuple[Cone, ...] = ()


def project_cone(w: jax.Array, cone: Cone) -> jax.Array:
    """Project per-knot vectors ``w (..., dim)`` onto ``cone``. Exact
    Euclidean projection, vectorized over every leading axis."""
    idx = jnp.asarray(cone.ball, jnp.int32)
    v = jnp.take(w, idx, axis=-1)
    s = w[..., cone.axis] + jnp.asarray(cone.shift, w.dtype)
    a = jnp.sqrt(jnp.sum(v * v, axis=-1))
    mu = jnp.asarray(cone.mu, w.dtype)

    inside = a <= mu * s
    polar = mu * a <= -s
    c = (mu * a + s) / (mu * mu + 1.0)
    # Guard a == 0 (then `inside` or `polar` holds and the scale is unused).
    scale = jnp.where(inside, 1.0, mu * c / jnp.where(a == 0.0, 1.0, a))
    scale = jnp.where(polar, 0.0, scale)
    s_new = jnp.where(inside, s, jnp.where(polar, 0.0, c))
    s_new = s_new - jnp.asarray(cone.shift, w.dtype)

    w = w.at[..., cone.axis].set(s_new.astype(w.dtype))
    # Scatter the scaled ball coordinates back.
    v_new = v * scale[..., None]
    for j, k in enumerate(cone.ball):
        w = w.at[..., k].set(v_new[..., j].astype(w.dtype))
    return w


def project_cone_masked(
    w: jax.Array,
    cone: Cone,
    ball_mask: jax.Array | None = None,
    axis_mask: jax.Array | None = None,
    mu: jax.Array | None = None,
    shift: jax.Array | None = None,
) -> jax.Array:
    """Exact projection of ``w (B, K, dim)`` with *per-instance* cone
    geometry/parameters: ``ball_mask``/``axis_mask`` are ``(B, dim)`` 0/1
    rows (None -> the static ``cone.ball``/``cone.axis`` indices),
    ``mu``/``shift`` are ``(B,)`` (None -> the static scalars). The row
    gather/scatter of :func:`project_cone` is replaced by mask-weighted
    sums; ``ball`` and ``axis`` entries must be disjoint per instance."""
    dt = w.dtype
    dim = w.shape[-1]
    if ball_mask is None:
        bm = jnp.zeros((1, dim), dt).at[0, jnp.asarray(cone.ball)].set(1.0)
    else:
        bm = jnp.asarray(ball_mask, dt)
    if axis_mask is None:
        am = jnp.zeros((1, dim), dt).at[0, cone.axis].set(1.0)
    else:
        am = jnp.asarray(axis_mask, dt)
    mu_ = (float(cone.mu) if mu is None
           else jnp.asarray(mu, dt).reshape(-1, 1))
    sh_ = (float(cone.shift) if shift is None
           else jnp.asarray(shift, dt).reshape(-1, 1))
    bmE, amE = bm[:, None, :], am[:, None, :]           # (B|1, 1, dim)
    a2 = jnp.sum((w * bmE) ** 2, axis=-1)               # (B, K)
    a = jnp.sqrt(a2)
    s = jnp.sum(w * amE, axis=-1) + sh_                 # (B, K)
    inside = a <= mu_ * s
    polar = mu_ * a <= -s
    c = (mu_ * a + s) / (mu_ * mu_ + 1.0)
    safe_a = jnp.where(a2 == 0.0, 1.0, a)
    scale = jnp.where(inside, 1.0, mu_ * c / safe_a)
    scale = jnp.where(polar, 0.0, scale)
    s_new = jnp.where(inside, s, jnp.where(polar, 0.0, c)) - sh_
    return (w * (1.0 - bmE - amE)
            + w * scale[..., None] * bmE
            + amE * s_new[..., None])


def make_cone_args(
    cones: ConeSet,
    batch: int,
    nx: int,
    nu: int,
    *,
    mu_u=None, shift_u=None, ball_u=None, axis_u=None,
    mu_x=None, shift_x=None, ball_x=None, axis_x=None,
    dtype=jnp.float32,
):
    """Per-instance cone overrides for the instance-ops (einsum) tier:
    ``mu_u``/``shift_u`` are ``(n_input_cones, B)``
    rows (or None for static scalars), ``ball_u[c]`` a ``(B, nu)`` 0/1
    membership array, ``axis_u[c]`` a ``(B,)`` int axis index (ditto
    ``*_x`` on ``nx``). Returns ``(input_args, state_args)``: one
    ``(mu, shift, ball_mask, axis_mask)`` tuple per cone with None for
    defaulted fields — a traced pytree for
    :func:`..solver.batched_ops.solve_instance_ops`'s ``cone_args``.

    Validated at pack time: axis indices must lie in ``[0, dim)`` and each
    instance's *effective* ball and axis entries (overridden or static)
    must be disjoint — the masked projection's
    arithmetic silently corrupts on overlap."""
    import numpy as np

    def build(cone_list, dim, mu, shift, ball, axis, kind):
        out = []
        for c, cone in enumerate(cone_list):
            mu_c = None if mu is None else jnp.asarray(mu[c], dtype)
            sh_c = None if shift is None else jnp.asarray(shift[c], dtype)
            bm_np = np.zeros((batch, dim), np.float32)
            bm = None
            if ball is not None and ball[c] is not None:
                bm_np[:, :] = np.asarray(ball[c], np.float32)
                bm = jnp.asarray(bm_np, dtype)
            else:
                bm_np[:, list(cone.ball)] = 1.0
            am_np = np.zeros((batch, dim), np.float32)
            am = None
            if axis is not None and axis[c] is not None:
                ax = np.asarray(axis[c], np.int64)
                if ax.min() < 0 or ax.max() >= dim:
                    raise ValueError(
                        f"{kind} cone {c}: axis indices must be in "
                        f"[0, {dim}), got [{ax.min()}, {ax.max()}]"
                    )
                am_np[np.arange(batch), ax] = 1.0
                am = jnp.asarray(am_np, dtype)
            else:
                am_np[:, int(cone.axis)] = 1.0
            bad = np.nonzero((bm_np * am_np).sum(axis=1) > 0)[0]
            if bad.size:
                raise ValueError(
                    f"{kind} cone {c}: ball and axis lanes overlap for "
                    f"instance(s) {bad[:8].tolist()}"
                    f"{'...' if bad.size > 8 else ''} — when overriding "
                    "only axis (or only ball), the other defaults to the "
                    "cone's static indices; pass both"
                )
            out.append((mu_c, sh_c, bm, am))
        return tuple(out)

    return (
        build(cones.input_cones, nu, mu_u, shift_u, ball_u, axis_u,
              "input"),
        build(cones.state_cones, nx, mu_x, shift_x, ball_x, axis_x,
              "state"),
    )


def cone_slack_update(cones: ConeSet):
    """Build an ``update_slack`` replacement applying box bounds (if enabled)
    then each cone in ``cones`` sequentially. Pass as
    ``admm_iteration(..., project=cone_slack_update(cones))`` or
    ``solve(..., project=...)`` / ``solve_batched(..., project=...)``."""

    def project(
        state: State, problem: Problem, settings: Settings
    ) -> State:
        state = update_slack(state, problem, settings)
        znew, vnew = state.znew, state.vnew
        for cone in cones.input_cones:
            znew = project_cone(znew, cone)
        for cone in cones.state_cones:
            vnew = project_cone(vnew, cone)
        return state.replace(znew=znew, vnew=vnew)

    return project


def cone_violation(w: jax.Array, cone: Cone) -> jax.Array:
    """Max violation ``||w[ball]|| - mu * (w[axis] + shift)`` over all
    leading axes (<= 0 means satisfied) — observability helper for
    tests/metrics."""
    idx = jnp.asarray(cone.ball, jnp.int32)
    v = jnp.take(w, idx, axis=-1)
    a = jnp.sqrt(jnp.sum(v * v, axis=-1))
    return jnp.max(a - cone.mu * (w[..., cone.axis] + cone.shift))
