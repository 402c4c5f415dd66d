"""Randomized dense LTI problem generator — the stress family for sweeping
(nx, nu, N) kernel shapes (capability parity with reference:
examples/codegen_random.cpp, generalized to batched random plants).

Plants are sampled to be stabilizable and mildly damped so the infinite-horizon
Riccati fixed point converges: A = I + dt * M with M ~ N(0, 1/sqrt(nx)) scaled to
spectral radius <= ~1.05, B ~ N(0, 1)/sqrt(nx).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

from ..types import Problem


def random_lti_problem(
    seed: int,
    nx: int,
    nu: int,
    horizon: int,
    *,
    dt: float = 0.05,
    q_scale: float = 10.0,
    r_scale: float = 1.0,
    bound: float = 3.0,
    dtype: Any = jnp.float32,
) -> tuple[Problem, float]:
    """Returns (problem, rho). Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((nx, nx)) / np.sqrt(nx)
    # Pull the continuous-time generator toward stability.
    M -= 0.5 * np.eye(nx)
    A = np.eye(nx) + dt * M
    # Clamp spectral radius so random plants stay near-marginally stable.
    rad = np.max(np.abs(np.linalg.eigvals(A)))
    if rad > 1.05:
        A *= 1.05 / rad
    B = rng.standard_normal((nx, nu)) / np.sqrt(nx)

    Q = q_scale * (0.5 + rng.random(nx))
    R = r_scale * (0.5 + rng.random(nu))
    rho = 1.0

    N, m = horizon, horizon - 1
    problem = Problem(
        A=jnp.asarray(A, dtype),
        B=jnp.asarray(B, dtype),
        Q=jnp.asarray(Q, dtype),
        R=jnp.asarray(R, dtype),
        u_min=jnp.full((m, nu), -bound, dtype),
        u_max=jnp.full((m, nu), bound, dtype),
        x_min=jnp.full((N, nx), -10.0 * bound, dtype),
        x_max=jnp.full((N, nx), 10.0 * bound, dtype),
        Xref=jnp.zeros((N, nx), dtype),
        Uref=jnp.zeros((m, nu), dtype),
    )
    return problem, rho


def random_lti_plants(
    batch: int,
    nx: int,
    nu: int,
    *,
    seed: int = 0,
    dt: float = 0.05,
    q_scale: float = 10.0,
    r_scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A batch of distinct plants from the :func:`random_lti_problem`
    family, drawn in bulk on the host: ``(A (B,nx,nx), B (B,nx,nu),
    Q (B,nx), R (B,nu))`` as float32, deterministic in ``seed``. The fleet
    entry point (:class:`..api.TinyMPCFleet`) takes these directly."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((batch, nx, nx)) / np.sqrt(nx) - 0.5 * np.eye(nx)
    A = np.eye(nx) + dt * M
    rad = np.max(np.abs(np.linalg.eigvals(A)), axis=-1)
    A *= np.where(rad > 1.05, 1.05 / rad, 1.0)[:, None, None]
    Bm = rng.standard_normal((batch, nx, nu)) / np.sqrt(nx)
    Q = q_scale * (0.5 + rng.random((batch, nx)))
    R = r_scale * (0.5 + rng.random((batch, nu)))
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(A), f32(Bm), f32(Q), f32(R)
