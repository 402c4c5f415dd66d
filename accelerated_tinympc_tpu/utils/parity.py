"""Comparing two tiers' adaptive solves instance by instance.

Two correct tiers that sum float32 products in another order put a residual
that sits on the tolerance on different sides of it, so at large batches a
small share of instances stops one check apart (measured on an H100 at
B=65,536: 0.6 % of instances, each exactly one iteration apart). Exact
equality of iteration counts is therefore the wrong test; this one accepts a
count that differs by exactly one check interval only where the tier that
stopped first did so with its worst residual within the tier-to-tier
residual drift of the tolerance, and only on a small share of instances.

The drift is measured, not assumed: over the instances whose counts agree
(so both residual sets come from the same iteration), the largest
difference between the two tiers' residuals, relative to the tolerance. A
residual is a difference of nearly equal iterates (the dual residual also
carries a factor rho), so it drifts far more, relative to its size, than
the iterates do. ``edge`` is a floor under the measured drift. Controls
must agree within ``u_tol`` wherever the counts are equal.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def compare_schedules(
    a: tuple, b: tuple, settings: Any, *, max_share: float = 0.01,
    edge: float = 0.01, u_tol: float = 1e-4,
) -> tuple[bool, float, dict[str, Any]]:
    """Compare ``(iterations (B,), residuals (B, 4), controls (B, ...))`` of
    two tiers solved with the same ``settings`` (residual columns: pri_state,
    dua_state, pri_input, dua_input). Returns ``(ok, max |du| where counts
    agree, detail)``."""
    (it_a, r_a, u_a), (it_b, r_b, u_b) = a, b
    it_a, it_b = np.asarray(it_a), np.asarray(it_b)
    check = max(1, int(settings.check_termination))
    tol = np.asarray([settings.abs_pri_tol, settings.abs_dua_tol] * 2,
                     np.float64)
    ratio = lambda r: np.max(np.asarray(r, np.float64) / tol, axis=-1)
    diff = it_a != it_b
    first = np.where(it_a < it_b, ratio(r_a), ratio(r_b))[diff]
    same = ~diff
    drift = edge
    if same.any():
        rel = np.abs(np.asarray(r_a, np.float64) - np.asarray(r_b, np.float64))
        drift = max(edge, float(np.max((rel / tol)[same])))
    u_a = np.asarray(u_a).reshape(len(it_a), -1)
    u_b = np.asarray(u_b).reshape(len(it_b), -1)
    err = float(np.max(np.abs(u_a[same] - u_b[same]))) if same.any() else 0.0
    ok = (diff.mean() <= max_share
          and bool(np.all(np.abs(it_a - it_b)[diff] == check))
          and bool(np.all(first >= 1.0 - drift)) and err <= u_tol)
    return ok, err, {
        "equal_fraction": float(same.mean()),
        "differing": int(diff.sum()),
        "max_abs_diter": int(np.max(np.abs(it_a - it_b))) if len(it_a) else 0,
        "first_stopper_residual_over_tol_min": (
            float(first.min()) if diff.any() else None),
        "residual_drift_over_tol": drift,
        "iters_mean": float(it_a.mean()), "iters_min": int(it_a.min()),
        "iters_max": int(it_a.max()),
    }
